"""CTC forced aligner (conv x3 + BatchNorm, BiLSTM, linear)."""
