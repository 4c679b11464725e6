"""HuBERT encoder for unit extraction, and its checkpoint loaders."""
