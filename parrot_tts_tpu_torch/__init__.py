"""PyTorch + CUDA port of parrot_tts_tpu for NVIDIA Hopper (H100).

Same module paths as the JAX package, which stays the reference the port
is held against. Serving (text -> HuBERT units -> 16 kHz waveform) is
`infer/serving.py::ParrotTTS`; its attention runs a hand-written CUDA
flash-attention forward (`csrc/flash_attn_fwd.cu`, 3xTF32 on the tensor
cores). This package imports
torch, numpy and the standard library only.
"""
