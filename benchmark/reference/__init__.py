"""The benchmark's plain reference of Parrot-TTS serving.

Frozen, plain PyTorch: the text front end (`text.py`), the TTE forward
with the reference's quirks and the length regulator (`tte.py`), and the
unit HiFi-GAN generator with weight norm folded (`vocoder.py`). It
imports nothing of the system under test and takes nothing the system
made: it reads the same seeded state dicts and texts the benchmark hands
the system, and tokenizes, regulates and folds again itself. Products run
in IEEE float32 (TF32 off, `ieee()`), batch of one, at each request's
own length.
"""

import contextlib

import torch


@contextlib.contextmanager
def ieee():
    """IEEE float32 products in cuBLAS and cuDNN (TF32 off) and cuDNN's
    deterministic algorithms; the previous flags are restored on exit."""
    flags = ((torch.backends.cuda.matmul, "allow_tf32", False),
             (torch.backends.cudnn, "allow_tf32", False),
             (torch.backends.cudnn, "deterministic", True))
    prev = [getattr(obj, name) for obj, name, _ in flags]
    for obj, name, value in flags:
        setattr(obj, name, value)
    try:
        with torch.no_grad():
            yield
    finally:
        for (obj, name, _), value in zip(flags, prev):
            setattr(obj, name, value)
