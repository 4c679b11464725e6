"""Where the port runs, and with what float32 numerics.

Entry points take `device=None`, which means the CUDA card; a run with no
card raises unless the caller asks for the CPU explicitly (`device="cpu"`),
so a serving process never carries on silently on the host.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """`None` -> cuda (raises without a card); anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "parrot_tts_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run on the host")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is unavailable")
    return device


@contextlib.contextmanager
def exact_numerics(exact: bool):
    """exact=True: IEEE float32 in every matmul and cuDNN convolution (TF32
    off for both; torch turns cuDNN TF32 on by default), and only
    deterministic cuDNN algorithms, so a request gives the same bits every
    time (the default algorithms of the vocoder's convs differ run to run
    in the last bit, measured on an H100). exact=False allows TF32 and any
    algorithm. The previous flags are restored on exit."""
    flags = (torch.backends.cuda.matmul, "allow_tf32"), \
        (torch.backends.cudnn, "allow_tf32"), \
        (torch.backends.cudnn, "deterministic")
    prev = [getattr(obj, name) for obj, name in flags]
    for (obj, name), value in zip(flags, (not exact, not exact, exact)):
        setattr(obj, name, value)
    try:
        yield
    finally:
        for (obj, name), value in zip(flags, prev):
            setattr(obj, name, value)


def batch_to_device(batch: dict, dtypes: dict, device) -> dict:
    """The keys of `dtypes` present in a numpy batch -> tensors of those
    dtypes on device (other keys dropped). For a CUDA device the host copy
    is pinned and the transfer does not block the host."""
    device = torch.device(device)
    out = {}
    for k, dt in dtypes.items():
        if k not in batch:
            continue
        x = torch.as_tensor(np.asarray(batch[k])).to(dt)
        if device.type == "cuda":
            x = x.pin_memory()
        out[k] = x.to(device, non_blocking=True)
    return out
