"""The port's CUDA kernels against their plain PyTorch versions.

This file imports no JAX, so it also runs on a machine with a card and no
JAX (tests/conftest.py imports JAX, hence `--noconftest`):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Tests marked `cuda` skip where there is no CUDA device.
"""

import math

import numpy as np
import pytest
import torch

from parrot_tts_tpu_torch.core.device import exact_numerics
from parrot_tts_tpu_torch.ops import flash_attention as fa


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(rng, b, h, t, d, device="cpu", all_masked_row=None):
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, t, d))
                                .astype(np.float32)).to(device)
               for _ in range(3))
    lengths = rng.integers(1, t + 1, size=b)
    lengths[0] = t
    mask = np.arange(t)[None, :] >= lengths[:, None]      # True = ignore
    if all_masked_row is not None:
        mask[all_masked_row] = True
    return q, k, v, torch.from_numpy(mask).to(device)


@pytest.mark.parametrize("bad", ["dtype", "width", "shape", "mask", "layout"])
def test_wrapper_rejects_what_the_kernel_does_not_take(rng, bad):
    q, k, v, mask = _inputs(rng, 2, 2, 8, 128)
    if bad == "dtype":
        k = k.double()
    elif bad == "width":
        q, k, v = (x[..., :32].contiguous() for x in (q, k, v))
    elif bad == "shape":
        v = v[:, :, :4].contiguous()
    elif bad == "mask":
        mask = mask.to(torch.uint8)
    else:
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises((TypeError, ValueError)):
        fa._check(q, k, v, mask)


def test_cpu_tensors_take_the_plain_version(rng):
    q, k, v, mask = _inputs(rng, 2, 2, 8, 16)
    before = fa.FLASH_FWD.launches
    torch.testing.assert_close(
        fa.flash_attention(q, k, v, mask, 0.25),
        fa.flash_attention_reference(q, k, v, mask, 0.25), rtol=0, atol=0)
    assert fa.FLASH_FWD.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("t,d", [(1, 128), (64, 128), (500, 128),
                                 (768, 128), (130, 64), (2048, 128)])
def test_kernel_matches_plain_on_card(cuda_device, t, d):
    rng = np.random.default_rng(t)
    q, k, v, mask = _inputs(rng, 4, 2, t, d, cuda_device,
                            all_masked_row=2)
    scale = 1.0 / math.sqrt(d)
    before = fa.FLASH_FWD.launches
    got = fa.flash_attention(q, k, v, mask, scale)
    torch.cuda.synchronize()
    assert fa.FLASH_FWD.launches == before + 1
    with exact_numerics(True):
        want = fa.flash_attention_reference(q, k, v, mask, scale)
    assert torch.equal(got[2], torch.zeros_like(got[2]))
    # IEEE float32 both; only the order of the sums differs
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_kernel_without_mask_and_on_a_side_stream(cuda_device):
    rng = np.random.default_rng(1)
    q, k, v, _ = _inputs(rng, 2, 2, 300, 128, cuda_device)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        got = fa.flash_attention(q, k, v, None, 0.1)
    torch.cuda.synchronize()
    with exact_numerics(True):
        want = fa.flash_attention_reference(q, k, v, None, 0.1)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
