"""The attention backward of TTE training (ops/flash_dropout.py, rows 3
and 4 of PERF.md's kernel table): the keep bits' layout, the wrappers'
checks of what the kernels read, and, on the card, that two launches give
the same bits. tests/test_torch_kernels.py holds the kernels to their
plain versions.

This file imports no JAX, so it also runs on a machine with a card and no
JAX (tests/conftest.py imports JAX, hence `--noconftest`):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_flash_dropout_bwd.py

Tests marked `cuda` skip where there is no CUDA device.
"""

import numpy as np
import pytest
import torch

from parrot_tts_tpu_torch.ops import flash_dropout as fd

P = 0.1


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(seed, b, h, t, d, device="cpu"):
    """q, k, v, do, bias with a padded tail on row 0 (lengths random) and,
    for b > 1, a last row with no valid key."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((b, h, t, d))
                                    .astype(np.float32)).to(device)
                   for _ in range(4))
    lengths = rng.integers(1, t + 1, size=b)
    pad = np.arange(t)[None, :] >= lengths[:, None]
    if b > 1:
        pad[b - 1] = True
    bias = fd.padding_bias(torch.from_numpy(pad), b, t, "cpu").to(device)
    return q, k, v, do, bias


@pytest.mark.parametrize("t", [1, 31, 32, 33, 65, 203])
def test_pack_keep_bits_is_the_mask_bit_by_bit(t):
    """Bit j % 32 of word j // 32 of row (bh, i) is mask element (bh, i, j);
    bits past T are 0."""
    mask = fd.keep_mask_reference(2, 2, t, 40 + t, 0.3)
    bits = fd.pack_keep_bits(mask)
    assert bits.dtype == torch.int32 and bits.shape == (4, t, -(-t // 32))
    words = bits.to(torch.int64) & 0xFFFFFFFF
    j = torch.arange(32 * bits.shape[-1])
    got = (words[..., j // 32] >> (j % 32)) & 1
    assert torch.equal(got[..., :t], mask.reshape(4, t, t).to(torch.int64))
    assert not got[..., t:].any()


def test_cpu_backward_takes_the_plain_versions_without_bits():
    """On the CPU dQ returns no bits and dK/dV draws the mask from the seed,
    reading neither bits nor the bf16 operands."""
    q, k, v, do, bias = _inputs(3, 2, 2, 40, 64)
    o, lse = fd.flash_attention_dropout_reference(q, k, v, bias, 9, P, 0.125)
    ops = fd.to_bf16(q, k, v, do)
    dq, delta, bits = fd.flash_dropout_dq(q, k, v, bias, 9, o, lse, do, P,
                                          0.125, operands=ops)
    assert bits is None
    dk, dv = fd.flash_dropout_dkv(q, k, v, bias, 9, delta, lse, do, P, 0.125,
                                  bits=None, operands=None)
    want = fd.flash_dropout_dkv_reference(q, k, v, bias, 9, delta, lse, do,
                                          P, 0.125)
    assert torch.equal(dk, want[0]) and torch.equal(dv, want[1])


@pytest.mark.parametrize("bad", ["missing", "dtype", "shape", "layout"])
def test_dkv_rejects_missing_or_wrong_bits(bad):
    """What the dK/dV kernel checks before it reads the dQ kernel's bits."""
    q = torch.zeros(2, 2, 40, 64)
    bits = fd.pack_keep_bits(fd.keep_mask_reference(2, 2, 40, 9, P))
    fd._check_bits(bits, q, P)
    fd._check_bits(None, q, 0.0)          # nothing dropped: no bits read
    if bad == "missing":
        bits = None
    elif bad == "dtype":
        bits = bits.to(torch.int64)
    elif bad == "shape":
        bits = bits[:, :, :1].contiguous()
    else:
        bits = bits.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="bits"):
        fd._check_bits(bits, q, P)


@pytest.mark.parametrize("bad", ["missing", "float32", "shape", "count",
                                 "layout", "aligned"])
def test_bf16_operands_are_checked(bad):
    q, k, v, do, _ = _inputs(5, 2, 2, 40, 64)
    ops = list(fd.to_bf16(q, k, v, do))
    if bad == "missing":
        ops = None
    elif bad == "float32":
        ops[1] = k
    elif bad == "shape":
        ops[2] = ops[2][:, :, :8].contiguous()
    elif bad == "count":
        ops = ops[:3]
    elif bad == "layout":
        ops[0] = ops[0].transpose(2, 3).contiguous().transpose(2, 3)
    else:
        buf = torch.empty(ops[3].numel() + 1, dtype=torch.bfloat16)
        ops[3] = buf[1:].view(ops[3].shape)
        assert ops[3].is_contiguous() and ops[3].data_ptr() % 16
    with pytest.raises(ValueError):
        fd._check_operands(ops, q)
    fd._check_operands(fd.to_bf16(q, k, v, do), q)


def test_to_bf16_rounds_to_nearest_even():
    """The kernels' operands: ties go to the even bf16 neighbour, as the
    kernels' own rounding (pack_bf16) and the plain versions' do."""
    one = 1.0
    tie_up = np.float32(one + 3 * 2.0**-8)      # halfway, odd below: up
    tie_down = np.float32(one + 2.0**-8)        # halfway, even below: down
    x = torch.tensor([tie_up, tie_down])
    got = fd.to_bf16(x)[0].float()
    assert got.tolist() == [one + 2 * 2.0**-7, one]
    assert torch.equal(got, fd._bf16(x))


@pytest.mark.cuda
@pytest.mark.parametrize("t,d", [(777, 128), (300, 64)])
def test_bwd_kernels_are_deterministic_on_card(cuda_device, t, d):
    """Two launches on the same inputs give the same bits: no atomics."""
    q, k, v, do, bias = _inputs(t + d, 3, 2, t, d, cuda_device)
    seed, scale = 555 + t, d ** -0.5
    o, lse = fd.flash_dropout_fwd(q, k, v, bias, seed, P, scale)
    ops = fd.to_bf16(q, k, v, do)
    runs = []
    for _ in range(2):
        dq, delta, bits = fd.flash_dropout_dq(q, k, v, bias, seed, o, lse,
                                              do, P, scale, operands=ops)
        dk, dv = fd.flash_dropout_dkv(q, k, v, bias, seed, delta, lse, do, P,
                                      scale, bits=bits, operands=ops)
        runs.append((dq, delta, bits, dk, dv))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))
