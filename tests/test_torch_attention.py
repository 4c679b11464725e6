"""Port attention (parrot_tts_tpu_torch.ops) against the JAX package.

On the CPU the port's attention runs the plain version of the flash kernel;
the JAX side runs its XLA path (ops/attention.py routes there off the TPU).
The kernel itself is held against the plain version on the card by
test_torch_kernels.py.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from parrot_tts_tpu.ops import attention as jax_attention
from parrot_tts_tpu_torch.core.device import exact_numerics
from parrot_tts_tpu_torch.ops import attention, flash_attention as fa

D_MODEL, N_HEAD = 32, 2


def _padding_mask(rng, b, t, all_masked_row=None):
    lengths = rng.integers(1, t + 1, size=b)
    lengths[0] = t
    mask = np.arange(t)[None, :] >= lengths[:, None]      # True = ignore
    if all_masked_row is not None:
        mask[all_masked_row] = True
    return mask


@pytest.mark.parametrize("t", [40, 130, 512])
def test_multi_head_attention_matches_jax(t):
    rng = np.random.default_rng(t)
    b = 3
    x = rng.standard_normal((3, b, t, D_MODEL)).astype(np.float32)
    in_proj = (rng.standard_normal((3 * D_MODEL, D_MODEL)) * 0.2).astype(np.float32)
    out_proj = (rng.standard_normal((D_MODEL, D_MODEL)) * 0.2).astype(np.float32)
    mask = _padding_mask(rng, b, t)

    want = np.asarray(jax_attention.multi_head_attention(
        jnp.asarray(x[0]), jnp.asarray(x[1]), jnp.asarray(x[2]),
        jnp.asarray(in_proj.T), jnp.asarray(out_proj.T), N_HEAD,
        key_padding_mask=jnp.asarray(mask)))
    got = attention.multi_head_attention(
        *(torch.from_numpy(a) for a in x), torch.from_numpy(in_proj),
        torch.from_numpy(out_proj), N_HEAD,
        key_padding_mask=torch.from_numpy(mask)).numpy()

    valid = ~mask                       # compare the valid query rows
    np.testing.assert_allclose(got[valid], want[valid], atol=1e-5, rtol=1e-5)


def test_all_masked_row_is_zero_not_nan():
    rng = np.random.default_rng(0)
    b, h, t, d = 3, 2, 20, 16
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, t, d)).astype(np.float32))
               for _ in range(3))
    mask = torch.from_numpy(_padding_mask(rng, b, t, all_masked_row=1))
    out = fa.flash_attention(q, k, v, mask, 1.0 / math.sqrt(d))
    assert torch.isfinite(out).all()
    assert torch.equal(out[1], torch.zeros_like(out[1]))

    # rows with valid keys: softmax over the valid keys only
    s = (q[0] @ k[0].transpose(-1, -2)) / math.sqrt(d)
    s = s.masked_fill(mask[0][None, None, :], float("-inf"))
    torch.testing.assert_close(out[0], torch.softmax(s, -1) @ v[0],
                               atol=1e-6, rtol=1e-5)


@pytest.mark.cuda
def test_multi_head_attention_kernel_matches_plain_on_card():
    """The same MHA on the card (the kernel, d_head 64) and on the CPU (the
    plain version). More kernel cases: test_torch_kernels.py."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    rng = np.random.default_rng(7)
    b, t, d_model, n_head = 3, 300, 128, 2
    x = torch.from_numpy(rng.standard_normal((b, t, d_model)).astype(np.float32))
    in_proj = torch.from_numpy((rng.standard_normal((3 * d_model, d_model))
                                * 0.1).astype(np.float32))
    out_proj = torch.from_numpy((rng.standard_normal((d_model, d_model))
                                 * 0.1).astype(np.float32))
    mask = torch.from_numpy(_padding_mask(rng, b, t, all_masked_row=2))

    def run(device):
        with exact_numerics(True):
            return attention.multi_head_attention(
                *(a.to(device) for a in (x, x, x, in_proj, out_proj)), n_head,
                key_padding_mask=mask.to(device)).cpu()

    before = fa.FLASH_FWD.launches
    got = run("cuda")
    assert fa.FLASH_FWD.launches == before + 1
    torch.testing.assert_close(got, run("cpu"), atol=1e-5, rtol=1e-5)


def test_kernel_rejects_what_it_does_not_take():
    x = torch.zeros(1, 1, 8, 128, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention(x, x, x, None, 1.0)
