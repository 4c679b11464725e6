"""The serving attention's 3xTF32 split (csrc/flash_attn_fwd.cu), emulated in
plain torch on the CPU.

The kernel multiplies float32 operands on the TF32 tensor cores: each x is
split as hi + lo with hi rounded to nearest at TF32's 11 significant bits,
the tensor cores read lo's top 11 bits, and each product is taken as
lo_a hi_b + hi_a lo_b + hi_a hi_b, summed in short partials (32 of d for
Q K^T, one 32-key tile for P V) that float32 adds up, with the softmax
online, tile by tile, against the running row max. `attention_3xtf32`
does the same with bit operations on the float32 view; it is a model of
the kernel's arithmetic, not a kernel's plain version. The card itself is
held to the plain version by tests/test_torch_kernels.py and chip_smoke.py
phases 3 and 4.

Checked here: the emulation stays within the 1e-5 the card's kernel is held
to against the IEEE float32 plain version (one TF32 product does not), and
with the emulation as the decoder's attention the tiny TTE's exact decode
gives the JAX package's durations and units.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from parrot_tts_tpu.models.tte import parrot as jax_parrot
from parrot_tts_tpu.ops import length_regulator as jax_lr
from parrot_tts_tpu_torch.models.tte import parrot
from parrot_tts_tpu_torch.ops import attention
from parrot_tts_tpu_torch.ops import flash_attention as fa
from parrot_tts_tpu_torch.ops import length_regulator as lr
from tests.test_torch_tte import (CFG, N_LAYER, configs, jax_params,
                                  make_batch, port_model)

ATOL = 1e-5                  # chip_smoke.py phase 3, the kernel against plain
LOW_BITS = 0x1FFF            # float32 mantissa bits below TF32's 10


def tf32_nearest(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (11 significant bits), to nearest, ties to even,
    on the float32 bit pattern (sign and magnitude: adding to the pattern
    rounds the magnitude)."""
    u = x.contiguous().view(torch.int32)
    u = (u + 0x0FFF + ((u >> 13) & 1)) & ~LOW_BITS
    return u.view(torch.float32)


def tf32_truncated(x: torch.Tensor) -> torch.Tensor:
    """What the tensor cores read of a float32 operand: its top 19 bits."""
    return (x.contiguous().view(torch.int32) & ~LOW_BITS).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32_nearest(x)
    return hi, tf32_truncated(x - hi)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel takes it: the two small products first."""
    (ah, al), (bh, bl) = split(a), split(b)
    return (torch.matmul(al, bh) + torch.matmul(ah, bl)) + torch.matmul(ah, bh)


def mm_1xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(tf32_nearest(a), tf32_nearest(b))


def partial_sums(mm, a, b, chunk):
    """sum over chunks c of mm(a[..., c], b[..., c, :]) in float32."""
    out = None
    for c0 in range(0, a.shape[-1], chunk):
        part = mm(a[..., c0:c0 + chunk], b[..., c0:c0 + chunk, :])
        out = part if out is None else out + part
    return out


def attention_3xtf32(q, k, v, key_padding_mask, scale, mm=mm_3xtf32):
    """`flash_attention` with the kernel's split products and order of
    sums: scores in partials of 32 of d, added in float32; then, 32-key
    tile by tile, the online softmax in float32 (P = exp(s - m) against
    the running row max m, the running sum and O rescaled by exp(m_old -
    m)) and the tile's P V as one partial added to the rescaled O; rows
    with no valid key give 0."""
    s = partial_sums(mm, q, k.transpose(-1, -2), 32) * scale
    if key_padding_mask is not None:
        s = s.masked_fill(key_padding_mask[:, None, None, :], float("-inf"))
    m = torch.full(s.shape[:-1] + (1,), float("-inf"))
    l = torch.zeros_like(m)
    o = torch.zeros(s.shape[:-1] + (v.shape[-1],))
    for j0 in range(0, s.shape[-1], 32):
        tile = s[..., j0:j0 + 32]
        m_new = torch.maximum(m, tile.amax(dim=-1, keepdim=True))
        m_use = torch.where(m_new == float("-inf"), 0.0, m_new)
        alpha = torch.exp(m - m_use)
        p = torch.exp(tile - m_use)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        o = o * alpha + mm(p, v[..., j0:j0 + 32, :])
        m = m_new
    return torch.where(l > 0, o / torch.where(l > 0, l, 1.0), 0.0)


def _inputs(seed, b, h, t, d):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, t, d))
                                .astype(np.float32)) for _ in range(3))
    lengths = rng.integers(1, t + 1, size=b)
    lengths[0] = t
    mask = np.arange(t)[None, :] >= lengths[:, None]
    mask[-1] = True                       # a row with no valid key
    return q, k, v, torch.from_numpy(mask)


def test_tf32_rounding_by_bits():
    """Ties go to the even TF32 neighbour; truncation drops the low bits;
    hi + lo is x up to lo's dropped bits."""
    one, ulp = 1.0, 2.0**-10                  # TF32 spacing at 1
    x = torch.tensor([one + ulp / 2, one + 3 * ulp / 2, -(one + 3 * ulp / 2),
                      one + ulp * 0.75], dtype=torch.float32)
    assert tf32_nearest(x).tolist() == [one, one + 2 * ulp, -(one + 2 * ulp),
                                        one + ulp]
    assert tf32_truncated(x).tolist() == [one, one + ulp, -(one + ulp), one]
    y = torch.from_numpy(np.random.default_rng(3).standard_normal(1000)
                         .astype(np.float32))
    hi, lo = split(y)
    assert torch.equal(tf32_truncated(hi), hi)
    assert float(((hi + lo - y) / y).abs().max()) <= 2.0**-20


@pytest.mark.parametrize("b,h,t,d", [(2, 2, 37, 64), (3, 2, 130, 128),
                                     (2, 1, 300, 128), (4, 2, 65, 64)])
def test_3xtf32_attention_within_the_kernel_gate(b, h, t, d):
    """The split's products keep the attention within the 1e-5 that the
    card's kernel is held to against IEEE float32; a single TF32 product
    does not (which is why the decoder needs the split)."""
    q, k, v, mask = _inputs(t + d, b, h, t, d)
    scale = 1.0 / math.sqrt(d)
    want = fa.flash_attention_reference(q, k, v, mask, scale)
    got = attention_3xtf32(q, k, v, mask, scale)
    assert torch.equal(got[-1], torch.zeros_like(got[-1]))
    err = float((got - want).abs().max())
    assert err <= ATOL, err
    err_1x = float((attention_3xtf32(q, k, v, mask, scale, mm_1xtf32)
                    - want).abs().max())
    assert err_1x > 10 * max(err, 1e-7), (err_1x, err)


@pytest.mark.parametrize("out_len", [128, 512])
def test_exact_decode_with_the_split_matches_jax(rng, out_len):
    """The tiny TTE's exact decode with the emulated 3xTF32 attention gives
    the JAX package's exact durations, frames and units (codes where the
    JAX logits' top-2 margin exceeds 1e-3)."""
    jcfg, tcfg = configs()
    params = jax_params(jcfg)
    model = port_model(params, tcfg)
    batch = make_batch(rng, [14, 9, 3], 16, CFG["vocab_size"],
                       CFG["n_speaker"])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    j_codes, j_mask, j_total = jax_parrot.infer_codes(
        params, jbatch, jcfg, out_len=out_len, exact=True)
    with jax.default_matmul_precision("highest"):
        j_logits, _, j_logdur = jax_parrot.apply_parrot(
            params, jbatch, jcfg, out_len=out_len, inference=True)
    j_mask, j_logits = np.asarray(j_mask), np.asarray(j_logits)
    j_dur = np.where(batch["src_mask"], np.asarray(
        jax_lr.durations_from_log_pred(j_logdur)), 0)

    calls = []

    def split_attention(*args):
        calls.append(args[0].shape)
        return attention_3xtf32(*args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(attention, "flash_attention", split_attention)
        codes, mask, total = parrot.infer_codes(model, batch,
                                                out_len=out_len, device="cpu")
        tb = parrot.to_batch(batch, torch.device("cpu"))
        with torch.no_grad():
            _, _, logdur = parrot.apply_parrot(model, tb, out_len=out_len)
    assert len(calls) == 2 * (N_LAYER + N_LAYER)  # every block, both runs
    dur = torch.where(tb["src_mask"], lr.durations_from_log_pred(logdur), 0)
    np.testing.assert_array_equal(dur.numpy(), j_dur)
    np.testing.assert_array_equal(mask.numpy(), j_mask)
    np.testing.assert_array_equal(total.numpy(), np.asarray(j_total))
    assert j_mask.sum() > 20                     # the decode is not empty
    top2 = np.sort(j_logits, axis=-1)[..., -2:]
    clear = j_mask & (top2[..., 1] - top2[..., 0] > 1e-3)
    np.testing.assert_array_equal(codes.numpy()[clear],
                                  np.asarray(j_codes)[clear])
