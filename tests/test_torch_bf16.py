"""The port's bfloat16 compute modes against the JAX package's on the CPU.

bf16 rounds at the places the JAX package rounds (`ops/activation.py`,
`ops/conv.py`, `models/vocoder/generator.py`, `generator_staticq.py`,
`ops/fused_mrf.py`, `ops/quant.py`); what may still differ is the order of
float32 sums, which bf16 rounding turns into one-ulp differences now and
then. The tolerances, each stated where it is used:

- the leaky ReLU and the int8 conv with a bf16 output: bit-equal;
- row 6's bf16 plain version against JAX's `mrf_fused` (interpret mode,
  folded), compiled with XLA's `xla_allow_excess_precision` off: with it
  on (XLA's default) the CPU backend keeps the bf16 `y + t` of a branch's
  last pair in float32 before the float32 branch sum, which the jaxpr
  rounds to bf16 and the TPU kernel stores as bf16, and many outputs
  then move by an ulp. With it off the sums still differ in order
  (block-Toeplitz against plain taps), so an element now and then moves
  by an ulp: max |diff| <= 2^-6 max |JAX| (4 ulps at the top binade, the
  card's gate of the kernel against its plain version) and at most 0.5%
  of elements differing;
- the generator in bf16 against JAX's bf16 generator, each mode on the
  JAX layout that defines it (fold_tail=False, but the fused MRF and
  "int8-tail", which JAX runs only on its folded tail): max |diff| <=
  2e-3 and SNR >= 45 dB (JAX's own folded-against-unfolded bf16 waveforms
  differ by ~59 dB at the fused test's config, and its bf16 by ~50 dB
  from its float32); the port's bf16 against its own float32 within
  tests/test_fullscale_parity.py's 2e-3 / 40 dB / log-mel L1 0.3;

The GAN step with a bf16 generator, and with bf16 discriminators, is held
to the JAX package's in tests/test_torch_gan.py, beside the float32 step
whose JAX run it shares.
"""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from parrot_tts_tpu.core import config as jax_config
from parrot_tts_tpu.models.hubert import model as jax_hub
from parrot_tts_tpu.models.vocoder import generator as jax_gen
from parrot_tts_tpu.models.vocoder import generator_staticq as jax_sq
from parrot_tts_tpu.ops import fused_mrf as jax_fused
from parrot_tts_tpu.ops import quant as jax_quant
from parrot_tts_tpu.ops.stft import mel_spectrogram as jax_mel
from parrot_tts_tpu_torch.core.config import (HubertConfig, TTEModelConfig,
                                              VocoderModelConfig, to_json,
                                              vocoder_config_from_json)
from parrot_tts_tpu_torch.infer.synthesize import VocoderSynthesizer
from parrot_tts_tpu_torch.models.hubert import model as hub
from parrot_tts_tpu_torch.models.tte import parrot
from parrot_tts_tpu_torch.models.vocoder import generator as gen
from parrot_tts_tpu_torch.models.vocoder import generator_staticq as sq
from parrot_tts_tpu_torch.ops import activation, fused_mrf, quant
from tests.test_torch_fused_mrf import DS, KS, _jax_resblocks, _port_pack
from tests.test_torch_quant_dynamic import TINY, _build

BF16 = torch.bfloat16
MRF_ULP_RTOL = 2.0 ** -6     # max |diff| / max |want| of row 6 in bf16
MRF_DIFF_SHARE = 0.005       # elements of row 6 that may differ at all
WAVE_ATOL, WAVE_SNR_DB = 2e-3, 45.0      # port bf16 against JAX bf16
BUDGET_ATOL, BUDGET_SNR_DB, BUDGET_MEL_L1 = 2e-3, 40.0, 0.3  # bf16 vs f32


def to16(a: np.ndarray) -> tuple[torch.Tensor, jnp.ndarray]:
    """The same bf16 values in both packages."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(BF16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def jax_rounded(fn, *args):
    """fn(*args) jitted with XLA's excess precision off, so every bf16
    value of the jaxpr is rounded where the jaxpr rounds it."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def snr_db(got: np.ndarray, want: np.ndarray) -> float:
    err = float(((got.astype(np.float64) - want) ** 2).sum())
    return 10 * math.log10(float((want.astype(np.float64) ** 2).sum())
                           / max(err, 1e-30))


@pytest.mark.parametrize("slope", [0.1, 0.01])
def test_leaky_relu_bf16_is_jax_bit_for_bit(rng, slope):
    """`activation.leaky_relu` on bf16 equals jax.nn.leaky_relu on bf16
    (zeros of both signs included); F.leaky_relu, which multiplies by the
    float32 slope, differs in over 5% of elements."""
    v = rng.standard_normal(100_000).astype(np.float32) * 3
    v[:4] = (0.0, -0.0, 1e-30, -1e-30)
    t, j = to16(v)
    want = f32(jax.nn.leaky_relu(j, slope))
    got = activation.leaky_relu(t, slope)
    assert got.dtype == BF16
    np.testing.assert_array_equal(f32(got), want)
    assert (f32(F.leaky_relu(t, slope)) != want).mean() > 0.05


def test_packed_leaky_relu_is_the_ports_on_every_finite_bf16():
    """Row 6's bf16 mode takes the leaky ReLU on packed pairs
    (csrc/fused_mrf.cu::leaky2: mul.bf16x2 by bf16(0.1), one rounding to
    nearest even, then max.bf16x2). Modelled here in integers on every
    finite bf16 value: the float32 product of two bf16 is exact, its bits
    rounded to bf16 (ties to even), then the larger of v and it; equal to
    `activation.leaky_relu` bit for bit, signed zeros and subnormals
    included."""
    bits = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32)
    v = bits.to(torch.int16).view(BF16)
    v = v[torch.isfinite(v.float())]
    prod = v.float() * activation.bf16_slope(0.1)
    assert torch.equal(prod.double(),
                       v.double() * activation.bf16_slope(0.1))
    u = prod.view(torch.int32)
    rne = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).to(torch.int16).view(BF16)
    packed = torch.where(v.float() >= rne.float(), v, rne)
    want = activation.leaky_relu(v, 0.1)
    assert v.numel() == 2 ** 16 - 2 ** 8      # all but infs and NaNs
    assert torch.equal(packed.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("k,d,pads,ci,co,leaky", [
    (3, 1, (1, 1), 32, 32, 0.1), (7, 3, (9, 9), 32, 32, None),
    (11, 5, (25, 25), 16, 16, 0.1), (2, 1, (1, 0), 64, 128, None)])
def test_int8_conv_bf16_output_is_jax_bit_for_bit(rng, k, d, pads, ci, co,
                                                  leaky):
    """The dynamic int8 conv on bf16 x (quantizer + row 7's plain version,
    float32 epilogue, rounded to bf16, then the bf16 leaky ReLU) equals
    JAX's `int8_conv_nwc` on bf16 x followed by its bf16 leaky ReLU."""
    x, xj = to16(rng.standard_normal((2, 50, ci)) * [[[1.0]], [[0.01]]])
    w, wj = to16(rng.standard_normal((k, ci, co)) * (ci * k) ** -0.5)
    b, bj = to16(rng.standard_normal(co) * 0.1)
    got = quant.int8_conv_nwc(x, w, b, pads=pads, rhs_dilation=d,
                              leaky=leaky)
    want = jax_quant.int8_conv_nwc(xj, wj, bj, pads=pads, rhs_dilation=d)
    if leaky is not None:
        want = jax.nn.leaky_relu(want, leaky)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(f32(got), f32(want))


@pytest.mark.parametrize("g,channels,t", [(2, 16, 192), (4, 16, 96)])
def test_mrf_reference_bf16_matches_jax_fused_kernel(rng, g, channels, t):
    """Row 6's bf16 plain version on the unfolded layout against JAX's
    fused kernel in interpret mode on the bf16 folded layout, rounded as
    its jaxpr rounds (module docstring: 4 ulps at the top binade, at most
    0.5% of elements differing)."""
    rbs = _jax_resblocks(channels)
    xf = rng.standard_normal((2, t, g * channels)).astype(np.float32)
    x, xj = to16(xf)
    flat, plan = jax_fused.pack_mrf(rbs, g, KS, DS, jnp.bfloat16)
    want = f32(jax_rounded(lambda v, f: jax_fused.mrf_fused(v, f, plan),
                           xj, flat))
    w, b, port_plan = _port_pack(rbs)
    got = fused_mrf.mrf_fused_reference(
        x.reshape(2, t * g, channels), w.to(BF16), b.to(BF16), port_plan)
    assert got.dtype == BF16
    got = f32(got).reshape(2, t, g * channels)
    err = float(np.abs(got - want).max())
    assert err <= MRF_ULP_RTOL * float(np.abs(want).max()), err
    assert (got != want).mean() <= MRF_DIFF_SHARE


def test_bf16_fragment_order_is_the_kernels():
    """csrc/fused_mrf.cu's bf16 products read A from the strips' [C / 8]
    [rows][8] planes, so logical k of a 16-channel k-step is channel 16 ks
    + k; `kernel_weights` puts the weight of input channel 8q + j and
    output channel co at [tap][q][co][j], the K-major slab of the B
    descriptor, in that same k order."""
    c = 32
    x, w, b, plan = _mrf_inputs(0, 1, 20, c)
    wk = fused_mrf.kernel_weights(w, plan).reshape(-1, c // 8, c, 8)
    taps = w.reshape(-1, c, c)                        # [tap][ci][co]
    assert wk.shape[0] == taps.shape[0] == sum(2 * k * len(d)
                                               for k, d in zip(KS, DS))
    ci = torch.arange(c)
    assert torch.equal(wk[:, ci // 8, :, ci % 8].permute(1, 0, 2), taps)


def _mrf_inputs(seed, b, t, c):
    rng = np.random.default_rng(seed)

    def tens(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32))
    convs = [[(tens(k, c, c, scale=(c * k) ** -0.5), tens(c, scale=0.1),
               tens(k, c, c, scale=(c * k) ** -0.5), tens(c, scale=0.1))
              for _ in ds] for k, ds in zip(KS, DS)]
    w, bias, plan = fused_mrf.pack_mrf(convs, KS, DS)
    x = tens(b, t, c)
    if b > 1:
        x[1, 2 * t // 3:] = 0.0           # a row that ends early
    return x.to(BF16), w.to(BF16), bias.to(BF16), plan


def emulate_bf16(x, wk, b, plan, tb):
    """csrc/fused_mrf.cu's bf16 mode on x (B, T, C), in torch: the strip
    walk of `conv_walk`, each conv's products from the bf16 weight slabs
    `kernel_weights` lays out (one tap, [k16(C) / 8][C][8]), in the order
    the kernel's wgmmas carry them: one float32 sum per conv that starts
    at the bias and takes each tap's 16-input k-steps in turn (at an odd
    C / 8 the last over C - 8..C and a zero plane, against the slab's zero
    rows), rounded to bf16 once at the conv's end; leaky and y + t in
    bf16; the branch sum in float32."""
    bsz, t, c = x.shape
    kc = fused_mrf._k16(c)
    h, length = plan.halo, tb + 2 * plan.halo
    slabs = wk.reshape(-1, kc // 8, c, 8).permute(0, 1, 3, 2).reshape(
        -1, kc, c)
    nb = len(plan.kernel_sizes)
    out = torch.full((bsz, t, c), math.nan)
    for blk in range(-(-t // tb)):
        rows = torch.arange(length) + blk * tb - h
        valid = (rows >= 0) & (rows < t)
        strip = torch.zeros((bsz, length, c), dtype=BF16)
        strip[:, valid] = x[:, rows[valid]]
        total, s = None, 0
        for i, k in enumerate(plan.kernel_sizes):
            y = strip.clone()
            lt = torch.zeros_like(strip)
            for br, j, cv, d, pad, lo, hi in fused_mrf.conv_walk(plan, tb):
                if br != i:
                    continue
                off = 2 * sum(len(dd) for dd in plan.dilations[:i]) + 2 * j + cv
                src = activation.leaky_relu(y, 0.1) if cv == 0 else lt
                acc = b[off * c:(off + 1) * c].float().expand(bsz, hi - lo, c)
                for tap in range(k):
                    a = F.pad(src[:, lo + tap * d - pad:hi + tap * d - pad]
                              .float(), (0, kc - c))     # the zero plane
                    for k0 in range(0, kc, 16):
                        acc = acc + (a[..., k0:k0 + 16]
                                     @ slabs[s, k0:k0 + 16].float())
                    s += 1
                tv = torch.where(valid[lo:hi, None], acc, 0.0).to(BF16)
                if cv == 0:
                    lt[:, lo:hi] = activation.leaky_relu(tv, 0.1)
                else:
                    y[:, lo:hi] = y[:, lo:hi] + tv
            part = y[:, h:h + tb].float()
            total = part if total is None else total + part
        n = min(tb, t - blk * tb)
        out[:, blk * tb:blk * tb + n] = (total * (1.0 / nb)).to(BF16)[:, :n]
    return out.to(BF16)


@pytest.mark.parametrize("b,t,c,tb", [(2, 300, 16, None), (1, 257, 32, 16),
                                      (1, 90, 64, None), (2, 150, 8, None),
                                      (1, 130, 24, 32), (1, 100, 48, None),
                                      (1, 70, 120, None)])
def test_emulated_bf16_kernel_within_the_card_gate(b, t, c, tb):
    """The bf16 mode's walk, slabs and rounding points, emulated, stay
    within the card's gate of the kernel against its plain version
    (2^-6 max |plain|); its tile fits the card."""
    x, w, bias, plan = _mrf_inputs(t + c, b, t, c)
    tile = fused_mrf.tile_plan(plan, (b, t), dtype=BF16)
    assert tile.smem_bytes <= fused_mrf.SMEM_BYTES and tile.k_chunk == c
    assert -(-(tile.tb + 2 * plan.halo) // fused_mrf.UNIT_ROWS) <= (
        tile.warpgroups * tile.rounds)
    wk = fused_mrf.kernel_weights(w, plan)
    assert wk.dtype == BF16
    assert wk.numel() == w.numel() // c * fused_mrf._k16(c)
    want = fused_mrf.mrf_fused_reference(x, w, bias, plan)
    got = emulate_bf16(x, wk, bias, plan, tb or tile.tb)
    assert torch.isfinite(got.float()).all()
    err = float((got.float() - want.float()).abs().max())
    assert err <= MRF_ULP_RTOL * float(want.float().abs().max()), err


# (tb, warpgroups, units per warpgroup, weight slots, resident,
# shared-memory bytes) of the bf16 tile at each width, halo 60 (V1's
# resblocks): csrc/fused_mrf.cu's header
BF16_TILES = {
    8: (1152, 4, 5, 126, True, 210240), 16: (944, 4, 5, 126, True, 229632),
    24: (688, 4, 5, 12, False, 223808), 32: (640, 3, 4, 12, False, 228096),
    40: (368, 3, 4, 12, False, 218432), 48: (352, 3, 4, 12, False, 228864),
    56: (240, 3, 4, 9, False, 224320), 64: (240, 2, 3, 8, False, 230016),
    72: (192, 2, 3, 5, False, 223424), 80: (176, 2, 3, 5, False, 224128),
    88: (160, 2, 3, 3, False, 223936), 96: (144, 2, 3, 3, False, 220288),
    104: (112, 2, 2, 3, False, 227776), 112: (96, 2, 2, 3, False, 222080),
    120: (64, 3, 1, 3, False, 223424)}


@pytest.mark.parametrize("c", sorted(BF16_TILES))
def test_every_bf16_width_tiles(c):
    """At every width the bf16 tile fits the SM's shared memory, its strip
    fits the warpgroups' rounds of 64-row units (each unit's C / 2 sums a
    thread within the registers of its warpgroup count), and the tile is
    the one csrc/fused_mrf.cu states."""
    t = fused_mrf.tile_plan(fused_mrf.MRFPlan(c, KS, DS, 60), dtype=BF16)
    assert (t.tb, t.warpgroups, t.rounds, t.ring_slots, t.resident,
            t.smem_bytes) == BF16_TILES[c]
    assert t.smem_bytes <= fused_mrf.SMEM_BYTES and t.tb >= 16
    assert -(-(t.tb + 120) // fused_mrf.UNIT_ROWS) <= t.warpgroups * t.rounds
    # a unit's sums, c / 2 floats a thread, within 65536 / threads registers
    assert t.rounds * c // 2 <= min(255, 65536 // (128 * t.warpgroups)) - 40
    assert t.resident or 3 <= t.ring_slots <= 12


def test_v1_bf16_tiles():
    """The bf16 tiles csrc/fused_mrf.cu's header states for V1's three
    fused stages (halo 60): (tb, warpgroups, units per warpgroup, weight
    slots, whole stage resident, shared-memory bytes)."""
    got = {c: fused_mrf.tile_plan(fused_mrf.MRFPlan(c, KS, DS, 60),
                                  dtype=BF16) for c in (64, 32, 16)}
    assert {c: (t.tb, t.warpgroups, t.rounds, t.ring_slots, t.resident,
                t.smem_bytes) for c, t in got.items()} == {
        64: (240, 2, 3, 8, False, 230016),
        32: (640, 3, 4, 12, False, 228096),
        16: (944, 4, 5, 126, True, 229632)}
    assert all(t.smem_bytes <= fused_mrf.SMEM_BYTES for t in got.values())


def test_mrf_fused_bf16_takes_only_the_kernels_widths():
    """The bf16 mode takes the float32 mode's widths, every multiple of 8
    up to 120 (its zero plane pads an odd C / 8 to the 16-deep k-step),
    and no other."""
    x, w, b, plan = _mrf_inputs(0, 1, 20, 16)
    with pytest.raises(TypeError, match="bfloat16"):
        fused_mrf._check(x, w.float(), b, plan)
    for c in range(8, 121, 8):
        x, w, b, plan = _mrf_inputs(c, 1, 20, c)
        fused_mrf._check(x, w, b, plan)
        wk = fused_mrf.kernel_weights(w, plan)
        taps = wk.reshape(-1, fused_mrf._k16(c) // 8, c, 8)
        assert taps.shape[0] == w.numel() // (c * c)
        assert not taps[:, c // 8:].any()       # the zero rows, if any
    for c in (12, 128):
        x, w, b, plan = _mrf_inputs(c, 1, 20, c)
        with pytest.raises(ValueError, match="channels"):
            fused_mrf._check(x, w, b, plan)


# (mode, fold_tail of the JAX side, fused_mrf); "fused-c64" is the fused
# route at upsample_initial_channel 64, whose stages (32, 16 and 8
# channels) JAX folds and fuses too
MODES = [("none", False, False), ("fused", True, True), ("int8", False, False),
         ("int8-tail", True, False), ("int8-static", False, False),
         ("fused-c64", True, True)]


def _serve(model, code, spkr, qscales=None):
    if model.cfg.quant == "int8-static":
        q = sq.quantize_generator(model, qscales, device="cpu")
        return sq.apply_code_generator_staticq(model, code, spkr, q,
                                               device="cpu").numpy()
    return gen.apply_code_generator(model, code, spkr, device="cpu").numpy()


def _port_model(model, **change):
    m = gen.CodeGenerator(dataclasses.replace(model.cfg, **change),
                          weight_norm=False)
    m.load_state_dict(model.state_dict(), strict=True)
    m.eval().pack_bf16()
    m.pack_fused_mrf()
    m.pack_int8()
    return m


@pytest.mark.parametrize("mode,fold_tail,fused", MODES,
                         ids=[m for m, _, _ in MODES])
def test_generator_bf16_matches_jax(rng, mode, fold_tail, fused):
    """Each serving mode in bf16 against the JAX package's bf16 generator
    on the same folded weights, and against the port's own float32 within
    the bf16 budgets (module docstring)."""
    static = mode == "int8-static"
    quant_mode = "none" if fused else mode
    cfg = dict(TINY, upsample_initial_channel=64) if mode == "fused-c64" \
        else TINY
    jcfg, folded, model = _build(cfg, "1", "none" if static else quant_mode,
                                 fold_tail, fused_mrf_=fused)
    jcfg16 = dataclasses.replace(jcfg, dtype="bfloat16", quant=quant_mode)
    code = rng.integers(0, 40, size=(2, 24)).astype(np.int32)
    spkr = np.array([0, 3], np.int32)
    args = (folded, jnp.asarray(code), jnp.asarray(spkr))
    if static:
        qs = jax_sq.calibrate_qscales(*args, jcfg16)
        want = np.asarray(jax.jit(
            jax_sq.apply_code_generator_staticq, static_argnums=4)(
                *args, qs, jcfg16))
        qs = [torch.from_numpy(np.array(s)) for s in qs]
    else:
        qs, want = None, np.asarray(jax.jit(
            jax_gen.apply_code_generator, static_argnums=3)(*args, jcfg16))
    m16 = _port_model(model, dtype="bfloat16", quant=quant_mode)
    if fused:
        assert sorted(m16.mrf_plans) == [0, 1, 2]
        assert m16.mrf_w0.dtype == BF16
    got = _serve(m16, code, spkr, qs)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= WAVE_ATOL
    assert snr_db(got, want) >= WAVE_SNR_DB, snr_db(got, want)

    m32 = _port_model(model, quant=quant_mode)
    q32 = (sq.calibrate_qscales(m32, code, spkr, device="cpu") if static
           else None)
    if static:
        qs = sq.calibrate_qscales(m16, code, spkr, device="cpu")
    w32, w16 = _serve(m32, code, spkr, q32), _serve(m16, code, spkr, qs)
    assert np.abs(w16 - w32).max() < BUDGET_ATOL
    assert snr_db(w16, w32) >= BUDGET_SNR_DB
    mel = [np.asarray(jax_mel(jnp.asarray(w[..., 0]))) for w in (w32, w16)]
    assert float(np.mean(np.abs(mel[0] - mel[1]))) < BUDGET_MEL_L1


def test_cli_width_bf16_is_the_jax_packages(rng):
    """At tests/test_torch_cli.py's 16-channel vocoder the bf16 waveform
    is more than 2e-3 from the float32 one in the JAX package too, and
    the port's bf16 equals the JAX package's (max |diff| <= 2e-3, SNR >=
    45 dB; bit-equal when measured): the CLI test's bf16 tolerance is
    the width's, not the port's."""
    from parrot_tts_tpu.models.vocoder import convert as jax_convert
    from tests.test_torch_cli import VOC

    sd = gen.init_code_generator(VOC, torch.Generator().manual_seed(0))
    jcfg = jax_config.VocoderModelConfig(**{
        f.name: getattr(VOC, f.name) for f in dataclasses.fields(VOC)},
        fold_tail=False)
    params = jax_gen.fold_params(jax_convert.generator_params_from_torch(
        sd, jcfg))
    code = rng.integers(0, VOC.num_embeddings, size=(3, 128))
    spkr = np.array([0, 1, 0])
    run = jax.jit(jax_gen.apply_code_generator, static_argnums=3)
    w32, w16 = (np.asarray(run(params, jnp.asarray(code), jnp.asarray(spkr),
                               c)) for c in (
                    jcfg, dataclasses.replace(jcfg, dtype="bfloat16")))
    assert np.abs(w16 - w32).max() > 2e-3
    model = gen.CodeGenerator(dataclasses.replace(VOC, dtype="bfloat16"),
                              weight_norm=False)
    model.load_state_dict(gen.fold_params(sd), strict=True)
    model.eval().pack_bf16()
    got = gen.apply_code_generator(model, code, spkr, device="cpu").numpy()
    assert np.abs(got - w16).max() <= WAVE_ATOL
    assert snr_db(got, w16) >= WAVE_SNR_DB


def test_bf16_serving_needs_its_packed_copies(rng):
    """A folded bf16 model serves from bf16 copies made once by
    pack_bf16 (left out of the state_dict); without them it raises. The
    synthesizer packs them, and returns float32 waveforms."""
    cfg = VocoderModelConfig(**TINY, dtype="bfloat16")
    state = gen.fold_params(gen.init_code_generator(
        cfg, torch.Generator().manual_seed(5)))
    model = gen.CodeGenerator(cfg, weight_norm=False)
    model.load_state_dict(state, strict=True)
    code = rng.integers(0, 40, size=(1, 12))
    with pytest.raises(RuntimeError, match="pack_bf16"):
        gen.apply_code_generator(model.eval(), code, [0], device="cpu")
    model.pack_bf16()
    assert set(model.state_dict()) == set(state)
    assert model.conv_pre.weight16.dtype == BF16
    assert torch.equal(model.conv_pre.weight16, state["conv_pre.weight"].to(BF16))
    # the synthesizer repeat-pads the 12 codes to its 128-code bucket
    padded = np.tile(code, 11)[:, :128]
    y = gen.apply_code_generator(model, padded, [0], device="cpu")
    assert y.dtype == torch.float32
    synth = VocoderSynthesizer(state, cfg, device="cpu")
    wav = synth.synthesize([code[0]], [0])[0]
    assert wav.dtype == np.float32 and wav.shape == (12 * 32,)
    np.testing.assert_array_equal(wav, y[0, :12 * 32, 0].numpy())


def test_vocoder_dtype_round_trips_through_config_json():
    """to_json / vocoder_config_from_json carry dtype, and a config.json
    the JAX package writes with "dtype" loads."""
    cfg = VocoderModelConfig(dtype="bfloat16", quant="int8")
    assert vocoder_config_from_json(to_json(cfg)) == cfg
    jcfg = jax_config.VocoderModelConfig(dtype="bfloat16")
    got = vocoder_config_from_json(jax_config.to_json(jcfg))
    assert got.dtype == "bfloat16" and got == VocoderModelConfig(
        dtype="bfloat16")
    assert json.loads(to_json(TTEModelConfig()))["dtype"] == "float32"
    with pytest.raises(ValueError, match="dtype"):
        gen.CodeGenerator(VocoderModelConfig(dtype="float16"))


def test_parrot_refuses_a_bf16_tte_config():
    """TTEModelConfig.dtype is read by no module of the JAX package; the
    port refuses "bfloat16" rather than run float32 silently."""
    with pytest.raises(ValueError, match="ignores this field"):
        parrot.Parrot(TTEModelConfig(dtype="bfloat16"))


def test_hubert_bf16_refused_in_the_port_and_raises_in_jax(rng):
    """The JAX package's bf16 extraction raises a TypeError at the second
    conv (its masked GroupNorm promotes x to float32); the port refuses
    the config up front."""
    kw = dict(conv_dim=(16, 16, 16), conv_kernel=(10, 3, 3),
              conv_stride=(5, 2, 2), d_model=32, n_layer=2, n_head=4,
              ffn_dim=64, pos_conv_kernel=8, pos_conv_groups=2,
              output_layer=2)
    jcfg = jax_config.HubertConfig(**kw, dtype="bfloat16")
    params = jax_hub.init_hubert(jax.random.key(0), jcfg)
    wav = jnp.asarray(rng.standard_normal((1, 1600)).astype(np.float32))
    with pytest.raises(TypeError, match="same dtypes"):
        jax_hub.apply_hubert(params, wav, jnp.asarray([1600]), jcfg)
    with pytest.raises(ValueError, match="TypeError at the second conv"):
        hub.HubertModel(HubertConfig(**kw, dtype="bfloat16"))
