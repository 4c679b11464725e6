"""Static-scale int8 serving forward for the unit HiFi-GAN generator.

Port of `parrot_tts_tpu/models/vocoder/generator_staticq.py` on the plain
(unfolded) layout. Activation scales are static: calibrated once per
checkpoint from a representative batch, per channel (absmax over batch
and time · margin / 127). Every conv between conv_pre and conv_post reads
an int8 activation and runs as an int8 conv with int32 accumulation
(`ops/quant.py::int8_conv_qweight`, the hand-written kernel
`csrc/int8_conv.cu` on the card); the per-channel scales fold into the
weight quantization, which `quantize_generator` does once per set of
scales. The upsamples run as stride-1 convs on the polyphase packing of
their transposed-conv kernels. conv_pre, conv_post and the
residual carriers stay in the compute dtype (`residual_int8=False`, the
default, puts quantization error only at conv inputs).

In bfloat16 (`cfg.dtype`) the forward follows the JAX package's: conv_pre
and conv_post run in bf16 (the model's `pack_bf16` copies) and conv_pre's
output is widened to float32; the int8 convs keep their float32 weights,
biases and outputs; the residual carriers are rounded to bf16 when served
(calibration keeps them float32, as there), and each carrier is widened
to float32 where it is read; the stage mean is taken in float32, and the
final leaky ReLU in float32 before the cast to bf16. Calibration runs
each conv in bf16 (weights and bias cast, the output rounded, then the
bias added in bf16) and records float32 absmaxes.

Sites, in forward order, per upsample stage: the upsample input, then for
each ResBlock and each of its (dilated, plain) conv pairs the two conv
inputs, plus (with residual_int8) the stage input and each pair's output.
At V1 that is 5 x (1 + 3 x 3 x 2) = 95 sites. A JAX scales file calibrated
with its default `fold_tail=True` has g·C-wide sites at the folded stages
and does not transfer: `load_qscales` checks every site's width against
the configuration and refuses it.

Calibration and serving share one forward body, so the site order cannot
skew; `_sites` lists the sites for the guards and the weight quantization,
and serving checks that each conv reads the site its weight was made
for. The body mirrors `generator.py::apply_generator`; a change of the
generator's topology must change this file too (the CPU tests compare both
against the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from parrot_tts_tpu_torch.core.config import VocoderModelConfig
from parrot_tts_tpu_torch.core.device import exact_numerics, resolve_device
from parrot_tts_tpu_torch.models.vocoder.generator import (LRELU_SLOPE,
                                                           CodeGenerator,
                                                           embed)
from parrot_tts_tpu_torch.ops import conv as conv_ops
from parrot_tts_tpu_torch.ops import quant as quant_ops


@dataclass(frozen=True)
class StaticQ:
    """A model's int8-static serving state for one set of scales: the
    per-site activation scales, and for each conv (keyed as in `_sites`)
    the site it reads, its int8 weight with that site's scales folded in
    (`quant.quantize_weight_qin`: (K, Co, Ci), the kernel's layout, and
    (Co,) scales) and its float32 bias. Made once, by `quantize_generator`."""

    scales: tuple
    residual_int8: bool
    convs: dict


@dataclass
class _QTape:
    """Threads the static state through the forward: mode "calibrate" runs
    the convs in float32 and records each site's absmax; mode "serve"
    consumes `q.scales[i]` in order and runs each conv on `q.convs`."""

    mode: str                      # "calibrate" | "serve"
    q: StaticQ | None = None
    collected: list = field(default_factory=list)
    i: int = 0


class _QT:
    """int8 tensor + its static per-channel scale and its site index
    (serve mode)."""

    __slots__ = ("q", "s", "site")

    def __init__(self, q: torch.Tensor, s: torch.Tensor, site: int):
        self.q, self.s, self.site = q, s, site


def _site_conv(model: CodeGenerator, conv: tuple
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The float (K, Ci, Co) kernel and the bias of the conv `conv` names;
    an upsample in its polyphase form (bias tiled over the phases)."""
    if conv[0] == "ups":
        i = conv[1]
        u, k = model.cfg.upsample_rates[i], model.cfg.upsample_kernel_sizes[i]
        up = model.ups[i]
        w = conv_ops.polyphase_weights(up.kernel().permute(2, 0, 1), u,
                                       (k - u) // 2)[0]
        return w, up.bias.repeat(u)
    r, name, j = conv
    c = getattr(model.resblocks[r], name)[j]
    return c.kernel().permute(2, 1, 0), c.bias


def _forward(model: CodeGenerator, x: torch.Tensor, tape: _QTape,
             residual_int8: bool = False) -> torch.Tensor:
    """The generator forward with explicit materialization points.
    x: (B, T, model_in_dim) float32 -> float32 (B, T*320, 1)."""
    cfg = model.cfg
    if cfg.resblock != "1":
        raise ValueError("int8-static serving targets the V1 topology "
                         "(resblock '1')")
    nk = len(cfg.resblock_kernel_sizes)
    calib = tape.mode == "calibrate"
    dt = model.dtype

    def mat(xf, int8=True):
        if not int8:
            return xf if calib else xf.to(dt)
        if calib:
            tape.collected.append(xf.abs().amax(dim=(0, 1)))
            return xf
        s = tape.q.scales[tape.i]
        tape.i += 1
        return _QT(quant_ops.quantize_static(xf, s), s, tape.i - 1)

    def deq(xt):
        return xt.q.float() * xt.s if isinstance(xt, _QT) else xt.float()

    def qconv(xt, conv, *, pads, dil=1, leaky=None):
        """The conv `conv` names on a materialized tensor, float32 out;
        leaky is the ReLU that follows (fused into the int8 kernel's
        epilogue)."""
        if calib:
            w, b = _site_conv(model, conv)
            xp = F.pad(xt.to(dt).transpose(1, 2), pads)
            y = conv_ops.conv1d(xp.transpose(1, 2), w.to(dt).permute(2, 1, 0),
                                b.to(dt), dilation=dil).float()
            return y if leaky is None else F.leaky_relu(y, leaky)
        site, qw, b = tape.q.convs[conv]
        if site != xt.site:
            raise RuntimeError(f"conv {conv} reads site {xt.site}; its weight "
                               f"was quantized for site {site}")
        return quant_ops.int8_conv_qweight(xt.q, qw, b, pads=pads,
                                           rhs_dilation=dil, leaky=leaky)

    # conv_pre stays in the compute dtype, its output widened
    x = conv_ops.conv1d(x.to(dt), model.conv_pre.weight_in(dt),
                        model.conv_pre.bias_in(dt), padding=3).float()
    for i, (u, k) in enumerate(zip(cfg.upsample_rates,
                                   cfg.upsample_kernel_sizes)):
        cout = cfg.upsample_initial_channel // (2 ** (i + 1))
        ups_in = mat(F.leaky_relu(x, LRELU_SLOPE))
        *_, pad_left, q_len = conv_ops._polyphase_plan(k, u, (k - u) // 2)
        y = qconv(ups_in, ("ups", i), pads=(pad_left, q_len - 1 - pad_left))
        bsz, t, _ = y.shape
        x = y.reshape(bsz, t * u, cout)      # phase-major (B, T, u*Co)

        x_mat = mat(x, int8=residual_int8)   # shared by all nk resblocks
        acc = None
        for r, rk, rds in zip(range(i * nk, (i + 1) * nk),
                              cfg.resblock_kernel_sizes,
                              cfg.resblock_dilation_sizes):
            xt_res = x_mat                   # residual carrier
            for j, d in enumerate(rds):
                p1 = conv_ops.get_padding(rk, d)
                p2 = conv_ops.get_padding(rk, 1)
                h = mat(F.leaky_relu(deq(xt_res), LRELU_SLOPE))
                h = qconv(h, (r, "convs1", j), pads=(p1, p1), dil=d,
                          leaky=LRELU_SLOPE)
                h = mat(h)
                h = qconv(h, (r, "convs2", j), pads=(p2, p2))
                xt_res = mat(h + deq(xt_res), int8=residual_int8)
            acc = deq(xt_res) if acc is None else acc + deq(xt_res)
        x = acc / nk

    # conv_post stays in the compute dtype; torch's default slope 0.01
    x = F.leaky_relu(x, 0.01).to(dt)
    x = conv_ops.conv1d(x, model.conv_post.weight_in(dt),
                        model.conv_post.bias_in(dt), padding=3)
    return torch.tanh(x).float()


def _sites(cfg: VocoderModelConfig, residual_int8: bool = False
           ) -> list[tuple[int, tuple | None]]:
    """Every int8 site in forward order as (channels, conv): conv names the
    conv that reads the site, ("ups", stage) or (resblock, "convs1" |
    "convs2", pair), and is None for a residual carrier."""
    sites = []
    nk = len(cfg.resblock_kernel_sizes)
    for i, (u, k) in enumerate(zip(cfg.upsample_rates,
                                   cfg.upsample_kernel_sizes)):
        if k - 2 * ((k - u) // 2) != u:
            raise ValueError(f"upsample {i}: kernel {k}, stride {u} has no "
                             "polyphase form (K - 2*padding != stride)")
        cin = cfg.upsample_initial_channel // (2 ** i)
        ch = cin // 2
        sites.append((cin, ("ups", i)))
        if residual_int8:
            sites.append((ch, None))
        for r, ds in zip(range(i * nk, (i + 1) * nk),
                         cfg.resblock_dilation_sizes):
            for j in range(len(ds)):
                sites += [(ch, (r, "convs1", j)), (ch, (r, "convs2", j))]
                if residual_int8:
                    sites.append((ch, None))
    return sites


def site_widths(cfg: VocoderModelConfig,
                residual_int8: bool = False) -> list[int]:
    """The channel count of every int8 site, in forward order."""
    return [c for c, _ in _sites(cfg, residual_int8)]


def check_qscales(qscales, cfg: VocoderModelConfig,
                  residual_int8: bool = False) -> None:
    """Raise ValueError unless qscales has one (C,) vector per site of this
    configuration, each as wide as its site."""
    want = site_widths(cfg, residual_int8)
    if len(qscales) != len(want):
        raise ValueError(f"qscales has {len(qscales)} sites, this "
                         f"configuration has {len(want)} (stale calibration "
                         "for this config?)")
    for i, (s, c) in enumerate(zip(qscales, want)):
        if tuple(s.shape) != (c,):
            raise ValueError(
                f"qscales site {i} has shape {tuple(s.shape)}, the "
                f"configuration's site is {c} channels wide (scales "
                "calibrated on the JAX package's folded tail do not "
                "transfer)")


def _inputs(model, code, spkr, device):
    device = resolve_device(device)
    model = model.to(device)
    code = torch.as_tensor(code).to(device, torch.int64)
    if spkr is not None:
        spkr = torch.as_tensor(spkr).to(device, torch.int64)
    return model, code, spkr, device


def calibrate_qscales(model: CodeGenerator, code, spkr, *,
                      margin: float = 1.0, residual_int8: bool = False,
                      exact: bool = True, device=None) -> tuple:
    """Run the float forward once on a representative batch and return the
    per-site, per-channel static scales (float32 (C,) tensors on the
    device): absmax over (B, T), zero -> 1, · margin / 127 in float64."""
    model, code, spkr, _ = _inputs(model, code, spkr, device)
    tape = _QTape("calibrate")
    with torch.no_grad(), exact_numerics(exact):
        _forward(model, embed(model, code, spkr), tape, residual_int8)
    out = []
    for a in tape.collected:
        a = a.double()
        a = torch.where(a > 0, a, torch.ones_like(a))
        out.append((a * margin / quant_ops.QMAX).float())
    return tuple(out)


def quantize_generator(model: CodeGenerator, qscales, *,
                       residual_int8: bool = False, device=None) -> StaticQ:
    """The int8-static state of `model` for qscales (from
    `calibrate_qscales` or `load_qscales`: same checkpoint, config and
    residual_int8): every conv's weight quantized once, on `device`."""
    check_qscales(qscales, model.cfg, residual_int8)
    device = resolve_device(device)
    model = model.to(device)
    scales = tuple(torch.as_tensor(s).to(device, torch.float32)
                   for s in qscales)
    convs = {}
    with torch.no_grad():
        for site, (_, conv) in enumerate(_sites(model.cfg, residual_int8)):
            if conv is not None:
                w, b = _site_conv(model, conv)
                convs[conv] = (site,
                               quant_ops.quantize_weight_qin(w, scales[site]),
                               b.float().contiguous())
    return StaticQ(scales, residual_int8, convs)


def apply_code_generator_staticq(model: CodeGenerator, code, spkr,
                                 q: StaticQ, *, exact: bool = True,
                                 device=None) -> torch.Tensor:
    """Serving forward with static int8 inter-stage activations; q from
    `quantize_generator` for this model. Returns the (B, T*320, 1)
    waveform."""
    model, code, spkr, _ = _inputs(model, code, spkr, device)
    with torch.no_grad(), exact_numerics(exact):
        return _forward(model, embed(model, code, spkr), _QTape("serve", q=q),
                        q.residual_int8)


def save_qscales(path, qscales) -> None:
    """Persist calibrated scales (npz, one array per site, in site order)."""
    np.savez(path, **{f"site_{i:03d}": torch.as_tensor(s).cpu().numpy()
                      for i, s in enumerate(qscales)})


def load_qscales(path, cfg: VocoderModelConfig,
                 residual_int8: bool = False) -> tuple:
    """Inverse of save_qscales; refuses a file whose site count or widths
    do not fit `cfg`."""
    with np.load(path) as z:
        qs = tuple(torch.from_numpy(np.asarray(z[k], np.float32))
                   for k in sorted(z.files))
    check_qscales(qs, cfg, residual_int8)
    return qs
