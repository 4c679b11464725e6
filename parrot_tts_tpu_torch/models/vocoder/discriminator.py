"""HiFi-GAN discriminators: multi-period (MPD) and multi-scale (MSD).

Port of `parrot_tts_tpu/models/vocoder/discriminator.py` (reference
`utils/vocoder/models.py:171-276`). MPD: five period discriminators
(2, 3, 5, 7, 11) that fold the waveform into (T/p, p) and run (5, 1)
convs with stride (3, 1), weight norm throughout. MSD: three scale
discriminators of grouped 1-D convs over x1 / x2 / x4 average-pooled
waveforms (AvgPool1d(4, 2, padding=2), padding counted); scale 0 under
spectral norm, whose power-iteration vectors are buffers that advance
when the caller says so, scales 1-2 under weight norm.

Parameter and buffer names are the reference's `state_dict` keys
(`discriminators.{i}.convs.{j}.weight_g / weight_v / bias`, and on the
spectral-norm scale `weight_orig / weight_u / weight_v / bias`), so the
JAX package's `models/vocoder/convert.py::{mpd,msd}_params_from_torch`
read the port's state. The JAX package's time-folded lowerings
(`ops/folded.py`) are TPU layouts; the port runs the same math as plain
cuDNN conv2d / grouped conv1d in torch layouts. Waveforms come in as
(B, T, 1) as in the JAX package; feature maps are NCHW (MPD) and NCW
(MSD), where the JAX package's are channels-last.

`dtype` (the trainer's `disc_dtype`, e.g. torch.bfloat16) casts the
input and the resolved kernels for the convolutions; parameters, the
power iteration and the losses' reductions stay float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from parrot_tts_tpu_torch.models.vocoder.generator import WNConv
from parrot_tts_tpu_torch.ops import init as init_ops
from parrot_tts_tpu_torch.ops.conv import reflect_pad
from parrot_tts_tpu_torch.ops.weight_norm import (sn_init, sn_power_iteration,
                                                  sn_resolve, wn_init)

LRELU_SLOPE = 0.1

MPD_PERIODS = (2, 3, 5, 7, 11)
MPD_KERNEL = 5           # DiscriminatorP's kernel_size default
# (cin, cout) per conv layer (reference models.py:175-181)
_MPD_CHANNELS = ((1, 32), (32, 128), (128, 512), (512, 1024), (1024, 1024))
_MPD_STRIDES = (3, 3, 3, 3, 1)
# (cin, cout, kernel, stride, groups, padding) (reference models.py:231-236)
_MSD_LAYERS = (
    (1, 128, 15, 1, 1, 7),
    (128, 128, 41, 2, 4, 20),
    (128, 256, 41, 2, 16, 20),
    (256, 512, 41, 4, 16, 20),
    (512, 1024, 41, 4, 16, 20),
    (1024, 1024, 41, 1, 16, 20),
    (1024, 1024, 5, 1, 1, 2),
)


class SNConv(nn.Module):
    """A spectral-normed conv under torch's `spectral_norm` keys: weight
    `weight_orig` and bias, and the power-iteration buffers `weight_u`
    (Cout,) and `weight_v` (numel / Cout,)."""

    def __init__(self, shape: tuple[int, ...], n_out: int):
        super().__init__()
        self.weight_orig = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.empty(n_out))
        n_in = 1
        for d in shape[1:]:
            n_in *= d
        self.register_buffer("weight_u", torch.empty(shape[0]))
        self.register_buffer("weight_v", torch.empty(n_in))

    def kernel(self, update: bool) -> torch.Tensor:
        """w / sigma; update=True advances (u, v) one power iteration
        first and stores them."""
        w, u, v = sn_resolve(self.weight_orig, self.weight_u, self.weight_v,
                             update=update)
        if update:
            self._store(u, v)
        return w

    def advance(self) -> None:
        """One power iteration without a forward (the JAX `_sn_advance`)."""
        self._store(*sn_power_iteration(self.weight_orig, self.weight_u))

    def _store(self, u: torch.Tensor, v: torch.Tensor) -> None:
        with torch.no_grad():
            self.weight_u.copy_(u)
            self.weight_v.copy_(v)


def _kernel(conv: nn.Module, update_sn: bool, dtype) -> torch.Tensor:
    w = (conv.kernel(update_sn) if isinstance(conv, SNConv)
         else conv.kernel())
    return w if dtype is None else w.to(dtype)


class DiscriminatorP(nn.Module):
    """Reference DiscriminatorP (models.py:171-203)."""

    def __init__(self, period: int):
        super().__init__()
        self.period = period
        self.convs = nn.ModuleList(
            WNConv((co, ci, MPD_KERNEL, 1), co, True)
            for ci, co in _MPD_CHANNELS)
        self.conv_post = WNConv((1, 1024, 3, 1), 1, True)


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self):
        super().__init__()
        self.discriminators = nn.ModuleList(DiscriminatorP(p)
                                            for p in MPD_PERIODS)


class DiscriminatorS(nn.Module):
    """Reference DiscriminatorS (models.py:228-255)."""

    def __init__(self, use_spectral_norm: bool = False):
        super().__init__()

        def conv(shape, n_out):
            return (SNConv(shape, n_out) if use_spectral_norm
                    else WNConv(shape, n_out, True))

        self.convs = nn.ModuleList(conv((co, ci // g, k), co)
                                   for ci, co, k, s, g, pad in _MSD_LAYERS)
        self.conv_post = conv((1, 1024, 3), 1)


class MultiScaleDiscriminator(nn.Module):
    def __init__(self):
        super().__init__()
        self.discriminators = nn.ModuleList([
            DiscriminatorS(use_spectral_norm=True), DiscriminatorS(),
            DiscriminatorS()])


def apply_discriminator_p(d: DiscriminatorP, x: torch.Tensor, dtype=None
                          ) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """x: (B, 1, T). Returns (score (B, n), feature maps (B, C, H, p))."""
    b, c, t = x.shape
    if dtype is not None:
        x = x.to(dtype)
    if t % d.period:
        x = reflect_pad(x, 0, d.period - t % d.period)
    x = x.reshape(b, c, x.shape[-1] // d.period, d.period)
    fmap = []
    # padding 2 = get_padding(5, 1), as the reference hardcodes it
    for conv, s in zip(d.convs, _MPD_STRIDES):
        x = F.leaky_relu(F.conv2d(x, _kernel(conv, False, dtype),
                                  conv.bias.to(x.dtype), stride=(s, 1),
                                  padding=(2, 0)), LRELU_SLOPE)
        fmap.append(x)
    x = F.conv2d(x, _kernel(d.conv_post, False, dtype),
                 d.conv_post.bias.to(x.dtype), padding=(1, 0))
    fmap.append(x)
    return x.reshape(b, -1), fmap


def _split(score, fmap, b: int):
    return score[:b], score[b:], [f[:b] for f in fmap], [f[b:] for f in fmap]


def apply_mpd(mpd: MultiPeriodDiscriminator, y: torch.Tensor,
              y_hat: torch.Tensor, dtype=None, stacked: bool = False):
    """(y_d_rs, y_d_gs, fmap_rs, fmap_gs) of the reference
    MultiPeriodDiscriminator (models.py:206-225) on (B, T, 1) waveforms.
    stacked=True runs real and fake as one 2B batch per period (the same
    numbers: weight norm only, convs per sample); the trainer uses it."""
    y, y_hat = y.transpose(1, 2), y_hat.transpose(1, 2)
    b = y.shape[0]
    out: tuple[list, list, list, list] = ([], [], [], [])
    for d in mpd.discriminators:
        if stacked:
            parts = _split(*apply_discriminator_p(
                d, torch.cat([y, y_hat]), dtype), b)
        else:
            (s_r, f_r), (s_g, f_g) = (apply_discriminator_p(d, y, dtype),
                                      apply_discriminator_p(d, y_hat, dtype))
            parts = (s_r, s_g, f_r, f_g)
        for acc, part in zip(out, parts):
            acc.append(part)
    return out


def apply_discriminator_s(d: DiscriminatorS, x: torch.Tensor, *,
                          update_sn: bool, dtype=None
                          ) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """x: (B, 1, T). Returns (score (B, n), feature maps (B, C, T')).
    On the spectral-norm scale update_sn=True advances each conv's (u, v)
    one power iteration as it is resolved."""
    if dtype is not None:
        x = x.to(dtype)
    fmap = []
    for conv, (ci, co, k, s, g, pad) in zip(d.convs, _MSD_LAYERS):
        x = F.leaky_relu(F.conv1d(x, _kernel(conv, update_sn, dtype),
                                  conv.bias.to(x.dtype), stride=s,
                                  padding=pad, groups=g), LRELU_SLOPE)
        fmap.append(x)
    x = F.conv1d(x, _kernel(d.conv_post, update_sn, dtype),
                 d.conv_post.bias.to(x.dtype), padding=1)
    fmap.append(x)
    return x.reshape(x.shape[0], -1), fmap


def sn_advance(d: DiscriminatorS) -> None:
    """One power iteration on every spectral-norm conv of d, no forward."""
    for conv in [*d.convs, d.conv_post]:
        if isinstance(conv, SNConv):
            conv.advance()


def apply_msd(msd: MultiScaleDiscriminator, y: torch.Tensor,
              y_hat: torch.Tensor, *, update_sn: bool = False, dtype=None,
              stacked: bool = False):
    """(y_d_rs, y_d_gs, fmap_rs, fmap_gs) of the reference
    MultiScaleDiscriminator (models.py:258-276) on (B, T, 1) waveforms.

    The reference calls each scale on y, then on y_hat, so in training u
    advances twice per MSD call; update_sn=True does the same, in place
    on the buffers. stacked=True runs real and fake as one 2B batch per
    scale, as the JAX trainer does: on the spectral-norm scale both halves
    use the first power iterate's sigma and a second iteration follows
    (two advances per call), where the sequential fake pass sees the
    second iterate's sigma."""
    y, y_hat = y.transpose(1, 2), y_hat.transpose(1, 2)
    b = y.shape[0]
    out: tuple[list, list, list, list] = ([], [], [], [])
    for i, d in enumerate(msd.discriminators):
        if i:
            y = F.avg_pool1d(y, 4, 2, padding=2)
            y_hat = F.avg_pool1d(y_hat, 4, 2, padding=2)
        if stacked:
            parts = _split(*apply_discriminator_s(
                d, torch.cat([y, y_hat]), update_sn=update_sn, dtype=dtype), b)
            if update_sn:
                sn_advance(d)
        else:
            s_r, f_r = apply_discriminator_s(d, y, update_sn=update_sn,
                                             dtype=dtype)
            s_g, f_g = apply_discriminator_s(d, y_hat, update_sn=update_sn,
                                             dtype=dtype)
            parts = (s_r, s_g, f_r, f_g)
        for acc, part in zip(out, parts):
            acc.append(part)
    return out


def _norm_conv(sd: dict, name: str, gen: torch.Generator, shape, fan_in: int,
               spectral: bool) -> None:
    w = init_ops.kaiming_uniform(gen, shape, fan_in)
    b = init_ops.uniform_fan_in(gen, (shape[0],), fan_in)
    if spectral:
        u, v = sn_init(w, gen)
        sd.update({f"{name}.weight_orig": w, f"{name}.weight_u": u,
                   f"{name}.weight_v": v})
    else:
        sd[f"{name}.weight_g"], sd[f"{name}.weight_v"] = wn_init(w)
    sd[f"{name}.bias"] = b


def init_mpd(gen: torch.Generator) -> dict:
    """Seeded MultiPeriodDiscriminator state dict (CPU tensors) with the
    JAX package's shapes and fan-in rules (`init_discriminator_p`)."""
    sd: dict = {}
    for i in range(len(MPD_PERIODS)):
        p = f"discriminators.{i}"
        for j, (ci, co) in enumerate(_MPD_CHANNELS):
            _norm_conv(sd, f"{p}.convs.{j}", gen, (co, ci, MPD_KERNEL, 1),
                       ci * MPD_KERNEL, False)
        _norm_conv(sd, f"{p}.conv_post", gen, (1, 1024, 3, 1), 1024 * 3,
                   False)
    return sd


def init_msd(gen: torch.Generator) -> dict:
    """Seeded MultiScaleDiscriminator state dict (CPU tensors): scale 0
    spectral-normed, scales 1-2 weight-normed (`init_discriminator_s`)."""
    sd: dict = {}
    for i in range(3):
        p = f"discriminators.{i}"
        for j, (ci, co, k, s, g, pad) in enumerate(_MSD_LAYERS):
            _norm_conv(sd, f"{p}.convs.{j}", gen, (co, ci // g, k),
                       (ci // g) * k, i == 0)
        _norm_conv(sd, f"{p}.conv_post", gen, (1, 1024, 3), 1024 * 3, i == 0)
    return sd
