"""Unit-conditioned HiFi-GAN generator (V1 topology).

Port of `parrot_tts_tpu/models/vocoder/generator.py` (reference
`utils/vocoder/models.py:69-169`): conv_pre -> per upsample stage
[leakyReLU -> ConvTranspose1d -> MRF (mean of ResBlocks)] -> leakyReLU
(torch's default slope 0.01) -> conv_post -> tanh. `CodeGenerator` embeds
HuBERT codes and a speaker id, repeats the speaker vector over frames and
concatenates channels.

Activations are (B, T, C) at every function boundary, as in the JAX
package; the convs are cuDNN's (`ops/conv.py`). Only the plain layout is
ported: no folded tail, no fused MRF kernel, no int8.

Weight norm is kept as plain `weight_g` / `weight_v` parameters under the
reference's state_dict keys; `fold_params` collapses them into `weight`
for serving (remove_weight_norm), loaded by `CodeGenerator(cfg,
weight_norm=False)`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from parrot_tts_tpu_torch.core.config import VocoderModelConfig
from parrot_tts_tpu_torch.core.device import exact_numerics, resolve_device
from parrot_tts_tpu_torch.ops import conv as conv_ops
from parrot_tts_tpu_torch.ops import init as init_ops
from parrot_tts_tpu_torch.ops.weight_norm import wn_init, wn_resolve

LRELU_SLOPE = 0.1  # reference models.py:11


class WNConv(nn.Module):
    """A conv's parameters: weight (torch layout) as weight_g/weight_v
    under weight norm, else plain weight; and bias."""

    def __init__(self, shape: tuple[int, int, int], n_out: int,
                 weight_norm: bool):
        super().__init__()
        if weight_norm:
            self.weight_g = nn.Parameter(torch.empty(shape[0], 1, 1))
            self.weight_v = nn.Parameter(torch.empty(shape))
        else:
            self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.empty(n_out))

    def kernel(self) -> torch.Tensor:
        if hasattr(self, "weight_v"):
            return wn_resolve(self.weight_g, self.weight_v)
        return self.weight


def _conv1d(channels_in: int, channels_out: int, k: int, wn: bool) -> WNConv:
    return WNConv((channels_out, channels_in, k), channels_out, wn)


class ResBlock1(nn.Module):
    def __init__(self, channels: int, kernel_size: int,
                 dilations: tuple[int, ...], weight_norm: bool):
        super().__init__()
        self.kernel_size, self.dilations = kernel_size, tuple(dilations)
        self.convs1 = nn.ModuleList(
            _conv1d(channels, channels, kernel_size, weight_norm)
            for _ in dilations)
        self.convs2 = nn.ModuleList(
            _conv1d(channels, channels, kernel_size, weight_norm)
            for _ in dilations)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_resblock1(self, x)


class ResBlock2(nn.Module):
    def __init__(self, channels: int, kernel_size: int,
                 dilations: tuple[int, ...], weight_norm: bool):
        super().__init__()
        self.kernel_size, self.dilations = kernel_size, tuple(dilations)
        self.convs = nn.ModuleList(
            _conv1d(channels, channels, kernel_size, weight_norm)
            for _ in dilations)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_resblock2(self, x)


def apply_resblock1(rb: ResBlock1, x: torch.Tensor) -> torch.Tensor:
    """ResBlock1 (reference models.py:13-44): pairs of (dilated, plain)
    convs with leaky relus and residual adds."""
    k = rb.kernel_size
    for c1, c2, d in zip(rb.convs1, rb.convs2, rb.dilations):
        xt = F.leaky_relu(x, LRELU_SLOPE)
        xt = conv_ops.conv1d(xt, c1.kernel(), c1.bias,
                             padding=conv_ops.get_padding(k, d), dilation=d)
        xt = F.leaky_relu(xt, LRELU_SLOPE)
        xt = conv_ops.conv1d(xt, c2.kernel(), c2.bias,
                             padding=conv_ops.get_padding(k, 1))
        x = xt + x
    return x


def apply_resblock2(rb: ResBlock2, x: torch.Tensor) -> torch.Tensor:
    """ResBlock2 (reference models.py:47-66)."""
    k = rb.kernel_size
    for c, d in zip(rb.convs, rb.dilations):
        xt = F.leaky_relu(x, LRELU_SLOPE)
        xt = conv_ops.conv1d(xt, c.kernel(), c.bias,
                             padding=conv_ops.get_padding(k, d), dilation=d)
        x = xt + x
    return x


class CodeGenerator(nn.Module):
    """Reference CodeGenerator (models.py:122-169) with the Generator's
    layers (models.py:69-111) under the reference's state_dict keys."""

    def __init__(self, cfg: VocoderModelConfig, *, weight_norm: bool = True):
        super().__init__()
        if cfg.f0 or cfg.fused_mrf or cfg.quant != "none":
            raise NotImplementedError(
                "the port serves the plain float generator only "
                "(f0=False, fused_mrf=False, quant='none')")
        self.cfg = cfg
        wn = weight_norm
        c0 = cfg.upsample_initial_channel
        self.conv_pre = _conv1d(cfg.model_in_dim, c0, 7, wn)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        rb_cls = ResBlock1 if cfg.resblock == "1" else ResBlock2
        ch = c0
        for i, (u, k) in enumerate(zip(cfg.upsample_rates,
                                       cfg.upsample_kernel_sizes)):
            cin, ch = c0 // (2 ** i), c0 // (2 ** (i + 1))
            self.ups.append(WNConv((cin, ch, k), ch, wn))
            for rk, rd in zip(cfg.resblock_kernel_sizes,
                              cfg.resblock_dilation_sizes):
                self.resblocks.append(rb_cls(ch, rk, rd, wn))
        self.conv_post = _conv1d(ch, 1, 7, wn)
        self.dict = nn.Embedding(cfg.num_embeddings, cfg.embedding_dim)
        if cfg.multispkr:
            self.spkr = nn.Embedding(cfg.num_speakers, cfg.embedding_dim)

    def forward(self, code: torch.Tensor,
                spkr: torch.Tensor | None) -> torch.Tensor:
        return _code_generator(self, code, spkr)


def apply_generator(model: CodeGenerator, x: torch.Tensor) -> torch.Tensor:
    """Generator forward (reference models.py:96-111): x (B, T,
    model_in_dim) -> waveform (B, T*prod(upsample_rates), 1)."""
    cfg = model.cfg
    nk = len(cfg.resblock_kernel_sizes)
    x = conv_ops.conv1d(x, model.conv_pre.kernel(), model.conv_pre.bias,
                        padding=3)
    for i, (u, k) in enumerate(zip(cfg.upsample_rates,
                                   cfg.upsample_kernel_sizes)):
        x = F.leaky_relu(x, LRELU_SLOPE)
        up = model.ups[i]
        x = conv_ops.conv_transpose1d(x, up.kernel(), up.bias, stride=u,
                                      padding=(k - u) // 2)
        acc = None
        for rb in model.resblocks[i * nk:(i + 1) * nk]:
            y = rb(x)
            acc = y if acc is None else acc + y
        x = acc / nk
    # final leaky uses torch's DEFAULT slope 0.01 (reference models.py:107)
    x = F.leaky_relu(x, 0.01)
    x = conv_ops.conv1d(x, model.conv_post.kernel(), model.conv_post.bias,
                        padding=3)
    return torch.tanh(x)


def upsample_cond(signal: torch.Tensor, max_frames: int) -> torch.Tensor:
    """Nearest-repeat upsample of a conditioning feature to the code frame
    axis — the reference ``CodeGenerator._upsample`` (models.py:131-150).
    Accepts (B, C, Tc), (B, C) or (B,) and returns (B, C, max_frames); the
    condition length must divide ``max_frames``."""
    if signal.dim() == 1:
        signal = signal.reshape(-1, 1, 1)
    elif signal.dim() == 2:
        signal = signal[:, :, None]
    elif signal.dim() != 3:
        raise ValueError(f"condition must be rank 1-3, got {tuple(signal.shape)}")
    tc = signal.shape[2]
    rep = max_frames // tc
    if rep * tc != max_frames:
        raise NotImplementedError(
            "Padding condition signal - misalignment between condition "
            f"features: {tc} frames into {max_frames}")
    return signal.repeat_interleave(rep, dim=-1)


def _code_generator(model: CodeGenerator, code: torch.Tensor,
                    spkr: torch.Tensor | None) -> torch.Tensor:
    x = model.dict.weight[code]                                # (B, T, E)
    if model.cfg.multispkr:
        if spkr is None:
            raise ValueError("multispeaker model needs spkr ids")
        s = model.spkr.weight[spkr.reshape(spkr.shape[0])]     # (B, E)
        x = torch.cat([x, s[:, None, :].expand_as(x)], dim=-1)
    return apply_generator(model, x)


def apply_code_generator(model: CodeGenerator, code, spkr, *,
                         exact: bool = True, device=None) -> torch.Tensor:
    """code: (B, T) int unit ids; spkr: (B,) or (B, 1) int speaker ids
    (numpy or tensors). Returns the (B, T*320, 1) waveform in [-1, 1] on
    `device` (default: the CUDA card; raises without one unless
    device="cpu"). exact=True: IEEE float32 convs (no TF32), deterministic
    cuDNN algorithms."""
    device = resolve_device(device)
    model = model.to(device)
    code = torch.as_tensor(code).to(device, torch.int64)
    if spkr is not None:
        spkr = torch.as_tensor(spkr).to(device, torch.int64)
    with torch.no_grad(), exact_numerics(exact):
        return _code_generator(model, code, spkr)


def fold_params(state: dict) -> dict:
    """Collapse every weight_g / weight_v pair into a plain `weight` — the
    functional remove_weight_norm (reference models.py:113-119)."""
    folded = {}
    for key, val in state.items():
        if key.endswith(".weight_g"):
            p = key[: -len(".weight_g")]
            folded[p + ".weight"] = wn_resolve(val, state[p + ".weight_v"])
        elif not key.endswith(".weight_v"):
            folded[key] = val
    return folded


def init_code_generator(cfg: VocoderModelConfig,
                        gen: torch.Generator) -> dict:
    """Seeded CodeGenerator state dict (weight-norm form, CPU tensors) with
    the shapes and fan-in rules of the JAX package's init_code_generator."""
    sd: dict = {}
    ku, ufi = init_ops.kaiming_uniform, init_ops.uniform_fan_in

    def wn(name, shape, fan_in, n_out):
        g, v = wn_init(ku(gen, shape, fan_in))
        sd[f"{name}.weight_g"], sd[f"{name}.weight_v"] = g, v
        sd[f"{name}.bias"] = ufi(gen, (n_out,), fan_in)

    c0 = cfg.upsample_initial_channel
    wn("conv_pre", (c0, cfg.model_in_dim, 7), cfg.model_in_dim * 7, c0)
    nk = len(cfg.resblock_kernel_sizes)
    ch = c0
    for i, (u, k) in enumerate(zip(cfg.upsample_rates,
                                   cfg.upsample_kernel_sizes)):
        cin, ch = c0 // (2 ** i), c0 // (2 ** (i + 1))
        wn(f"ups.{i}", (cin, ch, k), cin * k, ch)   # torch ConvT bias fan-in is cin*k
        for j, (rk, rd) in enumerate(zip(cfg.resblock_kernel_sizes,
                                         cfg.resblock_dilation_sizes)):
            names = ("convs1", "convs2") if cfg.resblock == "1" else ("convs",)
            for name in names:
                for m in range(len(rd)):
                    wn(f"resblocks.{i * nk + j}.{name}.{m}", (ch, ch, rk),
                       ch * rk, ch)
    wn("conv_post", (1, ch, 7), ch * 7, 1)
    sd["dict.weight"] = init_ops.embedding(
        gen, (cfg.num_embeddings, cfg.embedding_dim))
    if cfg.multispkr:
        sd["spkr.weight"] = init_ops.embedding(
            gen, (cfg.num_speakers, cfg.embedding_dim))
    return sd
