"""Unit-conditioned HiFi-GAN generator (V1 topology).

Port of `parrot_tts_tpu/models/vocoder/generator.py` (reference
`utils/vocoder/models.py:69-169`): conv_pre -> per upsample stage
[leakyReLU -> ConvTranspose1d -> MRF (mean of ResBlocks)] -> leakyReLU
(torch's default slope 0.01) -> conv_post -> tanh. `CodeGenerator` embeds
HuBERT codes and a speaker id, repeats the speaker vector over frames and
concatenates channels.

Activations are (B, T, C) at every function boundary, as in the JAX
package; the float convs are cuDNN's (`ops/conv.py`). Only the plain
layout is ported, with no folded tail. `fused_mrf=True` runs each ResBlock1
stage below 128 channels as one fused kernel (`ops/fused_mrf.py`) when
weight norm is folded, on weights packed once by
`CodeGenerator.pack_fused_mrf`. The dynamic int8 modes run their sites as
the dynamic int8 conv (`ops/quant.py`, the kernel `csrc/int8_conv.cu` on
the card), on int8 weights quantized once by `CodeGenerator.pack_int8`:
"int8" every MRF conv and upsample, "int8-tail" those of the stages the
JAX package folds (`quant_plan`). int8 supersedes the fused MRF on a
stage, as in the JAX package. `quant="int8-static"` is served by
`generator_staticq.py`. Conditioning features (f0 under `cfg.f0`) are
upsample-concatenated onto the embedding as in the JAX package (`embed`).

Weight norm is kept as plain `weight_g` / `weight_v` parameters under the
reference's state_dict keys; `fold_params` collapses them into `weight`
for serving (remove_weight_norm), loaded by `CodeGenerator(cfg,
weight_norm=False)`.

`cfg.dtype="bfloat16"` computes in bf16 at the JAX package's rounding
points: the embedding (with any conditioning feature) is cast at entry;
weight norm is resolved in float32 and cast, and every bias is cast to
bf16; each conv rounds its float32 sum to bf16 and then adds its bias in
bf16 (`ops/conv.py`); the leaky ReLUs take bf16(slope)
(`ops/activation.py`); the unfused MRF mean (`acc + y`, `/ nk`) is taken
in bf16; tanh in bf16, then the waveform is returned as float32. A fused
stage runs the fused kernel's bf16 mode, and the dynamic int8 convs
return bf16. Parameters stay float32: a serving model with weight norm
folded keeps bf16 copies of its weights and biases made once by
`CodeGenerator.pack_bf16` (the same values as the JAX package's cast at
each call); under weight norm the cast is taken per call, so training
differentiates through it into the float32 parameters.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from parrot_tts_tpu_torch.core.config import VocoderModelConfig
from parrot_tts_tpu_torch.core.device import exact_numerics, resolve_device
from parrot_tts_tpu_torch.ops import conv as conv_ops
from parrot_tts_tpu_torch.ops import fused_mrf
from parrot_tts_tpu_torch.ops import init as init_ops
from parrot_tts_tpu_torch.ops import quant as quant_ops
from parrot_tts_tpu_torch.ops.activation import leaky_relu
from parrot_tts_tpu_torch.ops.weight_norm import wn_init, wn_resolve

LRELU_SLOPE = 0.1  # reference models.py:11
# the JAX package fuses the stages it folds, those below its 128-lane
# target (generator.py:142, 219-222): 64, 32 and 16 channels at V1
FUSED_BELOW_CHANNELS = 128
LANE_TARGET = 128      # the JAX package's apply_generator(lane_target=128)
DYNAMIC_QUANT = ("int8", "int8-tail")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(cfg: VocoderModelConfig) -> torch.dtype:
    """The torch dtype of cfg.dtype ("float32" or "bfloat16")."""
    if cfg.dtype not in DTYPES:
        raise ValueError(f"VocoderModelConfig.dtype={cfg.dtype!r}: the "
                         f"vocoder computes in {tuple(DTYPES)}")
    return DTYPES[cfg.dtype]


class WNConv(nn.Module):
    """A conv's parameters: weight (torch layout) as weight_g/weight_v
    under weight norm, else plain weight; and bias."""

    def __init__(self, shape: tuple[int, ...], n_out: int,
                 weight_norm: bool):
        super().__init__()
        if weight_norm:
            self.weight_g = nn.Parameter(
                torch.empty(shape[0], *(1,) * (len(shape) - 1)))
            self.weight_v = nn.Parameter(torch.empty(shape))
        else:
            self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.empty(n_out))

    def kernel(self) -> torch.Tensor:
        if hasattr(self, "weight_v"):
            return wn_resolve(self.weight_g, self.weight_v)
        return self.weight

    def weight_in(self, dtype: torch.dtype) -> torch.Tensor:
        """The weight in the compute dtype: bfloat16 cast per call under
        weight norm (resolved in float32 first), else the copy
        `CodeGenerator.pack_bf16` made; any other dtype the weight as it
        is."""
        return self._in(dtype, self.kernel, "weight16")

    def bias_in(self, dtype: torch.dtype) -> torch.Tensor:
        """The bias in the compute dtype, as `weight_in`."""
        return self._in(dtype, lambda: self.bias, "bias16")

    def _in(self, dtype, value, packed: str) -> torch.Tensor:
        if dtype != torch.bfloat16:
            return value()
        if hasattr(self, "weight_v"):
            return value().to(dtype)
        if not hasattr(self, packed):
            raise RuntimeError("dtype='bfloat16': make the bf16 copies of "
                               "the weights with model.pack_bf16() once they "
                               "are loaded")
        return getattr(self, packed)

    def int8(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The int8 weight (K, Co, Ci) and its (Co,) scales that
        `CodeGenerator.pack_int8` made of this conv."""
        if not hasattr(self, "qweight"):
            raise RuntimeError("quant='int8' / 'int8-tail': quantize the "
                               "weights with model.pack_int8() once they "
                               "are loaded")
        return self.qweight, self.qscale


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


def _conv(c: WNConv, x: torch.Tensor, *, padding: int, dilation: int = 1,
          quant: bool = False, leaky: float | None = None) -> torch.Tensor:
    """The conv c on x, in x's dtype or (quant) as the dynamic int8 conv
    on c's packed int8 weight; `leaky` is the ReLU that follows it."""
    dt = x.dtype
    return conv_ops.conv1d(x, None if quant else c.weight_in(dt),
                           c.bias_in(dt), padding=padding,
                           dilation=dilation, quant=quant,
                           qweight=c.int8() if quant else None, leaky=leaky)


def apply_resblock1(rb: ResBlock1, x: torch.Tensor,
                    quant: bool = False) -> torch.Tensor:
    """ResBlock1 (reference models.py:13-44): pairs of (dilated, plain)
    convs with leaky relus and residual adds, in x's dtype."""
    k = rb.kernel_size
    for c1, c2, d in zip(rb.convs1, rb.convs2, rb.dilations):
        xt = leaky_relu(x, LRELU_SLOPE)
        xt = _conv(c1, xt, padding=conv_ops.get_padding(k, d), dilation=d,
                   quant=quant, leaky=LRELU_SLOPE)
        xt = _conv(c2, xt, padding=conv_ops.get_padding(k, 1), quant=quant)
        x = xt + x
    return x


def apply_resblock2(rb: ResBlock2, x: torch.Tensor,
                    quant: bool = False) -> torch.Tensor:
    """ResBlock2 (reference models.py:47-66)."""
    k = rb.kernel_size
    for c, d in zip(rb.convs, rb.dilations):
        xt = leaky_relu(x, LRELU_SLOPE)
        xt = _conv(c, xt, padding=conv_ops.get_padding(k, d), dilation=d,
                   quant=quant)
        x = xt + x
    return x


class CodeGenerator(nn.Module):
    """Reference CodeGenerator (models.py:122-169) with the Generator's
    layers (models.py:69-111) under the reference's state_dict keys."""

    def __init__(self, cfg: VocoderModelConfig, *, weight_norm: bool = True):
        super().__init__()
        if cfg.quant not in ("none", "int8-static", *DYNAMIC_QUANT):
            raise ValueError(f"unknown quant mode {cfg.quant!r}")
        self.dtype = compute_dtype(cfg)
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
        self.mrf_plans: dict = {}

    def pack_fused_mrf(self) -> None:
        """Pack the weights of every stage the fused route takes, once, for
        serving: per stage a flat kernel, the kernel's layout of it
        (`fused_mrf.kernel_weights`) and a bias buffer (moved with the
        module, left out of its state_dict) and its plan. Call it after the
        final weights are loaded; weights changed later need a new call."""
        self.mrf_plans = {}
        with torch.no_grad():
            for i in range(len(self.cfg.upsample_rates)):
                # "int8" quantizes every stage; which stages "int8-tail"
                # quantizes depends on the length served
                if _fuses(self, i, quant=self.cfg.quant == "int8"):
                    w, b, plan = pack_stage(self, i)
                    w, b = w.to(self.dtype), b.to(self.dtype)
                    self.register_buffer(f"mrf_w{i}", w, persistent=False)
                    self.register_buffer(f"mrf_k{i}", fused_mrf.kernel_weights(
                        w, plan), persistent=False)
                    self.register_buffer(f"mrf_b{i}", b, persistent=False)
                    self.mrf_plans[i] = plan

    def pack_int8(self) -> None:
        """Under quant "int8" / "int8-tail", quantize the weight of every
        MRF conv and every upsample (in its polyphase form) once, for
        serving: per conv an int8 (K, Co, Ci) kernel and its (Co,) scales
        as buffers (moved with the module, left out of its state_dict). A
        no-op in the other modes. In bfloat16 the weights are quantized
        from their bf16 values, as the JAX package quantizes its bf16
        kernels. Call it after the final weights are loaded; weights
        changed later need a new call."""
        if self.cfg.quant not in DYNAMIC_QUANT:
            return
        dt = self.dtype
        with torch.no_grad():
            for i, (u, k) in enumerate(zip(self.cfg.upsample_rates,
                                           self.cfg.upsample_kernel_sizes)):
                up = self.ups[i]
                if conv_ops.polyphase_applies(k, u, (k - u) // 2):
                    w = conv_ops.polyphase_weights(
                        up.kernel().to(dt).permute(2, 0, 1), u,
                        (k - u) // 2)[0]
                    _register_int8(up, quant_ops.quantize_weight(w))
            for rb in self.resblocks:
                for c in rb.modules():
                    if isinstance(c, WNConv):
                        _register_int8(c, quant_ops.quantize_weight(
                            c.kernel().to(dt).permute(2, 1, 0)))

    def pack_bf16(self) -> None:
        """Under dtype="bfloat16" with weight norm folded, the bf16 copy of
        every conv's weight and bias, once, for serving (buffers moved with
        the module, left out of its state_dict). A no-op otherwise. Call it
        after the final weights are loaded; weights changed later need a
        new call."""
        if self.dtype == torch.float32 or hasattr(self.conv_pre, "weight_v"):
            return
        with torch.no_grad():
            for c in self.modules():
                if isinstance(c, WNConv):
                    c.register_buffer("weight16", c.weight.to(self.dtype),
                                      persistent=False)
                    c.register_buffer("bias16", c.bias.to(self.dtype),
                                      persistent=False)

    def forward(self, code: torch.Tensor, spkr: torch.Tensor | None,
                extra_feats: dict | None = None) -> torch.Tensor:
        return _code_generator(self, code, spkr, extra_feats)


def _register_int8(c: WNConv, qweight: tuple) -> None:
    c.register_buffer("qweight", qweight[0], persistent=False)
    c.register_buffer("qscale", qweight[1], persistent=False)


def _quant_stage(cfg: VocoderModelConfig, g: int) -> bool:
    """Whether a site at fold factor g runs int8 (JAX generator.py:85-91)."""
    if cfg.quant == "int8":
        return True
    if cfg.quant == "int8-tail":
        return g > 1
    return False


def quant_plan(cfg: VocoderModelConfig, t: int) -> list[tuple[bool, bool]]:
    """Per upsample stage, whether its upsample and its MRF convs run int8
    for t frames at conv_pre. The port has no fold; it keeps the JAX
    package's bookkeeping of the fold factor g (generator.py:202-222 with
    its defaults fold_tail=True, lane_target=128) as arithmetic only, so
    "int8-tail" quantizes the sites JAX quantizes: while g = 1, a stage
    with cout < 128 folds by want = 128 // cout right after its upsample
    when its length is a multiple of want; each later upsample multiplies g
    by its stride; a stage's MRF runs int8 iff g > 1 there, an upsample iff
    g > 1 before it. "int8" quantizes every site."""
    plan, g = [], 1
    for i, u in enumerate(cfg.upsample_rates):
        cout = cfg.upsample_initial_channel // (2 ** (i + 1))
        ups_q = _quant_stage(cfg, g)
        t *= u
        if g > 1:
            g *= u
        else:
            want = max(1, LANE_TARGET // cout)
            if want > 1 and t % want == 0:
                g = want
        plan.append((ups_q, _quant_stage(cfg, g)))
    return plan


def apply_generator(model: CodeGenerator, x: torch.Tensor) -> torch.Tensor:
    """Generator forward (reference models.py:96-111): x (B, T,
    model_in_dim) -> waveform (B, T*prod(upsample_rates), 1): computed in
    bfloat16 under cfg.dtype "bfloat16" (x cast at entry, the waveform
    returned as float32), else in x's dtype."""
    cfg = model.cfg
    if model.dtype == torch.bfloat16:
        x = x.to(model.dtype)
    dt = x.dtype
    nk = len(cfg.resblock_kernel_sizes)
    apply_rb = apply_resblock1 if cfg.resblock == "1" else apply_resblock2
    plan = quant_plan(cfg, x.shape[1])
    x = conv_ops.conv1d(x, model.conv_pre.weight_in(dt),
                        model.conv_pre.bias_in(dt), padding=3)
    for i, (u, k) in enumerate(zip(cfg.upsample_rates,
                                   cfg.upsample_kernel_sizes)):
        ups_q, mrf_q = plan[i]
        x = leaky_relu(x, LRELU_SLOPE)
        up, pad = model.ups[i], (k - u) // 2
        packed = ups_q and conv_ops.polyphase_applies(k, u, pad)
        x = conv_ops.conv_transpose1d(
            x, up.weight_in(dt), up.bias_in(dt), stride=u, padding=pad,
            quant=ups_q, qweight=up.int8() if packed else None)
        y = _mrf_stage_fused(model, i, x, mrf_q)
        if y is not None:
            x = y
        else:
            acc = None
            for rb in model.resblocks[i * nk:(i + 1) * nk]:
                y = apply_rb(rb, x, mrf_q)
                acc = y if acc is None else acc + y
            x = acc / nk
    # final leaky uses torch's DEFAULT slope 0.01 (reference models.py:107)
    x = leaky_relu(x, 0.01)
    x = conv_ops.conv1d(x, model.conv_post.weight_in(dt),
                        model.conv_post.bias_in(dt), padding=3)
    x = torch.tanh(x)
    return x.float() if x.dtype == torch.bfloat16 else x


def _fuses(model: CodeGenerator, i: int, quant: bool) -> bool:
    """Whether stage i takes the fused route: the stages the JAX package
    fuses (fused_mrf=True, ResBlock1, fewer than 128 channels) with weight
    norm folded, unless its MRF runs int8 (quant), which supersedes the
    fused kernel as in the JAX package."""
    cfg = model.cfg
    return (not quant and cfg.fused_mrf and cfg.resblock == "1"
            and (cfg.upsample_initial_channel // 2 ** (i + 1)
                 < FUSED_BELOW_CHANNELS)
            and not hasattr(model.conv_pre, "weight_v"))


def _mrf_stage_fused(model: CodeGenerator, i: int, x: torch.Tensor,
                     quant: bool) -> torch.Tensor | None:
    """Stage i's whole MRF in one kernel (`ops/fused_mrf.py`) on its packed
    weights; None (the caller runs the composition) where `_fuses` says
    no."""
    if not _fuses(model, i, quant):
        return None
    if i not in model.mrf_plans:
        raise RuntimeError("fused_mrf=True: pack the fused stages with "
                           "model.pack_fused_mrf() once the weights are "
                           "loaded")
    c, width = x.shape[-1], model.mrf_plans[i].channels
    if width != c:
        x = F.pad(x, (0, width - c))
    y = fused_mrf.mrf_fused(x.contiguous(), getattr(model, f"mrf_w{i}"),
                            getattr(model, f"mrf_b{i}"), model.mrf_plans[i],
                            wk=getattr(model, f"mrf_k{i}"))
    return y if width == c else y[..., :c]


def pack_stage(model: CodeGenerator, i: int):
    """Stage i's ResBlock1 convs as `fused_mrf.pack_mrf` takes them, with
    zero channels up to the kernel's next multiple of 8 (a C = 4 stage
    runs at 8): padded channels have zero weights and biases, so they stay
    0 through every conv, leaky ReLU and residual add, and the stage's own
    channels come out as unpadded (`_mrf_stage_fused` pads x and slices
    the output)."""
    nk = len(model.cfg.resblock_kernel_sizes)
    c = model.resblocks[i * nk].convs1[0].bias.shape[0]
    pad = -c % fused_mrf.CHANNEL_QUANTUM

    def wb(conv):
        w = conv.kernel().permute(2, 1, 0)           # (K, Ci, Co)
        return F.pad(w, (0, pad, 0, pad)), F.pad(conv.bias, (0, pad))

    convs = [[(*wb(c1), *wb(c2)) for c1, c2 in zip(rb.convs1, rb.convs2)]
             for rb in model.resblocks[i * nk:(i + 1) * nk]]
    return fused_mrf.pack_mrf(convs, model.cfg.resblock_kernel_sizes,
                              model.cfg.resblock_dilation_sizes)


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


def embed(model: CodeGenerator, code: torch.Tensor,
          spkr: torch.Tensor | None,
          extra_feats: dict | None = None) -> torch.Tensor:
    """Code embedding, concatenated with the speaker embedding repeated
    over frames, then each conditioning feature of `extra_feats` ((B, C,
    Tc), (B, C) or (B,)) nearest-repeated to the frame axis
    (`upsample_cond`): (B, T) -> (B, T, model_in_dim). Features go in
    sorted-name order; "spkr" and "code" are skipped, and so is "f0" unless
    cfg.f0 (the reference's skip list, models.py:160-166). f0 goes in as
    raw Hz, as in the JAX package, whose checkpoints expect it."""
    x = model.dict.weight[code]                                # (B, T, E)
    if model.cfg.multispkr:
        if spkr is None:
            raise ValueError("multispeaker model needs spkr ids")
        s = model.spkr.weight[spkr.reshape(spkr.shape[0])]     # (B, E)
        x = torch.cat([x, s[:, None, :].expand_as(x)], dim=-1)
    for name in sorted(extra_feats or {}):
        if name in ("spkr", "code") or (name == "f0" and not model.cfg.f0):
            continue
        feat = upsample_cond(torch.as_tensor(extra_feats[name]).to(
            x.device, x.dtype), x.shape[1])
        x = torch.cat([x, feat.transpose(1, 2)], dim=-1)
    return x


def _code_generator(model: CodeGenerator, code: torch.Tensor,
                    spkr: torch.Tensor | None,
                    extra_feats: dict | None = None) -> torch.Tensor:
    return apply_generator(model, embed(model, code, spkr, extra_feats))


def apply_code_generator(model: CodeGenerator, code, spkr, *,
                         extra_feats: dict | None = None, exact: bool = True,
                         device=None) -> torch.Tensor:
    """code: (B, T) int unit ids; spkr: (B,) or (B, 1) int speaker ids;
    extra_feats: conditioning features by name (`embed`), e.g. {"f0": (B,
    1, T) code-rate pitch in Hz} (numpy or tensors). Returns the (B,
    T*320, 1) waveform in [-1, 1] on `device` (default: the CUDA card;
    raises without one unless device="cpu"). exact=True: IEEE float32
    convs (no TF32), deterministic cuDNN algorithms."""
    device = resolve_device(device)
    model = model.to(device)
    code = torch.as_tensor(code).to(device, torch.int64)
    if spkr is not None:
        spkr = torch.as_tensor(spkr).to(device, torch.int64)
    with torch.no_grad(), exact_numerics(exact):
        return _code_generator(model, code, spkr, extra_feats)


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
