"""HuBERT encoder for unit extraction: a port of
`parrot_tts_tpu/models/hubert/model.py` (the reference shells out to
fairseq, `utils/hubert_extraction/hubert_api.py:16-31`: one wav at a time,
layer-11 features, then sklearn k-means, `extractor.py:15-18`).

Modules are named with HF `HubertModel`'s state_dict keys, so a converted
checkpoint loads with `strict=True` and the JAX package's
`params_from_state_dict` reads this module's state. The positional conv
holds its folded weight (`convert.py::_fold_pos_conv`). Inference only.

Batches of zero-padded wavs give the features of each wav at its exact
length: the conv frontend is position-local; the one non-local frontend
op, GroupNorm over time in conv layer 0, takes its statistics over each
wav's valid frames only; padded frames are zeroed before the positional
conv (the zeros an exact-length conv pads with) and masked out of
attention as keys.

Layout: NCW through the conv frontend, (B, T, C) through the transformer.
Attention is a plain matmul and masked softmax in the module's dtype, as
the JAX `_attention`; run it under `exact_numerics(True)` (as
`apply_hubert` and the extractor do) for IEEE float32, since a TF32
feature flips the nearest centroid on near-ties.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from parrot_tts_tpu_torch.core.config import HubertConfig
from parrot_tts_tpu_torch.core.device import exact_numerics, resolve_device

NEG_INF = float(np.finfo(np.float32).min)   # the mask fill, as in JAX


def feat_extract_output_length(cfg: HubertConfig, n_samples):
    """Frame count the conv frontend yields for `n_samples` (an int or an
    integer tensor): L' = (L - k) // s + 1 per conv, and 0, not the
    formula's -1, for a wav shorter than one frame."""
    n = n_samples
    for k, s in zip(cfg.conv_kernel, cfg.conv_stride):
        n = (n - k) // s + 1
    return n.clamp(min=0) if isinstance(n, torch.Tensor) else max(n, 0)


class _ConvLayer(nn.Module):
    def __init__(self, c_in: int, c_out: int, k: int, s: int, bias: bool,
                 norm: bool):
        super().__init__()
        self.conv = nn.Conv1d(c_in, c_out, k, stride=s, bias=bias)
        # the affine of GroupNorm(C, C) ("group", layer 0) or of the
        # per-frame channel LayerNorm ("layer"); HF names both layer_norm
        if norm:
            self.layer_norm = nn.LayerNorm(c_out)


class _FeatureExtractor(nn.Module):
    def __init__(self, cfg: HubertConfig):
        super().__init__()
        c_in, layers = 1, []
        for i, (c, k, s) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel,
                                          cfg.conv_stride)):
            norm = (cfg.feat_extract_norm == "layer"
                    or (cfg.feat_extract_norm == "group" and i == 0))
            layers.append(_ConvLayer(c_in, c, k, s, cfg.conv_bias, norm))
            c_in = c
        self.conv_layers = nn.ModuleList(layers)


class _FeatureProjection(nn.Module):
    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg.conv_dim[-1],
                                       eps=cfg.layer_norm_eps)
        self.projection = nn.Linear(cfg.conv_dim[-1], cfg.d_model)


class _PosConv(nn.Module):
    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.conv = nn.Conv1d(cfg.d_model, cfg.d_model, cfg.pos_conv_kernel,
                              padding=cfg.pos_conv_kernel // 2,
                              groups=cfg.pos_conv_groups)


class _Attention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.q_proj, self.k_proj = nn.Linear(d, d), nn.Linear(d, d)
        self.v_proj, self.out_proj = nn.Linear(d, d), nn.Linear(d, d)


class _FeedForward(nn.Module):
    def __init__(self, d: int, f: int):
        super().__init__()
        self.intermediate_dense = nn.Linear(d, f)
        self.output_dense = nn.Linear(f, d)


class _Layer(nn.Module):
    def __init__(self, cfg: HubertConfig):
        super().__init__()
        d, eps = cfg.d_model, cfg.layer_norm_eps
        self.attention = _Attention(d)
        self.layer_norm = nn.LayerNorm(d, eps=eps)
        self.feed_forward = _FeedForward(d, cfg.ffn_dim)
        self.final_layer_norm = nn.LayerNorm(d, eps=eps)


class _Encoder(nn.Module):
    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.pos_conv_embed = _PosConv(cfg)
        self.layer_norm = nn.LayerNorm(cfg.d_model, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(_Layer(cfg) for _ in range(cfg.n_layer))


class HubertModel(nn.Module):
    """The HuBERT encoder under HF `HubertModel`'s state_dict keys."""

    def __init__(self, cfg: HubertConfig):
        super().__init__()
        if cfg.feat_extract_norm not in ("group", "layer", "none"):
            raise ValueError(
                f"feat_extract_norm {cfg.feat_extract_norm!r} not in "
                "('group', 'layer', 'none')")
        if cfg.dtype != "float32":
            raise ValueError(
                f"HubertConfig.dtype={cfg.dtype!r}: the port extracts in "
                "float32. The JAX package's bfloat16 extraction does not "
                "run: its masked GroupNorm multiplies by the float32 scale, "
                "which promotes x to float32, so it raises a TypeError at "
                "the second conv (a float32 input, a bfloat16 weight; "
                "parrot_tts_tpu/models/hubert/model.py:125-135, 206-207)")
        self.cfg = cfg
        self.feature_extractor = _FeatureExtractor(cfg)
        self.feature_projection = _FeatureProjection(cfg)
        self.encoder = _Encoder(cfg)

    def forward(self, wav: torch.Tensor, n_samples: torch.Tensor,
                output_layer: int | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """Features of transformer layer `output_layer` (1-based, fairseq
        `extract_features(output_layer=...)`), default cfg.output_layer.

        wav: (B, S), zero-padded; n_samples: (B,) true sample counts.
        Returns (features (B, T, D), n_frames (B,)); frames at or past
        n_frames[i] are not features of wav i."""
        cfg = self.cfg
        layer = cfg.output_layer if output_layer is None else output_layer
        if not 1 <= layer <= cfg.n_layer:
            raise ValueError(f"output_layer {layer} not in [1, {cfg.n_layer}]")
        eps = cfg.layer_norm_eps
        dtype = self.encoder.layer_norm.weight.dtype
        wav = wav.to(dtype)
        n_valid = n_samples.to(wav.device, torch.int64)
        if cfg.normalize_input:
            wav = masked_wav_layer_norm(wav, n_valid)

        x = wav[:, None, :]                                   # (B, 1, S)
        for i, (k, s) in enumerate(zip(cfg.conv_kernel, cfg.conv_stride)):
            lp = self.feature_extractor.conv_layers[i]
            x = lp.conv(x)
            n_valid = (n_valid - k) // s + 1
            if cfg.feat_extract_norm == "group" and i == 0:
                x = _masked_group_norm(x, lp.layer_norm, n_valid, eps)
            elif cfg.feat_extract_norm == "layer":
                x = F.layer_norm(x.transpose(1, 2), x.shape[1:2],
                                 lp.layer_norm.weight, lp.layer_norm.bias,
                                 eps).transpose(1, 2)
            x = F.gelu(x)
        x = x.transpose(1, 2)                                 # (B, T, C)

        fp = self.feature_projection
        x = fp.projection(F.layer_norm(x, x.shape[-1:], fp.layer_norm.weight,
                                       fp.layer_norm.bias, eps))
        frames = torch.arange(x.shape[1], device=x.device)[None, :]
        frame_mask = frames < n_valid[:, None]                # (B, T)
        x = x * frame_mask[..., None].to(dtype)
        pos = self.encoder.pos_conv_embed.conv(x.transpose(1, 2))
        if cfg.pos_conv_kernel % 2 == 0:   # HF SamePadLayer: drop the last
            pos = pos[:, :, :-1]
        x = x + F.gelu(pos).transpose(1, 2)
        enc = self.encoder
        x = F.layer_norm(x, x.shape[-1:], enc.layer_norm.weight,
                         enc.layer_norm.bias, eps)
        for lp in enc.layers[:layer]:
            x = lp.layer_norm(x + _attention(x, lp.attention, cfg.n_head,
                                             frame_mask))
            ff = lp.feed_forward
            x = lp.final_layer_norm(
                x + ff.output_dense(F.gelu(ff.intermediate_dense(x))))
        return x, n_valid.clamp(min=0)


def _masked_group_norm(x: torch.Tensor, affine: nn.LayerNorm,
                       n_valid: torch.Tensor, eps: float) -> torch.Tensor:
    """GroupNorm(C, C) of x (B, C, T): per-channel statistics over time,
    taken over each row's first n_valid frames only (nn.GroupNorm cannot
    mask); frames past them come out zero."""
    m = (torch.arange(x.shape[-1], device=x.device)[None, :]
         < n_valid[:, None]).to(x.dtype)[:, None, :]           # (B, 1, T)
    n = m.sum(dim=-1, keepdim=True).clamp(min=1.0)
    mu = (x * m).sum(dim=-1, keepdim=True) / n
    var = ((x - mu).square() * m).sum(dim=-1, keepdim=True) / n
    return ((x - mu) * torch.rsqrt(var + eps) * affine.weight[:, None]
            + affine.bias[:, None]) * m


def masked_wav_layer_norm(wav: torch.Tensor, n_samples: torch.Tensor,
                          eps: float = 1e-5) -> torch.Tensor:
    """F.layer_norm(x, x.shape) over the valid samples of each padded wav
    (reference hubert_api.py:55-56, task.cfg.normalize); padding stays 0."""
    m = (torch.arange(wav.shape[-1], device=wav.device)[None, :]
         < n_samples[:, None]).to(wav.dtype)
    n = m.sum(dim=-1, keepdim=True).clamp(min=1.0)
    mu = (wav * m).sum(dim=-1, keepdim=True) / n
    var = ((wav - mu).square() * m).sum(dim=-1, keepdim=True) / n
    return (wav - mu) * torch.rsqrt(var + eps) * m


def _attention(x: torch.Tensor, at: _Attention, n_head: int,
               key_mask: torch.Tensor) -> torch.Tensor:
    """Post-LN HF / fairseq MHA with biases; key_mask (B, T) True = valid.
    Masked scores take float32's min, not -inf, as in the JAX package."""
    b, t, d = x.shape
    dh = d // n_head

    def heads(lin):
        return lin(x).reshape(b, t, n_head, dh).transpose(1, 2)

    q = heads(at.q_proj) * (1.0 / math.sqrt(dh))
    s = q @ heads(at.k_proj).transpose(-1, -2)               # (B, H, T, T)
    s = s.masked_fill(~key_mask[:, None, None, :], NEG_INF)
    o = torch.softmax(s, dim=-1) @ heads(at.v_proj)
    return at.out_proj(o.transpose(1, 2).reshape(b, t, d))


def apply_hubert(model: HubertModel, wav, n_samples, *,
                 output_layer: int | None = None,
                 device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """`model`'s features of a padded batch (numpy or tensors) on `device`
    (default: the CUDA card; raises without one unless device="cpu"), in
    IEEE float32 matmuls and convolutions (no TF32) with deterministic
    cuDNN algorithms, as the extractor runs it."""
    device = resolve_device(device)
    model = model.to(device)
    wav = torch.as_tensor(wav).to(device)
    n_samples = torch.as_tensor(n_samples).to(device, torch.int64)
    with torch.no_grad(), exact_numerics(True):
        return model(wav, n_samples, output_layer)


def kmeans_distances(feats: torch.Tensor, centers: torch.Tensor
                     ) -> torch.Tensor:
    """Squared euclidean distance of every frame to every center, as one
    matmul: x^2 - 2 x.c + c^2, (..., D) x (K, D) -> (..., K)."""
    x2 = feats.square().sum(dim=-1, keepdim=True)
    c2 = centers.square().sum(dim=-1)
    return x2 - 2.0 * (feats @ centers.T) + c2


def kmeans_predict(feats: torch.Tensor, centers: torch.Tensor
                   ) -> torch.Tensor:
    """Nearest center of each frame: sklearn `KMeans.predict`; on ties the
    lowest index, as torch.argmin, sklearn and jnp.argmin all give."""
    return torch.argmin(kmeans_distances(feats, centers), dim=-1)


def init_hubert(cfg: HubertConfig, gen: torch.Generator) -> dict:
    """Seeded HubertModel state dict (CPU tensors) with the JAX package's
    init_hubert rules: conv and positional-conv weights N(0, 0.02^2),
    their biases and LayerNorm shifts 0, scales 1, linear layers torch's
    U(+-1/sqrt(d_in)). The numbers differ from jax.random's."""
    def normal(shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32) * 0.02

    def uniform(shape, d_in):
        b = 1.0 / math.sqrt(d_in)
        u = torch.rand(shape, generator=gen, dtype=torch.float32)
        return u * 2 * b - b

    sd = {}

    def ln(name, d):
        sd[name + ".weight"] = torch.ones(d)
        sd[name + ".bias"] = torch.zeros(d)

    def lin(name, d_in, d_out):
        sd[name + ".weight"] = uniform((d_out, d_in), d_in)
        sd[name + ".bias"] = uniform((d_out,), d_in)

    c_in = 1
    for i, (c, k) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel)):
        base = f"feature_extractor.conv_layers.{i}"
        sd[base + ".conv.weight"] = normal((c, c_in, k))
        if cfg.conv_bias:
            sd[base + ".conv.bias"] = torch.zeros(c)
        if cfg.feat_extract_norm == "layer" or (
                cfg.feat_extract_norm == "group" and i == 0):
            ln(base + ".layer_norm", c)
        c_in = c
    ln("feature_projection.layer_norm", c_in)
    lin("feature_projection.projection", c_in, cfg.d_model)
    d = cfg.d_model
    sd["encoder.pos_conv_embed.conv.weight"] = normal(
        (d, d // cfg.pos_conv_groups, cfg.pos_conv_kernel))
    sd["encoder.pos_conv_embed.conv.bias"] = torch.zeros(d)
    ln("encoder.layer_norm", d)
    for i in range(cfg.n_layer):
        base = f"encoder.layers.{i}"
        for p in ("q", "k", "v", "out"):
            lin(f"{base}.attention.{p}_proj", d, d)
        ln(base + ".layer_norm", d)
        lin(base + ".feed_forward.intermediate_dense", d, cfg.ffn_dim)
        lin(base + ".feed_forward.output_dense", cfg.ffn_dim, d)
        ln(base + ".final_layer_norm", d)
    return sd
