"""Carry the JAX package's parameter trees into the port's state dicts.

Each function takes a tree of numpy arrays in the JAX package's unfolded
training form (TTE attention `qkv / in_proj / out_proj / wo`, vocoder
weight norm `{g, v}`) in its (K, Cin, Cout) / (in, out) layouts and returns
a state dict under the reference's keys, in torch layouts, that the port's
modules load with `strict=True`. It is the inverse of the JAX package's
`models/tte/convert.py::params_from_torch` and
`models/vocoder/convert.py::generator_params_from_torch`.

`aligner_state_from_jax` carries the JAX aligner's params and BN state
(`init_aligner` / `params_from_torch`) into `Aligner`: the summed LSTM
bias goes to `bias_ih`, zeros to `bias_hh`, the running statistics to the
BN buffers.

`hubert_state_from_jax` carries a JAX HuBERT tree (`init_hubert` /
`params_from_state_dict`, positional conv folded) into `HubertModel`.

`vocoder_train_state_from_jax` also carries a JAX GAN training state
(generator, MPD, MSD with its spectral-norm vectors, both AdamW optimizers'
moments and the step) into the port's trainer (`train/vocoder.py`), so
both packages can take a step from the same numbers. The TTE's optimizer
state is not carried across. The vocoder's int8 serving modes need nothing
more: their int8 weights are derived from the float state
(`CodeGenerator.pack_int8`, `generator_staticq.quantize_generator`), and
the int8 GEMM of `ops/qconv.py` has no weights.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from parrot_tts_tpu_torch.core.config import (HubertConfig, TTEModelConfig,
                                              VocoderModelConfig)


def _t(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x), dtype=torch.float32)


def _linear(w) -> torch.Tensor:
    """(in, out) -> torch (out, in)."""
    return _t(np.asarray(w).T)


def _conv1d(w) -> torch.Tensor:
    """(K, Cin, Cout) -> torch Conv1d (Cout, Cin, K)."""
    return _t(np.transpose(np.asarray(w), (2, 1, 0)))


def _conv_t1d(w) -> torch.Tensor:
    """(K, Cin, Cout) -> torch ConvTranspose1d (Cin, Cout, K)."""
    return _t(np.transpose(np.asarray(w), (1, 2, 0)))


def aligner_state_from_jax(params: Mapping, bn_state: Mapping) -> dict:
    """JAX `init_aligner` / `params_from_torch` (params, state) ->
    `Aligner` state dict."""
    sd = {}
    for i, (conv, bn) in enumerate(zip(params["convs"], params["bns"])):
        p = f"convs.{i}."
        st = bn_state["bns"][i]
        sd[p + "conv.weight"] = _conv1d(conv["w"])
        sd[p + "bnorm.weight"] = _t(bn["scale"])
        sd[p + "bnorm.bias"] = _t(bn["bias"])
        sd[p + "bnorm.running_mean"] = _t(st.mean)
        sd[p + "bnorm.running_var"] = _t(st.var)
        sd[p + "bnorm.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    for name, sfx in (("lstm_fw", ""), ("lstm_bw", "_reverse")):
        lp = params[name]
        sd[f"rnn.weight_ih_l0{sfx}"] = _linear(lp["w_ih"])
        sd[f"rnn.weight_hh_l0{sfx}"] = _linear(lp["w_hh"])
        sd[f"rnn.bias_ih_l0{sfx}"] = _t(lp["b"])
        sd[f"rnn.bias_hh_l0{sfx}"] = torch.zeros_like(_t(lp["b"]))
    sd["lin.weight"] = _linear(params["lin"]["w"])
    sd["lin.bias"] = _t(params["lin"]["b"])
    return sd


def tte_state_from_jax(params: Mapping, cfg: TTEModelConfig) -> dict:
    """JAX `init_parrot` / `params_from_torch` tree -> `Parrot(cfg)` state."""
    dp = params["duration_predictor"]
    sd = {
        "tok_emb.weight": _t(params["tok_emb"]),
        "duration_predictor.layers.0.conv.weight": _conv1d(dp["conv1"]["w"]),
        "duration_predictor.layers.0.conv.bias": _t(dp["conv1"]["b"]),
        "duration_predictor.layers.2.weight": _t(dp["ln1"]["scale"]),
        "duration_predictor.layers.2.bias": _t(dp["ln1"]["bias"]),
        "duration_predictor.layers.4.conv.weight": _conv1d(dp["conv2"]["w"]),
        "duration_predictor.layers.4.conv.bias": _t(dp["conv2"]["b"]),
        "duration_predictor.layers.6.weight": _t(dp["ln2"]["scale"]),
        "duration_predictor.layers.6.bias": _t(dp["ln2"]["bias"]),
        "duration_predictor.proj.weight": _linear(dp["proj"]["w"]),
        "duration_predictor.proj.bias": _t(dp["proj"]["b"]),
        "head.weight": _linear(params["head"]["w"]),
        "head.bias": _t(params["head"]["b"]),
    }
    stacks = (("encoder_layers", cfg.encoder.n_layer),
              ("decoder_layers", cfg.decoder.n_layer))
    for name, n in stacks:
        if len(params[name]) != n:
            raise ValueError(f"{name}: {len(params[name])} blocks, cfg says {n}")
        for i, blk in enumerate(params[name]):
            p, a = f"{name}.{i}", blk["attn"]
            sd.update({
                f"{p}.attention.qkv.weight": _linear(a["qkv"]),
                f"{p}.attention.mha.in_proj_weight": _linear(a["in_proj"]),
                f"{p}.attention.mha.out_proj.weight": _linear(a["out_proj"]),
                f"{p}.attention.wo.weight": _linear(a["wo"]),
                f"{p}.convlayer.conv1.weight": _conv1d(blk["conv1"]["w"]),
                f"{p}.convlayer.conv1.bias": _t(blk["conv1"]["b"]),
                f"{p}.convlayer.conv2.weight": _conv1d(blk["conv2"]["w"]),
                f"{p}.convlayer.conv2.bias": _t(blk["conv2"]["b"]),
                f"{p}.attn_norm.weight": _t(blk["attn_norm"]["scale"]),
                f"{p}.attn_norm.bias": _t(blk["attn_norm"]["bias"]),
                f"{p}.conv_norm.weight": _t(blk["conv_norm"]["scale"]),
                f"{p}.conv_norm.bias": _t(blk["conv_norm"]["bias"]),
            })
    if "speaker_emb" in params:
        sd["speaker_emb.weight"] = _t(params["speaker_emb"])
    return sd


def generator_state_from_jax(params: Mapping,
                             cfg: VocoderModelConfig) -> dict:
    """JAX `init_code_generator` / `generator_params_from_torch` tree (weight
    norm live, `{g, v, b}` per conv) -> `CodeGenerator(cfg)` state."""
    sd: dict = {}

    def wn(name, p, transposed=False):
        g = np.asarray(p["g"])
        sd[f"{name}.weight_g"] = _t(g.reshape(-1, 1, 1))
        sd[f"{name}.weight_v"] = (_conv_t1d if transposed else _conv1d)(p["v"])
        sd[f"{name}.bias"] = _t(p["b"])

    wn("conv_pre", params["conv_pre"])
    wn("conv_post", params["conv_post"])
    if len(params["ups"]) != len(cfg.upsample_rates):
        raise ValueError("upsample stage count differs from cfg")
    for i, up in enumerate(params["ups"]):
        wn(f"ups.{i}", up, transposed=True)
    for i, rb in enumerate(params["resblocks"]):
        for name in ("convs1", "convs2", "convs"):
            for j, c in enumerate(rb.get(name, ())):
                wn(f"resblocks.{i}.{name}.{j}", c)
    if "dict" in params:
        sd["dict.weight"] = _t(params["dict"])
    if "spkr" in params:
        sd["spkr.weight"] = _t(params["spkr"])
    return sd


def hubert_state_from_jax(params: Mapping, cfg: HubertConfig) -> dict:
    """JAX `init_hubert` / `params_from_state_dict` tree -> `HubertModel(cfg)`
    state (HF keys). A conv bias the JAX tree holds where cfg.conv_bias is
    False (its init gives "layer" extractors one) must be zero, and is left
    out."""
    sd: dict = {}

    def lin(name, p):
        sd[name + ".weight"], sd[name + ".bias"] = _linear(p["w"]), _t(p["b"])

    def ln(name, p):
        sd[name + ".weight"] = _t(p["scale"])
        sd[name + ".bias"] = _t(p["bias"])

    for i, lp in enumerate(params["conv_layers"]):
        base = f"feature_extractor.conv_layers.{i}"
        sd[base + ".conv.weight"] = _conv1d(lp["w"])
        if cfg.conv_bias:
            sd[base + ".conv.bias"] = _t(lp["b"])
        elif "b" in lp and np.any(np.asarray(lp["b"])):
            raise ValueError(f"conv layer {i} has a bias; cfg.conv_bias "
                             "is False")
        if "norm" in lp:
            ln(base + ".layer_norm", lp["norm"])
    ln("feature_projection.layer_norm", params["fp_ln"])
    lin("feature_projection.projection", params["fp_proj"])
    sd["encoder.pos_conv_embed.conv.weight"] = _conv1d(params["pos_conv"]["w"])
    sd["encoder.pos_conv_embed.conv.bias"] = _t(params["pos_conv"]["b"])
    ln("encoder.layer_norm", params["enc_ln"])
    for i, lp in enumerate(params["layers"]):
        base = f"encoder.layers.{i}"
        for key, proj in (("q", "q"), ("k", "k"), ("v", "v"), ("o", "out")):
            lin(f"{base}.attention.{proj}_proj", lp[key])
        ln(base + ".layer_norm", lp["attn_ln"])
        lin(base + ".feed_forward.intermediate_dense", lp["fc1"])
        lin(base + ".feed_forward.output_dense", lp["fc2"])
        ln(base + ".final_layer_norm", lp["final_ln"])
    return sd


def _conv2d(w) -> torch.Tensor:
    """(Kh, Kw, Cin, Cout) -> torch Conv2d (Cout, Cin, Kh, Kw)."""
    return _t(np.transpose(np.asarray(w), (3, 2, 0, 1)))


def _norm_conv(sd: dict, name: str, p: Mapping, to_torch) -> None:
    """A weight-normed {g, v, b} or spectral-normed {w, u, sn_v, b} conv
    under the reference's keys."""
    if "u" in p:
        sd[f"{name}.weight_orig"] = to_torch(p["w"])
        sd[f"{name}.weight_u"] = _t(p["u"])
        sd[f"{name}.weight_v"] = _t(p["sn_v"])
    else:
        sd[f"{name}.weight_g"] = _t(np.asarray(p["g"]).reshape(
            -1, *(1,) * (np.ndim(p["v"]) - 1)))
        sd[f"{name}.weight_v"] = to_torch(p["v"])
    sd[f"{name}.bias"] = _t(p["b"])


def _discriminators_state(params: Mapping, n: int, to_torch) -> dict:
    if len(params["discriminators"]) != n:
        raise ValueError(f"{len(params['discriminators'])} discriminators, "
                         f"expected {n}")
    sd: dict = {}
    for i, d in enumerate(params["discriminators"]):
        for j, c in enumerate(d["convs"]):
            _norm_conv(sd, f"discriminators.{i}.convs.{j}", c, to_torch)
        _norm_conv(sd, f"discriminators.{i}.conv_post", d["conv_post"],
                   to_torch)
    return sd


def mpd_state_from_jax(params: Mapping) -> dict:
    """JAX `init_mpd` / `mpd_params_from_torch` tree ->
    `MultiPeriodDiscriminator()` state."""
    return _discriminators_state(params, 5, _conv2d)


def msd_state_from_jax(params: Mapping) -> dict:
    """JAX `init_msd` / `msd_params_from_torch` tree (scale 0 with its
    power-iteration vectors u, sn_v) -> `MultiScaleDiscriminator()` state."""
    return _discriminators_state(params, 3, _conv1d)


def _adam_moments(opt_state, step: int) -> tuple:
    """(mu, nu) of an optax adamw chain state whose counts are `step`."""
    counts = {int(np.asarray(part.count)) for part in opt_state
              if "count" in getattr(part, "_fields", ())}
    if counts != {step}:
        raise ValueError(f"optimizer counts {sorted(counts)} differ from "
                         f"the step {step}")
    for part in opt_state:
        if hasattr(part, "mu"):
            return part.mu, part.nu
    raise ValueError("no scale_by_adam state in the optimizer state")


def _sn_buffer(key: str, sd: Mapping) -> bool:
    """Whether a state key is a spectral-norm power-iteration buffer."""
    base = key.rsplit(".", 1)[0]
    return key.endswith(".weight_u") or (key.endswith(".weight_v")
                                         and f"{base}.weight_orig" in sd)


def vocoder_train_state_from_jax(state, cfg: VocoderModelConfig) -> dict:
    """JAX `train/vocoder.py::VocoderTrainState` (numpy or jax leaves) ->
    the port's `VocoderTrainState.state_dict()` form: the three networks'
    state dicts, the AdamW moments keyed by parameter name (the
    discriminators' as "mpd.<name>" / "msd.<name>"; optax's moments of the
    spectral-norm vectors are dropped, since the port keeps those vectors
    out of the optimizer) and the step."""
    out = {"gen": generator_state_from_jax(state.gen_params, cfg),
           "mpd": mpd_state_from_jax(state.mpd_params),
           "msd": msd_state_from_jax(state.msd_params),
           "step": int(np.asarray(state.step))}
    for name, g_tree, d_tree in zip(("mu", "nu"),
                                    _adam_moments(state.opt_g_state,
                                                  out["step"]),
                                    _adam_moments(state.opt_d_state,
                                                  out["step"])):
        out[f"{name}_g"] = generator_state_from_jax(g_tree, cfg)
        d = {f"mpd.{k}": v for k, v in mpd_state_from_jax(d_tree[0]).items()}
        msd = msd_state_from_jax(d_tree[1])
        d.update({f"msd.{k}": v for k, v in msd.items()
                  if not _sn_buffer(k, msd)})
        out[f"{name}_d"] = d
    return out
