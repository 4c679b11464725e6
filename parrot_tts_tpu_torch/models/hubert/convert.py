"""Load pretrained HuBERT weights and k-means codebooks into the port: a
copy of the loader pieces of `parrot_tts_tpu/models/hubert/convert.py`,
returning a `HubertModel` in place of a JAX tree.

Two state-dict naming schemes are accepted:

* **fairseq** HuBERT (what the reference loads,
  `utils/hubert_extraction/hubert_api.py:18-24`): keys like
  `encoder.layers.0.self_attn.k_proj.weight`, `post_extract_proj.*`,
  `encoder.pos_conv.0.weight_g`. A raw fairseq `.pt` stores the tensors
  under ["model"]; its pickled config needs fairseq classes, so
  `load_torch_state_dict` falls back to a lenient unpickler that keeps
  only the tensor payload.
* **HuggingFace** `HubertModel`: `encoder.layers.0.attention.k_proj.weight`,
  `feature_projection.projection.*`, including torch >= 2.1's
  `parametrizations.weight.original{0,1}` weight-norm names.

The positional conv's weight norm (torch `weight_norm(conv, dim=2)`) is
folded at load time. K-means: the reference `joblib.load`s an sklearn
model (`extractor.py:13`); `load_kmeans_centers` takes that pickle
(joblib imported only then), or a raw `.npy` / `.npz` of centers.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Mapping

import numpy as np
import torch

from parrot_tts_tpu_torch.core.config import HubertConfig
from parrot_tts_tpu_torch.models.hubert.model import HubertModel


def _np(v) -> np.ndarray:
    return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)


def load_torch_state_dict(path: str | Path) -> dict:
    """Tensor payload of a checkpoint: HF pytorch_model.bin, safetensors,
    or a fairseq checkpoint (tensors under ["model"])."""
    path = Path(path)
    if path.suffix == ".safetensors":
        from safetensors.torch import load_file

        return dict(load_file(str(path)))
    try:
        obj = torch.load(str(path), map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        # fairseq checkpoints pickle omegaconf configs; skip everything
        # that is not a tensor rather than import fairseq
        obj = torch.load(str(path), map_location="cpu", weights_only=False,
                         pickle_module=_LenientPickle)
    if isinstance(obj, dict):
        for key in ("model", "state_dict"):
            if key in obj and isinstance(obj[key], dict):
                obj = obj[key]
                break
    return {k: v for k, v in obj.items() if hasattr(v, "shape")}


def _ignore(self, *args, **kwargs) -> None:
    pass


class _LenientPickle:
    """pickle shim: classes that do not resolve (fairseq, omegaconf) become
    inert stubs so the tensor payload still loads."""

    class Unpickler(pickle.Unpickler):
        def find_class(self, module, name):
            try:
                return super().find_class(module, name)
            except (ImportError, AttributeError):
                return type(name, (), {"__init__": _ignore,
                                       "__setstate__": _ignore})

    @staticmethod
    def load(*a, **kw):
        return _LenientPickle.Unpickler(*a, **kw).load()


def config_from_state_dict(sd: Mapping) -> HubertConfig:
    """The HubertConfig topology of a state dict in either naming."""
    sd = _normalize_keys(sd)
    conv_dim, conv_kernel, conv_stride = [], [], []
    default_strides = (5, 2, 2, 2, 2, 2, 2)
    i = 0
    while f"feature_extractor.conv_layers.{i}.conv.weight" in sd:
        w = _np(sd[f"feature_extractor.conv_layers.{i}.conv.weight"])
        conv_dim.append(int(w.shape[0]))
        conv_kernel.append(int(w.shape[2]))
        conv_stride.append(default_strides[i] if i < len(default_strides)
                           else 2)
        i += 1
    n_layer = 0
    while f"encoder.layers.{n_layer}.attention.k_proj.weight" in sd:
        n_layer += 1
    d_model = int(_np(sd["feature_projection.projection.weight"]).shape[0])
    ffn = int(_np(sd["encoder.layers.0.feed_forward.intermediate_dense."
                     "weight"]).shape[0])
    has_l0_norm = "feature_extractor.conv_layers.0.layer_norm.weight" in sd
    has_l1_norm = "feature_extractor.conv_layers.1.layer_norm.weight" in sd
    for cand in ("encoder.pos_conv_embed.conv.weight_v",
                 "encoder.pos_conv_embed.conv.weight"):
        if cand in sd:
            pos_w = _np(sd[cand])
            break
    else:
        raise ValueError("positional conv weights not found")
    return HubertConfig(
        conv_dim=tuple(conv_dim), conv_kernel=tuple(conv_kernel),
        conv_stride=tuple(conv_stride),
        conv_bias="feature_extractor.conv_layers.0.conv.bias" in sd,
        feat_extract_norm=("layer" if has_l1_norm
                           else ("group" if has_l0_norm else "none")),
        d_model=d_model, n_layer=n_layer,
        n_head={768: 12, 1024: 16}.get(d_model, max(1, d_model // 64)),
        ffn_dim=ffn, pos_conv_kernel=int(pos_w.shape[2]),
        pos_conv_groups=d_model // int(pos_w.shape[1]),
    )


_FAIRSEQ_MAP = (
    # (fairseq fragment, HF fragment) applied in order
    (".self_attn.", ".attention."),
    (".self_attn_layer_norm.", ".layer_norm."),
    (".fc1.", ".feed_forward.intermediate_dense."),
    (".fc2.", ".feed_forward.output_dense."),
    ("encoder.pos_conv.0.", "encoder.pos_conv_embed.conv."),
)


def _normalize_keys(sd: Mapping) -> dict:
    """fairseq / old-HF naming -> HF HubertModel naming (weight norm as
    weight_g / weight_v); pretraining-only tensors dropped."""
    out = {}
    for k, v in sd.items():
        k = k.removeprefix("hubert.").removeprefix("model.")
        if k.startswith(("label_embs", "final_proj", "mask_emb",
                         "masked_spec_embed", "quantizer", "project_q")):
            continue
        if k.startswith("post_extract_proj."):
            k = k.replace("post_extract_proj.",
                          "feature_projection.projection.")
        if k.startswith("layer_norm."):
            k = k.replace("layer_norm.", "feature_projection.layer_norm.", 1)
        for a, b in _FAIRSEQ_MAP:
            k = k.replace(a, b)
        # fairseq conv frontend: conv_layers.{i}.0 = conv, .2 = group norm
        if k.startswith("feature_extractor.conv_layers."):
            parts = k.split(".")
            if parts[3] == "0":
                parts[3] = "conv"
            elif parts[3] == "2":
                parts[3] = "layer_norm"
            k = ".".join(parts)
        k = k.replace("parametrizations.weight.original0", "weight_g")
        k = k.replace("parametrizations.weight.original1", "weight_v")
        out[k] = v
    return out


def _fold_pos_conv(sd: Mapping) -> torch.Tensor:
    """The positional conv's weight with weight_norm(dim=2) folded in
    float64: torch layout (Cout, Cin/groups, K), g (1, 1, K), the norm over
    (Cout, Cin) per tap."""
    base = "encoder.pos_conv_embed.conv."
    if base + "weight" in sd:
        return torch.as_tensor(_np(sd[base + "weight"]))
    g = _np(sd[base + "weight_g"]).astype(np.float64)
    v = _np(sd[base + "weight_v"]).astype(np.float64)
    norm = np.sqrt(np.sum(v * v, axis=(0, 1), keepdims=True))
    return torch.as_tensor((g * v / norm).astype(np.float32))


def state_from_state_dict(sd: Mapping) -> dict:
    """A checkpoint's state dict in either naming -> `HubertModel`'s."""
    sd = _normalize_keys(sd)
    pos = "encoder.pos_conv_embed.conv."
    out = {k: torch.as_tensor(_np(v), dtype=torch.float32)
           for k, v in sd.items() if not k.startswith(pos)}
    out[pos + "weight"] = _fold_pos_conv(sd)
    out[pos + "bias"] = torch.as_tensor(_np(sd[pos + "bias"]))
    return out


def load_hubert(path: str | Path, cfg: HubertConfig | None = None
                ) -> tuple[HubertModel, HubertConfig]:
    """A checkpoint file -> (a CPU `HubertModel` in eval mode, its
    config); the config is read from the weights unless given."""
    sd = load_torch_state_dict(path)
    if cfg is None:
        cfg = config_from_state_dict(sd)
    model = HubertModel(cfg)
    model.load_state_dict(state_from_state_dict(sd), strict=True)
    return model.eval(), cfg


def load_kmeans_centers(path: str | Path) -> np.ndarray:
    """(K, D) float32 cluster centers from a joblib sklearn k-means pickle
    (the reference's `.bin`, extractor.py:13) or a raw .npy / .npz."""
    path = Path(path)
    if path.suffix in (".npy", ".npz"):
        arr = np.load(str(path))
        if isinstance(arr, np.lib.npyio.NpzFile):
            arr = arr[arr.files[0]]
        return np.asarray(arr, np.float32)
    import joblib

    km = joblib.load(str(path))
    return np.asarray(getattr(km, "cluster_centers_", km), np.float32)
