"""Parrot TTE model, inference path: character tokens -> HuBERT-unit codes.

Port of `parrot_tts_tpu/models/tte/parrot.py` (reference
`modules/parrot.py`). Encoder FFT stack -> (+speaker embedding) ->
duration predict / length regulate -> decoder FFT stack -> 1000-way linear
head. Masks in a batch are True = VALID; they are inverted into torch-style
True = IGNORE key-padding masks internally.

Precision: `exact=True` (the default) runs every matmul and convolution in
IEEE float32 — TF32 off for matmul and cuDNN alike — because a TF32 pass
perturbs the logits enough to flip argmax near-ties and rounded durations.
`exact=False` allows TF32. The JAX package's "selective", "selective-high"
and "hybrid" modes mix precisions by section; they are not ported until
they are gated unit-exact on the card, and raise NotImplementedError.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from parrot_tts_tpu_torch.core.config import TTEModelConfig
from parrot_tts_tpu_torch.core.device import exact_numerics, resolve_device
from parrot_tts_tpu_torch.models.tte import fft
from parrot_tts_tpu_torch.ops import conv as conv_ops
from parrot_tts_tpu_torch.ops import init as init_ops
from parrot_tts_tpu_torch.ops import length_regulator as lr_ops


def check_exact(exact) -> None:
    if exact is True or exact is False:
        return
    raise NotImplementedError(
        f"exact={exact!r}: the mixed-precision decode modes of the JAX "
        "package are not ported; use exact=True (IEEE float32) or False (TF32)")


class _ConvModule(nn.Module):
    def __init__(self, cin: int, cout: int, kernel_size: int):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, kernel_size)


class DurationPredictor(nn.Module):
    """Reference modules/duration.py:26-48; `layers` keeps the reference's
    Sequential indices (conv, relu, norm, dropout) x 2."""

    def __init__(self, d_model: int, n_filter: int, kernel_size: int,
                 dropout_p: float = 0.5):
        super().__init__()
        self.kernel_size = kernel_size
        self.layers = nn.ModuleList([
            _ConvModule(d_model, n_filter, kernel_size), nn.ReLU(),
            nn.LayerNorm(n_filter), nn.Dropout(dropout_p),
            _ConvModule(n_filter, n_filter, kernel_size), nn.ReLU(),
            nn.LayerNorm(n_filter), nn.Dropout(dropout_p),
        ])
        self.proj = nn.Linear(n_filter, 1)


def apply_duration_predictor(dp: DurationPredictor, x: torch.Tensor,
                             pad_mask: torch.Tensor,
                             cfg: TTEModelConfig) -> torch.Tensor:
    """Log-duration prediction; pad_mask True = PAD, padded outputs 0.
    Reference quirk (duration.py:34): conv2 hardcodes padding=1 whatever
    the kernel size (under cfg.reference_compat)."""
    ks = dp.kernel_size
    valid = (~pad_mask)[:, :, None].to(x.dtype)
    c1, ln1, c2, ln2 = (dp.layers[0].conv, dp.layers[2], dp.layers[4].conv,
                        dp.layers[6])
    h = conv_ops.conv1d(x * valid, c1.weight, c1.bias, padding=(ks - 1) // 2)
    h = fft.layer_norm(torch.relu(h), ln1.weight, ln1.bias)
    pad2 = 1 if cfg.reference_compat else (ks - 1) // 2
    h = conv_ops.conv1d(h * valid, c2.weight, c2.bias, padding=pad2)
    h = fft.layer_norm(torch.relu(h), ln2.weight, ln2.bias)
    out = torch.nn.functional.linear(h, dp.proj.weight, dp.proj.bias)[..., 0]
    return torch.where(pad_mask, 0.0, out)


def pos_table(cfg: TTEModelConfig) -> np.ndarray:
    """PE table padded to a multiple of 128 rows, so decoder buckets such
    as 3584 > max_len 3500 still index valid rows; rows beyond max_len only
    ever position padded frames."""
    return fft.sinusoidal_pos_table(-(-cfg.max_len // 128) * 128, cfg.d_model)


class Parrot(nn.Module):
    """The TTE. `folded=True` builds the serving form whose attention has
    no qkv / wo (load a `fold_tte_params` state dict into it)."""

    def __init__(self, cfg: TTEModelConfig, *, folded: bool = False):
        super().__init__()
        self.cfg = cfg
        self.tok_emb = nn.Embedding(cfg.vocab_size, cfg.d_model,
                                    padding_idx=cfg.pad_idx)
        if cfg.n_speaker > 1:
            self.speaker_emb = nn.Embedding(cfg.n_speaker, cfg.d_model)
        self.encoder_layers = nn.ModuleList(
            fft.FFTBlock(cfg.d_model, cfg.encoder.n_head, cfg.conv_n_filter,
                         cfg.conv_kernel_sizes, folded=folded)
            for _ in range(cfg.encoder.n_layer))
        self.decoder_layers = nn.ModuleList(
            fft.FFTBlock(cfg.d_model, cfg.decoder.n_head, cfg.conv_n_filter,
                         cfg.conv_kernel_sizes, folded=folded)
            for _ in range(cfg.decoder.n_layer))
        self.duration_predictor = DurationPredictor(
            cfg.d_model, cfg.dur_n_filter, cfg.dur_kernel_size,
            cfg.dur_dropout_p)
        self.head = nn.Linear(cfg.d_model, cfg.hubert_codes)
        self.register_buffer("pe", torch.from_numpy(pos_table(cfg)),
                             persistent=False)

    def forward(self, batch: dict, *, out_len: int):
        return apply_parrot(self, batch, out_len=out_len)


def init_parrot(cfg: TTEModelConfig, gen: torch.Generator) -> dict:
    """Seeded unfolded `Parrot` state dict (CPU tensors), with the shapes
    and fan-in rules of the JAX package's `init_parrot`."""
    d, nf, nd = cfg.d_model, cfg.conv_n_filter, cfg.dur_n_filter
    ks1, ks2 = cfg.conv_kernel_sizes
    dks = cfg.dur_kernel_size
    ku, ufi = init_ops.kaiming_uniform, init_ops.uniform_fan_in
    sd = {
        "tok_emb.weight": init_ops.embedding(gen, (cfg.vocab_size, d),
                                             padding_idx=cfg.pad_idx),
        "duration_predictor.layers.0.conv.weight": ku(gen, (nd, d, dks), d * dks),
        "duration_predictor.layers.0.conv.bias": ufi(gen, (nd,), d * dks),
        "duration_predictor.layers.2.weight": torch.ones(nd),
        "duration_predictor.layers.2.bias": torch.zeros(nd),
        "duration_predictor.layers.4.conv.weight": ku(gen, (nd, nd, dks), nd * dks),
        "duration_predictor.layers.4.conv.bias": ufi(gen, (nd,), nd * dks),
        "duration_predictor.layers.6.weight": torch.ones(nd),
        "duration_predictor.layers.6.bias": torch.zeros(nd),
        "duration_predictor.proj.weight": ku(gen, (1, nd), nd),
        "duration_predictor.proj.bias": ufi(gen, (1,), nd),
        "head.weight": ku(gen, (cfg.hubert_codes, d), d),
        "head.bias": ufi(gen, (cfg.hubert_codes,), d),
    }
    stacks = (("encoder_layers", cfg.encoder.n_layer),
              ("decoder_layers", cfg.decoder.n_layer))
    for name, n in stacks:
        for i in range(n):
            p = f"{name}.{i}"
            sd.update({
                f"{p}.attention.qkv.weight": ku(gen, (3 * d, d), d),
                f"{p}.attention.mha.in_proj_weight":
                    init_ops.xavier_uniform(gen, (3 * d, d), d, 3 * d),
                f"{p}.attention.mha.out_proj.weight": ku(gen, (d, d), d),
                f"{p}.attention.wo.weight": ku(gen, (d, d), d),
                f"{p}.convlayer.conv1.weight": ku(gen, (nf, d, ks1), d * ks1),
                f"{p}.convlayer.conv1.bias": ufi(gen, (nf,), d * ks1),
                f"{p}.convlayer.conv2.weight": ku(gen, (d, nf, ks2), nf * ks2),
                f"{p}.convlayer.conv2.bias": ufi(gen, (d,), nf * ks2),
                f"{p}.attn_norm.weight": torch.ones(d),
                f"{p}.attn_norm.bias": torch.zeros(d),
                f"{p}.conv_norm.weight": torch.ones(d),
                f"{p}.conv_norm.bias": torch.zeros(d),
            })
    if cfg.n_speaker > 1:
        sd["speaker_emb.weight"] = init_ops.embedding(gen, (cfg.n_speaker, d))
    return sd


def apply_parrot(model: Parrot, batch: dict, *, out_len: int):
    """Inference forward (reference parrot.py:90-120 with predicted
    durations). batch: phones (B, S) int, src_mask (B, S) bool True=valid,
    speaker (B,) int, all on the model's device. out_len: decoder length
    (bucket >= total duration). Returns (logits (B, out_len, n_codes),
    tgt_mask (B, out_len) True=valid, log_dur_pred (B, S))."""
    cfg = model.cfg
    pe = model.pe
    src_mask = batch["src_mask"]
    src_pad = ~src_mask
    src_lengths = src_mask.sum(dim=1)

    x = model.tok_emb.weight[batch["phones"]]
    x = fft.add_pos_emb(x, pe, src_lengths,
                        reference_compat=cfg.reference_compat)
    x = x * src_mask[:, :, None].to(x.dtype)   # pads stay batch-invariant
    for blk in model.encoder_layers:
        x = fft.apply_fft_block(blk, x, key_padding_mask=src_pad)
    if cfg.n_speaker > 1:
        x = x + model.speaker_emb.weight[batch["speaker"]][:, None, :]
        x = x * src_mask[:, :, None].to(x.dtype)
    log_dur_pred = apply_duration_predictor(model.duration_predictor, x,
                                            src_pad, cfg)

    durations = torch.where(src_mask,
                            lr_ops.durations_from_log_pred(log_dur_pred), 0)
    # exclusive mask: the decode covers exactly sum(dur) frames (the
    # reference's canonical batch-1 decode)
    x, tgt_mask = lr_ops.length_regulator(x, durations, out_len)
    total = durations.sum(dim=1)
    x = fft.add_pos_emb(x, pe, total.clamp(0, cfg.max_len - 1),
                        reference_compat=cfg.reference_compat)
    x = x * tgt_mask[:, :, None].to(x.dtype)
    for blk in model.decoder_layers:
        x = fft.apply_fft_block(blk, x, key_padding_mask=~tgt_mask)
    logits = torch.nn.functional.linear(x, model.head.weight, model.head.bias)
    return logits, tgt_mask, log_dur_pred


def to_batch(batch: dict, device: torch.device) -> dict:
    """phones / src_mask / speaker (numpy or tensors) -> tensors on device."""
    dtypes = {"phones": torch.int64, "src_mask": torch.bool,
              "speaker": torch.int64}
    return {k: torch.as_tensor(batch[k]).to(device, dt)
            for k, dt in dtypes.items()}


def infer_codes(model: Parrot, batch: dict, *, out_len: int,
                exact: bool = True, device=None):
    """Greedy decode (reference parrot.py:112-120). Returns (codes
    (B, out_len), mask True=valid, total (B,) = sum of predicted durations)
    on `device` (default: the CUDA card; raises without one unless
    device="cpu"). `total > out_len` means the bucket overflowed and the
    caller re-decodes in a larger one (infer/tte_infer.py does)."""
    check_exact(exact)
    device = resolve_device(device)
    model = model.to(device)
    batch = to_batch(batch, device)
    with torch.no_grad(), exact_numerics(exact):
        logits, tgt_mask, log_dur = apply_parrot(model, batch, out_len=out_len)
        durations = torch.where(batch["src_mask"],
                                lr_ops.durations_from_log_pred(log_dur), 0)
    return logits.argmax(dim=-1), tgt_mask, durations.sum(dim=1)
