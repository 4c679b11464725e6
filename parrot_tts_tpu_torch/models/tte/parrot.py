"""Parrot TTE model: character tokens -> HuBERT-unit codes.

Port of `parrot_tts_tpu/models/tte/parrot.py` (reference
`modules/parrot.py`). Encoder FFT stack -> (+speaker embedding) ->
duration predict / length regulate -> decoder FFT stack -> 1000-way linear
head. Masks in a batch are True = VALID; they are inverted into torch-style
True = IGNORE key-padding masks internally.

`apply_parrot` is the inference forward (predicted durations);
`apply_parrot_train` the training forward, which the JAX package runs as
`apply_parrot(..., inference=False)`: ground-truth durations and the
batch's `tgt_mask`, and, given a `(run seed, micro-step)` pair, attention
and duration-predictor dropout whose streams derive from that pair and the
site alone (`dropout_seed`), so a step is reproducible from its inputs.
Each element's draw is a function of its GLOBAL batch row: a data-parallel
shard passes `rows=(first row, global rows)` and draws the rows of the
whole batch's masks, so a step over the shards equals the step over the
global batch.

Precision (`exact`, the JAX package's modes, `parrot.py:173-344` there),
by section: the "encoder" section is the encoder stack, the duration
predictor and the 1000-way head, whose outputs pass through the rounding
of durations and the argmax; the "decoder" section is the decoder stack.
`SECTIONS` gives each mode's `ops/precision.py` mode per section:

- True (the exact decode): IEEE float32 throughout; attention on the card
  is row 1's 3xTF32 mode (ops/flash_attention.py), within 1e-5 of IEEE;
- "selective-high" (ParrotTTS's default, as in the JAX package, whose
  decoder runs 3-pass bf16 on the TPU): on the card the same as True, IEEE
  float32 in both sections, since a 3xTF32 decoder through cuBLAS / cuDNN
  was slower than IEEE and less exact (`ops/precision.py`);
- "selective": the encoder section IEEE, the decoder in 1-pass TF32 (the
  TPU's default precision) with row 1's 1-pass mode;
- False: 1-pass TF32 everywhere, attention included (row 1's 1-pass mode,
  as the JAX package's flash attention at default precision).

"hybrid" (`infer/tte_infer.py::decode_buckets` and ParrotTTS only) decodes
in "selective", reads each sample's top-2 logit margin (`code_margin`),
and decodes the samples below a threshold again in "selective-high".

Tensor parallelism (`parallel/tensor.py::shard_parrot_tp`, the forward
and decode only): the forward functions take a `mesh` whose model axis
shards the FFT blocks and the head (`fft.py`); the head's vocabulary
shards are gathered into every rank's logits. The embeddings and the
duration predictor replicate.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from parrot_tts_tpu_torch.core.config import TTEModelConfig
from parrot_tts_tpu_torch.core.device import exact_numerics, resolve_device
from parrot_tts_tpu_torch.core.mesh import Mesh, gather_last
from parrot_tts_tpu_torch.models.tte import fft
from parrot_tts_tpu_torch.ops import init as init_ops
from parrot_tts_tpu_torch.ops import length_regulator as lr_ops
from parrot_tts_tpu_torch.ops import precision as prec

# (encoder section, decoder section) precision of each decode mode
SECTIONS = {True: ("ieee", "ieee"), False: ("tf32", "tf32"),
            "selective": ("ieee", "tf32"),
            "selective-high": ("ieee", "ieee")}


def check_exact(exact, *, hybrid: bool = False) -> None:
    """Raise ValueError unless `exact` is a decode mode: True, False,
    "selective", "selective-high", and "hybrid" where `hybrid` allows it
    (a bucketed decode; one infer_codes call cannot re-decode)."""
    if exact is True or exact is False or exact in (
            "selective", "selective-high") or (hybrid and exact == "hybrid"):
        return
    modes = "True, False, 'selective', 'selective-high'" + (
        ", 'hybrid'" if hybrid else "")
    raise ValueError(f"exact={exact!r}: not a decode mode ({modes})")


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


_M64 = (1 << 64) - 1
# dropout sites (the JAX package's fold-ins, parrot.py:230, 240, 269)
ENCODER_SITE, PREDICTOR_SITE, DECODER_SITE = 100, 200, 300


def dropout_seed(*values: int) -> int:
    """A 64-bit stream id from integers alone (splitmix64 over them), e.g.
    (run seed, micro-step, site, layer)."""
    h = 0
    for v in values:
        z = (h + 0x9E3779B97F4A7C15 + (v & _M64)) & _M64
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
        h = z ^ (z >> 31)
    return h


def _dropout(h: torch.Tensor, p: float, seed: int,
             rows: tuple[int, int] | None = None) -> torch.Tensor:
    """Elementwise dropout drawn from a torch.Generator seeded with `seed`
    (F.dropout takes no generator): keep with probability 1 - p. rows:
    (first row, global rows) of a data-parallel shard h: the draw covers
    the global batch and h takes its rows of it."""
    gen = torch.Generator(device=h.device).manual_seed(seed)
    r0, n = rows or (0, h.shape[0])
    u = torch.rand((n,) + h.shape[1:], generator=gen, device=h.device)
    keep = u[r0: r0 + h.shape[0]] < 1.0 - p
    return torch.where(keep, h / (1.0 - p), 0.0)


def apply_duration_predictor(dp: DurationPredictor, x: torch.Tensor,
                             pad_mask: torch.Tensor, cfg: TTEModelConfig, *,
                             seed: int | None = None,
                             rows: tuple[int, int] | None = None,
                             precision: str | None = None) -> torch.Tensor:
    """Log-duration prediction; pad_mask True = PAD, padded outputs 0.
    Reference quirk (duration.py:34): conv2 hardcodes padding=1 whatever
    the kernel size (under cfg.reference_compat). seed: dropout after each
    LayerNorm (training, `cfg.dur_dropout_p`); None for no dropout. rows:
    `_dropout`'s. precision: the products' `ops/precision.py` mode."""
    ks = dp.kernel_size
    p = cfg.dur_dropout_p if seed is not None else 0.0
    valid = (~pad_mask)[:, :, None].to(x.dtype)
    c1, ln1, c2, ln2 = (dp.layers[0].conv, dp.layers[2], dp.layers[4].conv,
                        dp.layers[6])
    h = prec.conv1d(x * valid, c1.weight, c1.bias, precision,
                    padding=(ks - 1) // 2)
    h = fft.layer_norm(torch.relu(h), ln1.weight, ln1.bias)
    if p > 0:
        h = _dropout(h, p, dropout_seed(seed, 1), rows)
    pad2 = 1 if cfg.reference_compat else (ks - 1) // 2
    h = prec.conv1d(h * valid, c2.weight, c2.bias, precision, padding=pad2)
    h = fft.layer_norm(torch.relu(h), ln2.weight, ln2.bias)
    if p > 0:
        h = _dropout(h, p, dropout_seed(seed, 2), rows)
    out = prec.linear(h, dp.proj.weight, dp.proj.bias, precision)[..., 0]
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
        if cfg.dtype != "float32":
            raise ValueError(
                f"TTEModelConfig.dtype={cfg.dtype!r}: the TTE computes in "
                "float32 (its precision is the decode mode). The JAX "
                "package ignores this field (no module of it reads "
                "TTEModelConfig.dtype), so a bfloat16 config there runs "
                "float32; the port refuses it rather than do the same "
                "silently")
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


def _run_stack(layers, x: torch.Tensor, pad_mask: torch.Tensor,
               dropout_p: float, seed: int | None,
               precision: str | None = None, row0: int = 0,
               mesh: Mesh | None = None) -> torch.Tensor:
    for i, blk in enumerate(layers):
        x = fft.apply_fft_block(
            blk, x, key_padding_mask=pad_mask, dropout_p=dropout_p,
            seed=None if seed is None else dropout_seed(seed, i), row0=row0,
            precision=precision, mesh=mesh)
    return x


def _encode(model: Parrot, batch: dict, seed: int | None,
            precision: str | None = None,
            rows: tuple[int, int] | None = None, mesh: Mesh | None = None):
    """Embedding, encoder stack, speaker embedding and duration predictor:
    (encoder states (B, S, D), log_dur_pred (B, S))."""
    cfg = model.cfg
    src_mask = batch["src_mask"]
    src_pad = ~src_mask
    x = model.tok_emb.weight[batch["phones"]]
    x = fft.add_pos_emb(x, model.pe, src_mask.sum(dim=1),
                        reference_compat=cfg.reference_compat)
    x = x * src_mask[:, :, None].to(x.dtype)   # pads stay batch-invariant
    x = _run_stack(model.encoder_layers, x, src_pad, cfg.encoder.dropout_p,
                   None if seed is None else dropout_seed(seed, ENCODER_SITE),
                   precision, rows[0] if rows else 0, mesh)
    if cfg.n_speaker > 1:
        x = x + model.speaker_emb.weight[batch["speaker"]][:, None, :]
        x = x * src_mask[:, :, None].to(x.dtype)
    log_dur_pred = apply_duration_predictor(
        model.duration_predictor, x, src_pad, cfg,
        seed=None if seed is None else dropout_seed(seed, PREDICTOR_SITE),
        rows=rows, precision=precision)
    return x, log_dur_pred


def _decode(model: Parrot, x: torch.Tensor, tgt_mask: torch.Tensor,
            pe_rows: torch.Tensor, seed: int | None,
            precision: str | None = None, row0: int = 0,
            mesh: Mesh | None = None) -> torch.Tensor:
    """Positional row and decoder stack over regulated states."""
    cfg = model.cfg
    x = fft.add_pos_emb(x, model.pe, pe_rows.clamp(0, cfg.max_len - 1),
                        reference_compat=cfg.reference_compat)
    x = x * tgt_mask[:, :, None].to(x.dtype)
    return _run_stack(model.decoder_layers, x, ~tgt_mask,
                      cfg.decoder.dropout_p,
                      None if seed is None else dropout_seed(seed, DECODER_SITE),
                      precision, row0, mesh)


def _head(model: Parrot, x: torch.Tensor, precision: str | None = None,
          mesh: Mesh | None = None) -> torch.Tensor:
    """The 1000-way linear head: (B, T, D) -> logits (B, T, n_codes),
    its vocabulary shards gathered under a model axis."""
    return gather_last(prec.linear(x, model.head.weight, model.head.bias,
                                   precision), mesh)


def apply_parrot(model: Parrot, batch: dict, *, out_len: int,
                 exact: bool | str = True, mesh: Mesh | None = None):
    """Inference forward (reference parrot.py:90-120 with predicted
    durations). batch: phones (B, S) int, src_mask (B, S) bool True=valid,
    speaker (B,) int, all on the model's device. out_len: decoder length
    (bucket >= total duration). exact: the decode mode, whose `SECTIONS`
    set each section's precision. mesh: a model axis the weights are
    sharded over (module docstring). Returns (logits (B, out_len,
    n_codes), tgt_mask (B, out_len) True=valid, log_dur_pred (B, S))."""
    check_exact(exact)
    enc, dec = SECTIONS[exact]
    src_mask = batch["src_mask"]
    x, log_dur_pred = _encode(model, batch, None, enc, mesh=mesh)
    durations = torch.where(src_mask,
                            lr_ops.durations_from_log_pred(log_dur_pred), 0)
    # exclusive mask: the decode covers exactly sum(dur) frames (the
    # reference's canonical batch-1 decode)
    x, tgt_mask = lr_ops.length_regulator(x, durations, out_len)
    x = _decode(model, x, tgt_mask, durations.sum(dim=1), None, dec,
                mesh=mesh)
    return _head(model, x, enc, mesh), tgt_mask, log_dur_pred


def apply_parrot_train(model: Parrot, batch: dict, *, out_len: int,
                       dropout: tuple[int, int] | None = None,
                       rows: tuple[int, int] | None = None,
                       mesh: Mesh | None = None):
    """Training forward (JAX `apply_parrot(..., inference=False)`,
    `parrot.py:257-261`): ground-truth `duration` (B, S) and the batch's
    `tgt_mask` (B, out_len) True=valid, besides the inference keys.
    dropout: (run seed, micro-step) turns on attention dropout (every
    attention through `ops/flash_dropout.py`, rows 2-4, even at p = 0) and
    duration-predictor dropout, each site's stream from dropout_seed(run
    seed, micro-step, site[, layer]); None is the deterministic forward of
    `eval_step` (attention through row 1). rows: (first row, global rows)
    of a data-parallel shard, for the dropout masks (module docstring).
    mesh: a model axis the weights are sharded over, for the
    deterministic forward alone. Returns (logits, tgt_mask,
    log_dur_pred)."""
    seed = None if dropout is None else dropout_seed(*dropout)
    tgt_mask = batch["tgt_mask"]
    x, log_dur_pred = _encode(model, batch, seed, rows=rows, mesh=mesh)
    x, _ = lr_ops.length_regulator(x, batch["duration"], out_len)
    x = _decode(model, x, tgt_mask, tgt_mask.sum(dim=1), seed,
                row0=rows[0] if rows else 0, mesh=mesh)
    return _head(model, x, mesh=mesh), tgt_mask, log_dur_pred


def to_batch(batch: dict, device: torch.device) -> dict:
    """phones / src_mask / speaker (numpy or tensors) -> tensors on device."""
    dtypes = {"phones": torch.int64, "src_mask": torch.bool,
              "speaker": torch.int64}
    return {k: torch.as_tensor(batch[k]).to(device, dt)
            for k, dt in dtypes.items()}


def code_margin(logits: torch.Tensor, tgt_mask: torch.Tensor) -> torch.Tensor:
    """(B,) min over valid frames of the top-1 minus top-2 logit gap, inf
    for a sample with no valid frame (JAX `_code_margin`): how close the
    greedy decode came to an argmax tie. A frame whose gap exceeds twice a
    faster mode's worst logit perturbation cannot flip under it; the hybrid
    decode re-runs the samples below a threshold."""
    top2 = torch.topk(logits, 2, dim=-1).values
    gap = torch.where(tgt_mask, top2[..., 0] - top2[..., 1], torch.inf)
    return gap.amin(dim=1)


def infer_codes(model: Parrot, batch: dict, *, out_len: int,
                exact: bool | str = True, with_margin: bool = False,
                device=None, mesh: Mesh | None = None):
    """Greedy decode (reference parrot.py:112-120). Returns (codes
    (B, out_len), mask True=valid, total (B,) = sum of predicted durations),
    and with_margin=True the (B,) `code_margin` after them, on `device`
    (default: the CUDA card; raises without one unless device="cpu").
    `total > out_len` means the bucket overflowed and the caller re-decodes
    in a larger one (infer/tte_infer.py does). exact: True, False,
    "selective" or "selective-high" (module docstring); the durations are
    rounded from the encoder section's IEEE outputs in all but False.
    mesh: a model axis the weights are sharded over (`apply_parrot`);
    every rank of it gets the same result."""
    check_exact(exact)
    device = resolve_device(device)
    model = model.to(device)
    batch = to_batch(batch, device)
    with torch.no_grad(), exact_numerics(exact is not False):
        logits, tgt_mask, log_dur = apply_parrot(model, batch, out_len=out_len,
                                                 exact=exact, mesh=mesh)
        durations = torch.where(batch["src_mask"],
                                lr_ops.durations_from_log_pred(log_dur), 0)
        out = (logits.argmax(dim=-1), tgt_mask, durations.sum(dim=1))
        return out + (code_margin(logits, tgt_mask),) if with_margin else out
