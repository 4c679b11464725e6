"""Configurations for the port: copies of `TransformerStackConfig`,
`TTEModelConfig`, `TTETrainConfig`, `VocoderModelConfig`, `MelConfig`,
`VocoderTrainConfig`, `HubertConfig`, `Aligner{Audio,Model,Train}Config`
and `MeshConfig` from `parrot_tts_tpu/core/config.py` (defaults are the
reference's full-width models and recipe), the fields of `PipelineConfig`
that TTE and vocoder training read, `to_json`, `vocoder_config_from_json`
and the aligner's `aligner_configs_to_json` / `aligner_configs_from_json`.

Not copied: the reference-file loaders and the TPU-only fields.
`fold_tail` selects a TPU layout. `remat` / `remat_min_len`
rematerialised FFT blocks in the backward pass so the XLA attention's
saved (B, H, T, T) weights fit in memory; the port's training attention
(`ops/flash_dropout.py`) never stores (B, H, T, T) scores, so there is
nothing to rematerialise. The vocoder keeps `f0`, `dtype`, `fused_mrf` and
`quant`; the port serves `fused_mrf=True` and every `quant` mode ("int8",
"int8-tail", "int8-static"; int8-static refuses `f0=True`), each in
float32 or bfloat16, and trains only the generator without the fused MRF
(`train/vocoder.py`), with or without f0, in float32 or bfloat16.

`dtype` is a compute precision with a fidelity budget, not a layout. The
vocoder's "bfloat16" follows the JAX package's rounding points
(`models/vocoder/generator.py`): bf16 activations and weights, float32
sums in every conv, parameters, gradients and optimizer moments in
float32. `TTEModelConfig.dtype` is copied for the JAX package's
config.json, but no module of the JAX package reads it (its TTE always
computes in float32), so the port's `Parrot` refuses anything but
"float32" rather than run float32 silently. `MelConfig` leaves out
`center`, which no trainer reads: the loss mel is always the reference's
uncentred one.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class TransformerStackConfig:
    n_layer: int = 4
    n_head: int = 2
    dropout_p: float = 0.1


@dataclass(frozen=True)
class TTEModelConfig:
    """FFT-block transformer (reference `transformer:` + `duration_predictor:`)."""

    d_model: int = 256
    conv_n_filter: int = 1024
    conv_kernel_sizes: tuple[int, int] = (9, 1)
    max_len: int = 3500
    encoder: TransformerStackConfig = field(default_factory=TransformerStackConfig)
    decoder: TransformerStackConfig = field(default_factory=TransformerStackConfig)
    # duration predictor (reference modules/duration.py:26-48)
    dur_n_filter: int = 256
    dur_kernel_size: int = 3
    dur_dropout_p: float = 0.5
    # data/head
    hubert_codes: int = 1000
    n_speaker: int = 1
    vocab_size: int = 100
    pad_idx: int = 0
    # Reproduce reference quirks bit-for-bit:
    #   pe[seqlen] broadcast instead of pe[:seqlen]     (modules/fft.py:17-19)
    #   double QKV projection through an extra qkv/wo   (modules/fft.py:48-57)
    #   duration-predictor conv2 hardcoded padding=1    (modules/duration.py:34)
    reference_compat: bool = True
    # compute dtype for matmuls (params stay float32)
    dtype: str = "float32"


@dataclass(frozen=True)
class TTETrainConfig:
    """Reference `optimizer:` + `train:` sections of TTE_config.yaml."""

    init_lr: float = 1e-4
    # the reference's configure_optimizers ignores its own betas
    # (train.py:98-109); AdamW runs with (0.9, 0.999) whatever this says
    betas: tuple[float, float] = (0.9, 0.98)
    weight_decay: float = 0.0
    warmup_steps: int = 2000
    total_steps: int = 50_000
    log_every: int = 10
    val_every: int = 1000
    save_every: int = 1000
    batch_size: int = 6
    grad_acc_steps: int = 4
    grad_clip: float = 1.0
    seed: int = 42
    # length buckets: a batch is padded to a (src, tgt) bucket pair
    src_buckets: tuple[int, ...] = (128, 256)
    tgt_buckets: tuple[int, ...] = (512, 1024, 2048, 3584)


def to_json(cfg: Any) -> str:
    """Serialize any config dataclass (saved beside checkpoints)."""
    return json.dumps(dataclasses.asdict(cfg), indent=2, default=str)


@dataclass(frozen=True)
class VocoderModelConfig:
    """Unit HiFi-GAN V1 (reference config.json + utils/vocoder/models.py)."""

    resblock: str = "1"
    upsample_rates: tuple[int, ...] = (5, 4, 4, 2, 2)
    upsample_kernel_sizes: tuple[int, ...] = (11, 8, 8, 4, 4)
    upsample_initial_channel: int = 512
    resblock_kernel_sizes: tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: tuple[tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    num_embeddings: int = 1000       # HuBERT codebook size
    embedding_dim: int = 128
    model_in_dim: int = 256          # code emb + speaker emb concat
    multispkr: str | None = "_"
    num_speakers: int = 10           # reference hardcodes nn.Embedding(10, ...) models.py:130
    # fused_mrf=True: the ResBlock1 stages below 128 channels run as one
    # fused kernel each (ops/fused_mrf.py). quant: "none" | "int8" |
    # "int8-tail" | "int8-static". "int8": every MRF conv and upsample runs
    # int8 with per-batch-row activation scales taken on each call;
    # "int8-tail": only those of the stages the JAX package folds
    # (models/vocoder/generator.py::quant_plan; at V1 the 64-, 32- and
    # 16-channel stages); int8 supersedes the fused MRF on a stage.
    # "int8-static": every conv between conv_pre and conv_post runs int8
    # with calibrated static scales (models/vocoder/generator_staticq.py).
    # conv_pre and conv_post stay in `dtype`. f0=True: a code-rate pitch
    # channel joins the embedding (model_in_dim counts it). dtype: the
    # compute dtype, "float32" or "bfloat16" (parameters stay float32).
    f0: bool = False
    dtype: str = "float32"
    fused_mrf: bool = False
    quant: str = "none"

    @property
    def total_upsample(self) -> int:
        r = 1
        for u in self.upsample_rates:
            r *= u
        return r  # 320 == code_hop_size


@dataclass(frozen=True)
class MelConfig:
    """STFT / mel parameters (the vocoder's loss mel; reference
    config.json:24-35)."""

    n_fft: int = 1024
    num_mels: int = 80
    sampling_rate: int = 16_000
    hop_size: int = 256
    win_size: int = 1024
    fmin: float = 0.0
    fmax: float | None = 8000.0


@dataclass(frozen=True)
class VocoderTrainConfig:
    """Reference config.json training keys + train.py optimizer setup."""

    batch_size: int = 16
    learning_rate: float = 2e-4
    adam_b1: float = 0.8
    adam_b2: float = 0.99
    lr_decay: float = 0.999          # ExponentialLR gamma, per epoch
    seed: int = 1234
    segment_size: int = 8960
    code_hop_size: int = 320
    training_epochs: int = 2000
    checkpoint_interval: int = 10_000
    summary_interval: int = 100
    # discriminator compute dtype: inputs and weights are cast to it for
    # the convolutions; parameters and loss reductions stay float32
    disc_dtype: str = "float32"
    validation_interval: int = 1000


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout (`core/mesh.py`): a `data` axis, and a `model`
    axis for the tensor-parallel rules of `parallel/tensor.py`. The
    reference's parallelism is data-parallel only."""

    data_axis: str = "data"
    model_axis: str = "model"
    model_parallel_size: int = 1


@dataclass(frozen=True)
class PipelineConfig:
    """The fields of the JAX package's `PipelineConfig` that TTE and
    vocoder training read: the corpus and aligner directories, the TTE
    configs, the loss mel, the vocoder configs and the mesh."""

    root_path: str = "runs/TTE"
    alignment_path: str = "runs/aligner"
    tte_model: TTEModelConfig = field(default_factory=TTEModelConfig)
    tte_train: TTETrainConfig = field(default_factory=TTETrainConfig)
    mel: MelConfig = field(default_factory=MelConfig)
    vocoder_model: VocoderModelConfig = field(
        default_factory=VocoderModelConfig)
    vocoder_train: VocoderTrainConfig = field(
        default_factory=VocoderTrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)


@dataclass(frozen=True)
class HubertConfig:
    """HuBERT encoder for unit extraction. Defaults are the base topology of
    the fairseq mHuBERT the reference loads (`utils/hubert_extraction/
    hubert_api.py:16-31`; layer-11 features, k-means 1000), identical to
    HF `HubertModel` base: 7-layer conv frontend, 12-layer post-LN
    transformer."""

    # conv feature extractor (wav 16 kHz -> 50 Hz frames, hop 320)
    conv_dim: tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = False
    # "group": GroupNorm(C, C) after conv 0 only (base); "layer": per-conv
    # channel LayerNorm (large-style extractors)
    feat_extract_norm: str = "group"
    # transformer encoder (post-LN, HF do_stable_layer_norm=False)
    d_model: int = 768
    n_layer: int = 12
    n_head: int = 12
    ffn_dim: int = 3072
    layer_norm_eps: float = 1e-5
    pos_conv_kernel: int = 128
    pos_conv_groups: int = 16
    # task.cfg.normalize: wav-level layer norm (False for base checkpoints,
    # hubert_api.py:55-56 gates on it)
    normalize_input: bool = False
    sample_rate: int = 16_000
    # extraction defaults (extractor.py:12, hubert_api.py:17)
    output_layer: int = 11
    max_chunk: int = 1_600_000
    n_units: int = 1000
    dtype: str = "float32"

    @property
    def frame_hop(self) -> int:
        r = 1
        for s in self.conv_stride:
            r *= s
        return r  # 320 samples per frame

    @property
    def receptive_field(self) -> int:
        rf, hop = 1, 1
        for k, s in zip(self.conv_kernel, self.conv_stride):
            rf += (k - 1) * hop
            hop *= s
        return rf  # 400 samples


# ---------------------------------------------------------------------------
# Aligner stage (reference utils/aligner/aligner_train_config.yaml)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AlignerAudioConfig:
    """librosa mel for the aligner (reference utils/aligner/audio.py:30-42)."""

    sample_rate: int = 16_000
    n_filters: int = 1024            # n_fft
    n_mels: int = 80
    win_length: int = 1024
    hop_length: int = 320            # == HuBERT unit hop
    fmin: float = 0.0
    fmax: float = 8000.0
    power: float = 1.0


@dataclass(frozen=True)
class AlignerModelConfig:
    """conv x3 -> BiLSTM -> linear (reference utils/aligner/model.py:24-48)."""

    n_mels: int = 80
    conv_dim: int = 512
    lstm_dim: int = 512
    num_symbols: int = 100           # len(symbols) + 1 (CTC blank at 0)


@dataclass(frozen=True)
class AlignerTrainConfig:
    learning_rate: float = 1e-4
    batch_size: int = 16
    epochs: int = 450
    plot_steps: int = 1000
    checkpoint_steps: int = 10_000
    grad_clip: float = 1.0
    mel_bucket_sizes: tuple[int, ...] = (256, 512, 1024, 2048)
    token_bucket_sizes: tuple[int, ...] = (64, 128, 256, 512)


def aligner_configs_to_json(model_cfg: AlignerModelConfig,
                            train_cfg: AlignerTrainConfig) -> str:
    """Model + train config, saved as config.json beside the aligner's
    checkpoints so extract-durations can rebuild the model."""
    return json.dumps({"model": dataclasses.asdict(model_cfg),
                       "train": dataclasses.asdict(train_cfg)}, indent=2)


def aligner_configs_from_json(text: str
                              ) -> tuple[AlignerModelConfig,
                                         AlignerTrainConfig]:
    d = json.loads(text)
    t = dict(d["train"])
    for k in ("mel_bucket_sizes", "token_bucket_sizes"):
        if t.get(k) is not None:
            t[k] = tuple(t[k])
    return AlignerModelConfig(**d["model"]), AlignerTrainConfig(**t)


def vocoder_config_from_json(text: str) -> VocoderModelConfig:
    """Round trip of to_json(VocoderModelConfig): reads the config.json
    that vocoder training saves beside its checkpoints, restoring the
    tuple-typed fields JSON flattens to lists."""
    names = {f.name for f in dataclasses.fields(VocoderModelConfig)}
    d = {k: v for k, v in json.loads(text).items() if k in names}
    for k in ("upsample_rates", "upsample_kernel_sizes",
              "resblock_kernel_sizes"):
        if k in d:
            d[k] = tuple(d[k])
    if "resblock_dilation_sizes" in d:
        d["resblock_dilation_sizes"] = tuple(
            tuple(x) for x in d["resblock_dilation_sizes"])
    return VocoderModelConfig(**d)
