"""Configurations for the port: copies of `TransformerStackConfig`,
`TTEModelConfig`, `TTETrainConfig`, `VocoderModelConfig`, `MelConfig` and
`VocoderTrainConfig` from `parrot_tts_tpu/core/config.py` (defaults are
the reference's full-width model and recipe), the fields of
`PipelineConfig` that TTE and vocoder training read, and `to_json`.

Not copied: the reference-file loaders, the other stages' configs, and the
TPU-only fields. `dtype` and `fold_tail` select TPU layouts. `remat` /
`remat_min_len` rematerialised FFT blocks in the backward pass so the XLA
attention's saved (B, H, T, T) weights fit in memory; the port's training
attention (`ops/flash_dropout.py`) never stores (B, H, T, T) scores, so
there is nothing to rematerialise. The vocoder keeps `f0`, `fused_mrf` and
`quant`; the port serves `fused_mrf=True` and every `quant` mode ("int8",
"int8-tail", "int8-static"), trains only the float generator without the
fused MRF (`train/vocoder.py`), and refuses `f0=True` until a later slice
ports it. `MelConfig` leaves out `center`, which no trainer reads: the
loss mel is always the reference's uncentred one.
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
    # conv_pre and conv_post stay float32. Not ported yet: the generator
    # raises on f0=True.
    f0: bool = False
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
class PipelineConfig:
    """The fields of the JAX package's `PipelineConfig` that TTE and
    vocoder training read: the corpus and aligner directories, the TTE
    configs, the loss mel and the vocoder configs."""

    root_path: str = "runs/TTE"
    alignment_path: str = "runs/aligner"
    tte_model: TTEModelConfig = field(default_factory=TTEModelConfig)
    tte_train: TTETrainConfig = field(default_factory=TTETrainConfig)
    mel: MelConfig = field(default_factory=MelConfig)
    vocoder_model: VocoderModelConfig = field(
        default_factory=VocoderModelConfig)
    vocoder_train: VocoderTrainConfig = field(
        default_factory=VocoderTrainConfig)
