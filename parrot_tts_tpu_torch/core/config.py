"""Model configurations for the port: a copy of `TransformerStackConfig`,
`TTEModelConfig` and `VocoderModelConfig` from `parrot_tts_tpu/core/config.py`
(defaults are the reference's full-width model). Training configs, the
reference-file loaders and the TPU-only fields (`remat*`, `dtype`,
`fold_tail`) are not copied. The vocoder keeps `f0`, `fused_mrf` and
`quant`; the port serves `fused_mrf=True` and `quant="int8-static"` and
refuses `f0=True` and the dynamic `quant="int8"` / `"int8-tail"` until a
later slice ports them.
"""

from __future__ import annotations

from dataclasses import dataclass, field


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
    # fused kernel each (ops/fused_mrf.py); quant="int8-static": every conv
    # between conv_pre and conv_post runs int8 with calibrated static
    # scales (models/vocoder/generator_staticq.py). Not ported yet: the
    # generator raises on f0=True and on quant "int8" / "int8-tail".
    f0: bool = False
    fused_mrf: bool = False
    quant: str = "none"

    @property
    def total_upsample(self) -> int:
        r = 1
        for u in self.upsample_rates:
            r *= u
        return r  # 320 == code_hop_size
