"""Joint TTE + vocoder serving: batched text -> 16 kHz waveforms.

Port of `parrot_tts_tpu/infer/serving.py::ParrotTTS` on one CUDA device.
Both stages use folded (inference) parameters. Unlike the JAX class, whose
default decode is "selective-high", the port's default `exact=True` is
IEEE float32 everywhere (no TF32); `exact=False` allows TF32.
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import numpy as np

from parrot_tts_tpu_torch.core.config import TTEModelConfig, VocoderModelConfig
from parrot_tts_tpu_torch.core.device import resolve_device
from parrot_tts_tpu_torch.data.tte_data import pick_bucket
from parrot_tts_tpu_torch.infer.synthesize import VocoderSynthesizer
from parrot_tts_tpu_torch.infer.tte_infer import decode_buckets, max_decode_len
from parrot_tts_tpu_torch.models.tte import parrot
from parrot_tts_tpu_torch.models.tte.fold import fold_tte_params
from parrot_tts_tpu_torch.text.tokenizer import DFATokenizer

SRC_BUCKETS = (64, 128, 256, 512)


class ParrotTTS:
    """End-to-end synthesizer. Construct once; `tts()` serves batches.

    tte_state / vocoder_state: unfolded `Parrot` and `CodeGenerator` state
    dicts (convert.py carries JAX trees across). device: default the CUDA
    card, raising without one; pass "cpu" to run on the host."""

    def __init__(self, tte_state: dict, tte_cfg: TTEModelConfig,
                 vocoder_state: dict, vocoder_cfg: VocoderModelConfig,
                 tokenizer: DFATokenizer, cleaner: Callable[[str], str], *,
                 src_buckets: tuple[int, ...] = SRC_BUCKETS,
                 out_len_per_token: int = 16, batch_size: int = 64,
                 exact: bool = True, device=None):
        parrot.check_exact(exact)
        self.device = resolve_device(device)
        self.tte_cfg = tte_cfg
        self.tokenizer = tokenizer
        self.cleaner = cleaner
        self.src_buckets = src_buckets
        self.out_len_per_token = out_len_per_token
        self.batch_size = batch_size
        self.exact = exact
        self.tte = parrot.Parrot(tte_cfg, folded=True)
        self.tte.load_state_dict(fold_tte_params(tte_state), strict=True)
        self.tte.to(self.device).eval()
        self.vocoder = VocoderSynthesizer(vocoder_state, vocoder_cfg,
                                          exact=exact, device=self.device)
        self.last_stats: dict = {}

    def tokenize(self, text: str) -> np.ndarray:
        cleaned = self.cleaner(text)
        symbols = ["sil" if ch == " " else ch for ch in cleaned]
        ids = [self.tokenizer.stoi[s] for s in symbols
               if s in self.tokenizer.stoi]
        return np.asarray(ids, np.int32)

    def plan(self, token_seqs: Sequence[np.ndarray]
             ) -> list[tuple[int, int, list[int]]]:
        """(s_len, out_len, indices) decode buckets: the decoder bucket is
        min(ceil(s_len * out_len_per_token / 128) * 128, cap)."""
        by_bucket: dict[int, list[int]] = {}
        for i, seq in enumerate(token_seqs):
            by_bucket.setdefault(
                pick_bucket(self.src_buckets, len(seq)), []).append(i)
        cap = max_decode_len(self.tte_cfg)
        return [(s_len,
                 min(-(-s_len * self.out_len_per_token // 128) * 128, cap),
                 idxs)
                for s_len, idxs in sorted(by_bucket.items())]

    def predict_units(self, token_seqs: Sequence[np.ndarray],
                      speakers: Sequence[int],
                      stats: dict | None = None) -> list[np.ndarray]:
        samples = [(seq, speakers[i]) for i, seq in enumerate(token_seqs)]
        return decode_buckets(self.tte, samples, self.plan(token_seqs),
                              batch_size=self.batch_size, exact=self.exact,
                              device=self.device, stats=stats)

    def tts(self, texts: Sequence[str],
            speakers: Sequence[int] | None = None,
            vocoder_speakers: Sequence[int] | None = None) -> list[np.ndarray]:
        """Batched text -> float32 waveforms. Records wall time, the TTE /
        vocoder split, audio-seconds per second, RTF and the number of
        decode batches in `last_stats`."""
        n = len(texts)
        speakers = list(speakers) if speakers is not None else [0] * n
        vocoder_speakers = (list(vocoder_speakers)
                            if vocoder_speakers is not None else speakers)
        stats: dict = {"decode_batches": 0}
        t0 = time.perf_counter()
        tokens = [self.tokenize(t) for t in texts]
        units = self.predict_units(tokens, speakers, stats=stats)
        t1 = time.perf_counter()         # units are on the host: TTE done
        wavs = self.vocoder.synthesize(units, vocoder_speakers)
        dt = time.perf_counter() - t0
        audio_s = sum(len(w) for w in wavs) / self.vocoder.sample_rate
        self.last_stats = {
            **stats,
            "wall_s": dt,
            "tte_s": t1 - t0,
            "vocoder_s": dt - (t1 - t0),
            "audio_seconds": audio_s,
            "audio_seconds_per_second": audio_s / dt if dt else 0.0,
            "rtf": dt / audio_s if audio_s else None,
        }
        return wavs
