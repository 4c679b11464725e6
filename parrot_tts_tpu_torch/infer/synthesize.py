"""Vocoder batch synthesis: HuBERT units -> waveforms.

Port of `parrot_tts_tpu/infer/synthesize.py::{VocoderSynthesizer,
peak_normalize}`, single device, float generator only. Code sequences are
batched per length bucket (`CODE_BUCKETS`; longer sequences are cropped to
the largest bucket, as in the JAX package), short rows are repeat-padded
with their own codes, and each waveform is trimmed to len(units) * hop.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from parrot_tts_tpu_torch.core.config import VocoderModelConfig
from parrot_tts_tpu_torch.core.device import resolve_device
from parrot_tts_tpu_torch.data.tte_data import pick_bucket
from parrot_tts_tpu_torch.models.vocoder import generator as gen

CODE_BUCKETS = (128, 256, 512, 1024, 2048)


def peak_normalize(wav: np.ndarray) -> np.ndarray:
    """librosa.util.normalize default (peak |x| -> 1), used by the reference
    on every written wav (utils/vocoder/inference.py:169,174)."""
    peak = float(np.abs(wav).max()) if wav.size else 0.0
    return wav / peak if peak > 0 else wav


class VocoderSynthesizer:
    """Batched unit -> waveform synthesis.

    state: a `CodeGenerator` state dict (weight-norm form, or already
    folded); weight norm is collapsed once here. exact=True runs the
    convs in IEEE float32. device: default the CUDA card (raises without
    one); pass "cpu" to run on the host."""

    def __init__(self, state: dict, cfg: VocoderModelConfig, *,
                 sample_rate: int = 16_000,
                 exact: bool = True, device=None):
        self.cfg = cfg
        self.sample_rate = sample_rate
        self.exact = exact
        self.device = resolve_device(device)
        if any(k.endswith(".weight_g") for k in state):
            with torch.no_grad():
                state = gen.fold_params(state)
        self.model = gen.CodeGenerator(cfg, weight_norm=False)
        self.model.load_state_dict(state, strict=True)
        self.model.to(self.device).eval()
        self.last_rtf: float | None = None

    def synthesize(self, codes: list[np.ndarray],
                   speakers: list[int]) -> list[np.ndarray]:
        """Batch per length bucket; returns trimmed float32 waveforms (an
        empty code sequence gives an empty waveform)."""
        hop = self.cfg.total_upsample
        results: list[np.ndarray | None] = [None] * len(codes)
        by_bucket: dict[int, list[int]] = {}
        for i, c in enumerate(codes):
            by_bucket.setdefault(pick_bucket(CODE_BUCKETS, len(c)), []).append(i)

        t0 = time.perf_counter()
        total_audio_s = 0.0
        for t_len, idxs in sorted(by_bucket.items()):
            code_pad = np.zeros((len(idxs), t_len), np.int64)
            spk = np.zeros((len(idxs),), np.int64)
            for j, gi in enumerate(idxs):
                c = np.asarray(codes[gi])[:t_len]
                code_pad[j, : len(c)] = c
                # repeat-pad with the sequence itself (code 0 would
                # synthesize phantom audio; the output is trimmed anyway);
                # an empty sequence keeps a zero row and trims to nothing
                if 0 < len(c) < t_len:
                    code_pad[j] = np.tile(c, -(-t_len // len(c)))[:t_len]
                spk[j] = speakers[gi]
            y = gen.apply_code_generator(self.model, code_pad, spk,
                                         exact=self.exact, device=self.device)
            y = y[:, :, 0].cpu().numpy()
            for j, gi in enumerate(idxs):
                n = min(len(codes[gi]), t_len) * hop
                results[gi] = y[j, :n]
                total_audio_s += n / self.sample_rate
        dt = time.perf_counter() - t0
        self.last_rtf = dt / total_audio_s if total_audio_s else None
        return results  # type: ignore[return-value]
