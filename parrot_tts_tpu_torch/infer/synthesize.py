"""Vocoder batch synthesis: HuBERT units -> waveforms, and text ->
waveform for one request.

Port of `parrot_tts_tpu/infer/synthesize.py::{VocoderSynthesizer,
peak_normalize, synthesize_text}`, single device: the float generator
(with the fused MRF kernel under `fused_mrf=True`), the dynamic int8
generator (`quant="int8"` or `"int8-tail"`: per-row activation scales
taken on every call, nothing to calibrate) and the int8-static generator
(`quant="int8-static"`, calibrated explicitly or on the first served
batch). Code sequences are
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
from parrot_tts_tpu_torch.infer.tte_infer import max_decode_len
from parrot_tts_tpu_torch.models.tte import parrot
from parrot_tts_tpu_torch.models.vocoder import generator as gen
from parrot_tts_tpu_torch.models.vocoder import generator_staticq as sq
from parrot_tts_tpu_torch.text.tokenizer import DFATokenizer

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
    float convs in IEEE float32. device: default the CUDA card (raises
    without one); pass "cpu" to run on the host. calib_margin scales the
    int8-static activation scales (quant="int8-static" only); `staticq`
    holds the int8-static state once calibrated. Under fused_mrf=True each
    fused stage's weights are packed once, here, and under quant="int8" /
    "int8-tail" every MRF conv's and upsample's int8 weight."""

    def __init__(self, state: dict, cfg: VocoderModelConfig, *,
                 sample_rate: int = 16_000,
                 exact: bool = True, device=None,
                 calib_margin: float = 1.0):
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
        self.model.pack_fused_mrf()
        self.model.pack_int8()
        self.calib_margin = calib_margin
        self.staticq: sq.StaticQ | None = None
        self.last_rtf: float | None = None

    def calibrate(self, codes, speakers) -> None:
        """Static int8 activation scales from a representative batch of
        equal-length code sequences (quant="int8-static" only). Called on
        the first served batch if not done explicitly. Quantizes every
        conv's weight for these scales."""
        code = np.stack([np.asarray(c, np.int64) for c in codes])
        spk = np.asarray(speakers, np.int64)
        qscales = sq.calibrate_qscales(
            self.model, code, spk, margin=self.calib_margin,
            exact=self.exact, device=self.device)
        self.staticq = sq.quantize_generator(self.model, qscales,
                                             device=self.device)

    def _launch(self, code_pad: np.ndarray, spk: np.ndarray) -> torch.Tensor:
        if self.cfg.quant == "int8-static":
            if self.staticq is None:
                self.calibrate(code_pad, spk)
            return sq.apply_code_generator_staticq(
                self.model, code_pad, spk, self.staticq, exact=self.exact,
                device=self.device)
        return gen.apply_code_generator(self.model, code_pad, spk,
                                        exact=self.exact, device=self.device)

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
            y = self._launch(code_pad, spk)[:, :, 0].cpu().numpy()
            for j, gi in enumerate(idxs):
                n = min(len(codes[gi]), t_len) * hop
                results[gi] = y[j, :n]
                total_audio_s += n / self.sample_rate
        dt = time.perf_counter() - t0
        self.last_rtf = dt / total_audio_s if total_audio_s else None
        return results  # type: ignore[return-value]


def synthesize_text(text: str, *, tte_model: parrot.Parrot,
                    tokenizer: DFATokenizer,
                    synthesizer: VocoderSynthesizer, cleaner,
                    speaker_id: int = 0, device=None) -> np.ndarray:
    """Clean text -> char tokens -> TTE units (the exact decode) ->
    waveform (the demo notebook path, demo.ipynb cells 9-13). The decode
    bucket is s_len * 16
    frames; a prediction that overflows it is decoded again at the length
    it needs (up to the positional table's cap)."""
    cleaned = cleaner(text)
    symbols = ["sil" if ch == " " else ch for ch in cleaned]
    phones = [tokenizer.stoi[s] for s in symbols if s in tokenizer.stoi]
    batch = {"phones": np.asarray(phones, np.int64)[None],
             "src_mask": np.ones((1, len(phones)), bool),
             "speaker": np.asarray([speaker_id], np.int64)}
    cap = max_decode_len(tte_model.cfg)
    out_len = min(len(phones) * 16, cap)
    codes, mask, total = parrot.infer_codes(tte_model, batch, out_len=out_len,
                                            exact=True, device=device)
    if int(total[0]) > out_len and out_len < cap:
        out_len = min(-(-int(total[0]) // 128) * 128, cap)
        codes, mask, total = parrot.infer_codes(
            tte_model, batch, out_len=out_len, exact=True, device=device)
    units = codes[0][mask[0]].cpu().numpy()
    return synthesizer.synthesize([units], [speaker_id])[0]
