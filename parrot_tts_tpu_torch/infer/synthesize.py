"""Vocoder batch synthesis: HuBERT units -> waveforms, and text ->
waveform for one request.

Port of `parrot_tts_tpu/infer/synthesize.py::{VocoderSynthesizer,
peak_normalize, synthesize_text}`: the float generator
(with the fused MRF kernel under `fused_mrf=True`), the dynamic int8
generator (`quant="int8"` or `"int8-tail"`: per-row activation scales
taken on every call, nothing to calibrate) and the int8-static generator
(`quant="int8-static"`, calibrated explicitly or on the first served
batch). Code sequences are
batched per length bucket (`CODE_BUCKETS`; longer sequences are cropped to
the largest bucket, as in the JAX package), short rows are repeat-padded
with their own codes, and each waveform is trimmed to len(units) * hop.
An f0-conditioned vocoder (`cfg.f0`) takes a code-rate pitch track per
utterance, padded as its codes are; int8-static serving refuses it. Every
mode serves in `cfg.dtype`, float32 or bfloat16 (the JAX package's bf16
rounding points, `models/vocoder/generator.py`); the waveforms come back
as float32 either way.

With a mesh (`core/mesh.py`, model axis 1) each bucket's batch is padded
to a multiple of the data axis with repeats of row 0, every process takes
its rows (`local_rows`), each of its devices runs its shard on its own
replica, and the waveforms are fetched globally and trimmed: the
replacement for the reference's 8-GPU inference pool
(`utils/vocoder/inference.py:201-261`). A shard's rows give the same bits
as a solo serve of those rows.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from parrot_tts_tpu_torch.core import mesh as meshlib
from parrot_tts_tpu_torch.core.config import VocoderModelConfig
from parrot_tts_tpu_torch.core.device import resolve_device
from parrot_tts_tpu_torch.data.audio_io import write_wav
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
    without one), or the mesh's first device; pass "cpu" to run on the
    host. mesh: shard each batch over the mesh's data axis (module
    docstring); `replicas` holds one model per data-axis device of this
    process. calib_margin scales the int8-static activation scales
    (quant="int8-static" only); `staticq` holds the int8-static state
    once calibrated (of the first replica; `staticqs` of each). Under fused_mrf=True each fused stage's
    weights are packed once, here, under quant="int8" / "int8-tail"
    every MRF conv's and upsample's int8 weight, and under
    dtype="bfloat16" every conv's bf16 weight and bias."""

    def __init__(self, state: dict, cfg: VocoderModelConfig, *,
                 sample_rate: int = 16_000,
                 exact: bool = True, device=None,
                 calib_margin: float = 1.0, mesh=None):
        if cfg.f0 and cfg.quant == "int8-static":
            raise ValueError(
                "int8-static serving does not support f0 conditioning: the "
                "static activation scales are calibrated on the unconditioned "
                "graph (models/vocoder/generator_staticq.py). Serve "
                "f0-conditioned checkpoints with quant='none'/'int8'.")
        self.cfg = cfg
        self.sample_rate = sample_rate
        self.exact = exact
        self.mesh = mesh
        self.device = resolve_device(
            mesh.local_data[0] if device is None and mesh else device)
        if any(k.endswith(".weight_g") for k in state):
            with torch.no_grad():
                state = gen.fold_params(state)
        self.model = gen.CodeGenerator(cfg, weight_norm=False)
        self.model.load_state_dict(state, strict=True)
        self.model.to(self.device).eval()
        self.replicas = ([self.model] if mesh is None
                         else meshlib.replicated(mesh, self.model))
        for m in {id(m): m for m in self.replicas}.values():
            m.pack_bf16()
            m.pack_fused_mrf()
            m.pack_int8()
        self.calib_margin = calib_margin
        self.staticq: sq.StaticQ | None = None
        self.staticqs: list[sq.StaticQ] = []
        self.last_rtf: float | None = None

    def calibrate(self, codes, speakers) -> None:
        """Static int8 activation scales from a representative batch of
        equal-length code sequences (quant="int8-static" only). Called on
        the first served batch (under a mesh the whole padded global
        batch) if not done explicitly. The scales are calibrated once
        (rank 0's under a process group) and every replica's convs are
        quantized for them."""
        code = np.stack([np.asarray(c, np.int64) for c in codes])
        spk = np.asarray(speakers, np.int64)
        qscales = sq.calibrate_qscales(
            self.model, code, spk, margin=self.calib_margin,
            exact=self.exact, device=self.device)
        meshlib.broadcast(qscales)
        devices = self.mesh.local_data if self.mesh else [self.device]
        per_copy: dict = {}           # devices that repeat share a copy
        for m, d in zip(self.replicas, devices):
            if id(m) not in per_copy:
                per_copy[id(m)] = sq.quantize_generator(m, qscales, device=d)
        self.staticqs = [per_copy[id(m)] for m in self.replicas]
        self.staticq = self.staticqs[0]

    def _launch(self, code_pad: np.ndarray, spk: np.ndarray,
                f0_pad: np.ndarray | None, shard: int = 0) -> torch.Tensor:
        model = self.replicas[shard]
        device = self.mesh.local_data[shard] if self.mesh else self.device
        if self.cfg.quant == "int8-static":
            return sq.apply_code_generator_staticq(
                model, code_pad, spk, self.staticqs[shard], exact=self.exact,
                device=device)
        return gen.apply_code_generator(
            model, code_pad, spk,
            extra_feats=None if f0_pad is None else {"f0": f0_pad},
            exact=self.exact, device=device)

    def _serve(self, code_pad: np.ndarray, spk: np.ndarray,
               f0_pad: np.ndarray | None) -> np.ndarray:
        """(B, T * hop) waveforms of one padded bucket; under a mesh its
        rows are padded with repeats of row 0, sharded and fetched."""
        if self.cfg.quant == "int8-static" and self.staticq is None:
            self.calibrate(code_pad, spk)
        if self.mesh is None:
            return self._launch(code_pad, spk, f0_pad)[:, :, 0].cpu().numpy()
        b = len(code_pad)
        b_pad = meshlib.pad_rows_to_multiple(b, self.mesh.n_data)
        rows = {"code": code_pad, "spk": spk, "f0": f0_pad}
        rows = {k: None if v is None else np.concatenate(
            [v, np.repeat(v[:1], b_pad - b, axis=0)])[
                meshlib.local_rows(b_pad)] for k, v in rows.items()}
        n = len(self.replicas)
        loc = len(rows["code"]) // n
        part = [{k: None if v is None else v[i * loc: (i + 1) * loc]
                 for k, v in rows.items()} for i in range(n)]
        outs = [self._launch(p["code"], p["spk"], p["f0"], i)[:, :, 0]
                for i, p in enumerate(part)]
        return meshlib.fetch(outs)[:b]

    def synthesize(self, codes: list[np.ndarray], speakers: list[int],
                   f0: list[np.ndarray] | None = None) -> list[np.ndarray]:
        """Batch per length bucket; returns trimmed float32 waveforms (an
        empty code sequence gives an empty waveform).

        f0: per-utterance CODE-RATE pitch tracks ((Tc,) or (1, Tc)),
        required iff the model was trained with cfg.f0 (from the source
        audio: `ops/f0.py::f0_for_codes`) and dropped otherwise, as the
        reference drops the key."""
        if self.cfg.f0 and f0 is None:
            raise ValueError(
                "this checkpoint is f0-conditioned (cfg.f0): pass per-"
                "utterance code-rate f0 tracks (ops/f0.py::f0_for_codes on "
                "the source audio)")
        if not self.cfg.f0:
            f0 = None
        hop = self.cfg.total_upsample
        results: list[np.ndarray | None] = [None] * len(codes)
        by_bucket: dict[int, list[int]] = {}
        for i, c in enumerate(codes):
            by_bucket.setdefault(pick_bucket(CODE_BUCKETS, len(c)), []).append(i)

        t0 = time.perf_counter()
        total_audio_s = 0.0
        for t_len, idxs in sorted(by_bucket.items()):
            code_pad = _repeat_pad([np.asarray(codes[gi], np.int64)
                                    for gi in idxs], t_len)
            spk = np.asarray([speakers[gi] for gi in idxs], np.int64)
            f0_pad = None if f0 is None else _repeat_pad(
                [np.asarray(f0[gi], np.float32).reshape(-1) for gi in idxs],
                t_len)[:, None, :]
            y = self._serve(code_pad, spk, f0_pad)
            for j, gi in enumerate(idxs):
                n = min(len(codes[gi]), t_len) * hop
                results[gi] = y[j, :n]
                total_audio_s += n / self.sample_rate
        dt = time.perf_counter() - t0
        self.last_rtf = dt / total_audio_s if total_audio_s else None
        return results  # type: ignore[return-value]

    def to_wavs(self, codes, speakers, out_dir: str | Path,
                names: list[str] | None = None,
                f0: list[np.ndarray] | None = None) -> list[Path]:
        """`synthesize`, each waveform written to <out_dir>/<name>_gen.wav
        (names default utt_00000, ...); returns the paths."""
        out_dir = Path(out_dir)
        paths = []
        for i, w in enumerate(self.synthesize(codes, speakers, f0=f0)):
            p = out_dir / f"{names[i] if names else f'utt_{i:05d}'}_gen.wav"
            write_wav(p, w, self.sample_rate)
            paths.append(p)
        return paths


def _repeat_pad(rows: list[np.ndarray], t_len: int) -> np.ndarray:
    """(len(rows), t_len) of the rows cropped to t_len, each shorter one
    repeat-padded with itself (code 0 would synthesize phantom audio; the
    output is trimmed anyway); an empty row stays zero and trims to
    nothing."""
    out = np.zeros((len(rows), t_len), rows[0].dtype)
    for j, r in enumerate(rows):
        r = r[:t_len]
        if len(r):
            out[j] = np.tile(r, -(-t_len // len(r)))[:t_len]
    return out


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
