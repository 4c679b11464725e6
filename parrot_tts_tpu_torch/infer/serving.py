"""Joint TTE + vocoder serving: batched text -> 16 kHz waveforms.

Port of `parrot_tts_tpu/infer/serving.py::ParrotTTS`, on one CUDA device
or, with `mesh=`, sharded over a mesh's data axis in both stages (the TTE
decode and the vocoder; `core/mesh.py`). Both stages use folded
(inference) parameters. The default decode is
"selective-high", as in the JAX class, which the card runs as IEEE
float32 throughout (`models/tte/parrot.py` lists the modes). A string
mode sets the TTE decode only: the vocoder then runs as under exact=True
(IEEE float32, deterministic), so units equal to exact=True's give the
same waveform bits. exact=True is IEEE float32 but
for attention's 3xTF32 kernel; exact=False allows TF32 in both stages. A
vocoder config with dtype="bfloat16" serves the vocoder in bf16
(`infer/synthesize.py`); the TTE keeps its decode mode.
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import numpy as np

from parrot_tts_tpu_torch.core import mesh as meshlib
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
    dicts (convert.py carries JAX trees across). exact: the TTE decode
    mode, "selective-high" by default (module docstring), or "hybrid"
    (`infer/tte_infer.py::decode_buckets`, threshold 0.5). device: default
    the CUDA card, raising without one, or the mesh's first device; pass
    "cpu" to run on the host. mesh: shard both stages' batches over the
    mesh's data axis (each replica on its device, outputs fetched
    globally, so `last_stats` counts the global audio)."""

    def __init__(self, tte_state: dict, tte_cfg: TTEModelConfig,
                 vocoder_state: dict, vocoder_cfg: VocoderModelConfig,
                 tokenizer: DFATokenizer, cleaner: Callable[[str], str], *,
                 src_buckets: tuple[int, ...] = SRC_BUCKETS,
                 out_len_per_token: int = 16, batch_size: int = 64,
                 exact: bool | str = "selective-high", device=None,
                 mesh: meshlib.Mesh | None = None):
        parrot.check_exact(exact, hybrid=True)
        self.device = resolve_device(
            mesh.local_data[0] if device is None and mesh else device)
        self.mesh = mesh
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
        self.replicas = (None if mesh is None
                         else meshlib.replicated(mesh, self.tte))
        self.vocoder = VocoderSynthesizer(
            vocoder_state, vocoder_cfg, exact=exact is not False,
            device=self.device, mesh=mesh)
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
        return decode_buckets(self.replicas or self.tte, samples,
                              self.plan(token_seqs),
                              batch_size=self.batch_size, exact=self.exact,
                              device=self.device, stats=stats,
                              mesh=self.mesh)

    def tts(self, texts: Sequence[str],
            speakers: Sequence[int] | None = None,
            vocoder_speakers: Sequence[int] | None = None) -> list[np.ndarray]:
        """Batched text -> float32 waveforms. Records the decode mode, wall
        time, the TTE / vocoder split, audio-seconds per second, RTF, the
        number of decode batches and (hybrid) of re-decoded requests in
        `last_stats`."""
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
            "exact": self.exact,
            **stats,
            "wall_s": dt,
            "tte_s": t1 - t0,
            "vocoder_s": dt - (t1 - t0),
            "audio_seconds": audio_s,
            "audio_seconds_per_second": audio_s / dt if dt else 0.0,
            "rtf": dt / audio_s if audio_s else None,
        }
        return wavs
