"""Aligner preprocessing: corpus text cleaning and the per-utterance
mel / token dump; port of `parrot_tts_tpu/pipeline/aligner_preprocess.py`.

Reference: `utils/aligner/preprocessor.py` (per-speaker language
detection -> cleaners -> clean_txt/, global symbols) and
`utils/aligner/character_preprocess.py` (per-utterance mel + token npy
through a worker pool). As in the JAX package, language detection falls
back to a script-ratio heuristic when `langdetect` is absent, and mels are
computed in padded batches on the device (`ops/stft.py::
librosa_mel_spectrogram`, IEEE float32) instead of per file with librosa;
the files written are the JAX package's.
"""

from __future__ import annotations

import concurrent.futures as cf
import pickle
from pathlib import Path

import numpy as np
import torch

from parrot_tts_tpu_torch.core.config import AlignerAudioConfig
from parrot_tts_tpu_torch.core.device import exact_numerics, resolve_device
from parrot_tts_tpu_torch.data.audio_io import read_wav
from parrot_tts_tpu_torch.ops.stft import librosa_mel_spectrogram
from parrot_tts_tpu_torch.text.cleaners import CLEANERS
from parrot_tts_tpu_torch.text.tokenizer import (CharTokenizer,
                                                 build_symbol_inventory,
                                                 save_symbols)


def detect_language(text: str) -> str:
    """Best-effort language id. Uses langdetect when importable (reference
    preprocessor.py:71-77); otherwise a script heuristic: mostly-ASCII ->
    en, else non-English."""
    try:
        from langdetect import detect  # optional

        return detect(text)
    except Exception:
        ascii_letters = sum(c.isascii() and c.isalpha() for c in text)
        other_letters = sum((not c.isascii()) and c.isalpha() for c in text)
        return "en" if ascii_letters >= other_letters else "xx"


def cleaner_for_language(lang: str, transliterate: bool = False):
    if lang == "en":
        return CLEANERS["english_cleaners"]
    if transliterate:
        return CLEANERS["nonenglish_cleaners"]
    return CLEANERS["nonenglish_cleaners_no_transliteration"]


def clean_corpus(dataset_dir: str | Path, out_dir: str | Path,
                 transliterate: bool = False) -> list[str]:
    """Clean every speaker's txt/ into clean_txt/ and write the global
    symbols file. Layout mirrors the reference:
    <dataset>/<speaker>/{txt,wavs}/... -> <out>/<speaker>/clean_txt/.
    Returns the symbol inventory."""
    dataset_dir, out_dir = Path(dataset_dir), Path(out_dir)
    all_texts: list[str] = []
    for spk_dir in sorted(p for p in dataset_dir.iterdir() if p.is_dir()):
        txt_files = sorted((spk_dir / "txt").glob("*.txt"))
        if not txt_files:
            continue
        sample = txt_files[len(txt_files) // 2].read_text().strip()
        cleaner = cleaner_for_language(detect_language(sample), transliterate)
        clean_dir = out_dir / spk_dir.name / "clean_txt"
        clean_dir.mkdir(parents=True, exist_ok=True)
        for tf in txt_files:
            cleaned = cleaner(tf.read_text().strip())
            (clean_dir / tf.name).write_text(cleaned)
            all_texts.append(cleaned)

    symbols = build_symbol_inventory(all_texts)
    save_symbols(out_dir / "symbols.pkl", symbols)
    save_symbols(out_dir / "symbols.json", symbols)
    return symbols


def compute_mels_and_tokens(speaker_dir: str | Path, out_dir: str | Path,
                            symbols: list[str],
                            audio_cfg: AlignerAudioConfig | None = None,
                            batch_size: int = 16, device=None) -> dict:
    """Per-utterance mel (+ token) npy dump for one speaker (reference
    character_preprocess.py:35-117). Mels are computed on the device in
    zero-padded batches of `batch_size` wavs (in file order), then each is
    cropped to its own 1 + len // hop frames. device: default the CUDA
    card (raises without one); "cpu" runs on the host."""
    device = resolve_device(device)
    audio_cfg = audio_cfg or AlignerAudioConfig()
    speaker_dir, out_dir = Path(speaker_dir), Path(out_dir)
    mel_dir = out_dir / "mels"
    tok_dir = out_dir / "tokens"
    mel_dir.mkdir(parents=True, exist_ok=True)
    tok_dir.mkdir(parents=True, exist_ok=True)

    tokenizer = CharTokenizer(symbols)
    wavs = sorted((speaker_dir / "wavs").glob("*.wav"))
    clean_txt = speaker_dir / "clean_txt"
    if not clean_txt.exists():
        clean_txt = out_dir.parent / speaker_dir.name / "clean_txt"

    def load_one(wav_path: Path):
        txt_path = clean_txt / (wav_path.stem + ".txt")
        if not txt_path.exists():
            return None
        data, sr = read_wav(wav_path)
        if sr != audio_cfg.sample_rate:
            raise ValueError(
                f"{wav_path}: sample rate {sr} != {audio_cfg.sample_rate}")
        audio = data.astype(np.float32) / 32768.0
        return wav_path.stem, audio, txt_path.read_text().strip()

    # host-parallel wav reads (the reference's worker Pool,
    # character_preprocess.py:109-110); mels batched on the device
    with cf.ThreadPoolExecutor(max_workers=8) as pool:
        items = [it for it in pool.map(load_one, wavs) if it is not None]
    dataset_index = []

    for off in range(0, len(items), batch_size):
        chunk = items[off : off + batch_size]
        max_len = max(len(a) for _, a, _ in chunk)
        padded = np.zeros((len(chunk), max_len), np.float32)
        for i, (_, a, _) in enumerate(chunk):
            padded[i, : len(a)] = a
        with torch.no_grad(), exact_numerics(True):
            mels = librosa_mel_spectrogram(
                torch.from_numpy(padded).to(device),
                sample_rate=audio_cfg.sample_rate, n_fft=audio_cfg.n_filters,
                n_mels=audio_cfg.n_mels, hop_length=audio_cfg.hop_length,
                win_length=audio_cfg.win_length, fmin=audio_cfg.fmin,
                fmax=audio_cfg.fmax, power=audio_cfg.power).cpu().numpy()
        for i, (stem, a, text) in enumerate(chunk):
            n_frames = 1 + len(a) // audio_cfg.hop_length
            np.save(mel_dir / f"{stem}.npy", mels[i, :n_frames])
            tokens = np.asarray(tokenizer(text), np.int64)
            np.save(tok_dir / f"{stem}.npy", tokens)
            dataset_index.append((stem, n_frames, len(tokens)))

    with open(out_dir / "dataset.pkl", "wb") as f:
        pickle.dump(dataset_index, f)
    return {"items": len(dataset_index)}
