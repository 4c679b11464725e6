"""Tokenizers and the symbol inventory; a copy of
`parrot_tts_tpu/text/tokenizer.py`.

Two tokenizers mirror the reference's:
  * `CharTokenizer` - the aligner's `Tokenizer` (`utils/aligner/
    text.py:4-29`): ids start at 1, 0 is the pad token, unknown characters
    are silently dropped; optional space-split phoneme mode.
  * `DFATokenizer` - the TTE's (`modules/data.py:28-61`): vocabulary =
    [<pad>, <sep>] + aligner symbols with ' ' replaced by 'sil'; it
    tokenizes a space-separated symbol sequence.

Symbol inventories persist as JSON, and as the reference's pickled
`symbols.pkl`; `load_symbols` reads either (a list, or a dict's keys).
"""

from __future__ import annotations

import json
import pickle
from pathlib import Path
from typing import Iterable, List


def build_symbol_inventory(texts: Iterable[str]) -> list[str]:
    """Global sorted symbol set over cleaned texts (reference
    utils/aligner/preprocessor.py:91-108)."""
    symbols: set[str] = set()
    for t in texts:
        symbols.update(t)
    return sorted(symbols)


def save_symbols(path: str | Path, symbols: list[str]) -> None:
    """`.pkl` -> pickled list (the reference's format), else JSON."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if path.suffix == ".pkl":
        with open(path, "wb") as f:
            pickle.dump(symbols, f)
    else:
        path.write_text(json.dumps(symbols, ensure_ascii=False))


def load_symbols(path: str | Path) -> list[str]:
    path = Path(path)
    if path.suffix == ".pkl":
        with open(path, "rb") as f:
            obj = pickle.load(f)
    else:
        obj = json.loads(path.read_text())
    if isinstance(obj, dict):          # reference tolerates dict symbols.pkl
        return list(obj.keys())
    return list(obj)


class CharTokenizer:
    """Aligner tokenizer (reference utils/aligner/text.py)."""

    def __init__(self, symbols: List[str], pad_token: str = "_",
                 for_phonemes: bool = False):
        self.symbols = list(symbols)
        self.pad_token = pad_token
        self.idx_to_token = {i: s for i, s in enumerate(self.symbols, start=1)}
        self.idx_to_token[0] = pad_token
        self.token_to_idx = {s: i for i, s in self.idx_to_token.items()}
        self.vocab_size = len(self.symbols) + 1
        self.for_phonemes = for_phonemes

    def __call__(self, sentence: str) -> list[int]:
        units = sentence.split(" ") if self.for_phonemes else sentence
        return [self.token_to_idx[c] for c in units if c in self.token_to_idx]

    def decode(self, sequence: Iterable[int]) -> str:
        toks = [self.idx_to_token[int(t)] for t in sequence
                if int(t) in self.idx_to_token]
        return (" " if self.for_phonemes else "").join(toks)


class DFATokenizer:
    """TTE tokenizer over the aligner's symbol set
    (reference modules/data.py:28-61)."""

    PAD = "<pad>"
    SEP = "<sep>"

    def __init__(self, symbols: List[str]):
        symbols = list(symbols)
        if " " in symbols:            # ' ' -> 'sil' (data.py:46-48)
            symbols[symbols.index(" ")] = "sil"
        self.symbols = [self.PAD, self.SEP] + symbols
        self.stoi = {s: i for i, s in enumerate(self.symbols)}
        self.itos = {i: s for i, s in enumerate(self.symbols)}
        self.pad_idx = self.stoi[self.PAD]
        self.sep_idx = self.stoi[self.SEP]

    @classmethod
    def from_alignment_path(cls, alignment_path: str | Path) -> "DFATokenizer":
        p = Path(alignment_path)
        for name in ("symbols.pkl", "symbols.json"):
            if (p / name).exists():
                return cls(load_symbols(p / name))
        raise FileNotFoundError(f"no symbols.pkl/json under {p}")

    def __len__(self) -> int:
        return len(self.symbols)

    def tokenize(self, symbol_seq: Iterable[str]) -> list[int]:
        return [self.stoi[s] for s in symbol_seq]

    def tokenize_text(self, characters: str) -> list[int]:
        """Tokenize the manifest's space-separated character field."""
        return self.tokenize(characters.split(" "))
