"""The TTE tokenizer and its symbol-file loader; a copy of the
`DFATokenizer` half of `parrot_tts_tpu/text/tokenizer.py`.

`DFATokenizer` mirrors the reference's (`modules/data.py:28-61`):
vocabulary = [<pad>, <sep>] + aligner symbols with ' ' replaced by 'sil';
it tokenizes a space-separated symbol sequence. Symbol inventories persist
as JSON, and `load_symbols` also accepts the reference's pickled
`symbols.pkl` (list or dict).
"""

from __future__ import annotations

import json
import pickle
from pathlib import Path
from typing import Iterable, List


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
