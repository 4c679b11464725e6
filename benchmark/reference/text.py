"""Text -> TTE token ids, as the reference's English front end treats text
over the benchmark's alphabet: lower case, runs of whitespace collapsed
to one space, characters outside the symbol set dropped; the vocabulary
is [<pad>, <sep>] + the symbols (the space stands for "sil")."""

import re

SPECIAL = 2                      # <pad>, <sep> come before the symbols


def tokenize(text: str, characters: str) -> list[int]:
    """Token ids of `text` over the ordered symbol set `characters`."""
    text = re.sub(r"\s+", " ", text.lower())
    return [SPECIAL + characters.index(c) for c in text if c in characters]
