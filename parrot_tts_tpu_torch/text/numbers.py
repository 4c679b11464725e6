"""Number-to-words expansion (dependency-free replacement for `inflect`);
a copy of `parrot_tts_tpu/text/numbers.py`.

The reference uses inflect.engine().number_to_words for cardinal/ordinal
expansion (reference `utils/aligner/cleaners.py:5,92,100-113`); inflect
is not a dependency, so the subset of behavior the cleaners rely on is
implemented here: cardinals with "and"-less joining (andword=""), grouped
year-style reading (group=2), and ordinals.
"""

from __future__ import annotations

_ONES = ["zero", "one", "two", "three", "four", "five", "six", "seven",
         "eight", "nine", "ten", "eleven", "twelve", "thirteen", "fourteen",
         "fifteen", "sixteen", "seventeen", "eighteen", "nineteen"]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]
_SCALES = [(10 ** 12, "trillion"), (10 ** 9, "billion"), (10 ** 6, "million"),
           (10 ** 3, "thousand"), (100, "hundred")]

_ORDINAL_IRREGULAR = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _under_100(n: int) -> str:
    if n < 20:
        return _ONES[n]
    tens, ones = divmod(n, 10)
    return _TENS[tens] + ("-" + _ONES[ones] if ones else "")


def number_to_words(n: int, andword: str = "and", zero: str = "zero",
                    group: int = 0) -> str:
    """inflect-compatible cardinal expansion for the cleaner's call shapes:
    number_to_words(num), number_to_words(num, andword=""),
    number_to_words(num, andword="", zero="oh", group=2)."""
    if n < 0:
        return "minus " + number_to_words(-n, andword, zero, group)
    if group == 2:
        # pairwise digit reading used for years, e.g. 1984 -> nineteen eighty-four
        s = str(n)
        if len(s) % 2:
            s = "0" + s
        parts = []
        for i in range(0, len(s), 2):
            pair = int(s[i : i + 2])
            if pair == 0:
                parts.append(f"{zero} {zero}")
            elif pair < 10:
                parts.append(zero + " " + _ONES[pair])
            else:
                parts.append(_under_100(pair))
        return " ".join(parts)
    if n == 0:
        return zero
    words: list[str] = []
    rem = n
    for scale, name in _SCALES:
        if rem >= scale:
            words.append(number_to_words(rem // scale, andword="") + " " + name)
            rem %= scale
    if rem:
        if words and andword:
            words.append(andword)
        words.append(_under_100(rem))
    return " ".join(w for w in words if w)


def number_to_ordinal_words(n_or_text) -> str:
    """inflect number_to_words('3rd')-style ordinal expansion. Accepts either
    an int or a string like '21st' (the cleaner passes the regex match text,
    cleaners.py:92)."""
    if isinstance(n_or_text, str):
        digits = "".join(c for c in n_or_text if c.isdigit())
        n = int(digits)
    else:
        n = int(n_or_text)
    words = number_to_words(n, andword="")
    head, _, last = words.rpartition(" ")
    hy_head, _, hy_last = last.rpartition("-")
    if hy_last in _ORDINAL_IRREGULAR:
        ord_last = _ORDINAL_IRREGULAR[hy_last]
    elif hy_last.endswith("y"):
        ord_last = hy_last[:-1] + "ieth"
    elif hy_last.endswith("t") and hy_last in ("eight",):
        ord_last = hy_last + "h"
    else:
        ord_last = hy_last + "th"
    last = (hy_head + "-" if hy_head else "") + ord_last
    return (head + " " if head else "") + last
