"""Text cleaners: English, non-English (± transliteration), Devanagari
numerals. A copy of `parrot_tts_tpu/text/cleaners.py`, kept so the port
imports nothing of the JAX package.

Behavior-parity reimplementation of the reference's
`utils/aligner/cleaners.py` (character-set parity matters for unit-exact
TTE outputs — SURVEY.md §7). `unidecode` is replaced by a stdlib NFKD transliteration
(`ascii_transliterate`) that covers the Latin-script accents the reference
corpora contain; `inflect` by `parrot_tts_tpu_torch.text.numbers`.
"""

from __future__ import annotations

import re
import unicodedata

from parrot_tts_tpu_torch.text.numbers import (
    number_to_ordinal_words,
    number_to_words,
)

_comma_number_re = re.compile(r"([0-9][0-9\,]+[0-9])")
_decimal_number_re = re.compile(r"([0-9]+\.[0-9]+)")
_pounds_re = re.compile(r"£([0-9\,]*[0-9]+)")
_dollars_re = re.compile(r"\$([0-9\.\,]*[0-9]+)")
_ordinal_re = re.compile(r"[0-9]+(st|nd|rd|th)")
_number_re = re.compile(r"[0-9]+")
_whitespace_re = re.compile(r"\s+")

# (abbreviation, expansion) pairs (reference cleaners.py:16-38)
_ABBREVIATIONS = [
    (re.compile(rf"\b{abbr}\.", re.IGNORECASE), full)
    for abbr, full in [
        ("mrs", "misess"), ("&", "and"), ("mr", "mister"), ("dr", "doctor"),
        ("st", "saint"), ("co", "company"), ("jr", "junior"), ("maj", "major"),
        ("gen", "general"), ("drs", "doctors"), ("rev", "reverend"),
        ("lt", "lieutenant"), ("hon", "honorable"), ("sgt", "sergeant"),
        ("capt", "captain"), ("esq", "esquire"), ("ltd", "limited"),
        ("col", "colonel"), ("ft", "fort"), ("tts", "text to speech"),
    ]
]

_HINDI_NUMBERS = {
    0: "शून्य", 1: "एक", 2: "दो", 3: "तीन", 4: "चार", 5: "पाँच", 6: "छह",
    7: "सात", 8: "आठ", 9: "नौ", 10: "दस", 11: "ग्यारह", 12: "बारह",
    13: "तेरह", 14: "चौदह", 15: "पंद्रह", 16: "सोलह", 17: "सत्रह",
    18: "अठारह", 19: "उन्नीस", 20: "बीस", 30: "तीस", 40: "चालीस",
    50: "पचास", 60: "साठ", 70: "सत्तर", 80: "अस्सी", 90: "नब्बे",
    100: "सौ", 200: "दो सौ", 300: "तीन सौ", 400: "चार सौ", 500: "पाँच सौ",
    600: "छह सौ", 700: "सात सौ", 800: "आठ सौ", 900: "नौ सौ",
}

_EN_UNWANTED = ['#', '+', '\\', '_', '`', '@', '/', '-', "'", '>', '<', '(',
                ')', '*', '"', ':', ';', '!']
_NONEN_UNWANTED = ['|', '%', '+', '=', '[', ']', '^', '\\', '{', '}', '_',
                   '`', '‘', '’', '@', '/', '-', "'", '>', '<', '(', ')',
                   '*', '"', ':', ';', '!']
_NONEN_NOTRANS_UNWANTED = ['—', '⇒', "'", '–', '…', '“', '”', '%', '+', '=',
                           '[', ']', '^', '\\', '{', '}', '_', '`', '‘', '’',
                           '@', '/', '-', "'", '>', '<', '(', ')', '*', '"',
                           ':', ';', '!']


def ascii_transliterate(text: str) -> str:
    """unidecode-lite: NFKD-decompose and drop combining marks, keep ASCII.
    Covers accented Latin (é->e, ü->u ...); non-Latin scripts are dropped
    like the reference's subsequent [^\\x20-\\x7E] strip would anyway."""
    out = []
    for ch in text:
        if ord(ch) < 128:
            out.append(ch)
            continue
        decomp = unicodedata.normalize("NFKD", ch)
        out.extend(c for c in decomp if ord(c) < 128
                   and not unicodedata.combining(c))
    return "".join(out)


def collapse_whitespace(text: str) -> str:
    return re.sub(_whitespace_re, " ", text)


def lowercase(text: str) -> str:
    return text.lower()


def expand_abbreviations(text: str) -> str:
    for regex, replacement in _ABBREVIATIONS:
        text = re.sub(regex, replacement, text)
    return text


def _remove_commas(m):
    return m.group(1).replace(",", "")


def _expand_decimal_point(m):
    return m.group(1).replace(".", " point ")


def _expand_dollars(m):
    match = m.group(1)
    parts = match.split(".")
    if len(parts) > 2:
        return match + " dollars"
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    if dollars and cents:
        d_unit = "dollar" if dollars == 1 else "dollars"
        c_unit = "cent" if cents == 1 else "cents"
        return f"{dollars} {d_unit}, {cents} {c_unit}"
    if dollars:
        return f"{dollars} {'dollar' if dollars == 1 else 'dollars'}"
    if cents:
        return f"{cents} {'cent' if cents == 1 else 'cents'}"
    return "zero dollars"


def _expand_ordinal(m):
    return number_to_ordinal_words(m.group(0))


def _expand_number(m):
    num = int(m.group(0))
    if 1000 < num < 3000:
        if num == 2000:
            return "two thousand"
        if 2000 < num < 2010:
            return "two thousand " + number_to_words(num % 100)
        if num % 100 == 0:
            return number_to_words(num // 100) + " hundred"
        return number_to_words(num, andword="", zero="oh", group=2).replace(
            ", ", " ")
    return number_to_words(num, andword="")


def normalize_numbers(text: str) -> str:
    text = re.sub(_comma_number_re, _remove_commas, text)
    text = re.sub(_pounds_re, r"\1 pounds", text)
    text = re.sub(_dollars_re, _expand_dollars, text)
    text = re.sub(_decimal_number_re, _expand_decimal_point, text)
    text = re.sub(_ordinal_re, _expand_ordinal, text)
    text = re.sub(_number_re, _expand_number, text)
    return text


expand_numbers = normalize_numbers


def basic_cleaners(text: str) -> str:
    """Lowercase + collapse whitespace (reference cleaners.py:115-119)."""
    return collapse_whitespace(lowercase(text))


def english_cleaners(input_text: str) -> str:
    """Reference cleaners.py:120-140."""
    input_text = ascii_transliterate(input_text)
    input_text = input_text.lower()
    input_text = expand_numbers(input_text)
    input_text = expand_abbreviations(input_text)
    input_text = collapse_whitespace(input_text)
    cleaned = re.sub(r"[^\x20-\x7E]", "", input_text)
    for ch in _EN_UNWANTED:
        cleaned = cleaned.replace(ch, "")
    return cleaned.replace("&", "and")


def nonenglish_cleaners(input_text: str) -> str:
    """Reference cleaners.py:142-166 (with transliteration)."""
    input_text = ascii_transliterate(input_text)
    input_text = input_text.lower()
    input_text = collapse_whitespace(input_text)
    for d in "0123456789":
        input_text = input_text.replace(d, "")
    cleaned = re.sub(r"[^\x20-\x7E]", "", input_text)
    for ch in _NONEN_UNWANTED:
        cleaned = cleaned.replace(ch, "")
    cleaned = cleaned.replace("&", "and")
    return " ".join(cleaned.split())


def number_to_hindi(num: int) -> str:
    """Reference cleaners.py:168-181."""
    if num in _HINDI_NUMBERS:
        return _HINDI_NUMBERS[num]
    if num < 100:
        return _HINDI_NUMBERS[(num // 10) * 10] + " " + _HINDI_NUMBERS[num % 10]
    if num < 1000:
        hundreds = (num // 100) * 100
        rem = num % 100
        if rem == 0:
            return _HINDI_NUMBERS[hundreds]
        return _HINDI_NUMBERS[hundreds] + " " + number_to_hindi(rem)
    raise ValueError(f"devanagari number out of range: {num}")


def replace_devanagari_numbers(text: str) -> str:
    """Reference cleaners.py:183-202."""
    dev_digits = {"०": "0", "१": "1", "२": "2", "३": "3", "४": "4",
                  "५": "5", "६": "6", "७": "7", "८": "8", "९": "9"}

    def repl(m):
        n = int("".join(dev_digits[c] for c in m.group(0)))
        return number_to_hindi(n)

    return re.sub(r"[०१२३४५६७८९]+", repl, text)


def nonenglish_cleaners_no_transliteration(input_text: str) -> str:
    """Reference cleaners.py:204-233 (keeps native script)."""
    input_text = collapse_whitespace(input_text)
    for d in "0123456789":
        input_text = input_text.replace(d, "")
    for ch in _NONEN_NOTRANS_UNWANTED:
        input_text = input_text.replace(ch, "")
    input_text = input_text.replace("|", ".")
    input_text = replace_devanagari_numbers(input_text)
    for ch in ("\x92", "\xad", "\x10", "\x13", "\x14", "\x16", "\x91"):
        input_text = input_text.replace(ch, "")
    return " ".join(input_text.split())


CLEANERS = {
    "basic_cleaners": basic_cleaners,
    "english_cleaners": english_cleaners,
    "nonenglish_cleaners": nonenglish_cleaners,
    "nonenglish_cleaners_no_transliteration":
        nonenglish_cleaners_no_transliteration,
}
