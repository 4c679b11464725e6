"""The one traffic generator. A mix is a data file, `traffic/<name>.json`:

- "loop": "closed" (back-to-back `tts()` calls of "requests_per_call"
  requests) or "open" (arrivals at "rate_per_s" on a schedule, taken by
  the benchmark's batcher up to "max_batch" rows a call);
- "chars": the request's length in characters, {"dist": "normal",
  "mean", "sd", "min", "max"} (clipped) or {"dist": "uniform", "min",
  "max"};
- "warmup": {"calls": n, "rows": [lo, hi] (optional)}: set-up serves n
  calls of the mix and, with "rows", every batch size in [lo, hi];
- "source", "why": where the numbers come from.

Every seed gets the same set of requests' lengths and speakers (and,
open, of gaps between arrivals): the quantiles of the distribution, the
speakers in turn over them, in an order drawn from the seed. The seed
draws the words, the punctuation and the order. A request's text is
exactly its length in characters of the alphabet, words from
`words.txt` (none that the English cleaner would expand), so it is also
its length in tokens.
"""

import math
import statistics
from dataclasses import dataclass
from pathlib import Path

import numpy as np

WORDS = (Path(__file__).with_name("words.txt")).read_text().split()
STREAMS = {"window": 1, "warmup": 2, "sample": 3, "calibration": 4}


def lengths(chars: dict, n: int) -> list[int]:
    """The n quantiles (i + 1/2) / n of the length distribution."""
    qs = [(i + 0.5) / n for i in range(n)]
    if chars["dist"] == "normal":
        dist = statistics.NormalDist(chars["mean"], chars["sd"])
        vals = [round(dist.inv_cdf(q)) for q in qs]
    elif chars["dist"] == "uniform":
        lo, hi = chars["min"], chars["max"]
        vals = [lo + math.floor(q * (hi - lo + 1)) for q in qs]
    else:
        raise ValueError(f"unknown length distribution {chars['dist']!r}")
    return [min(max(v, chars["min"]), chars["max"]) for v in vals]


def text(rng: np.random.Generator, n: int) -> str:
    """Exactly n characters of words, spaces and , . ?"""
    parts, size = [], 0
    while size <= n:
        w = WORDS[rng.integers(len(WORDS))]
        p = rng.random()
        w += "," if p < 0.08 else "." if p < 0.12 else "?" if p < 0.13 else ""
        parts.append(w)
        size += len(w) + 1
    s = " ".join(parts)[:n]
    return s[:-1] + "." if s.endswith(" ") else s


def rng_for(seed: int, stream: str, index: int = 0) -> np.random.Generator:
    return np.random.default_rng([seed % 2**64, STREAMS[stream], index])


@dataclass
class Request:
    text: str
    speaker: int
    due: float = 0.0          # seconds after the window opened (open loop)


def _requests(rng: np.random.Generator, ls: list[int],
              n_speaker: int) -> list[Request]:
    """Requests of the lengths ls (sorted), the speakers in turn over
    them, in an order drawn from rng."""
    return [Request(text(rng, ls[i]), i % n_speaker)
            for i in rng.permutation(len(ls))]


def call(spec: dict, seed: int, n_speaker: int, index: int,
         stream: str = "window") -> list[Request]:
    """The index-th call of a closed mix."""
    return _requests(rng_for(seed, stream, index),
                     lengths(spec["chars"], spec["requests_per_call"]),
                     n_speaker)


def arrivals(spec: dict, seed: int, n_speaker: int, seconds: float,
             stream: str = "window") -> list[Request]:
    """Requests of an open mix due in [0, seconds), in due order."""
    rate = spec["rate_per_s"]
    m = max(1, round(rate * seconds))
    rng = rng_for(seed, stream)
    gaps = [-math.log(1.0 - (i + 0.5) / m) for i in range(m)]
    rng.shuffle(gaps)
    out, u = [], 0.0
    for g, r in zip(gaps, _requests(rng, lengths(spec["chars"], m),
                                    n_speaker)):
        if u / rate >= seconds:
            break
        r.due = u / rate
        out.append(r)
        u += g
    return out
