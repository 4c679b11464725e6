"""Set-up warm-up and the measured window: the closed loop (back-to-back
`tts()` calls) and the open loop (arrivals on a schedule, a batcher that
takes every due request, up to the mix's "max_batch", whenever `tts()`
is free). Every request is kept in the record with its times, text,
speaker and unit count; a few, drawn from the seed, keep their units and
waveform too, for the check.
"""

import time
from dataclasses import dataclass, field

import numpy as np

from harness import traffic
from harness.system import synchronize

KEEP_PER_CALL = 8          # requests a call keeps for the check, besides
                           # the longest served so far


@dataclass
class Kept:
    text: str
    speaker: int
    units: np.ndarray
    wav: np.ndarray


@dataclass
class Call:
    start: float            # seconds after the window opened
    end: float
    n: int
    audio_s: float
    stats: dict
    tokens: list            # token count of each request
    units: list             # unit count of each request
    seqs: list              # the token sequences
    plan: list | None = None    # (s_len, out_len, request indices), after
                                # the window (system.plan)


@dataclass
class Window:
    seconds: float = 0.0            # the nominal length
    calls: list = field(default_factory=list)
    due: list = field(default_factory=list)      # per request, seconds
    done: list = field(default_factory=list)     # None: never served
    picked: list = field(default_factory=list)
    served: list = field(default_factory=list)   # (text, speaker, units)
    kept: list = field(default_factory=list)
    longest: Kept | None = None
    failed: int = 0
    errors: list = field(default_factory=list)

    @property
    def attempted(self) -> int:
        return len(self.due)

    @property
    def last_end(self) -> float:
        return max((c.end for c in self.calls), default=0.0)


def _serve(tts, tap, reqs, win: Window, t0: float, seed: int, index: int):
    """One tts() call; its record and its kept requests."""
    start = time.perf_counter() - t0
    try:
        wavs = tts.tts([r.text for r in reqs], [r.speaker for r in reqs])
    except Exception as exc:           # a failed call fails its requests
        win.failed += len(reqs)
        win.errors.append(f"{type(exc).__name__}: {exc}")
        return None, start
    end = time.perf_counter() - t0
    tapped = tap.pop()
    units = tapped["units"]
    win.calls.append(Call(start, end, len(reqs),
                          sum(len(w) for w in wavs) / tts.vocoder.sample_rate,
                          dict(tts.last_stats),
                          [len(t) for t in tapped["tokens"]],
                          [len(u) for u in units], tapped["tokens"]))
    win.served += [(r.text, r.speaker, len(u)) for r, u in zip(reqs, units)]
    rng = traffic.rng_for(seed, "sample", index)
    for j in rng.choice(len(reqs), min(KEEP_PER_CALL, len(reqs)),
                        replace=False):
        win.kept.append(Kept(reqs[j].text, reqs[j].speaker, units[j], wavs[j]))
    j = int(np.argmax([len(u) for u in units]))
    if win.longest is None or len(units[j]) > len(win.longest.units):
        win.longest = Kept(reqs[j].text, reqs[j].speaker, units[j], wavs[j])
    return end, start


def closed(tts, tap, spec: dict, seed: int, n_speaker: int,
           seconds: float, calls: list) -> Window:
    """Back-to-back calls while the window is open; the last call
    started before the close runs to its end. `calls` are the prepared
    calls (more are made if the window outlasts them)."""
    win = Window(seconds)
    t0 = synchronize(tts.device)
    i = 0
    while time.perf_counter() - t0 < seconds:
        if i == len(calls):
            calls.append(traffic.call(spec, seed, n_speaker, i))
        reqs = calls[i]
        end, start = _serve(tts, tap, reqs, win, t0, seed, i)
        win.due += [start] * len(reqs)
        win.picked += [start] * len(reqs)
        win.done += [end] * len(reqs)
        i += 1
    return win


def open_loop(tts, tap, spec: dict, seed: int, reqs: list,
              seconds: float, drain_s: float = 60.0) -> Window:
    """Serve every request of `reqs` (due in [0, seconds)); a request not
    served within drain_s of the close counts as failed."""
    win = Window(seconds)
    win.due = [r.due for r in reqs]
    win.done = [None] * len(reqs)
    win.picked = [None] * len(reqs)
    t0 = synchronize(tts.device)
    k, index = 0, 0
    while k < len(reqs):
        now = time.perf_counter() - t0
        if now > seconds + drain_s:
            win.failed += len(reqs) - k
            break
        if reqs[k].due > now:
            time.sleep(min(reqs[k].due - now, 0.01))
            continue
        j = k
        while (j < len(reqs) and j - k < spec["max_batch"]
               and reqs[j].due <= now):
            j += 1
        end, start = _serve(tts, tap, reqs[k:j], win, t0, seed, index)
        for m in range(k, j):
            win.picked[m] = start
            win.done[m] = end
        k, index = j, index + 1
    return win


def warm(tts, tap, spec: dict, seed: int, n_speaker: int) -> None:
    """Serve the mix's warm-up: its calls, then (with "rows") a call of
    each batch size and the vocoder at each batch size in every code
    bucket the calls reached."""
    from parrot_tts_tpu_torch.data.tte_data import pick_bucket
    from parrot_tts_tpu_torch.infer.synthesize import CODE_BUCKETS

    w = spec.get("warmup", {})
    buckets = set()
    if spec["loop"] == "closed":
        n = spec["requests_per_call"]
    else:
        n = spec["max_batch"]
    for i in range(w.get("calls", 1)):
        if spec["loop"] == "closed":
            reqs = traffic.call(spec, seed, n_speaker, i, "warmup")
        else:
            reqs = traffic.call({**spec, "requests_per_call": n}, seed,
                                n_speaker, i, "warmup")
        tts.tts([r.text for r in reqs], [r.speaker for r in reqs])
        buckets |= {pick_bucket(CODE_BUCKETS, len(u))
                    for u in tap.pop()["units"]}
    if "rows" in w:
        lo, hi = w["rows"]
        pool = traffic.call({**spec, "requests_per_call": hi}, seed,
                            n_speaker, 10**6, "warmup")
        for r in range(lo, hi + 1):
            tts.tts([q.text for q in pool[:r]], [q.speaker for q in pool[:r]])
            buckets |= {pick_bucket(CODE_BUCKETS, len(u))
                        for u in tap.pop()["units"]}
        codes = np.arange(max(buckets), dtype=np.int64) % 997
        for b in sorted(buckets):
            for r in range(lo, hi + 1):
                tts.vocoder.synthesize([codes[:b]] * r, [0] * r)
    synchronize(tts.device)
