"""What decides `correct`: the benchmark's plain reference
(`reference/`) judges a sample of the requests the window served, drawn
from the seed, the longest among them, at their own lengths.

For each sampled request the reference tokenizes the text and runs the
TTE on the seeded weights, made again here. Its durations are forced to
the served unit count: where they sum to another count, the tokens whose
exp(p) - 1 lies nearest a rounding boundary, in the needed direction,
move by one frame. The numbers:

- dur_gap: the largest distance, in frames, by which such a token lay
  from its boundary (0 when the counts agree), over SAMPLE_DUR requests
  (the encoder alone);
- unit_gap: the widest gap by which a served unit's logit lies below the
  reference's best logit at its frame (teacher-forced on the served
  units), over SAMPLE requests, the longest among them;
- wave_err: how far the served waveforms lie from the reference's
  float32 waveforms, over the first SAMPLE_WAVE of those. For a float32
  configuration the worst request's share ||served - float32|| /
  ||float32||; for one in a lower precision, how much farther than the
  reference's own waveforms at that precision they lie, pooled over the
  requests: max(E / F - 1, 0) with E^2 = sum ||served - float32||^2 and
  F^2 = sum ||at the precision - float32||^2 (a sound path rounds as
  often and as finely, E = F to within a percent; a coarser one lies
  farther). The reference's generator runs on the served units, over
  the samples before the last `receptive_reach` ones (the system pads a
  batch's shorter rows with their own codes, which reach back that
  far);
- wave_len: requests of those SAMPLE_WAVE whose waveform is not 320
  samples per served unit.

Each has its limit in the configuration file ("correct"); the worst
request counts (the pooled wave_err excepted).
"""

import math

import numpy as np
import torch

from harness import traffic, weights, yardstick
from reference import ieee
from reference import text as ref_text
from reference import tte as ref_tte
from reference import vocoder as ref_vocoder

SAMPLE_DUR = 512       # requests whose durations are judged
SAMPLE = 64            # requests whose units are judged, the longest first
SAMPLE_WAVE = 16       # of which the vocoder's reference runs on the first
NAMES = ("unit_gap", "dur_gap", "wave_err", "wave_len")
DIAGNOSTICS = ("wave_vs_f32", "wave_floor", "wave_len_units")


def sample(win, seed: int, k: int = SAMPLE) -> list:
    """The longest served request and k - 1 others of those kept."""
    rng = traffic.rng_for(seed, "sample", 10**9)
    pool = [q for q in win.kept if q is not win.longest]
    pick = rng.choice(len(pool), min(k - 1, len(pool)), replace=False)
    return ([win.longest] if win.longest else []) + [pool[i] for i in pick]


def force(v: torch.Tensor, dur: torch.Tensor, total: int):
    """(durations summing to total, the largest boundary distance moved)."""
    dur = dur.clone()
    m = total - int(dur.sum())
    if m == 0:
        return dur, 0.0
    if m > 0:
        cost = dur.double() + 0.5 - v.double()
    else:
        cost = torch.where(dur > 0, v.double() - (dur.double() - 0.5),
                           torch.full_like(v.double(), math.inf))
    if abs(m) > int(torch.isfinite(cost).sum()):
        return None, math.inf
    idx = torch.argsort(cost)[: abs(m)]
    dur[idx] += 1 if m > 0 else -1
    return dur, float(cost[idx].max())


def _tte(tte_sd, tcfg, chars, text, speaker, n_units):
    """(encoder states, forced durations or None, dur_gap)."""
    enc, log_dur = ref_tte.encode(tte_sd, tcfg, ref_text.tokenize(text, chars),
                                  speaker)
    dur, gap = force(torch.exp(log_dur) - 1.0, ref_tte.durations(log_dur),
                     n_units)
    return enc, dur, gap


def judge(config: dict, seed: int, win, device) -> dict:
    """The numbers over the window's sampled requests, and as DIAGNOSTICS
    the largest ||served - float32|| / ||float32|| and ||at the
    precision - float32|| / ||float32||, and the most units of a request
    whose waveform has the wrong length."""
    tcfg, vcfg = config["tte"], config["vocoder"]
    chars = config["assumed"]["characters"]
    dtype = getattr(torch, config["correct"]["reference_dtype"])
    tte_sd, voc_sd = weights.make(config, seed, device)
    reach = yardstick.receptive_reach(vcfg)
    hop = math.prod(vcfg["upsample_rates"])
    out = dict.fromkeys(NAMES + DIAGNOSTICS, 0.0)
    pooled = [0.0, 0.0]    # E^2, F^2 (lower precision)
    rng = traffic.rng_for(seed, "sample", 10**9 + 1)
    pick = rng.choice(len(win.served), min(SAMPLE_DUR, len(win.served)),
                      replace=False)
    with ieee():
        for i in pick:
            _, _, gap = _tte(tte_sd, tcfg, chars, *win.served[i])
            out["dur_gap"] = max(out["dur_gap"], gap)
        for i, q in enumerate(sample(win, seed)):
            enc, dur, gap = _tte(tte_sd, tcfg, chars, q.text, q.speaker,
                                 len(q.units))
            out["dur_gap"] = max(out["dur_gap"], gap)
            if dur is None:
                out["unit_gap"] = math.inf
                continue
            logits = ref_tte.decode(tte_sd, tcfg, enc, dur)
            units = torch.as_tensor(np.asarray(q.units, np.int64),
                                    device=logits.device)
            served = logits.gather(1, units[:, None])[:, 0]
            out["unit_gap"] = max(out["unit_gap"], float(
                (logits.max(dim=1).values - served).max()))
            if i >= SAMPLE_WAVE:
                continue
            if len(q.wav) != len(q.units) * hop:
                out["wave_len"] += 1
                out["wave_len_units"] = max(out["wave_len_units"],
                                            len(q.units))
                continue
            m = len(q.wav) - reach
            if m <= 0:
                continue
            y32 = ref_vocoder.generate(voc_sd, vcfg, q.units,
                                       q.speaker)[:m].double()
            norm = float(y32.norm())
            e = float((torch.as_tensor(q.wav[:m], device=y32.device).double()
                       - y32).norm()) / norm
            if dtype == torch.float32:
                f = 0.0
                out["wave_err"] = max(out["wave_err"], e)
            else:
                y = ref_vocoder.generate(voc_sd, vcfg, q.units, q.speaker,
                                         dtype)
                f = float((y[:m].double() - y32).norm()) / norm
                pooled[0] += (e * norm) ** 2
                pooled[1] += (f * norm) ** 2
            out["wave_vs_f32"] = max(out["wave_vs_f32"], e)
            out["wave_floor"] = max(out["wave_floor"], f)
    if pooled[1] > 0:
        out["wave_err"] = max(math.sqrt(pooled[0] / pooled[1]) - 1.0, 0.0)
    return out


def verdict(numbers: dict, limits: dict, failed: int) -> bool:
    return failed == 0 and all(numbers[k] <= limits[k] for k in NAMES)
