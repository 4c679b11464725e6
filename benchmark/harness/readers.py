"""What the metric readers (`metrics/<name>.py`) compute, over a run's
record: `Run` holds the cell, its configuration and mix, the window's
calls and requests, the set-up time and, in a traced run, the trace. A
reader returns None where it finds nothing to read."""

from dataclasses import dataclass

import numpy as np

from harness import yardstick

ATTENTION_KERNELS = ("attn_kernel", "prep_kernel")   # csrc/flash_attn_fwd.cu
MRF_KERNELS = ("mrf_kernel",)                        # csrc/fused_mrf.cu


@dataclass
class Run:
    cell: str
    config: dict
    traffic: dict
    window: object            # harness.loops.Window
    setup_s: float
    batch_size: int           # rows of a decode batch (the system's)
    trace: object = None      # harness.trace.Trace


def closed_only(run: Run) -> bool:
    return run.traffic["loop"] == "closed"


def audio_s_per_s(run: Run):
    w = run.window
    if not closed_only(run) or not w.calls:
        return None
    return sum(c.audio_s for c in w.calls) / w.last_end


def latency_ms(run: Run, q: float):
    """The q-th percentile (linear between ranks) of due-to-return times;
    a request never served counts as waiting until the batcher gave up."""
    w = run.window
    if closed_only(run) or not w.due:
        return None
    give_up = max(w.last_end, w.seconds + 60.0)
    lat = [(d if d is not None else give_up) - due
           for d, due in zip(w.done, w.due)]
    return 1e3 * float(np.percentile(lat, q))


def _audio(run: Run) -> float:
    return sum(c.audio_s for c in run.window.calls)


def stage_ms_per_audio_s(run: Run, key: str):
    """Summed last_stats[key] over the audio seconds served, in ms."""
    audio = _audio(run)
    if not audio:
        return None
    return 1e3 * sum(c.stats[key] for c in run.window.calls) / audio


def decode_pad_pct(run: Run):
    """1 - units returned / (rows x decoder length) over the decode plans."""
    cap = sum(len(idxs) * out_len for c in run.window.calls
              for _, out_len, idxs in c.plan)
    if not cap:
        return None
    return 100.0 * (1.0 - sum(sum(c.units) for c in run.window.calls) / cap)


def _attention_launches(run: Run) -> list:
    """Row lengths of every attention launch: per decode batch, each
    encoder block over the rows' tokens, each decoder block over their
    units."""
    cfg = run.config["tte"]
    out = []
    for c in run.window.calls:
        for _, _, idxs in c.plan:
            for off in range(0, len(idxs), run.batch_size):
                rows = idxs[off: off + run.batch_size]
                enc = [c.tokens[i] for i in rows]
                dec = [c.units[i] for i in rows]
                out += [enc] * cfg["encoder"]["n_layer"]
                out += [dec] * cfg["decoder"]["n_layer"]
    return out


def attn_roofline(run: Run):
    t = run.trace
    spent = t.kernel_s(*ATTENTION_KERNELS) if t else 0.0
    if not spent:
        return None
    cfg = run.config["tte"]
    heads = cfg["encoder"]["n_head"]
    bound = yardstick.attention_bound_s(_attention_launches(run), heads,
                                        cfg["d_model"] // heads)
    return 100.0 * bound / spent


def mrf_roofline(run: Run):
    t = run.trace
    spent = t.kernel_s(*MRF_KERNELS) if t else 0.0
    if not spent:
        return None
    vcfg = run.config["vocoder"]
    bound = sum(yardstick.mrf_bound_s(c.units, vcfg, vcfg["dtype"])
                for c in run.window.calls)
    return 100.0 * bound / spent


def device_idle_pct(run: Run):
    t = run.trace
    if not t or not t.kernels:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def busy_ms_per_request(run: Run):
    t = run.trace
    n = sum(c.n for c in run.window.calls)
    if not t or not t.kernels or not n:
        return None
    return 1e3 * t.busy_s / n


def mfu(run: Run):
    """Sum over requests of the model's operations at the peak of their
    type, over the summed wall time of the tts() calls, in %."""
    tcfg, vcfg = run.config["tte"], run.config["vocoder"]
    need, wall = 0.0, 0.0
    for c in run.window.calls:
        wall += c.end - c.start
        for tok, units in zip(c.tokens, c.units):
            need += (yardstick.tte_ops(tcfg, tok, units)
                     / yardstick.PEAK["float32"]
                     + yardstick.vocoder_ops(vcfg, units)
                     / yardstick.PEAK[vcfg["dtype"]])
    return 100.0 * need / wall if wall else None
