#!/usr/bin/env python3
"""The benchmark of parrot_tts_tpu_torch's serving, one cell a run.

    python3 benchmark/run.py --workload f32.bulk --seed 7 --seconds 30 \
        --trace 0

from the root of a checkout on a machine with a CUDA card. A cell
(`BENCHMARK.json` "workloads") names a configuration file and a traffic
mix (`traffic/<name>.json`). The run makes the weights and the requests
from --seed, builds `ParrotTTS` as the configuration states, warms up
the mix's shapes (the set-up, `setup_s`), serves the mix for --seconds,
then judges a sample of what it served against the plain reference
(`reference/`, `harness/check.py`). With --trace 1 the window runs under
torch.profiler (its first TRACE_SECONDS) and the line carries the
per-layer metrics in place of the end-to-end ones. Each metric is
computed by `metrics/<name>.py`.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device, (traced) breakdown, and last, checks: each
number compared with its limit, which the last lines of standard error
repeat. Without a card, with fewer cards than the cell asks for, without
the port beside it, or with JAX loaded, it exits non-zero and prints no
result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "parrot_tts_tpu")
TRACE_SECONDS = 10.0       # a traced run serves this much of its window
# build and kernel caches at fixed paths inside the checkout; no flax
os.environ.update({
    "TORCH_EXTENSIONS_DIR": str(ROOT / "build" / "torch_extensions"),
    "TRITON_CACHE_DIR": str(ROOT / "build" / "triton"),
    "USE_FLAX": "0"})
sys.path[:0] = [str(BENCH), str(ROOT)]

from harness import spec  # noqa: E402


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({exc})"


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def clean(x: float) -> float:
    return x if math.isfinite(x) else 1e300


def execute(cell, seed: int, seconds: float, trace: bool = False,
            device: str = "cuda", override: dict | None = None,
            numbers: dict | None = None) -> dict:
    """Set up, serve the window, read the metrics and judge: the result
    line's object. A traced run serves the first TRACE_SECONDS of the
    window, all under the profiler. override: the configuration's
    "serving" / "vocoder" fields to replace (a control); numbers: a dict
    to receive every number the check took, its diagnostics too."""
    import torch
    from harness import check, loops, readers, system, traffic
    from harness.trace import Trace

    config, mix = cell.config, cell.traffic
    n_spk = config["tte"]["n_speaker"]
    if trace:
        seconds = min(seconds, TRACE_SECONDS)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        system.build_kernels()
    tts, tap = system.build(config, seed, device, override)
    loops.warm(tts, tap, mix, seed, n_spk)
    if mix["loop"] == "closed":
        per_call = max(tts.last_stats["wall_s"], 1e-3)
        work = [traffic.call(mix, seed, n_spk, i)
                for i in range(math.ceil(1.3 * seconds / per_call) + 2)]
    else:
        work = traffic.arrivals(mix, seed, n_spk, seconds)
    tap.annotate = trace
    gc.collect()
    gc.freeze()     # the window's collections skip the set-up's objects
    setup_s = system.synchronize(device) - T_START
    tracer = Trace(cuda) if trace else contextlib.nullcontext()
    with tracer:
        if mix["loop"] == "closed":
            win = loops.closed(tts, tap, mix, seed, n_spk, seconds, work)
        else:
            win = loops.open_loop(tts, tap, mix, seed, work, seconds)
    system.synchronize(device)
    gc.unfreeze()
    system.plan(tts, win)
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": cell.chips,
                   "memory_peak_bytes": (torch.cuda.max_memory_allocated(0)
                                         if cuda else 0)}
    run = readers.Run(cell.name, config, mix, win, setup_s, tts.batch_size,
                      tracer if trace else None)
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = spec.reader(m["name"])(run)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    waits = sorted(p - d for p, d in zip(win.picked, win.due) if p is not None)
    log(f"window: {len(win.calls)} calls, {win.attempted} requests "
        f"({win.failed} failed), {sum(c.audio_s for c in win.calls):.3f} "
        f"audio-s, last return {win.last_end:.3f} s after the opening of "
        f"a {seconds} s window; set-up {setup_s:.3f} s")
    if mix["loop"] == "open" and waits:
        log(f"generator: requests sent by the schedule at their due times; "
            f"each waited for the batcher a median "
            f"{1e3 * waits[len(waits) // 2]:.3f} ms, at most "
            f"{1e3 * waits[-1]:.3f} ms; rows per call "
            f"{min(c.n for c in win.calls)}-{max(c.n for c in win.calls)}")
    for err in win.errors[:5]:
        log(f"failed call: {err}")
    result = {"correct": False, "attempted": win.attempted,
              "failed": win.failed, "metrics": metrics, "device": device_info}
    if trace:
        device_info.update(busy_s=tracer.busy_s, window_s=tracer.window_s)
        result["breakdown"] = {
            "device_ops": tracer.top_ops(),
            "idle_gaps": [list(g) for g in tracer.idle_gaps]}
        log(f"trace: {tracer.kernels} device operations, busy "
            f"{tracer.busy_s:.6f} s of {tracer.window_s:.6f} s, reduced in "
            f"{tracer.reduce_s:.3f} s")

    # the check, once the system is freed: the reference sets no peak
    del tts, tap, run, tracer
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    judged = check.judge(config, seed, win, device)
    if numbers is not None:
        numbers.update(judged, served_units_max=max(
            (u for _, _, u in win.served), default=0))
    limits = config["correct"]["limits"]
    result["correct"] = check.verdict(judged, limits, win.failed)
    log(f"reference: judged in {time.perf_counter() - t:.3f} s; "
        + ", ".join(f"{k} {judged[k]!r}" for k in check.DIAGNOSTICS))
    result["checks"] = {k: {"value": clean(judged[k]), "limit": limits[k]}
                        for k in check.NAMES}
    result["checks"]["failed"] = {"value": win.failed, "limit": 0}
    return result


def main(argv=None) -> int:
    args = parse(argv)
    cell = spec.load(args.workload)
    import torch
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA device(s); found {n}")
        return 2
    try:
        import parrot_tts_tpu_torch  # noqa: F401
    except ImportError as exc:
        log(f"the system under test is not beside the benchmark: {exc}")
        return 3
    log(f"card: {card_line()}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    torch.set_num_threads(1)       # one process, few threads: steadier
    result = execute(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        log(f"loaded in this process: {', '.join(found)}; no result")
        return 4
    for k, v in result["checks"].items():
        log(f"check {k}: {v['value']!r} (limit {v['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
