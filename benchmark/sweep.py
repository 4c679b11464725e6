#!/usr/bin/env python3
"""The rate sweep of an open mix: the cell served at each given rate, in
one process, and whether its backlog grows through the window. The
highest rate whose backlog does not grow is the mix's capacity; its
traffic file fixes its rate at four fifths of that.

    python3 benchmark/sweep.py --workload bf16.online --seconds 15 \\
        --seed 5 --rates 200 300 400 500

For each rate: requests, latency median and 95th percentile, rows per
call, the queue (requests due and not yet taken) at the opening of each
call, its mean in the first and the last third of the window, and how
long after the close the last request returned. Needs a CUDA card.
"""

import argparse
import json
import statistics
import sys

import run  # sets the paths and the cache directories

from harness import loops, readers, spec, system, traffic


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        run.log("the sweep needs a CUDA card")
        return 2
    cell = spec.load(args.workload)
    config, n_spk = cell.config, cell.config["tte"]["n_speaker"]
    system.build_kernels()
    tts, tap = system.build(config, args.seed)
    loops.warm(tts, tap, cell.traffic, args.seed, n_spk)
    for rate in args.rates:
        mix = {**cell.traffic, "rate_per_s": rate}
        reqs = traffic.arrivals(mix, args.seed, n_spk, args.seconds)
        win = loops.open_loop(tts, tap, mix, args.seed, reqs, args.seconds)
        due = sorted(win.due)
        queue = []
        for c in win.calls:
            taken = sum(1 for p in win.picked if p is not None
                        and p < c.start)
            arrived = sum(1 for d in due if d <= c.start)
            queue.append((c.start, arrived - taken))
        third = args.seconds / 3
        first = [q for t, q in queue if t < third]
        last = [q for t, q in queue if t >= 2 * third]
        run_ = readers.Run(cell.name, config, mix, win, 0.0, tts.batch_size)
        print(json.dumps({
            "rate_per_s": rate, "requests": win.attempted,
            "failed": win.failed,
            "latency_p50_ms": readers.latency_ms(run_, 50),
            "latency_p95_ms": readers.latency_ms(run_, 95),
            "rows_per_call": statistics.mean(c.n for c in win.calls),
            "queue_first_third": statistics.mean(first) if first else 0,
            "queue_last_third": statistics.mean(last) if last else 0,
            "drain_s": win.last_end - args.seconds}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
