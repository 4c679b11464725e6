#!/usr/bin/env python3
"""The readings that the limits of `correct` are set from: a cell's
numbers on sound runs of the system over many seeds (the lower
readings), and on its controls, the configuration's "controls" (the
system's own lower-precision paths switched on), on the same seeds (the
upper readings), and with --fault the sound runs with that fault
planted (`harness/faults.py`). One process serves every seed, each a
short window at the cell's own load, judged as a run judges it.

    python3 benchmark/readings.py --workload bf16.bulk --seconds 8 \\
        --seeds 11 12 13 [--controls] [--sound 0] [--fault louder] \\
        [--probe 'int8-static={"vocoder": {"quant": "int8-static"}}']

--probe runs another override of the configuration's fields as a
control is run, for readings of a path that is not one of its controls.

Prints one JSON line per run and, last, each number's largest sound
reading and smallest control reading. Needs a CUDA card.
"""

import argparse
import json
import sys

import run  # sets the paths and the cache directories

from harness import check, faults, spec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--controls", action="store_true")
    p.add_argument("--sound", type=int, default=1)
    p.add_argument("--fault", choices=sorted(faults.FAULTS),
                   help="plant this fault in the sound runs")
    p.add_argument("--probe", action="append", default=[],
                   metavar="NAME=JSON", help="another override to read")
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        run.log("readings need a CUDA card")
        return 2
    cell = spec.load(args.workload)
    runs = {"sound": {}} if args.sound else {}
    if args.controls:
        runs.update({name: override for name, override
                     in cell.config.get("controls", {}).items()})
    for probe in args.probe:
        name, override = probe.split("=", 1)
        runs[name] = json.loads(override)
    seen: dict[str, list] = {}
    for seed in args.seeds:
        for name, override in runs.items():
            numbers = {}
            with faults.planted(args.fault if name == "sound" else None):
                res = run.execute(cell, seed, args.seconds,
                                  override=override or None, numbers=numbers)
            seen.setdefault(name, []).append(numbers)
            print(json.dumps({"workload": cell.name,
                              "run": args.fault or name if name == "sound"
                              else name,
                              "seed": seed, "correct": res["correct"],
                              "numbers": numbers,
                              "metrics": res["metrics"]}), flush=True)
            torch.cuda.empty_cache()
    summary = {}
    for k in check.NAMES + check.DIAGNOSTICS:
        summary[k] = {name: (max if name == "sound" else min)(
            r[k] for r in rs) for name, rs in seen.items()}
    print(json.dumps({"workload": cell.name, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
