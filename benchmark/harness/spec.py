"""A cell as `BENCHMARK.json` names it: its configuration file, its
traffic file (`traffic/<traffic>.json`), and the metrics it reports,
each computed by the reader `metrics/<name>.py`."""

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list          # the BENCHMARK.json entries this cell reports
    per_layer: list


def _reports(metric: dict, cell: str, e2e_names: set | None) -> bool:
    """Whether the cell reports the metric: those its "workloads" list
    names, else (end-to-end) every cell or (per-layer) every cell that
    reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def load(workload: str, bench_file: Path = ROOT / "BENCHMARK.json") -> Cell:
    bench = json.loads(Path(bench_file).read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}: "
                         f"{', '.join(sorted(cells))}")
    w = cells[workload]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload, None)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, workload, names)]
    return Cell(workload, w["chips"], config, traffic, e2e, per_layer)


def reader(name: str):
    """The `read(run)` of metrics/<name>.py."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
