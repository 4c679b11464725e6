"""BENCHMARK.json against the benchmark's contract: its keys, names,
units and limits; every configuration, mix and metric has its file; every
cell reports set-up, another end-to-end metric and a per-layer metric;
the full check of 24 cells fits its time."""

import json
import re

import pytest

from harness import spec

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|proj|head|_dim$|"
                    r"_rank$|channel|filter|d_model|expert)")


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_and_entries():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    for section, keys in KEYS.items():
        names = [e["name"] for e in BENCH[section]]
        assert len(names) == len(set(names))
        for e in BENCH[section]:
            assert keys <= set(e) <= keys | {"workloads"}, e["name"]
            assert NAME.fullmatch(e["name"])
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_configs_and_cells():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in configs.values():
        assert line(c["source"]) and line(c["why"])
        assert c["file"].startswith("benchmark/")
        assert not any(WIDTHS.search(k) for k in c["reduced"])
        assert json.loads((spec.ROOT / c["file"]).read_text())["name"] == \
            c["name"]
    used = set()
    pairs = set()
    for w in BENCH["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert line(w["why"]) and NAME.fullmatch(w["traffic"])
        assert (spec.BENCH / "traffic" / f"{w['traffic']}.json").exists()
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
    assert used == set(configs)
    assert 1 <= len(BENCH["workloads"]) <= 24
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower",
                                                              "higher")
        assert (spec.BENCH / "metrics" / f"{m['name']}.py").exists()
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_reports_enough(w):
    cell = spec.load(w)
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in names


def test_full_check_fits_with_24_cells():
    rs = BENCH["run_seconds"]
    assert 1 <= rs <= 51 and isinstance(rs, int)
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_files_are_named_from_name_characters():
    for p in spec.BENCH.rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = p.relative_to(spec.ROOT).as_posix()
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]+", rel), rel
