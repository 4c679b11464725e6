"""CPU tests of the benchmark (`python -m pytest benchmark/tests -q`);
the card's test is marked `cuda` and skips without one."""

import copy
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def online_cell():
    """The open mix (`traffic/online.json`, no cell of BENCHMARK.json) on
    the bf16 configuration, reporting its latency and the .online
    per-layer metrics."""
    import json
    from harness import spec
    e2e = [{"name": "latency_p95_ms", "unit": "ms"},
           {"name": "setup_s", "unit": "s"}]
    per_layer = [{"name": f"{n}.online", "unit": u} for n, u in (
        ("tte_ms_per_audio_s", "ms/audio-s"), ("decode_pad_pct", "%"),
        ("vocoder_ms_per_audio_s", "ms/audio-s"), ("attn_roofline", "%"),
        ("mrf_roofline", "%"), ("busy_ms_per_request", "ms"),
        ("mfu", "%"))]
    return spec.Cell("bf16.online", 1, json.loads(
        (BENCH / "configs" / "parrot-v1-bf16.json").read_text()), json.loads(
        (BENCH / "traffic" / "online.json").read_text()), e2e, per_layer)


def tiny(workload):
    """The cell (a name in BENCHMARK.json, or a Cell) at a width the CPU
    holds in a test: the TTE at d_model 32 (2 + 2 blocks), V1's topology
    at 32 channels, a few short requests."""
    from harness import spec
    cell = spec.load(workload) if isinstance(workload, str) else workload
    c = copy.deepcopy(cell.config)
    c["tte"].update(d_model=32, conv_n_filter=64, dur_n_filter=32)
    c["tte"]["encoder"]["n_layer"] = c["tte"]["decoder"]["n_layer"] = 2
    c["vocoder"].update(upsample_initial_channel=32, embedding_dim=16,
                        model_in_dim=32)
    t = dict(cell.traffic)
    if t["loop"] == "closed":
        t.update(requests_per_call=4, warmup={"calls": 1},
                 chars={"dist": "uniform", "min": 12, "max": 40})
    else:
        t.update(rate_per_s=6, max_batch=3,
                 warmup={"calls": 1, "rows": [1, 2]})
    cell.config, cell.traffic = c, t
    return cell
