"""A whole run on the CPU at a tiny width (the look for a card skipped):
the last line's keys and metrics; without a card, or with nothing but
the benchmark in the directory, run.py exits non-zero and prints
nothing; no module of JAX or of the JAX package is loaded."""

import json
import shutil
import subprocess
import sys

import pytest

import run
from conftest import ROOT, online_cell, tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_last_line_keys_and_end_to_end_metrics():
    cell = tiny("f32.bulk")
    res = run.execute(cell, 2**31 + 3, 1.0, device="cpu")
    assert list(res) == KEYS + ["checks"]
    assert set(res["metrics"]) == {"audio_s_per_s", "setup_s"}
    assert all(v["unit"] for v in res["metrics"].values())
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 4
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert list(res["checks"]) == ["unit_gap", "dur_gap", "wave_err",
                                   "wave_len", "failed"]
    json.dumps(res)


def test_traced_line_has_per_layer_metrics_and_breakdown():
    cell = tiny("bf16.bulk")
    res = run.execute(cell, 17, 1.0, trace=True, device="cpu")
    assert list(res) == KEYS + ["breakdown", "checks"]
    # the CPU has no device trace: the device's readers find nothing
    assert set(res["metrics"]) == {
        "tte_ms_per_audio_s.bulk", "vocoder_ms_per_audio_s.bulk",
        "decode_pad_pct.bulk", "mfu.bulk"}
    assert 0 < res["metrics"]["decode_pad_pct.bulk"]["value"] < 100
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_open_loop_serves_every_due_request():
    cell = tiny(online_cell())
    res = run.execute(cell, 2**31 + 9, 1.5, device="cpu")
    assert res["failed"] == 0 and res["attempted"] >= 5
    assert set(res["metrics"]) == {"latency_p95_ms", "setup_s"}
    assert res["metrics"]["latency_p95_ms"]["value"] > 0


def _run_py(cwd):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "f32.bulk",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=cwd,
        capture_output=True, text=True, timeout=300)


def test_no_card_exits_nonzero_with_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = _run_py(ROOT)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA" in p.stderr


def test_bare_benchmark_exits_nonzero_with_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run_py(tmp_path)
    assert p.returncode != 0 and p.stdout == ""


def test_no_jax_module_is_loaded():
    """A fresh interpreter imports the harness, the reference and the
    system, serves a tiny cell and judges it; no loaded module's
    top-level name is jax, jaxlib, flax or parrot_tts_tpu (whole names:
    parrot_tts_tpu_torch is the system)."""
    code = (
        "import sys; sys.path[:0] = ['benchmark/tests', 'benchmark']\n"
        "import run\n"
        "from conftest import tiny\n"
        "run.execute(tiny('f32.bulk'), 5, 0.5, device='cpu')\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "print(run.forbidden_modules(), 'parrot_tts_tpu_torch' in tops)\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[] True"
