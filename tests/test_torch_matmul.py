"""Row 8, the GEMM (ops/qconv.py::matmul, its plain version matmul_reference,
and the ported int8-rate experiment) against the JAX package's
`matmul_pallas` on the CPU, where the wrapper takes the plain version.

int8 is exact on both sides. bf16 and float32: the JAX interpret-mode
kernel sums its float32 products block by block, the plain version in one
float32 matmul, so the two differ in summation order only: max |diff| <=
MM_RTOL * sqrt(K) * max |plain| (tests/test_torch_kernels.py states why).
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from parrot_tts_tpu.ops import pallas_qconv as jax_pq
from parrot_tts_tpu_torch.ops import qconv
from parrot_tts_tpu_torch.scripts import exp_int8_rate

MM_RTOL = 1e-5


def _inputs(rng, m, k, n, dtype):
    if dtype == "int8":
        return (rng.integers(-127, 128, size=(m, k)).astype(np.int8),
                rng.integers(-127, 128, size=(k, n)).astype(np.int8))
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    if dtype == "bfloat16":     # values a bf16 holds exactly, on both sides
        a, b = (np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
                for x in (a, b))
    return a, b


def _torch(x, dtype):
    t = torch.from_numpy(x)
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def _close(got: np.ndarray, want: np.ndarray, k: int) -> None:
    err = float(np.abs(got - want).max())
    assert err <= MM_RTOL * math.sqrt(k) * float(np.abs(want).max()), err


@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
def test_matmul_matches_jax_matmul_pallas(rng, dtype):
    """tests/test_pallas_qconv.py::test_int8_matmul_exact's shape and
    blocks, in all three operand types."""
    a, b = _inputs(rng, 256, 512, 256, dtype)
    ja, jb = (jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else None)
              for x in (a, b))
    want = np.asarray(jax_pq.matmul_pallas(ja, jb, bm=128, bn=128, bk=256,
                                           interpret=True))
    got = qconv.matmul(_torch(a, dtype), _torch(b, dtype))
    assert got.dtype == (torch.int32 if dtype == "int8" else torch.float32)
    assert want.dtype == (np.int32 if dtype == "int8" else np.float32)
    if dtype == "int8":
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            got.numpy(), a.astype(np.int64) @ b.astype(np.int64))
    else:
        _close(got.numpy(), want, 512)


@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
def test_matmul_ragged_shape_matches_numpy(rng, dtype):
    a, b = _inputs(rng, 37, 53, 29, dtype)
    got = qconv.matmul(_torch(a, dtype), _torch(b, dtype)).numpy()
    want = a.astype(np.float64) @ b.astype(np.float64)
    if dtype == "int8":
        np.testing.assert_array_equal(got, want.astype(np.int64))
    else:
        _close(got, want, 53)


def test_cpu_tensors_take_the_plain_version(rng):
    a, b = (torch.from_numpy(x) for x in _inputs(rng, 9, 40, 7, "int8"))
    before = qconv.MATMUL.launches
    assert torch.equal(qconv.matmul(a, b), qconv.matmul_reference(a, b))
    assert qconv.MATMUL.launches == before


def test_int8_sums_near_the_int32_limit_are_exact():
    """The largest K the wrapper takes, all operands at +-127: the plain
    version's float64 sums are exact."""
    k = qconv.INT8_MAX_K
    a = torch.full((2, k), 127, dtype=torch.int8)
    b = torch.full((k, 2), 127, dtype=torch.int8)
    b[:, 1] = -127
    got = qconv.matmul(a, b)
    assert got.tolist() == [[127 * 127 * k, -127 * 127 * k]] * 2
    assert 127 * 127 * k < 2**31 <= 127 * 127 * (k + 1)


@pytest.mark.parametrize("bad", ["int16", "float64", "mixed", "overflow",
                                 "shape", "empty", "rank"])
def test_matmul_rejects_what_the_kernel_does_not_take(bad):
    a, b = torch.zeros(4, 8, dtype=torch.int8), torch.zeros(8, 3,
                                                            dtype=torch.int8)
    if bad == "int16":
        a, b = a.to(torch.int16), b.to(torch.int16)
    elif bad == "float64":
        a, b = a.double(), b.double()
    elif bad == "mixed":
        b = b.to(torch.bfloat16)
    elif bad == "overflow":
        a = torch.zeros(1, qconv.INT8_MAX_K + 1, dtype=torch.int8)
        b = torch.zeros(qconv.INT8_MAX_K + 1, 1, dtype=torch.int8)
    elif bad == "shape":
        b = b[:7]
    elif bad == "empty":
        a, b = a[:0], b
    else:
        a = a[None]
    with pytest.raises((TypeError, ValueError)):
        qconv.matmul(a, b)


def test_int8_rate_experiment_runs_on_the_cpu():
    """The ported experiment end to end at a tiny size: both parts, every
    numerics guard, no time taken off the card."""
    lines = []
    res = exp_int8_rate.run("cpu", shape=(48, 64, 40), batch=2, codes=3,
                            reps=1, out=lines.append)
    assert lines[0] == "device cpu: times not measured"
    p1 = res["part1"]
    assert p1["int8_equal"] and p1["int8_ms"] is None
    assert p1["ops"] == 2.0 * 48 * 64 * 40
    assert [r["label"] for r in res["part2"]] == [
        s[0] for s in exp_int8_rate.SITES]
    assert all(r["bit_identical"] for r in res["part2"])
    up = res["part2"][2]     # the upsample's polyphase conv: 4 x 128 out
    assert (up["Ci"], up["Co"], up["T"]) == (256, 512, 15)
    assert all("not measured" in line for line in lines
               if " ms" not in line and "ratio" in line)
    assert sum("part 2" in line for line in lines) == 5 * len(
        exp_int8_rate.SITES)
