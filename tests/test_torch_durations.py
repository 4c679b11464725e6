"""Port duration extraction (parrot_tts_tpu_torch.ops.monotonic_align:
the built DP, its numpy oracle, the margin and the beam search) against
the JAX package's on the same posteriors: durations equal, exactly."""

import numpy as np
import pytest

from parrot_tts_tpu.ops import monotonic_align as jax_ma
from parrot_tts_tpu_torch.ops import monotonic_align as ma


def posteriors(rng, m, v, ties=False):
    post = rng.random((m, v)).astype(np.float32)
    post /= post.sum(axis=1, keepdims=True)
    # rounded posteriors give exact ties, which the DP resolves down, then
    # diagonal, then right, in both packages
    return np.round(post, 1).astype(np.float32) if ties else post


@pytest.mark.parametrize("ties", [False, True])
def test_dp_native_and_numpy_equal_jax(rng, ties):
    for _ in range(40):
        m, n, v = int(rng.integers(2, 70)), int(rng.integers(1, 16)), 20
        post = posteriors(rng, m, v, ties)
        tokens = rng.integers(0, v, size=n)
        want = jax_ma.extract_durations(tokens, post, use_native=False)
        native = ma.extract_durations(tokens, post)
        oracle = ma.extract_durations(tokens, post, use_native=False)
        assert native.dtype == np.int32 and native.sum() == m
        np.testing.assert_array_equal(native, want)
        np.testing.assert_array_equal(oracle, want)
        durs, _ = ma.extract_durations_margin(tokens, post)
        np.testing.assert_array_equal(durs, want)


def _paths(m, n):
    """Every monotonic path from (0, 0) to (m-1, n-1), as node lists."""
    out = []

    def walk(i, j, acc):
        if (i, j) == (m - 1, n - 1):
            out.append(acc)
            return
        for di, dj in ((0, 1), (1, 0), (1, 1)):
            if i + di < m and j + dj < n:
                walk(i + di, j + dj, acc + [(i + di, j + dj)])

    walk(0, 0, [])
    return out


def test_margin_is_the_second_best_path_gap(rng):
    """The margin is the second-best path's cost less the best's, by
    enumeration of every path on small grids (within 1e-9: the sums run in
    another order); inf where only one path exists."""
    for _ in range(40):
        m, n, v = int(rng.integers(1, 6)), int(rng.integers(1, 5)), 8
        post = rng.random((m, v)).astype(np.float32)
        tokens = rng.integers(0, v, size=n)
        cost = (1.0 - post[:, tokens]).astype(np.float32)
        costs = sorted(sum(float(cost[i, j]) for i, j in p)
                       for p in _paths(m, n))
        _, gap = ma.extract_durations_margin(tokens, post)
        if len(costs) == 1:
            assert np.isinf(gap)
        else:
            assert abs(gap - (costs[1] - costs[0])) < 1e-9


def test_beam_equals_jax(rng):
    for _ in range(20):
        m, n, v = int(rng.integers(3, 50)), int(rng.integers(2, 12)), 20
        post = posteriors(rng, m, v)
        tokens = rng.integers(0, v, size=n)
        want, (w_paths, w_scores) = jax_ma.extract_durations_beam(
            tokens, post, 10)
        got, (g_paths, g_scores) = ma.extract_durations_beam(tokens, post, 10)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g_paths, w_paths)
        np.testing.assert_array_equal(g_scores, w_scores)


def test_built_from_the_port_source_into_build(rng):
    """The library is the port's own source, built under build/native/
    and named by the source's hash."""
    post = posteriors(rng, 10, 5)
    ma.extract_durations(np.arange(3), post)
    path = ma.library_path()
    assert path.exists() and path.parent.name == "native"
    assert path.parent.parent.name == "build"
    assert ma.SOURCE.name == "monotonic_align.cc"
    assert ma.SOURCE.parent.parent.name == "parrot_tts_tpu_torch"


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """No fallback: a source g++ cannot compile raises, and nothing is
    loaded."""
    bad = tmp_path / "monotonic_align.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(ma, "SOURCE", bad)
    monkeypatch.setattr(ma, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(ma, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        ma.extract_durations(np.arange(2), np.full((3, 4), 0.25, np.float32))
    assert ma._lib is None
    assert not list((tmp_path / "build").glob("*.so"))
