"""Duration extraction: the monotonic shortest path through CTC
posteriors, and the beam-search alternative; port of
`parrot_tts_tpu/ops/monotonic_align.py`.

Reference: `utils/aligner/duration_extraction.py:52-110`. The shortest
path over (mel frame, token) nodes with right / down / down-right moves is
an O(M*N) dynamic program, run by the port's own `csrc/monotonic_align.cc`
(sums in double, ties down, then diagonal, then right). g++ builds it at
first use into `build/native/` at the root of the checkout (git ignores
it), named by a hash of the source, so an edited source is rebuilt. A
failed build raises: nothing falls back. `_durations_numpy` is the same DP
in numpy, run only when a caller asks for it (`use_native=False`, the
tests' oracle).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "monotonic_align.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libmonotonic_align-{digest}.so"


def load() -> ctypes.CDLL:
    """The built DP library, compiled with g++ on first use. Raises if the
    build fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, str(SOURCE)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(
                    f"g++ failed for {SOURCE}:\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, path)          # atomic: no partial library
        lib = ctypes.CDLL(str(path))
        fptr, i32p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(
            ctypes.c_int32)
        lib.monotonic_duration.argtypes = [fptr, ctypes.c_int, ctypes.c_int,
                                           i32p]
        lib.monotonic_duration.restype = None
        lib.monotonic_duration_margin.argtypes = [
            fptr, ctypes.c_int, ctypes.c_int, i32p,
            ctypes.POINTER(ctypes.c_double)]
        lib.monotonic_duration_margin.restype = None
        _lib = lib
        return lib


def _cost(tokens: np.ndarray, posteriors: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(1.0 - posteriors[:, tokens],
                                dtype=np.float32)


def _durations_numpy(cost: np.ndarray) -> np.ndarray:
    rows, cols = cost.shape
    INF = np.inf
    dist = np.full((rows, cols), INF)
    choice = np.zeros((rows, cols), np.uint8)  # 0=right 1=down 2=diag
    dist[0, 0] = 0.0
    for j in range(1, cols):
        dist[0, j] = dist[0, j - 1] + cost[0, j]
    for i in range(1, rows):
        # down move for all columns
        down = dist[i - 1]
        diag = np.concatenate([[INF], dist[i - 1, :-1]])
        best = down.copy()
        ch = np.ones(cols, np.uint8)
        better = diag < best
        best[better] = diag[better]
        ch[better] = 2
        # right move is within-row sequential
        for j in range(cols):
            b, c = best[j], ch[j]
            if j > 0 and dist[i, j - 1] < b:
                b, c = dist[i, j - 1], 0
            dist[i, j] = b + cost[i, j]
            choice[i, j] = c
    row_token = np.full(rows, -1, np.int32)
    i, j = rows - 1, cols - 1
    while True:
        if row_token[i] < 0:
            row_token[i] = j
        if i == 0 and j == 0:
            break
        c = choice[i, j]
        if c == 0:
            j -= 1
        elif c == 1:
            i -= 1
        else:
            i -= 1
            j -= 1
    durations = np.zeros(cols, np.int32)
    for jj in row_token:
        durations[jj] += 1
    return durations


def extract_durations_beam(tokens: np.ndarray, posteriors: np.ndarray,
                           k: int = 10):
    """Beam-search alternative to the shortest-path DP.

    Semantics of the reference's `extract_durations_beam`
    (`utils/aligner/duration_extraction.py:88-110`): walk the mel rows top
    to bottom; each hypothesis may stay on its current token or advance by
    one; score is the running -log posterior of the visited cells; keep
    the `k` best (stable order: existing-beam order, stay before advance,
    ties preserved). A hypothesis whose advance step runs past the last
    token is kept with +inf score (it survives only if fewer than `k`
    finite candidates exist). Durations of a hypothesis are the bincount
    of its token-index path, so trailing never-visited tokens are absent
    (the returned vector can be shorter than `len(tokens)`).

    Returns (durations_list, (paths, scores)): `durations_list[0]` is the
    best hypothesis's durations, `paths` is an int (k, M) array of token
    indices per mel row, `scores` the matching (k,) path costs.
    """
    data = posteriors[:, tokens]
    m, n = data.shape
    with np.errstate(divide="ignore"):
        neglog = -np.log(data)
    pos = np.array([0], np.int64)
    # accumulate in the posteriors' dtype (reference: float32 running sums)
    # so near-tie orderings agree bit-for-bit with the oracle
    scores = np.array([neglog[0, 0]], neglog.dtype)
    paths = np.zeros((1, 1), np.int64)
    for i in range(1, m):
        # candidate order matters for stable tie-breaks: for each existing
        # hypothesis, stay (j) comes before advance (j+1)
        cand_pos = np.stack([pos, pos + 1], axis=1).reshape(-1)
        valid = cand_pos < n
        step = np.full(cand_pos.shape, np.inf, neglog.dtype)
        step[valid] = neglog[i, cand_pos[valid]]
        cand_scores = np.repeat(scores, 2) + step
        cand_paths = np.concatenate(
            [np.repeat(paths, 2, axis=0), cand_pos[:, None]], axis=1)
        keep = np.argsort(cand_scores, kind="stable")[:k]
        pos, scores, paths = cand_pos[keep], cand_scores[keep], cand_paths[keep]
    durations = [np.bincount(p) for p in paths]
    return durations, (paths, scores)


def extract_durations(tokens: np.ndarray, posteriors: np.ndarray,
                      use_native: bool = True) -> np.ndarray:
    """tokens (N,) int token ids of the transcript; posteriors (M, V)
    frame-wise symbol posteriors (softmax output) -> (N,) int32 durations
    summing to M (reference extract_durations_with_dijkstra, :52).
    use_native=False runs the numpy DP instead of the built one."""
    cost = _cost(tokens, posteriors)
    if not use_native:
        return _durations_numpy(cost)
    rows, cols = cost.shape
    out = np.zeros(cols, np.int32)
    load().monotonic_duration(
        cost.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), rows, cols,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out


def extract_durations_margin(tokens: np.ndarray, posteriors: np.ndarray
                             ) -> tuple[np.ndarray, float]:
    """`extract_durations` and the gap between the second-best path's cost
    and the best one's (inf where no other path exists): a gap near 0 is
    a near-tie that tiny changes in the posteriors can flip."""
    cost = _cost(tokens, posteriors)
    rows, cols = cost.shape
    out = np.zeros(cols, np.int32)
    gap = ctypes.c_double()
    load().monotonic_duration_margin(
        cost.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), rows, cols,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), ctypes.byref(gap))
    return out, gap.value
