"""int8 stride-1 NWC convolution and the dense GEMM: the CUDA kernels'
wrappers and their plain versions.

`int8_conv` computes, for xq (B, T, Ci) int8 and a kernel w (K, Ci, Co)
int8, given as wt (K, Co, Ci), the layout the kernel reads,
    acc = conv(xq, w) in int32 (stride 1, dilation d, zero pads (pl, pr)),
    y = float32(acc) · scale[b, co] + bias[co],  then max(y, leaky·y),
as float32 (B, T + pl + pr - d·(K-1), Co), or with out_dtype=bfloat16
    y16 = bf16(float32(acc) · scale[b, co] + bias[co]),  then
    max(y16, bf16(bf16(leaky)·y16)),
the JAX package's bf16 serving path (its int8 conv's output rounded to
bf16, then its bf16 leaky ReLU). It replaces the TPU's Pallas
kernel `parrot_tts_tpu/ops/pallas_qconv.py::_conv_kernel`, which the JAX
package never wired in; here it is the int8 conv of every int8-static
serving site (`ops/quant.py`). PyTorch has no int8
convolution on CUDA.

A CPU tensor goes to `int8_conv_reference`; a CUDA tensor launches
`csrc/int8_conv.cu` or raises. Nothing falls back. `INT8_CONV.launches`
counts kernel launches. The kernel's output is bit-identical to the plain
version: the plain conv runs in float64, which is exact for these integer
sums (|acc| < 2^53), and the epilogue is the same two float32 roundings.

`matmul(a, b)` computes (M, K) @ (K, N): int8 operands give int32, bf16
and float32 operands float32 (bf16 products are exact in float32, so only
the order of the float32 sums differs from the plain version). It replaces
`parrot_tts_tpu/ops/pallas_qconv.py::matmul_pallas` (`_mm_kernel`), the
rate microkernel of the int8 experiment
(`parrot_tts_tpu_torch/scripts/exp_int8_rate.py`). The TPU tile arguments
`bm / bn / bk` are not carried over: the Hopper kernel `csrc/int8_gemm.cu`
picks its own tiles and takes any M, N, K >= 1. A CPU tensor goes to
`matmul_reference`, a CUDA tensor launches the kernel or raises;
`MATMUL.launches` counts its launches. Other dtypes, mixed dtypes and an
int8 K above 133,144 (where 127^2 * K overflows int32) raise on either
device.

Both tensor-core kernels read their operands by TMA, which wants 16-byte
row strides and bases. `conv_plan` and `gemm_plan` compute, from the
shapes and the alignment of the operands alone, which operand goes through
a zero-padded workspace (the "padded" branch; the same kernel runs on it),
the tile width, the ring depth and the number of persistent blocks;
`conv_tile` and `gemm_tile` give the order in which the kernels walk their
tiles. The tests check both on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
import types

import torch
import torch.nn.functional as F

from parrot_tts_tpu_torch.core import kernels
from parrot_tts_tpu_torch.core.device import exact_numerics
from parrot_tts_tpu_torch.ops.activation import leaky_relu

INT8_MAX_K = 133_144       # the largest K with 127^2 * K < 2^31
SMEM_MAX = 232_448         # dynamic shared memory a block may use (H100)
H100_SMS = 132             # streaming multiprocessors of an H100 SXM
# csrc/int8_conv.cu: tile widths (channels), the most rows of a tile at each
# width (its accumulators: 64 registers at most; its float32 output tile:
# 32 KB at most), the chunks of Ci a ring stage carries (bytes), the
# ring's depth at most (even: half of it for each consumer)
CONV_TILE_N = (16, 32, 64, 128)
CONV_TILE_ROWS = {16: 512, 32: 256, 64: 128, 128: 64}
CONV_CHUNKS = (128, 64, 32)
CONV_STAGES = 8
# conv_plan's launch model, in SM cycles: a wgmma m64nNk32 by N (s8, both
# operands in shared memory, scripts/exp_wgmma_rate.py --only s8 on the
# H100); a ring slot's reload (release to full), one row of a TMA
# box and the cost of a tile beyond its bytes and products (fitted to
# scripts/time_int8_conv.py's V1 sites on the H100); the bytes an
# SM moves per cycle from memory (3.35 TB/s over 132 SMs at 1.755 GHz)
# and from L2 (a third of the 5.5 TB/s L2 reads lost to contention: an
# assumption)
CONV_WGMMA_CYCLES = {16: 22.0, 32: 26.4, 64: 35.3, 128: 70.5}
CONV_RELOAD_CYCLES = 2500
CONV_ROW_CYCLES = 10
CONV_TILE_CYCLES = 1500
CONV_SM_BYTES = 14.5
CONV_L2_BYTES = 16.0
# csrc/int8_gemm.cu: output tile and grouped order
GEMM_BM, GEMM_BN, GEMM_GROUP = 128, 256, 8
_MM_CODES = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}


class _Kernel:
    """A loaded kernel entry point and its launch count (one per process)."""

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.launches = 0
        self._source, self._symbol, self._argtypes = source, symbol, argtypes
        self._fn = None

    def fn(self):
        if self._fn is None:
            fn = getattr(kernels.load(self._source), self._symbol)
            fn.argtypes = self._argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn


_P, _I = ctypes.c_void_p, ctypes.c_int
INT8_CONV = _Kernel("int8_conv", "int8_conv_s8",
                    [_P] * 3 + [_I] + [_P] * 2 + [_I] * 10 + [ctypes.c_float]
                    + [_I] * 7 + [_P])
OUT_DTYPES = (torch.float32, torch.bfloat16)   # int8_conv's outputs
MATMUL = _Kernel("int8_gemm", "int8_gemm",
                 [_I, _P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _I, _P])
# the int8 GEMM's B^T pass (part of every int8 `matmul`, whose launch
# MATMUL counts)
TRANSPOSE = _Kernel("int8_gemm", "int8_gemm_transpose",
                    [_P, _P, _I, _I, _I, _P])


def out_len(t: int, k: int, pads: tuple[int, int], dilation: int) -> int:
    return t + pads[0] + pads[1] - dilation * (k - 1)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(a: int, b: int) -> int:
    return _ceil(a, b) * b


@functools.lru_cache(maxsize=None)
def _sms_of(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _sms(device) -> int:
    return _sms_of(device.index if device.index is not None
                   else torch.cuda.current_device())


def _padded(x: torch.Tensor, shape: tuple) -> torch.Tensor:
    """x copied into the leading corner of a zeroed workspace of `shape`."""
    ws = torch.zeros(shape, dtype=x.dtype, device=x.device)
    ws[tuple(slice(0, n) for n in x.shape)] = x
    return ws


def _slab(rows: int, k: int, dilation: int) -> tuple[int, int]:
    """(n_rbox, box_rows): a tile's activation slab, rows + (k-1)*dilation
    rows in n_rbox TMA boxes of box_rows <= 256 rows, each a multiple of 8."""
    need = rows + (k - 1) * dilation
    n_rbox = _ceil(need, 256)
    return n_rbox, _round_up(_ceil(need, n_rbox), 8)


def _conv_smem(k: int, bn: int, rows: int, ck: int, slab: int,
               n_chunks: int, resident: bool, out_bytes: int,
               stages: int) -> int:
    """Shared memory of csrc/int8_conv.cu's Plan::smem(): two output tiles
    (one per consumer), the resident weights of a channel tile, `stages`
    ring stages (a slab of ck-byte rows, and the chunk's weights when they
    stream), the mbarriers and the alignment slack."""
    wchunk = k * bn * ck
    stage = _round_up(slab * ck + (0 if resident else wchunk), 1024)
    wres = _round_up(n_chunks * wchunk, 1024) if resident else 0
    return (2 * rows * bn * out_bytes + wres + stages * stage
            + (2 * stages + n_chunks) * 8 + 1024)


@functools.lru_cache(maxsize=4096)
def conv_plan(b: int, t: int, ci: int, k: int, co: int,
              pads: tuple[int, int], dilation: int, *, x_aligned: bool = True,
              w_aligned: bool = True, sms: int = H100_SMS,
              out_bytes: int = 4) -> dict:
    """The launch of csrc/int8_conv.cu for xq (b, t, ci), wt (k, co, ci):
    - branch: xq / wt go through a workspace (b, t_x, ci_p) / (k, co, ci_p),
      zero past ci, when ci is not a multiple of 16 or the base is not
      16-byte aligned (TMA's rule; t_x = max(t, 1), since a map has no empty
      dimension); the output through (b, t_out, co_p) when its rows are
      not a multiple of 16 bytes (co not a multiple of 4 in float32, 8 in
      bfloat16: out_bytes 4 or 2); "tma" when nothing is padded;
    - bn (channels), bm (= 64 * mb, output rows), ck (bytes of ci per
      chunk: one ring stage and one weight box of {ck, bn, k} in the
      ck-byte swizzle) and stages (as many as fit, even: half for each
      consumer warpgroup, which needs two, since it frees a slot after
      the next one's products are issued; at least 4, at most
      CONV_STAGES): the tile that fits shared memory (SMEM_MAX) with the
      least modelled time (from the CONV_* constants: per SM, its share
      of the tiles, each the largest of its products, bytes, L2 reads,
      box rows and ring reloads plus a fixed cost), bn from CONV_TILE_N up to the width
      that covers co and down to 32 (16 where co needs no more), bm from
      CONV_TILE_ROWS[bn] down to 64, ck from CONV_CHUNKS up to ci_p
      rounded to 32; ties go to the widest, then the longest tile. The
      weights of a channel tile (every tap, ci_p, bn channels) stay
      resident in the block beside the ring; where no width lets them,
      they stream through the ring (resident False) in 64-channel tiles;
      n_chunks;
    - n_rbox, box_rows, slab: the tile's activation rows (_slab); planes:
      ci_p = 16, whose slab rows are the input's own 16-byte rows, so a
      slab inside the batch row is one 1-d copy (boxes of {16, rows} at
      the edges), beside a zero plane that pads the 32-byte k-step;
    - tiles = b * tiles_m * tiles_n, walked by conv_tile; grid: tiles_n
      blocks for each of min(b * tiles_m, sms // tiles_n) groups, so that a
      block keeps one channel tile (at least one group).
    Raises ValueError when the slab leaves no room for four ring stages. The
    plan is cached per argument list (the wrapper computes it at every
    launch), so it is read-only."""
    t_out = out_len(t, k, pads, dilation)
    ci_p, co_p, t_x = (_round_up(ci, 16), _round_up(co, 16 // out_bytes),
                       max(t, 1))
    plan = {"t_out": t_out, "ci_p": ci_p, "co_p": co_p, "t_x": t_x, "k": k,
            "pad_x": ci_p != ci or t_x != t or not x_aligned,
            "pad_w": ci_p != ci or not w_aligned, "pad_out": co_p != co}
    plan["branch"] = ("padded" if plan["pad_x"] or plan["pad_w"]
                      or plan["pad_out"] else "tma")
    cover = next(n for n in CONV_TILE_N if n >= min(co, CONV_TILE_N[-1]))
    chunks = [c for c in CONV_CHUNKS if c <= _round_up(ci_p, 32)]

    def candidates(resident: bool, widths):
        """(cycles, order, config) of every tile that fits with four
        stages or more: the launch model, the largest of a tile's
        products, its bytes from memory and from L2, its TMA box rows
        and half its ring's reloads (two consumers), plus
        CONV_TILE_CYCLES, times the tiles an SM takes."""
        for bn in widths:
            tiles_n = _ceil(co, bn)
            rows = CONV_TILE_ROWS[bn]
            while rows >= 64:
                n_rbox, box_rows = _slab(rows, k, dilation)
                tiles_m = _ceil(t_out, rows)
                groups = min(b * tiles_m, max(1, sms // tiles_n))
                for ck in chunks:
                    n_chunks = _ceil(ci_p, ck)
                    args = (k, bn, rows, ck, n_rbox * box_rows, n_chunks,
                            resident, out_bytes)
                    stages = max((s for s in range(4, CONV_STAGES + 1, 2)
                                  if _conv_smem(*args, s) <= SMEM_MAX),
                                 default=0)
                    if not stages:
                        continue
                    products = (n_chunks * k * ck // 32 * rows // 64
                                * CONV_WGMMA_CYCLES[bn])
                    moved = rows * bn * out_bytes + rows * ci_p / tiles_n
                    fetched = n_chunks * (n_rbox * box_rows * ck + (
                        0 if resident else k * bn * ck))
                    boxes = n_chunks * n_rbox * box_rows * (ci_p != 16)
                    reload = n_chunks * CONV_RELOAD_CYCLES / (stages // 2 - 1)
                    tile = max(products, moved / CONV_SM_BYTES,
                               fetched / CONV_L2_BYTES,
                               boxes * CONV_ROW_CYCLES,
                               reload / 2) + CONV_TILE_CYCLES
                    waves = _ceil(b * tiles_m, groups)
                    yield (waves * tile, -bn, -rows, -ck,
                           (bn, rows, ck, n_rbox, box_rows, stages))
                rows //= 2

    # resident weights wherever some width fits (down to 32 channels, or
    # 16 where co needs no more); streamed in 64-channel tiles otherwise
    found = min(candidates(True, [n for n in CONV_TILE_N
                                  if min(cover, 32) <= n <= cover]),
                default=None)
    resident = found is not None
    if found is None:
        found = min(candidates(False, [min(cover, 64)]), default=None)
    if found is None:
        raise ValueError(f"int8_conv: K = {k}, dilation = {dilation}: the "
                         "input slab leaves no room for four ring stages")
    bn, rows, ck, n_rbox, box_rows, stages = found[-1]
    plan.update(bn=bn, mb=rows // 64, bm=rows, ck=ck, planes=ci_p == 16,
                n_chunks=_ceil(ci_p, ck), resident=resident, n_rbox=n_rbox,
                box_rows=box_rows, slab=n_rbox * box_rows,
                tiles_m=_ceil(t_out, rows), tiles_n=_ceil(co, bn),
                stages=stages)
    plan["smem"] = _conv_smem(k, bn, rows, ck, plan["slab"],
                              plan["n_chunks"], resident, out_bytes, stages)
    plan["tiles"] = b * plan["tiles_m"] * plan["tiles_n"]
    plan["grid"] = plan["tiles_n"] * min(b * plan["tiles_m"],
                                         max(1, sms // plan["tiles_n"]))
    plan["workspace_bytes"] = (
        (b * t_x * ci_p if plan["pad_x"] else 0)
        + (k * co * ci_p if plan["pad_w"] else 0)
        + (out_bytes * b * t_out * co_p if plan["pad_out"] else 0))
    return types.MappingProxyType(plan)


def conv_tile(plan: dict, tile: int) -> tuple[int, int, int]:
    """(batch row, first output row, first channel) of tile `tile`: the
    kernel's walk, channels fastest, then time tiles, then batch rows.
    Block i of the plan's grid takes tiles i, i + grid, i + 2*grid, ...
    (all of one channel tile, since the grid is a multiple of tiles_n),
    its consumer warpgroups taking them in turn: the block's j-th tile
    belongs to consumer j % 2."""
    nt, r = tile % plan["tiles_n"], tile // plan["tiles_n"]
    mt, b = r % plan["tiles_m"], r // plan["tiles_m"]
    return b, mt * plan["bm"], nt * plan["bn"]


def int8_conv_reference(xq: torch.Tensor, wt: torch.Tensor,
                        scale: torch.Tensor, bias: torch.Tensor | None, *,
                        pads: tuple[int, int], dilation: int = 1,
                        leaky: float | None = None,
                        out_dtype: torch.dtype = torch.float32
                        ) -> torch.Tensor:
    """Plain PyTorch: the conv in float64, then the float32 epilogue (in
    bfloat16: rounded, then the bf16 leaky ReLU). cuDNN is off for the
    conv, since its FFT and Winograd algorithms are not exact; PyTorch's
    own im2col + GEMM sums integers below 2^53 exactly."""
    x = F.pad(xq.double().transpose(1, 2), pads)
    with torch.backends.cudnn.flags(enabled=False):
        acc = F.conv1d(x, wt.double().permute(1, 2, 0), dilation=dilation)
    y = acc.transpose(1, 2).float() * scale[:, None, :]
    if bias is not None:
        y = y + bias
    if out_dtype == torch.bfloat16:
        y = y.to(out_dtype)
        return (y if leaky is None else leaky_relu(y, leaky)).contiguous()
    if leaky is not None:
        y = torch.maximum(y, leaky * y)
    return y.contiguous()


def int8_conv(xq: torch.Tensor, wt: torch.Tensor, scale: torch.Tensor,
              bias: torch.Tensor | None = None, *, pads: tuple[int, int],
              dilation: int = 1, leaky: float | None = None,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """xq (B, T, Ci) int8, wt (K, Co, Ci) int8, scale (B, Co) float32 with
    unit channel stride (a (Co,) vector `expand`ed over the batch is passed
    as it is), bias (Co,) float32 or None; xq, wt and bias contiguous; all
    on one device. out_dtype: float32 or bfloat16."""
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"int8_conv: out_dtype {out_dtype}; the kernel "
                        "writes float32 or bfloat16")
    if xq.device.type == "cpu":
        return int8_conv_reference(xq, wt, scale, bias, pads=pads,
                                   dilation=dilation, leaky=leaky,
                                   out_dtype=out_dtype)
    if xq.device.type != "cuda":
        raise ValueError(f"int8_conv: unsupported device {xq.device}")
    _check(xq, wt, scale, bias, pads, dilation)
    b, t, ci = xq.shape
    k, co, _ = wt.shape
    t_out = out_len(t, k, pads, dilation)
    out = torch.empty((b, t_out, co), dtype=out_dtype, device=xq.device)
    if b == 0 or co == 0:
        return out
    bf16 = out_dtype == torch.bfloat16
    plan = conv_plan(b, t, ci, k, co, tuple(pads), dilation,
                     x_aligned=xq.data_ptr() % 16 == 0,
                     w_aligned=wt.data_ptr() % 16 == 0,
                     sms=_sms(xq.device), out_bytes=2 if bf16 else 4)
    if plan["pad_x"]:
        xq = _padded(xq, (b, plan["t_x"], plan["ci_p"]))
    if plan["pad_w"]:
        wt = _padded(wt, (k, co, plan["ci_p"]))
    y = (torch.empty((b, t_out, plan["co_p"]), dtype=out_dtype,
                     device=xq.device) if plan["pad_out"] else out)
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        err = INT8_CONV.fn()(
            xq.data_ptr(), wt.data_ptr(), scale.data_ptr(), scale.stride(0),
            bias.data_ptr() if bias is not None else None, y.data_ptr(),
            b, plan["t_x"], plan["ci_p"], k, co, plan["co_p"], t_out, pads[0],
            dilation, int(leaky is not None), float(leaky or 0.0),
            plan["bn"], plan["mb"], plan["ck"], plan["stages"],
            int(plan["resident"]),
            plan["grid"], int(bf16), stream)
    if err != 0:
        raise RuntimeError(f"int8_conv launch failed: CUDA error {err}")
    INT8_CONV.launches += 1
    if plan["pad_out"]:
        out.copy_(y[..., :co])
    return out


def _check(xq, wt, scale, bias, pads, dilation) -> None:
    if xq.dim() != 3 or wt.dim() != 3:
        raise ValueError(f"int8_conv: want xq (B, T, Ci) and wt (K, Co, Ci), "
                         f"got {tuple(xq.shape)} and {tuple(wt.shape)}")
    b, t, ci = xq.shape
    k, co, wci = wt.shape
    for name, x, dtype in (("xq", xq, torch.int8), ("wt", wt, torch.int8),
                           ("scale", scale, torch.float32),
                           ("bias", bias, torch.float32)):
        if x is None:
            continue
        if x.dtype != dtype:
            raise TypeError(f"int8_conv: {name} must be {dtype}, got {x.dtype}")
        if x.device != xq.device:
            raise ValueError(f"int8_conv: {name} on {x.device}, xq on "
                             f"{xq.device}")
        if name != "scale" and not x.is_contiguous():
            raise ValueError(f"int8_conv: {name} must be contiguous")
    if wci != ci or k < 1:
        raise ValueError(f"int8_conv: wt {tuple(wt.shape)} does not fit xq "
                         f"{tuple(xq.shape)}")
    if scale.shape != (b, co):
        raise ValueError(f"int8_conv: scale must be (B, Co) = {(b, co)}, "
                         f"got {tuple(scale.shape)}")
    if co > 1 and scale.stride(1) != 1 or scale.stride(0) < 0:
        raise ValueError(f"int8_conv: scale strides {scale.stride()}; the "
                         "kernel wants unit channel stride")
    if bias is not None and bias.shape != (co,):
        raise ValueError(f"int8_conv: bias must be ({co},), got "
                         f"{tuple(bias.shape)}")
    if min(pads) < 0 or dilation < 1:
        raise ValueError(f"int8_conv: pads {pads} and dilation {dilation}")
    if out_len(t, k, pads, dilation) < 1:
        raise ValueError("int8_conv: the output would be empty")
    if b * t * ci >= 2**31 or b * out_len(t, k, pads, dilation) * co >= 2**31:
        raise ValueError(f"int8_conv: B = {b}, T = {t}, Ci = {ci}, Co = {co} "
                         "exceeds the kernel's 32-bit indices")


def matmul_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch: int8 as a float64 matmul cast to int32 (exact: |acc|
    < 2^53), bf16 and float32 as a float32 matmul with TF32 off."""
    if a.dtype == torch.int8:
        return (a.double() @ b.double()).to(torch.int32)
    with exact_numerics(True):
        return a.float() @ b.float()


@functools.lru_cache(maxsize=1024)
def gemm_plan(m: int, k: int, n: int, dtype: torch.dtype, *,
              a_aligned: bool = True, b_aligned: bool = True,
              sms: int = H100_SMS) -> dict:
    """The launch of csrc/int8_gemm.cu for (m, k) @ (k, n) in `dtype`.
    float32 takes the CUDA-core kernel (route "sgemm"), which reads the
    operands as they are. int8 and bf16 (route "wgmma"):
    - lda, ldb, ldc: the row strides, in elements, of the buffers the kernel
      reads and writes: A as it is, or a zero-padded workspace (m, lda) when
      its rows or base are off 16 bytes (pad_a); int8 reads B^T from the
      transpose pass's workspace (n, ldb), rows padded to 16 bytes; bf16
      reads B as it is or from a workspace (k, ldb) (pad_b); C goes through
      a workspace (m, ldc) when n is not a multiple of 4 (pad_c);
    - workspaces: name -> shape of every buffer the wrapper allocates;
    - tiles_m x tiles_n tiles of GEMM_BM x GEMM_BN, walked in groups of
      GEMM_GROUP tile rows (gemm_tile), by grid = min(tiles, sms) blocks.
    Cached per argument list and read-only, like conv_plan."""
    if dtype == torch.float32:
        return types.MappingProxyType({"route": "sgemm", "branch": "plain",
                                       "workspaces": {}})
    esize = 1 if dtype == torch.int8 else 2
    per16 = 16 // esize                    # elements in 16 bytes
    lda = _round_up(k, per16)
    plan = {"route": "wgmma", "pad_a": lda != k or not a_aligned,
            "ldc": _round_up(n, 4)}
    plan["pad_c"] = plan["ldc"] != n
    workspaces = {}
    if plan["pad_a"]:
        workspaces["a"] = (m, lda)
    else:
        lda = k
    if dtype == torch.int8:
        plan["ldb"], plan["pad_b"] = _round_up(k, 16), False
        workspaces["bt"] = (n, plan["ldb"])
    else:
        ldb = _round_up(n, per16)
        plan["pad_b"] = ldb != n or not b_aligned
        plan["ldb"] = ldb if plan["pad_b"] else n
        if plan["pad_b"]:
            workspaces["b"] = (k, ldb)
    if plan["pad_c"]:
        workspaces["c"] = (m, plan["ldc"])
    plan.update(lda=lda, workspaces=workspaces,
                branch="padded" if plan["pad_a"] or plan["pad_b"]
                or plan["pad_c"] else "tma",
                tiles_m=_ceil(m, GEMM_BM), tiles_n=_ceil(n, GEMM_BN),
                group=GEMM_GROUP)
    plan["tiles"] = plan["tiles_m"] * plan["tiles_n"]
    plan["grid"] = min(plan["tiles"], sms)
    return types.MappingProxyType(plan)


def gemm_tile(plan: dict, tile: int) -> tuple[int, int]:
    """(tile row, tile column) of tile `tile` in the kernel's grouped order:
    `group` tile rows at a time, down each column of the group before the
    next. Block i of the plan's grid takes tiles i, i + grid, ..."""
    per_group = plan["group"] * plan["tiles_n"]
    first = tile // per_group * plan["group"]
    rows = min(plan["group"], plan["tiles_m"] - first)
    r = tile % per_group
    return first + r % rows, r // rows


def transpose_int8_b(b: torch.Tensor, ldb: int) -> torch.Tensor:
    """The int8 GEMM's B^T pass on the card: b (K, N) contiguous int8 ->
    (N, ldb), zero in columns [K, ldb)."""
    k, n = b.shape
    bt = torch.empty((n, ldb), dtype=torch.int8, device=b.device)
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        err = TRANSPOSE.fn()(b.data_ptr(), bt.data_ptr(), k, n, ldb, stream)
    if err != 0:
        raise RuntimeError(f"int8 B^T pass failed: CUDA error {err}")
    return bt


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) @ b (K, N), both int8 (-> int32) or both bf16 or float32
    (-> float32); on the card both contiguous, on one device."""
    _check_mm(a, b)
    if a.device.type == "cpu":
        return matmul_reference(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"matmul: unsupported device {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul: a and b must be contiguous")
    (m, k), n = a.shape, b.shape[1]
    code = _MM_CODES[a.dtype]
    out = torch.empty((m, n), dtype=torch.int32 if code == 0 else
                      torch.float32, device=a.device)
    plan = gemm_plan(m, k, n, a.dtype, a_aligned=a.data_ptr() % 16 == 0,
                     b_aligned=b.data_ptr() % 16 == 0, sms=_sms(a.device))
    c = out
    if plan["route"] == "wgmma":
        ws = plan["workspaces"]
        if plan["pad_a"]:
            a = _padded(a, ws["a"])
        if code == 0:
            b = transpose_int8_b(b, plan["ldb"])
        elif plan["pad_b"]:
            b = _padded(b, ws["b"])
        if plan["pad_c"]:
            c = torch.empty(ws["c"], dtype=out.dtype, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = MATMUL.fn()(code, a.data_ptr(), plan.get("lda", k),
                          b.data_ptr(), plan.get("ldb", n), c.data_ptr(),
                          plan.get("ldc", n), m, n, k, plan.get("group", 1),
                          plan.get("grid", 1), stream)
    if err != 0:
        raise RuntimeError(f"matmul launch failed: CUDA error {err}")
    MATMUL.launches += 1
    if c is not out:
        out.copy_(c[:, :n])
    return out


def _check_mm(a, b) -> None:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul: want (M, K) @ (K, N), got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != b.dtype:
        raise TypeError(f"matmul: mixed dtypes {a.dtype} and {b.dtype}")
    if a.dtype not in _MM_CODES:
        raise TypeError(f"matmul: takes int8, bfloat16 or float32, got "
                        f"{a.dtype}")
    if a.device != b.device:
        raise ValueError(f"matmul: a on {a.device}, b on {b.device}")
    (m, k), n = a.shape, b.shape[1]
    if min(m, k, n) < 1:
        raise ValueError(f"matmul: empty operand ({m}, {k}) @ ({k}, {n})")
    if a.dtype == torch.int8 and k > INT8_MAX_K:
        raise ValueError(f"matmul: int8 K = {k} > {INT8_MAX_K} would overflow "
                         "the int32 sums")
    # the float32 kernel's grid is (ceil(M/128), ceil(N/128)); every kernel
    # indexes with 32-bit integers
    if -(-n // 128) > 65535 or max(m, n, 2 * k) >= 2**31:
        raise ValueError(f"matmul: ({m}, {k}) @ ({k}, {n}) exceeds the grid")
