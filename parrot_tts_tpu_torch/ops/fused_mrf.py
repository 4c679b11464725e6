"""Fused MRF stage: the CUDA kernel's wrapper, its plain version and the
weight packing.

Port of `parrot_tts_tpu/ops/fused_mrf.py::{MRFPlan, pack_mrf, mrf_fused}`.
One MRF stage (the mean of the stage's ResBlock1 branches, each a chain of
(dilated conv, conv) pairs with leaky ReLUs and residual adds) runs as one
kernel, `csrc/fused_mrf.cu` (3xTF32 products on the tensor cores, wgmma),
which replaces the TPU's Pallas `_mrf_kernel`. The TPU kernel works on the
folded block-Toeplitz layout; here the activations stay (B, T, C) and the
weights are plain (K, Ci, Co) kernels, so the halo is counted in samples.
`kernel_weights` lays the packed weights out for the kernel (split into
TF32 hi and lo halves, K-major slabs); `tile_plan` chooses the kernel's
time tile; `conv_walk` lists the rows each conv computes in it.

A CPU tensor goes to `mrf_fused_reference` (the averaged `apply_resblock1`
composition); a CUDA tensor launches the kernel or raises. Nothing falls
back, and unlike the JAX `mrf_fused` the kernel takes any T.
`FUSED_MRF.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from parrot_tts_tpu_torch.core import kernels

LRELU_SLOPE = 0.1
MAX_BRANCHES = 4           # csrc/fused_mrf.cu MAXB
MAX_PAIRS = 4              # csrc/fused_mrf.cu MAXP
CHANNEL_QUANTUM = 8        # the wgmma's n and k: channels come in eights
MAX_CHANNELS = 120         # the fused route takes stages below 128 channels
UNIT_ROWS = 64             # csrc/fused_mrf.cu UNIT_ROWS: a warpgroup's unit
RING_SLOTS = 2             # csrc/fused_mrf.cu NS
SMEM_BYTES = 232448        # shared memory a block may take on Hopper
H100_SMS = 132
_MAX_GRID_Y = 65535


@dataclass(frozen=True)
class MRFPlan:
    """Static description of one stage: each branch's kernel size and the
    dilation of each of its dilated convs; halo = the longest branch's
    one-sided receptive field in samples (the sum of its convs' pads)."""

    channels: int
    kernel_sizes: tuple[int, ...]
    dilations: tuple[tuple[int, ...], ...]
    halo: int

    def pads(self, branch: int) -> list[tuple[int, int]]:
        """(dilated pad, plain pad) of each pair of a branch."""
        k = self.kernel_sizes[branch]
        return [((k - 1) * d // 2, (k - 1) // 2)
                for d in self.dilations[branch]]


def pack_mrf(convs: list[list[tuple]], kernel_sizes, dilation_sizes
             ) -> tuple[torch.Tensor, torch.Tensor, MRFPlan]:
    """convs[branch][pair] = (w1, b1, w2, b2): the stage's weight-norm-folded
    ResBlock1 convs, w (K, Ci, Co) and b (Co,). Returns all kernels
    flattened in traversal order (branch, pair, dilated then plain), their
    biases likewise, and the plan."""
    ws, bs = [], []
    for branch in convs:
        for w1, b1, w2, b2 in branch:
            ws += [w1.reshape(-1), w2.reshape(-1)]
            bs += [b1, b2]
    halo = max(sum((k - 1) * d // 2 + (k - 1) // 2 for d in dils)
               for k, dils in zip(kernel_sizes, dilation_sizes))
    plan = MRFPlan(channels=convs[0][0][0].shape[2],
                   kernel_sizes=tuple(kernel_sizes),
                   dilations=tuple(tuple(d) for d in dilation_sizes),
                   halo=halo)
    return (torch.cat(ws).float().contiguous(),
            torch.cat(bs).float().contiguous(), plan)


@dataclass(frozen=True)
class MRFTile:
    """The kernel's launch tile for one stage (one block per SM): the
    wgmma's n (`wgmma_n` output channels per product; k_chunk = min(n, 32)
    input channels per weight slab), `warpgroups` per block, `rounds`
    64-row units each warpgroup holds through a conv, tb output rows per
    block on a strip of tb + 2 * halo rows, the strips' row stride
    (floats), the shared memory and the recompute factor (rows the convs
    compute, in whole rounds, over n_convs * tb)."""

    channels: int
    halo: int
    tb: int
    wgmma_n: int
    warpgroups: int
    rounds: int
    strip_stride: int
    smem_bytes: int
    recompute: float

    @property
    def k_chunk(self) -> int:
        return min(self.wgmma_n, 32)


def _wgmma_n(c: int) -> int:
    """csrc/fused_mrf.cu wg_n: 64 at C = 64, else the widest of 32, 16, 8
    that divides C."""
    return 64 if c == 64 else 32 if c % 32 == 0 else 16 if c % 16 == 0 else 8


def _warpgroups(c: int) -> int:
    """csrc/fused_mrf.cu warpgroups: 4 at C = 8 and 16, 3 at 32, else 2."""
    return 4 if c in (8, 16) else 3 if c == 32 else 2


def _rounds(c: int) -> int:
    """csrc/fused_mrf.cu rounds: 64 x C units a warpgroup holds through a
    conv."""
    return {8: 5, 16: 5, 32: 4, 64: 3}.get(c, 2)


def _strip_stride(c: int) -> int:
    """C + 8 or C + 16: a multiple of 8 that is 8 or 24 mod 32, so the
    float2 fragment loads of a half warp hit 32 banks."""
    return c + 8 if c % 16 == 0 else c + 16


def max_strip_rows(c: int) -> int:
    """The longest strip: two strips and the ring in shared memory, and
    ceil(rows / 64) units within the warpgroups' rounds."""
    ring = 4 * RING_SLOTS * 2 * min(_wgmma_n(c), 32) * c
    by_smem = (SMEM_BYTES - ring) // (2 * 4 * _strip_stride(c))
    return min(by_smem, UNIT_ROWS * _warpgroups(c) * _rounds(c))


def conv_walk(plan: MRFPlan, tb: int) -> list[tuple[int, int, int, int, int,
                                                    int, int]]:
    """(branch, pair, conv, dilation, pad, lo, hi) of each conv in the
    kernel's order: conv 0 (dilated) or 1 computes strip rows [lo, hi),
    strip row halo being the tile's first output row. The dilated conv
    reads rows [lo - pad, hi + pad) of the branch state; each branch ends
    on exactly [halo, halo + tb)."""
    out, h = [], plan.halo
    for i, k in enumerate(plan.kernel_sizes):
        pads = plan.pads(i)
        rem = sum(p1 + p2 for p1, p2 in pads)
        for j, (d, (p1, p2)) in enumerate(zip(plan.dilations[i], pads)):
            out.append((i, j, 0, d, p1, h - rem + p1, h + tb + rem - p1))
            rem -= p1 + p2
            out.append((i, j, 1, 1, p2, h - rem, h + tb + rem))
    return out


def _rows_computed(plan: MRFPlan, tb: int) -> int:
    """Rows a block's convs compute: each conv in rounds of one 64-row
    unit per warpgroup."""
    step = UNIT_ROWS * _warpgroups(plan.channels)
    return sum(-(-(hi - lo) // step) * step
               for *_, lo, hi in conv_walk(plan, tb))


@functools.lru_cache(maxsize=256)
def tile_plan(plan: MRFPlan, shape: tuple[int, int] | None = None,
              sms: int = H100_SMS) -> MRFTile:
    """tb, a multiple of 16 whose strip fits, chosen for the least work: a
    block's time taken as the rows its convs compute (whole rounds of
    units), a launch of shape = (B, T) as its waves of blocks (one block
    per SM) times a block's; with no shape, the least work per output row.
    No tb below 2 * halo where a longer one fits: every block streams the
    stage's weights and waits at a barrier per slab, which the rows do not
    count. Raises ValueError when no tile of 16 rows fits (a halo too long
    for the strips)."""
    c, halo = plan.channels, plan.halo
    tb_max = (max_strip_rows(c) - 2 * halo) // 16 * 16
    if tb_max < 16:
        raise ValueError(f"mrf_fused: a halo of {halo} rows leaves no room "
                         f"for a 16-row tile at {c} channels")

    def cost(tb):
        if shape is None:
            return _rows_computed(plan, tb) / tb, -tb
        bsz, t = shape
        return -(-bsz * -(-t // tb) // sms) * _rows_computed(plan, tb), -tb

    floor = min(tb_max, max(16, -(-2 * halo // 16) * 16))
    tb = min(range(floor, tb_max + 1, 16), key=cost)
    n = _wgmma_n(c)
    n_convs = 2 * sum(len(d) for d in plan.dilations)
    smem = 4 * (2 * (tb + 2 * halo) * _strip_stride(c)
                + RING_SLOTS * 2 * min(n, 32) * c)
    return MRFTile(channels=c, halo=halo, tb=tb, wgmma_n=n,
                   warpgroups=_warpgroups(c), rounds=_rounds(c),
                   strip_stride=_strip_stride(c),
                   smem_bytes=smem,
                   recompute=_rows_computed(plan, tb) / (n_convs * tb))


def tf32_split(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """w = hi + lo: hi is w rounded to TF32's 11 significant bits (to
    nearest, ties to even, on the float32 bit pattern), lo the rest."""
    u = w.contiguous().view(torch.int32)
    hi = ((u + 0x0FFF + ((u >> 13) & 1)) & ~0x1FFF).view(torch.float32)
    return hi, w - hi


_K_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)   # element k of an 8-wide k-step


def kernel_weights(w: torch.Tensor, plan: MRFPlan) -> torch.Tensor:
    """`pack_mrf`'s weights as the kernel streams them: for each conv (in
    pack order), tap and chunk of k_chunk input channels, one slab: its
    TF32 hi half, then its lo half, each K-major [k_chunk / 4][Co][4] (the
    wgmma's no-swizzle layout), the input channels of every 8 in the order
    _K_ORDER (the A fragment's: k t holds channel 2t, k t + 4 channel
    2t + 1)."""
    c = plan.channels
    kc = min(_wgmma_n(c), 32)
    order = torch.tensor(_K_ORDER)
    slabs, off = [], 0
    for k, dils in zip(plan.kernel_sizes, plan.dilations):
        for _ in range(2 * len(dils)):
            kern = w[off:off + k * c * c].reshape(k, c, c)      # [tap][ci][co]
            off += k * c * c
            kt = kern.transpose(1, 2).reshape(k, c, c // 8, 8)[..., order]
            kt = kt.reshape(k, c, c // kc, kc // 4, 4).permute(0, 2, 3, 1, 4)
            hi, lo = tf32_split(kt.contiguous())
            # [tap][chunk][hi, lo][kc / 4][co][4]
            slabs.append(torch.stack([hi, lo], dim=2))
    return torch.cat([x.reshape(-1) for x in slabs]).contiguous()


def _unpack(w: torch.Tensor, b: torch.Tensor, plan: MRFPlan):
    """Yield (branch, pair, w1, b1, w2, b2, d, pads) with w in (K, Ci, Co)."""
    c, wo, bo = plan.channels, 0, 0
    for i, k in enumerate(plan.kernel_sizes):
        n = k * c * c
        for j, (d, pads) in enumerate(zip(plan.dilations[i], plan.pads(i))):
            w1 = w[wo:wo + n].reshape(k, c, c)
            w2 = w[wo + n:wo + 2 * n].reshape(k, c, c)
            yield i, j, w1, b[bo:bo + c], w2, b[bo + c:bo + 2 * c], d, pads
            wo, bo = wo + 2 * n, bo + 2 * c


def mrf_fused_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        plan: MRFPlan) -> torch.Tensor:
    """Plain PyTorch: the mean of the branches' apply_resblock1 chains,
    each conv a zero-padded F.conv1d on (B, C, T)."""
    xt = x.transpose(1, 2)
    acc, y = None, None
    for i, j, w1, b1, w2, b2, d, (p1, p2) in _unpack(w, b, plan):
        if j == 0:
            y = xt
        t = F.leaky_relu(y, LRELU_SLOPE)
        t = F.conv1d(t, w1.permute(2, 1, 0), b1, padding=p1, dilation=d)
        t = F.leaky_relu(t, LRELU_SLOPE)
        t = F.conv1d(t, w2.permute(2, 1, 0), b2, padding=p2)
        y = t + y
        if j == len(plan.dilations[i]) - 1:
            acc = y if acc is None else acc + y
    return (acc / len(plan.kernel_sizes)).transpose(1, 2)


class _FusedMRF:
    """The loaded kernel and its launch count (one per process)."""

    def __init__(self):
        self.launches = 0
        self._lib = None

    def lib(self):
        if self._lib is None:
            lib = kernels.load("fused_mrf")
            lib.fused_mrf_f32.argtypes = [ctypes.c_void_p] * 4 + [
                ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] * 3 + [
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            lib.fused_mrf_f32.restype = ctypes.c_int
            self._lib = lib
        return self._lib


FUSED_MRF = _FusedMRF()


def mrf_fused(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              plan: MRFPlan, *, wk: torch.Tensor | None = None
              ) -> torch.Tensor:
    """x (B, T, C) float32; w, b from `pack_mrf`; wk, `kernel_weights(w,
    plan)` where the caller keeps it (made here otherwise). Returns
    (B, T, C)."""
    if x.device.type == "cpu":
        return mrf_fused_reference(x, w, b, plan)
    if x.device.type != "cuda":
        raise ValueError(f"mrf_fused: unsupported device {x.device}")
    _check(x, w, b, plan)
    if wk is None:
        wk = kernel_weights(w, plan)
    if (wk.dtype != torch.float32 or wk.device != x.device
            or not wk.is_contiguous() or wk.shape != (2 * w.numel(),)
            or wk.data_ptr() % 16):
        raise ValueError("mrf_fused: wk is not kernel_weights(w, plan) on "
                         "x's device")
    bsz, t, c = x.shape
    out = torch.empty_like(x)
    if bsz == 0 or t == 0:
        return out
    nb = len(plan.kernel_sizes)
    ks = (ctypes.c_int * nb)(*plan.kernel_sizes)
    npairs = (ctypes.c_int * nb)(*(len(d) for d in plan.dilations))
    dils = (ctypes.c_int * (nb * MAX_PAIRS))(
        *(d[j] if j < len(d) else 0 for d in plan.dilations
          for j in range(MAX_PAIRS)))
    with torch.cuda.device(x.device):
        sms = _sm_count(torch.cuda.current_device())
        tile = tile_plan(plan, (bsz, t), sms)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = FUSED_MRF.lib().fused_mrf_f32(
            x.data_ptr(), wk.data_ptr(), b.data_ptr(), out.data_ptr(),
            bsz, t, c, nb, ks, npairs, dils, plan.halo, tile.tb, stream)
    if err != 0:
        raise RuntimeError(f"fused_mrf launch failed: CUDA error {err}")
    FUSED_MRF.launches += 1
    return out


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(x, w, b, plan: MRFPlan) -> None:
    for name, t in (("x", x), ("w", w), ("b", b)):
        if t.dtype != torch.float32:
            raise TypeError(f"mrf_fused: {name} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"mrf_fused: {name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"mrf_fused: {name} must be contiguous")
    if x.data_ptr() % 16:          # 16-byte loads of its rows
        raise ValueError("mrf_fused: x must be 16-byte aligned")
    if x.dim() != 3 or x.shape[2] != plan.channels:
        raise ValueError(f"mrf_fused: want x (B, T, {plan.channels}), got "
                         f"{tuple(x.shape)}")
    c = plan.channels
    if c % CHANNEL_QUANTUM or not CHANNEL_QUANTUM <= c <= MAX_CHANNELS:
        raise ValueError(f"mrf_fused: {c} channels; the kernel takes "
                         f"multiples of {CHANNEL_QUANTUM} up to "
                         f"{MAX_CHANNELS}")
    nb = len(plan.kernel_sizes)
    if not 1 <= nb <= MAX_BRANCHES or any(
            not 1 <= len(d) <= MAX_PAIRS for d in plan.dilations):
        raise ValueError(f"mrf_fused: at most {MAX_BRANCHES} branches of "
                         f"{MAX_PAIRS} pairs")
    n_pairs = sum(len(d) for d in plan.dilations)
    n_w = sum(2 * k * c * c * len(d)
              for k, d in zip(plan.kernel_sizes, plan.dilations))
    if w.shape != (n_w,) or b.shape != (2 * n_pairs * c,):
        raise ValueError("mrf_fused: packed weights do not fit the plan")
    if x.shape[0] > _MAX_GRID_Y:
        raise ValueError(f"mrf_fused: B = {x.shape[0]} > {_MAX_GRID_Y}")
    tile_plan(plan)                # raises for a halo the strips cannot hold
