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
TF32 hi and lo halves, one K-major block per k-step of 8 input channels;
the kernel copies `slab_ksteps` of them at a time into a ring of
`ring_slots`); `tile_plan` chooses the kernel's time tile; `conv_walk`
lists the rows each conv computes in it. The kernel carries a conv's
sums in the wgmma accumulators over at most `SUM_SPAN` taps x input
channels (`MRFTile.sum_taps` taps: the whole conv at C <= 64) and adds
such partials in float32.

A CPU tensor goes to `mrf_fused_reference` (the averaged `apply_resblock1`
composition); a CUDA tensor launches the kernel or raises. Nothing falls
back, and unlike the JAX `mrf_fused` the kernel takes any T.
`FUSED_MRF.launches` counts kernel launches.

In bfloat16 (x, w and b bf16: the bf16 vocoder) the kernel's bf16 mode
runs (bf16 wgmma, both operands in shared memory; the float32 mode's
widths, every multiple of 8 up to 120) and
the plain version follows the JAX kernel's rounding points on a bf16
strip: each conv sums in float32 from its bf16 bias and is rounded to
bf16 once, the leaky ReLU (bf16(0.1)) and y + t are taken in bf16, and the
branches are summed in float32 and the mean rounded to bf16. That differs
from the unfused bf16 composition, which rounds each conv before its bias
and averages in bf16, as the JAX package's two routes differ.
`kernel_weights` of bf16 weights lays out one slab per tap ([k16(C) / 8]
[C][8], zero input channels past C at an odd C / 8), which the kernel
copies into a ring of slots, or holds whole at C = 8 and 16 (`tile_plan`'s
`ring_slots` and `resident`).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from parrot_tts_tpu_torch.core import kernels
from parrot_tts_tpu_torch.ops.activation import leaky_relu

LRELU_SLOPE = 0.1
MAX_BRANCHES = 4           # csrc/fused_mrf.cu MAXB
MAX_PAIRS = 4              # csrc/fused_mrf.cu MAXP
CHANNEL_QUANTUM = 8        # the wgmma's n and k: channels come in eights
MAX_CHANNELS = 120         # the fused route takes stages below 128 channels
UNIT_ROWS = 64             # csrc/fused_mrf.cu UNIT_ROWS: a warpgroup's unit
RING_BYTES = 32768         # csrc/fused_mrf.cu slots32: the float32 ring's
                           # bytes, 4-12 slots (3 at C = 64)
SLAB_BYTES = 8192          # csrc/fused_mrf.cu slab_ksteps: a float32 slab's
                           # k-steps (64 C bytes each) within this
SUM_SPAN = 704             # csrc/fused_mrf.cu tap_group: taps x inputs a
                           # float32 partial sum covers on the tensor cores
RING_SLOTS_BF16 = {64: 8, 32: 12}   # csrc/fused_mrf.cu slots16: the bf16
                                    # ring at V1's widths; elsewhere as many
                                    # slabs as fit in RING_BYTES_BF16, 3-12
RING_BYTES_BF16 = 65536
RESIDENT_BF16 = (8, 16)    # csrc/fused_mrf.cu resident16: bf16 widths whose
                           # whole weight stream stays in shared memory
SMEM_BYTES = 232448        # shared memory a block may take on Hopper
H100_SMS = 132
_MAX_GRID_Y = 65535
DTYPES = (torch.float32, torch.bfloat16)


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
    wgmma's n (`wgmma_n` output channels per product: C), `warpgroups` per
    block, `rounds` 64-row units each warpgroup holds through a conv, tb
    output rows per block on a strip of tb + 2 * halo rows, the strips'
    row stride (floats), the shared memory and the recompute factor (rows
    the convs compute, in whole rounds, over n_convs * tb); `dtype` the
    kernel's mode (in bfloat16 the strips hold bf16 in [C / 8][rows][8]
    planes, a row's C elements, and a float32 strip of tb rows holds the
    branch sum); `ring_slots` the weight slabs shared memory holds at
    once, all of the stage's when `resident`; in float32 `slab_ksteps`
    the k-steps (8 input channels each) of a slab and `sum_taps` the taps
    over which the tensor cores carry a conv's sums before they are added
    in float32."""

    channels: int
    halo: int
    tb: int
    wgmma_n: int
    warpgroups: int
    rounds: int
    strip_stride: int
    smem_bytes: int
    recompute: float
    dtype: torch.dtype = torch.float32
    ring_slots: int = 0
    resident: bool = False
    slab_ksteps: int = 1
    sum_taps: int = 0

    @property
    def k_chunk(self) -> int:
        """Input channels of the weight layout's slab: one tap's C in
        bfloat16, one k-step's 8 in float32 (`slab_ksteps` of which share
        a ring slot)."""
        if self.dtype == torch.bfloat16:
            return self.channels
        return CHANNEL_QUANTUM


def _warpgroups(c: int, dtype: torch.dtype = torch.float32) -> int:
    """csrc/fused_mrf.cu warpgroups32: 3 at C = 16, 4 at 8 and 24, 3 up to
    48, else 2; in bfloat16 warpgroups16: 4 up to C = 24, 3 up to 56, 2 up
    to 112, 3 at 120."""
    if dtype == torch.bfloat16:
        return 4 if c <= 24 else 3 if c <= 56 else 2 if c <= 112 else 3
    return 3 if c == 16 else 4 if c <= 24 else 3 if c <= 48 else 2


def _rounds(c: int, dtype: torch.dtype = torch.float32) -> int:
    """csrc/fused_mrf.cu rounds32 (rounds16 in bfloat16): 64 x C units a
    warpgroup holds through a conv."""
    if dtype == torch.bfloat16:
        return (5 if c <= 24 else 4 if c <= 56 else 3 if c <= 96
                else 2 if c <= 112 else 1)
    return 5 if c == 16 else 4 if c <= 40 else 3 if c <= 96 else 2


def _slab_ksteps(c: int) -> int:
    """csrc/fused_mrf.cu slab_ksteps: the most k-steps dividing a tap's
    C / 8 whose slab stays within SLAB_BYTES."""
    return max(k for k in range(1, c // 8 + 1)
               if (c // 8) % k == 0 and 64 * c * k <= SLAB_BYTES)


def _slots(c: int) -> int:
    """csrc/fused_mrf.cu slots32: the float32 ring's slots."""
    if c == 64:
        return 3
    return min(12, max(4, RING_BYTES // (64 * c * _slab_ksteps(c))))


def _barrier_bytes(nslot: int) -> int:
    """A full and an empty mbarrier per slot, padded to 128 bytes."""
    return -(-16 * nslot // 128) * 128


def _k16(c: int) -> int:
    """csrc/fused_mrf.cu k16: C rounded up to the bf16 wgmma's 16-deep
    k-step (an odd C / 8 adds one zero plane of 8 channels)."""
    return -(-c // 16) * 16


def _strip_stride(c: int) -> int:
    """C + 8 or C + 16: a multiple of 8 that is 8 or 24 mod 32, so the
    float2 fragment loads of a half warp hit 32 banks."""
    return c + 8 if c % 16 == 0 else c + 16


def _n_slabs(plan: MRFPlan) -> int:
    """The bf16 weight stream's slabs: one per tap of every conv."""
    return 2 * sum(k * len(d)
                   for k, d in zip(plan.kernel_sizes, plan.dilations))


def _slots_bf16(c: int, slabs: int) -> int:
    """Weight slots in shared memory: the whole stream at a resident
    width, else the ring (csrc/fused_mrf.cu slots16)."""
    if c in RESIDENT_BF16:
        return slabs
    return RING_SLOTS_BF16.get(
        c, min(12, max(3, RING_BYTES_BF16 // (2 * _k16(c) * c))))


def _strip_rows(rows: int) -> int:
    """csrc/fused_mrf.cu strip_rows: a bf16 strip plane's rows, rounded
    up to 4 mod 8."""
    return (rows + 3) // 8 * 8 + 4


def _smem_bf16(c: int, tb: int, halo: int, slabs: int) -> int:
    """csrc/fused_mrf.cu smem_bytes_bf16: a full and an empty mbarrier per
    weight slot (padded to 128 bytes), the slots of one-tap slabs
    ([k16(C) / 8][C][8]), two bf16 strips ([C / 8][rows][8] and, read by
    the products, [k16(C) / 8][rows][8]; tb + 2 * halo rows rounded up to
    4 mod 8), the float32 branch sum of tb rows of `_strip_stride(C)`, and
    16 bytes a row for one unit per warpgroup (a last round's unit reads
    that far past the strips)."""
    nslot, bf16 = _slots_bf16(c, slabs), torch.bfloat16
    return (_barrier_bytes(nslot) + 2 * nslot * _k16(c) * c
            + 2 * _strip_rows(tb + 2 * halo) * (c + _k16(c))
            + 4 * tb * _strip_stride(c)
            + 16 * UNIT_ROWS * _warpgroups(c, bf16))


def _tb_max_bf16(c: int, halo: int, slabs: int) -> int:
    """The longest bf16 tile (a multiple of 16): its strips within the
    warpgroups' rounds of units and within shared memory."""
    bf16 = torch.bfloat16
    tb = (UNIT_ROWS * _warpgroups(c, bf16) * _rounds(c, bf16)
          - 2 * halo) // 16 * 16
    while tb >= 16 and _smem_bf16(c, tb, halo, slabs) > SMEM_BYTES:
        tb -= 16
    return tb


def _smem(c: int, rows: int) -> int:
    """csrc/fused_mrf.cu smem_bytes: the barriers, the float32 ring and two
    strips of `rows` rows."""
    return (_barrier_bytes(_slots(c)) + 64 * _slots(c) * c * _slab_ksteps(c)
            + 8 * rows * _strip_stride(c))


def max_strip_rows(c: int) -> int:
    """The longest float32 strip: two strips and the ring in shared
    memory, and ceil(rows / 64) units within the warpgroups' rounds."""
    by_smem = (SMEM_BYTES - _smem(c, 0)) // (8 * _strip_stride(c))
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


def _rows_computed(plan: MRFPlan, tb: int,
                   dtype: torch.dtype = torch.float32) -> int:
    """Rows a block's convs compute: each conv in rounds of one 64-row
    unit per warpgroup."""
    step = UNIT_ROWS * _warpgroups(plan.channels, dtype)
    return sum(-(-(hi - lo) // step) * step
               for *_, lo, hi in conv_walk(plan, tb))


@functools.lru_cache(maxsize=256)
def tile_plan(plan: MRFPlan, shape: tuple[int, int] | None = None,
              sms: int = H100_SMS,
              dtype: torch.dtype = torch.float32) -> MRFTile:
    """tb, a multiple of 16 whose strip fits, chosen for the least work: a
    block's time taken as the rows its convs compute (whole rounds of
    units), a launch of shape = (B, T) as its waves of blocks (one block
    per SM) times a block's; with no shape, the least work per output row.
    No tb below 2 * halo where a longer one fits: every block streams the
    stage's weights, which the rows do not count. Raises ValueError when
    no tile of 16 rows fits (a halo too long for the strips). dtype: the
    kernel's mode (bfloat16: bf16 strips, the weight slots and the float32
    branch-sum strip, `_smem_bf16`)."""
    c, halo = plan.channels, plan.halo
    bf16 = dtype == torch.bfloat16
    slabs = _n_slabs(plan)
    tb_max = (_tb_max_bf16(c, halo, slabs) if bf16
              else (max_strip_rows(c) - 2 * halo) // 16 * 16)
    if tb_max < 16:
        raise ValueError(f"mrf_fused: a halo of {halo} rows leaves no room "
                         f"for a 16-row tile at {c} channels")

    def cost(tb):
        if shape is None:
            return _rows_computed(plan, tb, dtype) / tb, -tb
        bsz, t = shape
        return (-(-bsz * -(-t // tb) // sms)
                * _rows_computed(plan, tb, dtype), -tb)

    floor = min(tb_max, max(16, -(-2 * halo // 16) * 16))
    tb = min(range(floor, tb_max + 1, 16), key=cost)
    n_convs = 2 * sum(len(d) for d in plan.dilations)
    smem = (_smem_bf16(c, tb, halo, slabs) if bf16
            else _smem(c, tb + 2 * halo))
    return MRFTile(channels=c, halo=halo, tb=tb, wgmma_n=c,
                   warpgroups=_warpgroups(c, dtype),
                   rounds=_rounds(c, dtype),
                   strip_stride=c if bf16 else _strip_stride(c),
                   smem_bytes=smem,
                   recompute=(_rows_computed(plan, tb, dtype)
                              / (n_convs * tb)),
                   dtype=dtype,
                   ring_slots=_slots_bf16(c, slabs) if bf16 else _slots(c),
                   resident=bf16 and c in RESIDENT_BF16,
                   slab_ksteps=1 if bf16 else _slab_ksteps(c),
                   sum_taps=0 if bf16 else SUM_SPAN // c)


def tf32_split(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """w = hi + lo: hi is w rounded to TF32's 11 significant bits (to
    nearest, ties to even, on the float32 bit pattern), lo the rest."""
    u = w.contiguous().view(torch.int32)
    hi = ((u + 0x0FFF + ((u >> 13) & 1)) & ~0x1FFF).view(torch.float32)
    return hi, w - hi


_K_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)   # element k of an 8-wide k-step


def kernel_weights(w: torch.Tensor, plan: MRFPlan) -> torch.Tensor:
    """`pack_mrf`'s weights as the kernel streams them: for each conv (in
    pack order), tap and k-step of 8 input channels, one slab: its TF32 hi
    half, then its lo half, each K-major [2][Co][4] (the wgmma's
    no-swizzle layout), the 8 input channels in the order _K_ORDER (the A
    fragment's: k t holds channel 2t, k t + 4 channel 2t + 1). For
    bfloat16 w, one bf16 slab per tap: K-major [k16(C) / 8][C][8] (input
    channel 8q + j of output channel co at [q][co][j]; the last 8 input
    channels zero at an odd C / 8, where the 16-deep k-steps run one plane
    past C), the order in which the strips' [C / 8][rows][8] planes give
    the A operand its k."""
    c = plan.channels
    if w.dtype == torch.bfloat16:
        return _kernel_weights_bf16(w, plan)
    kc = CHANNEL_QUANTUM
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


def _kernel_weights_bf16(w: torch.Tensor, plan: MRFPlan) -> torch.Tensor:
    c = plan.channels
    if c % CHANNEL_QUANTUM:
        raise ValueError(f"mrf_fused: {c} channels; the bf16 kernel takes "
                         f"multiples of {CHANNEL_QUANTUM}")
    # [tap][ci][co] of every conv, in pack order -> [tap][ci / 8][co][8],
    # with zero input channels up to k16(C)
    kern = F.pad(w.reshape(-1, c, c), (0, 0, 0, _k16(c) - c))
    kern = kern.reshape(-1, _k16(c) // 8, 8, c)
    return kern.permute(0, 1, 3, 2).contiguous().reshape(-1)


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
    each conv a zero-padded F.conv1d on (B, C, T); for a bfloat16 x the JAX
    kernel's bf16 rounding points (`_reference_bf16`)."""
    if x.dtype == torch.bfloat16:
        return _reference_bf16(x, w, b, plan)
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


def _reference_bf16(x, w, b, plan: MRFPlan) -> torch.Tensor:
    """The JAX `_mrf_kernel` on a bf16 strip: each conv in float32 on bf16
    values with its bf16 bias, rounded to bf16 once; leaky ReLU and y + t
    in bf16; the branches summed in float32, times 1 / n, rounded."""
    bf16 = torch.bfloat16
    xt = x.transpose(1, 2)
    acc, y = None, None
    w, b = w.to(bf16).float(), b.to(bf16).float()
    for i, j, w1, b1, w2, b2, d, (p1, p2) in _unpack(w, b, plan):
        if j == 0:
            y = xt
        t = leaky_relu(y, LRELU_SLOPE).float()
        t = F.conv1d(t, w1.permute(2, 1, 0), b1, padding=p1,
                     dilation=d).to(bf16)
        t = leaky_relu(t, LRELU_SLOPE).float()
        t = F.conv1d(t, w2.permute(2, 1, 0), b2, padding=p2).to(bf16)
        y = t + y
        if j == len(plan.dilations[i]) - 1:
            acc = y.float() if acc is None else acc + y.float()
    return (acc * (1.0 / len(plan.kernel_sizes))).to(bf16).transpose(1, 2)


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
            lib.fused_mrf_bf16.argtypes = lib.fused_mrf_f32.argtypes
            lib.fused_mrf_bf16.restype = ctypes.c_int
            self._lib = lib
        return self._lib


FUSED_MRF = _FusedMRF()


def mrf_fused(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              plan: MRFPlan, *, wk: torch.Tensor | None = None
              ) -> torch.Tensor:
    """x (B, T, C) float32 or bfloat16; w, b from `pack_mrf` in x's dtype;
    wk, `kernel_weights(w, plan)` where the caller keeps it (made here
    otherwise). Returns (B, T, C) in x's dtype."""
    if x.device.type == "cpu":
        return mrf_fused_reference(x, w, b, plan)
    if x.device.type != "cuda":
        raise ValueError(f"mrf_fused: unsupported device {x.device}")
    _check(x, w, b, plan)
    if wk is None:
        wk = kernel_weights(w, plan)
    bf16 = x.dtype == torch.bfloat16
    c = plan.channels
    if (wk.dtype != x.dtype or wk.device != x.device
            or not wk.is_contiguous()
            or wk.shape != ((w.numel() // c * _k16(c) if bf16
                             else 2 * w.numel()),)
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
        tile = tile_plan(plan, (bsz, t), sms, x.dtype)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        lib = FUSED_MRF.lib()
        err = (lib.fused_mrf_bf16 if bf16 else lib.fused_mrf_f32)(
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
    if x.dtype not in DTYPES:
        raise TypeError(f"mrf_fused: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    for name, t in (("x", x), ("w", w), ("b", b)):
        if t.dtype != x.dtype:
            raise TypeError(f"mrf_fused: {name} must be {x.dtype}, got "
                            f"{t.dtype}")
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
    # raises for a halo the strips cannot hold
    tile_plan(plan, dtype=x.dtype)
