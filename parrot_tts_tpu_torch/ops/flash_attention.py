"""Flash-attention forward: the CUDA kernel's wrapper and its plain version.

`flash_attention` computes softmax(Q Kᵀ·scale + mask) V for (B, H, T, D)
float32, non-causal, with a torch-style key padding mask (True = ignore
that key). It replaces the TPU's Pallas flash attention
(`parrot_tts_tpu/ops/attention.py::_flash_attention`). A query row whose
keys are all masked gives 0, never NaN.

A CPU tensor goes to `flash_attention_reference` (plain PyTorch); a CUDA
tensor launches `csrc/flash_attn_fwd.cu` or raises. Nothing falls back.
The kernels multiply on the TF32 tensor cores in one of two modes, each
a pre-pass and an attention kernel of the same source. The pre-pass
writes K and Vᵀ once per (b, h), tile by tile (BK keys) in the layout the
wgmma products read, with each key's mask bias, into scratch; the
attention kernel reads those tiles:

- passes=3: a 3xTF32 split (each float32 operand as a sum of two TF32
  values, three products), which keeps float32 accuracy: it stays within
  1e-5 of the IEEE float32 plain version and keeps the exact decode's
  units (the source says how). The pre-pass (`split_operands`) writes K
  and Vᵀ split into TF32 hi and lo planes; the kernel
  (`split_attention`) splits Q and P in registers. Its plain version is
  `flash_attention_reference(..., passes=3)`, IEEE float32; the
  pre-pass's is `split_operands_reference`;
- passes=1: one TF32 product of operands rounded to TF32, the TPU's
  default 1-pass precision, for the "selective" decode and exact=False.
  The pre-pass (`one_pass_operands`) writes K and Vᵀ rounded to TF32; the
  kernel is `one_pass_attention`. Its plain version is
  `flash_attention_reference(..., passes=1)`, which rounds q, k, P and v
  to TF32 where the kernel does, P tile by tile against the running row
  max; the pre-pass's is `one_pass_operands_reference`.

`FLASH_FWD.launches` counts attention launches, and `FLASH_FWD.one_pass`
those of them in 1-pass mode, so a run can show that its attention went
through the kernels, and in which mode; `SPLIT_PREP.launches` and
`ONE_PASS_PREP.launches` count the two pre-passes.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from parrot_tts_tpu_torch.core import kernels
# the TF32 A fragment's k order (csrc/tf32x3.cuh): logical k t of 8 holds
# element 2t, t + 4 element 2t + 1; here the key of each logical k of a
# V^T tile
from parrot_tts_tpu_torch.ops.fused_mrf import _K_ORDER
from parrot_tts_tpu_torch.ops.precision import round_tf32

D_HEADS = (64, 128)        # head widths the kernels are instantiated for
BK = 32                    # keys per tile of every kernel; the 1-pass mode
                           # rounds P per BK keys against the running max
_MAX_GRID_Y = 65535


def _entry(name: str, argtypes: list):
    fn = getattr(kernels.load("flash_attn_fwd"), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


# each mode's attention entry point (q, kv, o, B, H, T, D, scale, stream);
# the pre-passes' (`_Prep`) take (k, v, mask, kv, B, H, T, D, stream)
_ATTENTION = {3: "flash_attn_fwd_f32", 1: "flash_attn_1pass_f32"}


class _FlashForward:
    """The loaded attention kernels and their launch counts (one per
    process): all attention launches, and the 1-pass ones among them."""

    def __init__(self):
        self.launches = 0
        self.one_pass = 0
        self._fn = {}

    def fn(self, passes: int):
        if passes not in self._fn:
            self._fn[passes] = _entry(_ATTENTION[passes],
                                      [ctypes.c_void_p] * 3
                                      + [ctypes.c_int] * 4
                                      + [ctypes.c_float, ctypes.c_void_p])
        return self._fn[passes]


class _Prep:
    """One mode's pre-pass and its launch count (one per process)."""

    def __init__(self, name: str):
        self.launches = 0
        self._name = name
        self._fn = None

    def fn(self):
        if self._fn is None:
            self._fn = _entry(self._name, [ctypes.c_void_p] * 4
                              + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        return self._fn


FLASH_FWD = _FlashForward()
SPLIT_PREP = _Prep("flash_attn_split_f32")       # the 3xTF32 mode's
ONE_PASS_PREP = _Prep("flash_attn_prep_f32")     # the 1-pass mode's
_PREP = {3: SPLIT_PREP, 1: ONE_PASS_PREP}
_PARTS = {3: 2, 1: 1}      # planes of K and of Vᵀ in a tile, per mode


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              key_padding_mask: torch.Tensor | None,
                              scale: float, passes: int = 3) -> torch.Tensor:
    """Plain PyTorch: the XLA path of the JAX package
    (`attention.py:99-111`), except that rows with no valid key give 0.
    passes=3: IEEE float32 (under IEEE matmul flags). passes=1: the
    kernel's 1-pass mode, q, k, v and the unnormalised weights rounded to
    TF32 (`round_tf32`) before their products, which are exact in float32.
    As in the kernel's online softmax, the weights of each BK-key tile are
    P = exp(s - m) with m the row max over the keys up to that tile, and
    are rounded so, then scaled by exp(m - max); P V is divided by the sum
    of the unrounded weights."""
    if passes == 1:
        q, k, v = round_tf32(q), round_tf32(k), round_tf32(v)
    elif passes != 3:
        raise ValueError(f"flash_attention: passes {passes} not in (1, 3)")
    scores = torch.matmul(q, k.transpose(-1, -2)) * scale
    if key_padding_mask is not None:
        scores = scores.masked_fill(key_padding_mask[:, None, None, :],
                                    float("-inf"))
    if passes == 3:
        if key_padding_mask is None:
            return torch.matmul(torch.softmax(scores, dim=-1), v)
        attn = torch.softmax(scores, dim=-1)
        all_masked = key_padding_mask.all(dim=-1)[:, None, None, None]
        return torch.matmul(attn.masked_fill(all_masked, 0.0), v)
    t = scores.shape[-1]
    n = -(-t // BK)
    tiles = F.pad(scores, (0, n * BK - t), value=float("-inf"))
    m = tiles.unflatten(-1, (n, BK)).amax(-1).cummax(-1).values
    m = m.repeat_interleave(BK, dim=-1)[..., :t]    # running max, per key
    seen = m > float("-inf")        # a valid key at or before this tile
    p = torch.exp(scores - torch.where(seen, m, 0.0))
    rescale = torch.where(seen, torch.exp(m - m[..., -1:]), 0.0)
    l = (p * rescale).sum(dim=-1, keepdim=True)
    o = torch.matmul(round_tf32(p) * rescale, v)
    return torch.where(l > 0, o / torch.where(l > 0, l, 1.0), 0.0)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x = hi + lo exactly, as csrc/tf32x3.cuh::split takes it (Veltkamp,
    in float32 operations rounded to nearest): hi is x rounded to TF32's
    11 significant bits, lo the rest."""
    c = x * 8193.0                     # 2^13 + 1
    hi = c - (c - x)
    return hi, x - hi


def _tiles_reference(k: torch.Tensor, v: torch.Tensor,
                     key_padding_mask: torch.Tensor | None,
                     passes: int) -> torch.Tensor:
    """Plain PyTorch: a mode's pre-pass scratch for (B, H, T, D) float32 k
    and v, (B*H, ceil(T / BK), 2*P*D*BK + BK) float32 with P planes (P = 2
    at passes=3, 1 at passes=1). Each key tile holds P planes of K as
    [D / 4][BK][4] (key n's d at [d / 4][n][d % 4]), then the key bias [BK]
    (0, or -inf for a masked key or one past T), then P planes of Vᵀ as
    [BK / 4][D][4] with its keys in `_K_ORDER` within every 8 (logical key
    p's d at [p / 4][d][p % 4]); keys past T are 0. The planes: at
    passes=3, `split_tf32`'s hi, then lo; at passes=1, the values rounded
    to TF32 (`round_tf32`)."""
    b, h, t, d = k.shape
    n = -(-t // BK)
    pad = (0, 0, 0, n * BK - t)

    def planes(x):
        return split_tf32(x) if passes == 3 else [round_tf32(x)]

    ks = [F.pad(x, pad).reshape(b * h, n, BK, d // 4, 4)
          .permute(0, 1, 3, 2, 4).reshape(b * h, n, -1) for x in planes(k)]
    valid = (torch.ones(b, t, dtype=torch.bool, device=k.device)
             if key_padding_mask is None else ~key_padding_mask)
    valid = F.pad(valid, (0, n * BK - t))
    bias = torch.where(valid, 0.0, float("-inf")).reshape(b, 1, n, BK)
    bias = bias.expand(b, h, n, BK).reshape(b * h, n, BK)
    order = torch.tensor(_K_ORDER, device=k.device)
    vs = [F.pad(x, pad).reshape(b * h, n, BK // 8, 8, d)[:, :, :, order]
          .reshape(b * h, n, BK // 4, 4, d).permute(0, 1, 2, 4, 3)
          .reshape(b * h, n, -1) for x in planes(v)]
    return torch.cat(ks + [bias] + vs, dim=-1).contiguous()


def split_operands_reference(k, v, key_padding_mask) -> torch.Tensor:
    """The 3xTF32 pre-pass's plain version (`_tiles_reference`)."""
    return _tiles_reference(k, v, key_padding_mask, 3)


def one_pass_operands_reference(k, v, key_padding_mask) -> torch.Tensor:
    """The 1-pass pre-pass's plain version (`_tiles_reference`)."""
    return _tiles_reference(k, v, key_padding_mask, 1)


def _tiles(k: torch.Tensor, v: torch.Tensor,
           key_padding_mask: torch.Tensor | None, passes: int) -> torch.Tensor:
    """A mode's K, bias and Vᵀ tiles (`_tiles_reference`): its pre-pass
    kernel on a CUDA tensor, the plain version on a CPU one."""
    if k.device.type == "cpu":
        return _tiles_reference(k, v, key_padding_mask, passes)
    if k.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {k.device}")
    _check(k, k, v, key_padding_mask)
    b, h, t, d = k.shape
    n = -(-t // BK)
    kv = torch.empty((b * h, n, 2 * _PARTS[passes] * d * BK + BK),
                     dtype=torch.float32, device=k.device)
    if kv.numel() == 0:
        return kv
    with torch.cuda.device(k.device):
        stream = torch.cuda.current_stream(k.device).cuda_stream
        err = _PREP[passes].fn()(
            k.data_ptr(), v.data_ptr(),
            key_padding_mask.data_ptr() if key_padding_mask is not None
            else None, kv.data_ptr(), b, h, t, d, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention pre-pass (passes={passes}) "
                           f"launch failed: CUDA error {err}")
    _PREP[passes].launches += 1
    return kv


def split_operands(k, v, key_padding_mask) -> torch.Tensor:
    """The 3xTF32 kernel's split K, bias and Vᵀ tiles (`_tiles`)."""
    return _tiles(k, v, key_padding_mask, 3)


def one_pass_operands(k, v, key_padding_mask) -> torch.Tensor:
    """The 1-pass kernel's rounded K, bias and Vᵀ tiles (`_tiles`)."""
    return _tiles(k, v, key_padding_mask, 1)


def _attention_reference(q: torch.Tensor, kv: torch.Tensor, scale: float,
                         passes: int) -> torch.Tensor:
    """Plain PyTorch: a mode's plain version on the K, V and key padding
    that its pre-pass's tiles kv (`_tiles_reference`) hold for q's
    (B, H, T, D); a split tile's two planes sum to the float32 values."""
    b, h, t, d = q.shape
    n, parts = kv.shape[1], _PARTS[passes]
    plane = d * BK

    def tiles(x, layout):
        return sum(x[..., i * plane:(i + 1) * plane] for i in range(parts)
                   ).reshape(b * h, n, *layout)

    k = tiles(kv, (d // 4, BK, 4)).permute(0, 1, 3, 2, 4)
    k = k.reshape(b, h, n * BK, d)[:, :, :t]
    off = parts * plane
    masked = torch.isinf(kv[..., off:off + BK]).reshape(b, h, -1)
    inverse = torch.argsort(torch.tensor(_K_ORDER, device=kv.device))
    v = tiles(kv[..., off + BK:], (BK // 4, d, 4)).permute(0, 1, 2, 4, 3)
    v = v.reshape(b * h, n, BK // 8, 8, d)[:, :, :, inverse]
    v = v.reshape(b, h, n * BK, d)[:, :, :t]
    return flash_attention_reference(q, k.contiguous(), v.contiguous(),
                                     masked[:, 0, :t].contiguous(), scale,
                                     passes=passes)


def _attention(q: torch.Tensor, kv: torch.Tensor, scale: float,
               passes: int) -> torch.Tensor:
    """A mode's attention kernel on q (B, H, T, D) float32 and its
    pre-pass's tiles kv of k, v and the key padding (`_tiles`); on a CPU
    tensor its plain version (`_attention_reference`)."""
    if q.device.type == "cpu":
        return _attention_reference(q, kv, scale, passes)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check(q, q, q, None)
    b, h, t, d = q.shape
    if (kv.dtype != torch.float32 or kv.device != q.device
            or not kv.is_contiguous()
            or kv.shape != (b * h, -(-t // BK),
                            2 * _PARTS[passes] * d * BK + BK)):
        raise ValueError(f"flash_attention: kv is not the passes={passes} "
                         "pre-pass's tiles of q's shape on q's device")
    out = torch.empty_like(q)
    if t == 0 or b * h == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = FLASH_FWD.fn(passes)(q.data_ptr(), kv.data_ptr(),
                                   out.data_ptr(), b, h, t, d, float(scale),
                                   stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel (passes={passes}) launch"
                           f" failed: CUDA error {err}")
    FLASH_FWD.launches += 1
    FLASH_FWD.one_pass += int(passes == 1)
    return out


def split_attention(q, kv, scale) -> torch.Tensor:
    """The 3xTF32 kernel on `split_operands`' tiles (`_attention`)."""
    return _attention(q, kv, scale, 3)


def one_pass_attention(q, kv, scale) -> torch.Tensor:
    """The 1-pass kernel on `one_pass_operands`' tiles (`_attention`)."""
    return _attention(q, kv, scale, 1)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_padding_mask: torch.Tensor | None,
                    scale: float, passes: int = 3) -> torch.Tensor:
    """q, k, v: (B, H, T, D) float32; key_padding_mask: (B, T) bool or
    None; passes: 3 (3xTF32) or 1 (one TF32 pass). A CUDA tensor runs the
    mode's pre-pass, then its attention kernel."""
    if passes not in (1, 3):
        raise ValueError(f"flash_attention: passes {passes} not in (1, 3)")
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, key_padding_mask, scale,
                                         passes)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check(q, k, v, key_padding_mask)
    b, h, t, d = q.shape
    if t == 0 or b * h == 0:
        return torch.empty_like(q)
    return _attention(q, _tiles(k, v, key_padding_mask, passes), scale,
                      passes)


def _check(q, k, v, key_padding_mask) -> None:
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"flash_attention: {name} on {x.device}, "
                             f"q on {q.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"flash_attention: {name} must be float32, "
                            f"got {x.dtype}")
        if x.shape != q.shape:
            raise ValueError(f"flash_attention: {name} shape {tuple(x.shape)}"
                             f" != q shape {tuple(q.shape)}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be contiguous "
                             "and 16-byte aligned")
    if q.dim() != 4:
        raise ValueError(f"flash_attention: want (B, H, T, D), got "
                         f"{tuple(q.shape)}")
    b, h, t, d = q.shape
    if d not in D_HEADS:
        raise ValueError(f"flash_attention: head width {d} not in {D_HEADS}")
    if b * h > _MAX_GRID_Y:
        raise ValueError(f"flash_attention: B*H = {b * h} > {_MAX_GRID_Y}")
    if key_padding_mask is not None:
        m = key_padding_mask
        if (m.dtype != torch.bool or m.shape != (b, t)
                or m.device != q.device or not m.is_contiguous()):
            raise ValueError(
                "flash_attention: key_padding_mask must be a contiguous "
                f"bool (B, T) = {(b, t)} tensor on {q.device}")
