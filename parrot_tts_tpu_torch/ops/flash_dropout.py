"""Flash attention with attention-weight dropout: the CUDA kernels' wrappers,
their plain versions, and the autograd function that trains with them.

Port of `parrot_tts_tpu/ops/flash_dropout.py`. Per (batch, head) row, with
M the keep mask, p the dropout probability and c = 1/(1-p):

    S  = scale * Q K^T + bias        bias = 0 / NEG_BIAS per key
    P  = softmax(S)                  denominator over the UNdropped P
    O  = (M . P * c) V               lse = rowmax(S) + log(rowsum(exp(S - max)))
    backward, D = rowsum(dO . O):
    dPd = M . (dO V^T) * c           dS = P . (dPd - D)
    dQ = scale dS K    dK = scale dS^T Q    dV = (M . P * c)^T dO

The dQ step computes D along with dQ and returns it; the dK/dV step reads
it, so D is reduced once per backward. Under dropout the dQ kernel also
returns the keep mask as bits (`pack_keep_bits` is their oracle), which the
dK/dV kernel requires: on the card the mask is drawn once per backward and
never silently redrawn. The plain versions draw it from the seed.

Every operand of the five products is rounded to bf16 and each product is
summed in float32, as the JAX package's `_dot` does. Products of bf16
values are exact in float32 and in TF32, so the plain versions give the
same products with TF32 on or off.

The keep mask is the port's own: the TPU's `prng_random_bits` cannot be
reproduced off the TPU. Element (bh, i, j) of a call with 64-bit `seed`
reads word j mod 4 of Philox4x32-10 with key (seed lo, seed hi) at counter
(j // 4, i, bh + bh_offset, 0), and is dropped iff that word <
`threshold(p)`. So the mask is a function of (seed, global bh, i, j)
alone: the forward, dQ and dK/dV kernels regenerate it under any tiling,
and so does `keep_mask_reference` in torch integer ops on any device.
`bh_offset` is a data-parallel shard's first global row times H, so the
shards of a batch draw the rows of the whole batch's mask, not one mask
each.

On the card the autograd function casts Q, K and V to bf16 once in the
forward (`to_bf16`, round to nearest even, as the kernels round), hands
them to the forward kernel and saves them in place of the float32 tensors;
the backward casts dO alone and hands both backward wrappers the four
operands. The kernels require them: they take them by TMA into shared
memory and multiply with wgmma (csrc/flash_dropout.cu says how), and each
wrapper checks only what its kernel reads. The plain versions round their
own, and on the CPU the autograd function saves the float32 tensors.

A CPU tensor takes the plain versions; a CUDA tensor launches
`csrc/flash_dropout.cu` (rows 2-5 of PERF.md's kernel table) or raises.
Nothing falls back. `FWD`, `DQ`, `DKV` and `KEEP_MASK` count launches.
"""

from __future__ import annotations

import ctypes

import torch

from parrot_tts_tpu_torch.core import kernels

NEG_BIAS = -1e30
D_HEADS = (64, 128)        # head widths the kernels are instantiated for
_MAX_GRID_Y = 65535
_SEED_MASK = (1 << 64) - 1

_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_U32 = 0xFFFFFFFF


def threshold(dropout_p: float) -> int:
    """uint32 threshold: words < threshold are DROPPED (JAX `_threshold`)."""
    return min(int(round(dropout_p * 2.0**32)), 2**32 - 1)


def _keep_scale(dropout_p: float) -> float:
    return 1.0 / (1.0 - dropout_p) if dropout_p > 0.0 else 1.0


# ---------------------------------------------------------------------------
# Philox4x32-10 in torch integer ops (int64 holding uint32 values)
# ---------------------------------------------------------------------------


def _mulhilo(m: int, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of m * x for a uint32 constant m and uint32
    values x in int64. The 64-bit product would overflow int64 and lose the
    high word, so x is split into 16-bit limbs."""
    t_lo = x.bitwise_and(0xFFFF) * m             # < 2^48
    t_hi = x.bitwise_right_shift(16) * m         # < 2^48
    hi = (t_hi + t_lo.bitwise_right_shift(16)).bitwise_right_shift(16)
    lo = (t_hi.bitwise_and(0xFFFF).bitwise_left_shift(16) + t_lo).bitwise_and(
        _U32)
    return hi, lo


def philox4x32(seed: int, c0, c1, c2, c3) -> list[torch.Tensor]:
    """The four output words of Philox4x32-10 at counters (c0, c1, c2, c3)
    (broadcastable int64 tensors of uint32 values) with key (seed lo,
    seed hi)."""
    seed &= _SEED_MASK
    k0, k1 = seed & _U32, seed >> 32
    device = next((x.device for x in (c0, c1, c2, c3)
                   if isinstance(x, torch.Tensor)), None)
    c = torch.broadcast_tensors(*(torch.as_tensor(x, dtype=torch.int64,
                                                  device=device)
                                  for x in (c0, c1, c2, c3)))
    c0, c1, c2, c3 = c
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = (hi1.bitwise_xor(c1).bitwise_xor(k0), lo1,
                          hi0.bitwise_xor(c3).bitwise_xor(k1), lo0)
        k0, k1 = (k0 + _PHILOX_W[0]) & _U32, (k1 + _PHILOX_W[1]) & _U32
    return [c0, c1, c2, c3]


def keep_mask_reference(b: int, h: int, t: int, seed: int, dropout_p: float,
                        device=None, bh_offset: int = 0) -> torch.Tensor:
    """The (B, H, T, T) int32 keep mask (1 = keep) that the kernels
    regenerate; JAX `dump_keep_mask` with the port's generator. Computed one
    counter per 4 keys, so each Philox block is drawn once."""
    bh = torch.arange(bh_offset, bh_offset + b * h,
                      device=device)[:, None, None]
    i = torch.arange(t, device=device)[None, :, None]
    j4 = torch.arange(-(-t // 4), device=device)[None, None, :]
    words = philox4x32(seed, j4, i, bh, 0)
    keep = torch.stack(words, dim=-1) >= threshold(dropout_p)
    keep = keep.reshape(b * h, t, -1)[:, :, :t]
    return keep.to(torch.int32).reshape(b, h, t, t)


def pack_keep_bits(keep: torch.Tensor) -> torch.Tensor:
    """A (B, H, T, T) keep mask (nonzero = keep) as (B*H, T, ceil(T/32))
    words: bit j % 32 of word j // 32 of row (bh, i) is element (bh, i, j),
    bits past T are 0. The words are uint32 bit patterns held in int32 (the
    dQ kernel's output, of which this is the oracle)."""
    b, h, t, _ = keep.shape
    w = -(-t // 32)
    x = torch.zeros((b * h, t, 32 * w), dtype=torch.int64, device=keep.device)
    x[..., :t] = keep.reshape(b * h, t, t).ne(0)
    x = x.reshape(b * h, t, w, 32).bitwise_left_shift(
        torch.arange(32, device=keep.device)).sum(dim=-1)
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


# ---------------------------------------------------------------------------
# plain versions (float32 sums of bf16 operands)
# ---------------------------------------------------------------------------


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _scores(q, k, bias, scale):
    s = torch.matmul(_bf16(q), _bf16(k).transpose(-1, -2)) * scale
    return s + bias[:, None, None, :]


def _dropped(x: torch.Tensor, seed: int, dropout_p: float,
             bh_offset: int = 0) -> torch.Tensor:
    """where(keep, x, 0) * c, the JAX kernels' order of operations."""
    if dropout_p == 0.0:
        return x
    b, h, t, _ = x.shape
    keep = keep_mask_reference(b, h, t, seed, dropout_p, x.device,
                               bh_offset).bool()
    return torch.where(keep, x, 0.0) * _keep_scale(dropout_p)


def flash_attention_dropout_reference(q, k, v, bias, seed: int,
                                      dropout_p: float, scale: float,
                                      bh_offset: int = 0):
    """Plain forward: (O, lse (B, H, T)). The JAX kernel's math, with P
    taken against the final row max."""
    s = _scores(q, k, bias, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(_bf16(_dropped(p, seed, dropout_p, bh_offset)),
                     _bf16(v)) / l
    return o, (m + torch.log(l))[..., 0]


def _backward_common(q, k, v, bias, seed, delta, lse, do, dropout_p, scale,
                     bh_offset):
    p = torch.exp(_scores(q, k, bias, scale) - lse[..., None])
    dpd = _dropped(torch.matmul(_bf16(do), _bf16(v).transpose(-1, -2)), seed,
                   dropout_p, bh_offset)
    return p, p * (dpd - delta[..., None])


def flash_dropout_dq_reference(q, k, v, bias, seed: int, o, lse, do,
                               dropout_p: float, scale: float,
                               bh_offset: int = 0):
    """Plain (dQ, D = rowsum(dO . O) (B, H, T)) (JAX `_dq_kernel`,
    `flash_dropout.py:173-204`)."""
    delta = (do * o).sum(dim=-1)
    _, ds = _backward_common(q, k, v, bias, seed, delta, lse, do, dropout_p,
                             scale, bh_offset)
    return torch.matmul(_bf16(ds), _bf16(k)) * scale, delta


def flash_dropout_dkv_reference(q, k, v, bias, seed: int, delta, lse, do,
                                dropout_p: float, scale: float,
                                bh_offset: int = 0):
    """Plain (dK, dV) (JAX `_dkv_kernel`, `flash_dropout.py:207-246`), with
    D = rowsum(dO . O) as the dQ version returns it."""
    p, ds = _backward_common(q, k, v, bias, seed, delta, lse, do, dropout_p,
                             scale, bh_offset)
    pd = _dropped(p, seed, dropout_p, bh_offset)
    dv = torch.matmul(_bf16(pd).transpose(-1, -2), _bf16(do))
    dk = torch.matmul(_bf16(ds).transpose(-1, -2), _bf16(q)) * scale
    return dk, dv


# ---------------------------------------------------------------------------
# the kernels (csrc/flash_dropout.cu)
# ---------------------------------------------------------------------------

_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
# threshold, keep scale, seed lo, seed hi, bh offset
_SEED_ARGS = [_U, _F, _U, _U, _U]


class _Kernel:
    """One entry point of the flash_dropout library and its launch count."""

    def __init__(self, symbol: str, argtypes: list):
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(kernels.load("flash_dropout"), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            raise RuntimeError(f"{self.symbol} launch failed: CUDA error {err}")
        self.launches += 1


# q, k, v, bias, o, lse; B, H, T, D; scale; seed args; stream
FWD = _Kernel("flash_dropout_fwd", [_P] * 6 + [_I] * 4 + [_F] + _SEED_ARGS
              + [_P])
# bf16 q, k, v, do; bias, do, o, lse, delta (out), dq (out), bits (out);
# B, H, T, D; scale; seed args; stream
DQ = _Kernel("flash_dropout_dq", [_P] * 11 + [_I] * 4 + [_F] + _SEED_ARGS
             + [_P])
# bf16 q, k, v, do; bias, lse, delta, bits, dk (out), dv (out); B, H, T, D;
# scale; seed args; stream
DKV = _Kernel("flash_dropout_dkv", [_P] * 10 + [_I] * 4 + [_F] + _SEED_ARGS
              + [_P])
# out; BH, T; threshold; seed lo, hi; bh offset; stream
KEEP_MASK = _Kernel("flash_dropout_keep_mask",
                    [_P, _I, _I, _U, _U, _U, _U, _P])


def _seed_args(seed: int, dropout_p: float, bh_offset: int) -> tuple:
    seed &= _SEED_MASK
    if not 0 <= bh_offset < 2**32:
        raise ValueError(f"flash_dropout: bh_offset {bh_offset} out of range")
    return (threshold(dropout_p), _keep_scale(dropout_p), seed & _U32,
            seed >> 32, bh_offset)


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _on_card(name: str, x: torch.Tensor) -> bool:
    """False for a CPU tensor (plain version), True for a CUDA tensor."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    return True


def _check(q, k, v, bias, dropout_p, *more) -> None:
    """What every kernel reads: q, k and v of one type (float32, or the
    bf16 operands of `to_bf16`) and each (name, tensor) of `more` float32,
    all shaped like q, on its device and contiguous; the (B, T) float32
    bias; d_head, B*H and p in range."""
    if q.dim() != 4:
        raise ValueError(f"flash_dropout: want (B, H, T, D), got "
                         f"{tuple(q.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v)) + more:
        if x.device != q.device:
            raise ValueError(f"flash_dropout: {name} on {x.device}, q on "
                             f"{q.device}")
        want = q.dtype if name in ("q", "k", "v") else torch.float32
        if x.dtype != want or want not in (torch.float32, torch.bfloat16):
            raise TypeError(f"flash_dropout: {name} must be {want}, got "
                            f"{x.dtype}")
        if x.shape != q.shape:
            raise ValueError(f"flash_dropout: {name} shape {tuple(x.shape)} "
                             f"!= q shape {tuple(q.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"flash_dropout: {name} must be contiguous")
    b, h, t, d = q.shape
    if d not in D_HEADS:
        raise ValueError(f"flash_dropout: head width {d} not in {D_HEADS}")
    if b * h > _MAX_GRID_Y:
        raise ValueError(f"flash_dropout: B*H = {b * h} > {_MAX_GRID_Y}")
    if (bias.dtype != torch.float32 or bias.shape != (b, t)
            or bias.device != q.device or not bias.is_contiguous()):
        raise ValueError("flash_dropout: bias must be a contiguous float32 "
                         f"(B, T) = {(b, t)} tensor on {q.device}")
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"flash_dropout: dropout_p {dropout_p} not in [0, 1)")


def flash_dropout_fwd(q, k, v, bias, seed: int, dropout_p: float,
                      scale: float, *, operands=None, bh_offset: int = 0):
    """(O, lse), both float32. On CUDA tensors row 2, which reads
    `operands` (q, k, v as `to_bf16` rounds them; required there) and
    not the float32 q, k, v. On CPU tensors the plain forward, which does
    not read `operands`. bh_offset: the global index of this call's first
    (batch, head) row in the keep mask (module docstring)."""
    if not _on_card("flash_dropout_fwd", q):
        return flash_attention_dropout_reference(q, k, v, bias, seed,
                                                 dropout_p, scale, bh_offset)
    ops = _check_operands(operands, q, ("q", "k", "v"))
    _check(*ops, bias, dropout_p)
    b, h, t, d = q.shape
    o = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    if t == 0 or b * h == 0:
        return o, lse
    with torch.cuda.device(q.device):
        FWD(*(x.data_ptr() for x in ops), bias.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, h, t, d, scale,
            *_seed_args(seed, dropout_p, bh_offset), _stream(q))
    return o, lse


def _check_bwd(ops, bias, dropout_p, do, rows: dict, *more) -> None:
    """Checks what a backward kernel reads: the bf16 operands (checked by
    `_check_operands`), float32 dO and `more`, the bias and `rows`, its
    (B, H, T) float32 tensors."""
    q = ops[0]
    _check(*ops[:3], bias, dropout_p, ("do", do), *more)
    b, h, t, _ = q.shape
    for name, x in rows.items():
        if (x.dtype != torch.float32 or x.shape != (b, h, t)
                or x.device != q.device or not x.is_contiguous()):
            raise ValueError(f"flash_dropout: {name} must be a contiguous "
                             f"float32 (B, H, T) = {(b, h, t)} tensor on "
                             f"{q.device}")


def to_bf16(*xs: torch.Tensor) -> tuple:
    """The kernels' product operands rounded to bf16 (to nearest even, as
    the kernels round): q, k, v once per forward, which the backward
    reuses, and do once per backward."""
    return tuple(x.to(torch.bfloat16) for x in xs)


def _check_bits(bits, q, dropout_p) -> None:
    """The dK/dV kernel under dropout reads the dQ kernel's bits: present,
    int32 (B*H, T, ceil(T/32)), contiguous, beside q."""
    if not threshold(dropout_p):
        return
    if bits is None:
        raise ValueError("flash_dropout_dkv: dropout_p > 0 needs the keep "
                         "bits that flash_dropout_dq returned")
    b, h, t, _ = q.shape
    want = (b * h, t, -(-t // 32))
    if (bits.dtype != torch.int32 or tuple(bits.shape) != want
            or bits.device != q.device or not bits.is_contiguous()):
        raise ValueError(f"flash_dropout_dkv: bits must be a contiguous int32 "
                         f"{want} tensor on {q.device}, got {bits.dtype} "
                         f"{tuple(bits.shape)} on {bits.device}")


def _check_operands(ops, q, names=("q", "k", "v", "do")) -> tuple:
    """A kernel's bf16 operands (the backward's q, k, v, do; the
    forward's q, k, v), as `to_bf16` makes them: present, each shaped like
    q and on its device, contiguous, 16-byte aligned (TMA reads them)."""
    if ops is None or len(ops) != len(names):
        raise ValueError(f"flash_dropout: the kernel wants {', '.join(names)}"
                         f" as {len(names)} bf16 operands (to_bf16)")
    for name, x in zip(names, ops):
        if (x.dtype != torch.bfloat16 or x.shape != q.shape
                or x.device != q.device or not x.is_contiguous()
                or x.data_ptr() % 16):
            raise ValueError(f"flash_dropout: bf16 operand {name} must be a "
                             f"contiguous 16-byte aligned bf16 "
                             f"{tuple(q.shape)} tensor on {q.device}")
    return tuple(ops)


def flash_dropout_dq(q, k, v, bias, seed: int, o, lse, do,
                     dropout_p: float, scale: float, *, operands,
                     bh_offset: int = 0):
    """(dQ, D = rowsum(dO . O) (B, H, T), keep bits or None). On CUDA
    tensors row 3, which reads `operands` (q, k, v, do as `to_bf16` rounds
    them; required) and not q, k, v themselves (which may be those bf16
    copies), and computes D and, under dropout, the keep bits
    (`pack_keep_bits`' layout) with dQ for `flash_dropout_dkv`. On CPU
    tensors the plain formulas, with no bits: the plain dK/dV draws the
    mask from the seed, and `operands` is not read. bh_offset: as
    `flash_dropout_fwd`'s."""
    if not _on_card("flash_dropout_dq", q):
        return (*flash_dropout_dq_reference(q, k, v, bias, seed, o, lse, do,
                                            dropout_p, scale, bh_offset),
                None)
    ops = _check_operands(operands, q)
    _check_bwd(ops, bias, dropout_p, do, {"lse": lse}, ("o", o))
    b, h, t, d = q.shape
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    bits = (torch.empty((b * h, t, -(-t // 32)), dtype=torch.int32,
                        device=q.device) if threshold(dropout_p) else None)
    if t and b * h:
        with torch.cuda.device(q.device):
            DQ(*(x.data_ptr() for x in ops), bias.data_ptr(), do.data_ptr(),
               o.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
               None if bits is None else bits.data_ptr(), b, h, t, d, scale,
               *_seed_args(seed, dropout_p, bh_offset), _stream(q))
    return dq, delta, bits


def flash_dropout_dkv(q, k, v, bias, seed: int, delta, lse, do,
                      dropout_p: float, scale: float, *, bits, operands,
                      bh_offset: int = 0):
    """(dK, dV) from D = rowsum(dO . O), the keep bits and the bf16
    operands, each as `flash_dropout_dq` returns or reads them. On CUDA
    tensors row 4, which reads no float32 q, k, v; under dropout a missing
    bits tensor raises (the mask is not drawn again). On CPU tensors the
    plain formulas, which draw the mask from the seed and read neither
    `bits` nor `operands`. bh_offset: as `flash_dropout_fwd`'s."""
    if not _on_card("flash_dropout_dkv", q):
        return flash_dropout_dkv_reference(q, k, v, bias, seed, delta, lse,
                                           do, dropout_p, scale, bh_offset)
    _check_bits(bits, q, dropout_p)
    ops = _check_operands(operands, q)
    _check_bwd(ops, bias, dropout_p, do, {"lse": lse, "delta": delta})
    b, h, t, d = q.shape
    dk, dv = (torch.empty(q.shape, dtype=torch.float32, device=q.device)
              for _ in range(2))
    if t and b * h:
        with torch.cuda.device(q.device):
            DKV(*(x.data_ptr() for x in ops), bias.data_ptr(),
                lse.data_ptr(), delta.data_ptr(),
                bits.data_ptr() if threshold(dropout_p) else None,
                dk.data_ptr(), dv.data_ptr(), b, h, t, d, scale,
                *_seed_args(seed, dropout_p, bh_offset), _stream(q))
    return dk, dv


def keep_mask(b: int, h: int, t: int, seed: int, dropout_p: float,
              device, bh_offset: int = 0) -> torch.Tensor:
    """The (B, H, T, T) int32 keep mask: row 5 on a CUDA device, the plain
    version on the CPU. The test oracle of rows 2-4; training never calls
    it."""
    device = torch.device(device)
    if device.type == "cpu":
        return keep_mask_reference(b, h, t, seed, dropout_p, device,
                                   bh_offset)
    if device.type != "cuda":
        raise ValueError(f"keep_mask: unsupported device {device}")
    if b * h > _MAX_GRID_Y:
        raise ValueError(f"keep_mask: B*H = {b * h} > {_MAX_GRID_Y}")
    out = torch.empty((b, h, t, t), dtype=torch.int32, device=device)
    if out.numel():
        thr, _, lo, hi, off = _seed_args(seed, dropout_p, bh_offset)
        with torch.cuda.device(device):
            KEEP_MASK(out.data_ptr(), b * h, t, thr, lo, hi, off,
                      _stream(out))
    return out


class _FlashDropout(torch.autograd.Function):
    """JAX `custom_vjp` of `flash_attention_dropout` (`:330-359`): saves q,
    k, v (on the card their bf16 copies, which every kernel reads), bias, o
    and lse (and the seed and bh offset); bias and seed get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, seed, dropout_p, scale, bh_offset):
        ops = to_bf16(q, k, v) if _on_card("flash_dropout", q) else None
        o, lse = flash_dropout_fwd(q, k, v, bias, seed, dropout_p, scale,
                                   operands=ops, bh_offset=bh_offset)
        ctx.save_for_backward(*(ops or (q, k, v)), bias, o, lse)
        ctx.seed, ctx.dropout_p, ctx.scale = seed, dropout_p, scale
        ctx.bh_offset = bh_offset
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, o, lse = ctx.saved_tensors
        do = do.contiguous()
        # on the card both kernels read the forward's copies and one of dO
        ops = ((q, k, v, *to_bf16(do)) if _on_card("flash_dropout", q)
               else None)
        common = (q, k, v, bias, ctx.seed)
        rest = (lse, do, ctx.dropout_p, ctx.scale)
        dq, delta, bits = flash_dropout_dq(*common, o, *rest, operands=ops,
                                           bh_offset=ctx.bh_offset)
        dk, dv = flash_dropout_dkv(*common, delta, *rest, bits=bits,
                                   operands=ops, bh_offset=ctx.bh_offset)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_dropout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            bias: torch.Tensor, seed: int, dropout_p: float,
                            scale: float, bh_offset: int = 0) -> torch.Tensor:
    """Flash attention with attention-weight dropout, differentiable in q, k
    and v. q, k, v: (B, H, T, dh) float32 contiguous; bias: (B, T) float32
    (0 valid / NEG_BIAS masked); seed: this call's 64-bit dropout stream;
    bh_offset: the global (batch, head) row of q's first, for a
    data-parallel shard (module docstring)."""
    return _FlashDropout.apply(q, k, v, bias, seed, dropout_p, scale,
                               bh_offset)


def padding_bias(key_padding_mask: torch.Tensor | None, b: int, t: int,
                 device) -> torch.Tensor:
    """(B, T) float32 additive key bias from a True = IGNORE mask."""
    if key_padding_mask is None:
        return torch.zeros((b, t), dtype=torch.float32, device=device)
    return torch.where(key_padding_mask, NEG_BIAS, 0.0).to(torch.float32)

