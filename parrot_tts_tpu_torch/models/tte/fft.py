"""FFT (feed-forward transformer) block — the TTE's core layer.

Port of `parrot_tts_tpu/models/tte/fft.py` (reference `modules/fft.py`):
pre-LN block of MHA and a 2-conv position-wise FFN (kernels 9/1), with
residuals. Two reference quirks are kept:

  * the positional "encoding" adds ONE table row, `pe[seqlen]`, to every
    position (reference fft.py:17-19), with per-sample row indices so
    bucket-padded batches add the row a batch-1 decode would;
  * the double projection: a bias-free qkv Linear feeds the MHA (which
    applies its own in_proj), and an extra wo Linear follows MHA's out_proj.
    `fold.py` collapses both for serving.

Padding discipline: padded positions are zeroed at every conv input and at
the block output, so outputs do not depend on the bucket size.

Tensor parallelism (`parallel/tensor.py`, forward only): given a mesh
whose model axis shards the block's weights, qkv's output features are
gathered, attention runs on this rank's heads, and the out-projection,
wo and conv2 are summed over the axis, each bias added once.

Parameter names are the reference's `state_dict` keys
(`attention.qkv.weight`, `attention.mha.in_proj_weight`, ...).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from parrot_tts_tpu_torch.core.mesh import (Mesh, gather_last, model_part,
                                            model_sum, once)
from parrot_tts_tpu_torch.ops import precision as prec
from parrot_tts_tpu_torch.ops.attention import multi_head_attention


def sinusoidal_pos_table(max_len: int, d_model: int) -> np.ndarray:
    """Reference `positionalencoding1d` (modules/fft.py:21-38)."""
    if d_model % 2:
        raise ValueError("d_model must be even for sin/cos positional encoding")
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div_term = np.exp(
        np.arange(0, d_model, 2, dtype=np.float32) * -(math.log(10000.0) / d_model)
    )
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


def add_pos_emb(x: torch.Tensor, pe: torch.Tensor, lengths: torch.Tensor,
                *, reference_compat: bool = True) -> torch.Tensor:
    """compat: per-sample `x + pe[length_b]` row broadcast (reference
    fft.py:17-19); clean: x + pe[:T]."""
    if reference_compat:
        rows = pe[lengths.clamp(0, pe.shape[0] - 1)]        # (B, D)
        return x + rows[:, None, :]
    return x + pe[None, : x.shape[1], :]


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """torch nn.LayerNorm over the last dim."""
    return F.layer_norm(x, (x.shape[-1],), weight, bias, eps)


class _MHA(nn.Module):
    """Holds nn.MultiheadAttention's bias-free weights under its names."""

    def __init__(self, d_model: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.out_proj = nn.Linear(d_model, d_model, bias=False)


class _Attention(nn.Module):
    def __init__(self, d_model: int, folded: bool):
        super().__init__()
        self.mha = _MHA(d_model)
        # serving-folded blocks (fold.py) carry no qkv / wo
        self.qkv = None if folded else nn.Linear(d_model, 3 * d_model, bias=False)
        self.wo = None if folded else nn.Linear(d_model, d_model, bias=False)


class _ConvLayer(nn.Module):
    def __init__(self, d_model: int, n_filter: int,
                 kernel_sizes: tuple[int, int]):
        super().__init__()
        self.conv1 = nn.Conv1d(d_model, n_filter, kernel_sizes[0])
        self.conv2 = nn.Conv1d(n_filter, d_model, kernel_sizes[1])


class FFTBlock(nn.Module):
    def __init__(self, d_model: int, n_head: int, n_filter: int,
                 kernel_sizes: tuple[int, int], *, folded: bool = False):
        super().__init__()
        self.n_head = n_head
        self.kernel_sizes = tuple(kernel_sizes)
        self.attention = _Attention(d_model, folded)
        self.convlayer = _ConvLayer(d_model, n_filter, kernel_sizes)
        self.attn_norm = nn.LayerNorm(d_model)
        self.conv_norm = nn.LayerNorm(d_model)

    def forward(self, x: torch.Tensor,
                key_padding_mask: torch.Tensor | None = None) -> torch.Tensor:
        return apply_fft_block(self, x, key_padding_mask=key_padding_mask)


def _gather_packed(y: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """A column-parallel packed [q; k; v] output gathered from the model
    axis's shards (each rank's [q_r; k_r; v_r]) into [q; k; v] order."""
    full = gather_last(y, mesh)
    if full is y:
        return y
    *lead, w = full.shape
    return (full.reshape(*lead, mesh.n_model, 3, w // (3 * mesh.n_model))
            .transpose(-3, -2).reshape(*lead, w))


def apply_fft_block(block: FFTBlock, x: torch.Tensor, *,
                    key_padding_mask: torch.Tensor | None = None,
                    dropout_p: float = 0.0, seed: int | None = None,
                    row0: int = 0,
                    precision: str | None = None,
                    mesh: Mesh | None = None) -> torch.Tensor:
    """One FFT block on x (B, T, D); key_padding_mask (B, T) True = IGNORE.
    seed: the attention's dropout stream (training, with `dropout_p` on
    the attention weights); None for the deterministic forward. row0: the
    global batch row of x's first (`multi_head_attention`).
    precision: the products of every linear and conv and row 1's mode
    (`ops/precision.py`, `ops/attention.py`); None: the ambient torch
    flags. LayerNorm, masks and residuals stay float32. mesh: a model
    axis the block's weights are sharded over (module docstring)."""
    valid = None
    if key_padding_mask is not None:
        valid = (~key_padding_mask)[:, :, None].to(x.dtype)

    a = block.attention
    h = layer_norm(x, block.attn_norm.weight, block.attn_norm.bias)
    if a.qkv is not None:
        q, k, v = _gather_packed(prec.linear(h, a.qkv.weight, mode=precision),
                                 mesh).chunk(3, dim=-1)
        y = multi_head_attention(q, k, v, a.mha.in_proj_weight,
                                 a.mha.out_proj.weight, block.n_head,
                                 key_padding_mask=key_padding_mask,
                                 dropout_p=dropout_p, seed=seed, row0=row0,
                                 precision=precision, mesh=mesh)
        y = model_sum(prec.linear(model_part(y, mesh), a.wo.weight,
                                  mode=precision), mesh)
    else:
        y = multi_head_attention(h, h, h, a.mha.in_proj_weight,
                                 a.mha.out_proj.weight, block.n_head,
                                 key_padding_mask=key_padding_mask,
                                 dropout_p=dropout_p, seed=seed, row0=row0,
                                 precision=precision, mesh=mesh)
    h = x + y

    c = layer_norm(h, block.conv_norm.weight, block.conv_norm.bias)
    if valid is not None:
        c = c * valid
    ks1, ks2 = block.kernel_sizes
    cl = block.convlayer
    c = prec.conv1d(c, cl.conv1.weight, cl.conv1.bias, precision,
                    padding=(ks1 - 1) // 2)
    c = torch.relu(c)
    if valid is not None:
        c = c * valid
    c = model_sum(prec.conv1d(c, cl.conv2.weight, once(cl.conv2.bias, mesh),
                              precision, padding=(ks2 - 1) // 2), mesh)
    out = h + c
    if valid is not None:
        out = out * valid
    return out
