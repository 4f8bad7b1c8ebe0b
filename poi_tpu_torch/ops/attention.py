"""Windowed causal multi-head attention over check-in hidden states,
counterpart of ``poi_tpu/ops/attention.py`` (plain torch: the TPU package
has no Pallas kernel here).

``poi_tpu`` has three equal forms of the local attention (``vanilla``,
``blockwise``, ``banded``); the port has one, the masked-scores form:
fp32 scores of the ``dtype``-rounded q and k, an fp32 softmax, p rounded to
v's dtype before ``p · v``, fp32 sums. At config #4's T = 128 the [T, T]
scores of a batch take 16 MB.
"""

from __future__ import annotations

import torch

from poi_tpu_torch.models.base import matmul_fp32

NEG_INF = -1e30


def window_mask(T: int, window: int, device=None) -> torch.Tensor:
    """[T, T] bool: query i attends key j iff j <= i and i - j < window."""
    qi = torch.arange(T, device=device)[:, None]
    kj = torch.arange(T, device=device)[None, :]
    return (kj <= qi) & (qi - kj < window)


def windowed_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int) -> torch.Tensor:
    """q, k, v [B, H, T, Dh] → [B, H, T, Dh] fp32."""
    T = q.shape[2]
    scale = q.shape[-1] ** -0.5
    s = matmul_fp32(q, k.transpose(-1, -2), q.dtype) * scale
    s = torch.where(window_mask(T, window, device=q.device), s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return matmul_fp32(p, v, v.dtype)


def _heads(y: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, T, D] → [B, heads, T, D / heads]."""
    B, T, D = y.shape
    return y.reshape(B, T, num_heads, D // num_heads).transpose(1, 2)


def multihead_attention(x: torch.Tensor, p, num_heads: int, window: int,
                        dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """[B, T, D] → [B, T, D] fp32 windowed causal MHA with projections
    ``p["wq"]``, ``p["wk"]``, ``p["wv"]``, ``p["wo"]``, each [D, D]."""
    B, T, D = x.shape
    q, k, v = (_heads(matmul_fp32(x, p[w], dtype), num_heads).to(dtype) for w in ("wq", "wk", "wv"))
    o = windowed_attention(q, k, v, window).transpose(1, 2).reshape(B, T, D)
    return matmul_fp32(o, p["wo"], dtype)


def multihead_attention_last(x: torch.Tensor, p, num_heads: int, window: int, last: torch.Tensor,
                             dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Windowed causal MHA at one query position per row: [B, T, D] and
    ``last [B]`` → [B, D], equal to ``multihead_attention(x, …)[arange(B),
    last]``. Only the window ending at ``last`` is projected (the eval and
    serving path)."""
    B, T, D = x.shape
    Dh = D // num_heads
    idx = last[:, None] - window + 1 + torch.arange(window, device=x.device)[None, :]  # [B, W]
    valid = idx >= 0
    rows = torch.arange(B, device=x.device)
    xw = x[rows[:, None], idx.clamp(0, T - 1)]  # [B, W, D]
    xq = x[rows, last][:, None, :]  # [B, 1, D]
    q = _heads(matmul_fp32(xq, p["wq"], dtype), num_heads).to(dtype)  # [B, H, 1, Dh]
    k = _heads(matmul_fp32(xw, p["wk"], dtype), num_heads).to(dtype)
    v = _heads(matmul_fp32(xw, p["wv"], dtype), num_heads).to(dtype)
    s = matmul_fp32(q, k.transpose(-1, -2), dtype) * Dh ** -0.5
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    o = matmul_fp32(torch.softmax(s, dim=-1), v, v.dtype)  # [B, H, 1, Dh]
    return matmul_fp32(o.transpose(1, 2).reshape(B, D), p["wo"], dtype)
