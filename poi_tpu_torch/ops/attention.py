"""Windowed causal multi-head attention over check-in hidden states,
counterpart of ``poi_tpu/ops/attention.py`` (plain torch: the TPU package
has no Pallas kernel here).

The reference's three local forms, under its names and with its rounding
points (q, k and v in the compute dtype, fp32 scores and sums):

- ``vanilla``: the whole [T, T] masked scores and an fp32 softmax, whose
  normalised p is rounded to v's dtype before ``p · v``;
- ``blockwise``: an online softmax over KV blocks of ``block_size``, whose
  unnormalised ``exp(s - m)`` is rounded to v's dtype before ``p · v`` and
  divided by the row's sum at the end. The reference scores every query
  against every block; here each query block meets only the KV blocks that
  can reach its window, in the reference's order. A block outside a row's
  window is an exact no-op in the online update (after the row's first
  valid block it gives ``alpha = 1`` and ``p = 0``; before it, what it
  added is wiped by ``alpha = exp(-1e30 - m) = 0``), so the values are the
  reference's, at O(T · (W + block)) memory and work instead of O(T²)
  (``blockwise_attention_reference`` is the reference's loop, its plain
  version);
- ``banded``: query blocks of W rows scored against their own block and the
  one before (a [W, 2W] band), the vanilla form's values.

``multihead_attention`` dispatches as the reference does and runs the form
between the projections (``project_attend``). The sequence-parallel forms
(ring, Ulysses) live in ``parallel/sp_attention.py`` and share
``_online_block_update`` and ``blockwise_attention``.
"""

from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F

from poi_tpu_torch.models.base import matmul_fp32

NEG_INF = -1e30


def window_mask(t_q: int, t_kv: int, window: int, q_offset: int = 0, kv_offset: int = 0,
                device=None) -> torch.Tensor:
    """[t_q, t_kv] bool: query i attends key j iff j <= i and i - j <
    window, at the global positions ``q_offset + i`` and ``kv_offset + j``."""
    qi = q_offset + torch.arange(t_q, device=device)[:, None]
    kj = kv_offset + torch.arange(t_kv, device=device)[None, :]
    return (kj <= qi) & (qi - kj < window)


def vanilla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int) -> torch.Tensor:
    """q, k, v [B, H, T, Dh] → [B, H, T, Dh] fp32."""
    T = q.shape[2]
    scale = q.shape[-1] ** -0.5
    s = matmul_fp32(q, k.transpose(-1, -2), q.dtype) * scale
    s = torch.where(window_mask(T, T, window, device=q.device), s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return matmul_fp32(p, v, v.dtype)


def _online_block_update(carry, qk_inputs):
    """One online-softmax step (shared with ring attention): ``carry`` (m
    [.., Tq, 1], l [.., Tq, 1], acc [.., Tq, Dh]) fp32, ``qk_inputs`` (s
    [.., Tq, Tkv] raw masked fp32 scores, v [.., Tkv, Dh])."""
    m, l, acc = carry
    s, v = qk_inputs
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    # Renormalise the accumulator, then fold in this block.
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new)
    l_new = l * alpha + p.sum(dim=-1, keepdim=True)
    acc_new = acc * alpha + matmul_fp32(p, v, v.dtype)
    return m_new, l_new, acc_new


def _blocks(x: torch.Tensor, n: int, bs: int, before: int = 0, after: int = 0) -> torch.Tensor:
    """[B, H, L, Dh] → [B, H, before + n + after, bs, Dh]: zero blocks
    before, the L rows padded with zeros to n whole blocks, zero blocks
    after."""
    B, H, L, Dh = x.shape
    x = F.pad(x, (0, 0, before * bs, (n + after) * bs - L))
    return x.reshape(B, H, before + n + after, bs, Dh)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int, block_size: int = 128,
                        kv_offset: int = 0) -> torch.Tensor:
    """q [B, H, T, Dh], k and v [B, H, Tk, Dh] → [B, H, T, Dh] fp32, the
    reference's online softmax over KV blocks of ``block_size``.
    ``kv_offset`` is the global position of k[..., 0, :] against q's.

    The queries go in blocks of ``block_size`` too, all at once: query
    block i meets KV block i + d for each offset d that can reach its
    window, oldest first (KV blocks outside [0, ceil(Tk / block)) are zero
    padding, fully masked). Each row thus sees its valid blocks in the
    reference's order, and each block it skips is an exact no-op there."""
    B, H, T, Dh = q.shape
    Tk = k.shape[2]
    bs = block_size
    scale = Dh ** -0.5
    nq, nk = -(-T // bs), -(-Tk // bs)
    # Rows [i·bs, i·bs + bs) reach keys [i·bs - W + 1, i·bs + bs - 1] -
    # kv_offset: KV blocks i + d_lo .. i + d_hi, clipped to the blocks any
    # query block meets.
    d_lo = max((1 - window - kv_offset) // bs, 1 - nq)
    d_hi = min((bs - 1 - kv_offset) // bs, nk - 1)
    before, after = max(0, -d_lo), max(0, nq + d_hi - nk)
    hq = min(bs, T)  # query rows a block: all T where one block holds them, as the reference scores them
    qb = _blocks(q, nq, hq)
    kb, vb = _blocks(k, nk, bs, before, after), _blocks(v, nk, bs, before, after)
    dev = q.device
    row = torch.arange(bs, device=dev)
    blk = torch.arange(nq, device=dev)
    qi = (blk[:, None] * bs + row[:hq])[:, :, None]  # [nq, hq, 1]
    m = torch.full((B, H, nq, hq, 1), NEG_INF, device=dev)
    l = torch.zeros((B, H, nq, hq, 1), device=dev)
    acc = torch.zeros((B, H, nq, hq, Dh), device=dev)
    for d in range(d_lo, d_hi + 1):
        jj = ((blk + d)[:, None] * bs + row)[:, None, :]  # [nq, 1, bs] key index in k
        kj = kv_offset + jj
        mask = (kj <= qi) & (qi - kj < window) & (jj >= 0) & (jj < Tk)
        sl = slice(before + d, before + d + nq)
        s = matmul_fp32(qb, kb[:, :, sl].transpose(-1, -2), q.dtype) * scale
        s = torch.where(mask, s, NEG_INF)
        m, l, acc = _online_block_update((m, l, acc), (s, vb[:, :, sl]))
    o = acc / l.clamp_min(1e-30)
    return o.reshape(B, H, nq * hq, Dh)[:, :, :T]


def blockwise_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int,
                                  block_size: int = 128, kv_offset: int = 0) -> torch.Tensor:
    """Plain version of ``blockwise_attention``: the reference's form as it
    runs, every query scored against every KV block in order, masked,
    through the online update, at O(T · Tk) memory and work."""
    B, H, T, Dh = q.shape
    Tk = k.shape[2]
    nb = -(-Tk // block_size)
    k, v = (F.pad(t, (0, 0, 0, nb * block_size - Tk)) for t in (k, v))
    dev = q.device
    qi = torch.arange(T, device=dev)[:, None]
    carry = (torch.full((B, H, T, 1), NEG_INF, device=dev), torch.zeros(B, H, T, 1, device=dev),
             torch.zeros(B, H, T, Dh, device=dev))
    for b in range(nb):
        blk = slice(b * block_size, (b + 1) * block_size)
        s = matmul_fp32(q, k[:, :, blk].transpose(-1, -2), q.dtype) * Dh ** -0.5
        kj = kv_offset + b * block_size + torch.arange(block_size, device=dev)[None, :]
        s = torch.where((kj <= qi) & (qi - kj < window) & (kj < kv_offset + Tk), s, NEG_INF)
        carry = _online_block_update(carry, (s, v[:, :, blk]))
    _, l, acc = carry
    return acc / l.clamp_min(1e-30)


def banded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int) -> torch.Tensor:
    """q, k, v [B, H, T, Dh] → [B, H, T, Dh] fp32, the vanilla form's
    values on the band that can be unmasked: query block m of W rows attends
    key blocks m - 1 and m (zeros before block 0), a [W, 2W] score tile a
    block; pure reshapes, no gathers."""
    B, H, T, Dh = q.shape
    W = window
    scale = Dh ** -0.5
    nb = -(-T // W)
    qb, kb, vb = (_blocks(t, nb, W) for t in (q, k, v))
    # The previous block beside each block: [.., nb, 2W, Dh].
    k2, v2 = (torch.cat([F.pad(t, (0, 0, 0, 0, 1, 0))[:, :, :-1], t], dim=3) for t in (kb, vb))
    s = matmul_fp32(qb, k2.transpose(-1, -2), q.dtype) * scale
    # Query a of block m sits at i = mW + a, key b at j = (m - 1)W + b:
    # j <= i and i - j < W  ⇔  a < b <= a + W; block 0's first half is pad.
    a = torch.arange(W, device=q.device)[:, None]
    b = torch.arange(2 * W, device=q.device)[None, :]
    band = (b > a) & (b <= a + W)  # [W, 2W]
    first = torch.arange(nb, device=q.device)[:, None, None] > 0
    mask = band[None] & (first | (b[None] >= W))  # [nb, W, 2W]
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = matmul_fp32(p, v2, v2.dtype)
    return o.reshape(B, H, nb * W, Dh)[:, :, :T]


IMPLS = ("vanilla", "blockwise", "banded")


def _heads(y: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, T, D] → [B, heads, T, D / heads]."""
    B, T, D = y.shape
    return y.reshape(B, T, num_heads, D // num_heads).transpose(1, 2)


def project_attend(x: torch.Tensor, p, num_heads: int, form, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """[B, T, D] → [B, T, D] fp32: q, k and v projected by ``p["wq"]``,
    ``p["wk"]`` and ``p["wv"]`` ([D, D] each) and rounded to ``dtype``, the
    local ``form(q, k, v)`` on [B, heads, T, D / heads], then ``p["wo"]``."""
    B, T, D = x.shape
    q, k, v = (_heads(matmul_fp32(x, p[w], dtype), num_heads).to(dtype) for w in ("wq", "wk", "wv"))
    o = form(q, k, v).transpose(1, 2).reshape(B, T, D)
    return matmul_fp32(o, p["wo"], dtype)


def multihead_attention(x: torch.Tensor, p, num_heads: int, window: int, impl: str = "blockwise",
                        block_size: int = 128, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """[B, T, D] → [B, T, D] fp32 windowed causal MHA with projections
    ``p["wq"]``, ``p["wk"]``, ``p["wv"]``, ``p["wo"]``, each [D, D].

    ``impl`` picks the form by the reference's rule: ``vanilla``;
    ``banded`` when asked, or for ``blockwise`` once ``window >= 128`` and
    ``T >= 2 · window`` (the band's tiles fill the reference's 128-wide
    matrix unit only then); else ``blockwise`` at ``block_size``."""
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r} (SP modes are applied in parallel/sp_attention)")
    T = x.shape[1]
    if impl == "vanilla":
        form = partial(vanilla_attention, window=window)
    elif impl == "banded" or (window >= 128 and T >= 2 * window):
        form = partial(banded_attention, window=window)
    else:
        form = partial(blockwise_attention, window=window, block_size=block_size)
    return project_attend(x, p, num_heads, form, dtype)


def multihead_attention_last(x: torch.Tensor, p, num_heads: int, window: int, last: torch.Tensor,
                             dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Windowed causal MHA at one query position per row: [B, T, D] and
    ``last [B]`` → [B, D], equal to ``multihead_attention(x, …)[arange(B),
    last]``. Only the window ending at ``last`` is projected (the eval and
    serving path); its one query needs no blocks, so this is the
    normalised form whatever ``impl`` the full path takes, as in the
    reference."""
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