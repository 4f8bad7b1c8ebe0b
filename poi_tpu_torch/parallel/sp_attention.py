"""Sequence-parallel attention on a mesh's model axis, ring and Ulysses,
counterpart of ``poi_tpu/parallel/sp_attention.py``.

The recurrent tower is serial in time, so every model rank holds the GRU's
whole output ``[B_local, T, D]`` (its data rows, replicated over
``model``). The windowed attention after it can be split over time: each
of the M model ranks takes its block of ``Tl = T / M`` steps
(``collectives.split``, whose backward gathers the blocks' gradients, so
the GRU's backward sees the whole gradient on every rank), projects it with
its own q, k and v, and attends its queries to every key in the window:

- ``ring``: the key and value blocks travel around the model ring
  (``collectives.ppermute_ring``, M rotations) while the queries stay; each
  block's scores, masked at the blocks' global offsets, join the fp32
  online softmax of ``ops.attention._online_block_update``;
- ``ulysses``: one ``all_to_all`` turns the time blocks of all heads into
  the whole sequence of ``heads / M`` heads, the reference's local
  ``blockwise_attention`` at ``block_size`` runs on them, and a second
  ``all_to_all`` turns the result back.

Each rank applies ``wo`` to its block, and the blocks are all-gathered over
``model`` into the replicated ``[B_local, T, D]`` output. The projections
``wq``, ``wk``, ``wv`` and ``wo`` are replicated and each rank's work covers
its block alone, so they enter through ``grad_psum``: their gradients are
summed over ``model``. As in the reference, this path rounds nothing to the
compute dtype: q, k, v, the scores, ``p · v`` and ``wo`` are fp32 whatever
``model.compute_dtype`` is.
"""

from __future__ import annotations

import torch

from poi_tpu_torch.models.base import matmul_fp32
from poi_tpu_torch.ops.attention import NEG_INF, _online_block_update, blockwise_attention
from poi_tpu_torch.parallel import collectives as cc
from poi_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh

IMPLS = ("ring", "ulysses")


def _ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int, mesh: Mesh,
                          axis: str = MODEL_AXIS) -> torch.Tensor:
    """q, k, v ``[B, H, Tl, Dh]``, this rank's time block → ``[B, H, Tl,
    Dh]`` fp32. Step j scores the queries against the block of rank ``my -
    j`` (the ring's rotations bring it), in an fp32 online softmax."""
    B, H, Tl, Dh = q.shape
    m_sz, my = cc.axis_size(mesh, axis), cc.axis_index(mesh, axis)
    scale = Dh ** -0.5
    qi = my * Tl + torch.arange(Tl, device=q.device)[:, None]
    m = torch.full((B, H, Tl, 1), NEG_INF, device=q.device)
    l = torch.zeros((B, H, Tl, 1), device=q.device)
    acc = torch.zeros((B, H, Tl, Dh), device=q.device)
    for step in range(m_sz):
        src = (my - step) % m_sz
        kj = src * Tl + torch.arange(Tl, device=q.device)[None, :]
        s = matmul_fp32(q, k.transpose(-1, -2), q.dtype) * scale
        s = torch.where((kj <= qi) & (qi - kj < window), s, NEG_INF)
        m, l, acc = _online_block_update((m, l, acc), (s, v))
        if step + 1 < m_sz:  # the last rotation would bring back this rank's own block
            k, v = cc.ppermute_ring(k, mesh, axis), cc.ppermute_ring(v, mesh, axis)
    return acc / l.clamp_min(1e-30)


def _to_heads(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``[B, H, Tl, Dh]`` time blocks → ``[B, H / M, T, Dh]``: head group j
    to rank j, the received time blocks concatenated in rank order."""
    B, H, Tl, Dh = x.shape
    m_sz = cc.axis_size(mesh, axis)
    x = cc.all_to_all(x.reshape(B, m_sz, H // m_sz, Tl, Dh).transpose(0, 1), mesh, axis)  # [M(src), B, H/M, Tl, Dh]
    return x.permute(1, 2, 0, 3, 4).reshape(B, H // m_sz, m_sz * Tl, Dh)


def _to_seq(o: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``_to_heads``' inverse: ``[B, H / M, T, Dh]`` → ``[B, H, Tl, Dh]``."""
    B, Hl, T, Dh = o.shape
    m_sz = cc.axis_size(mesh, axis)
    o = cc.all_to_all(o.reshape(B, Hl, m_sz, T // m_sz, Dh).permute(2, 0, 1, 3, 4), mesh, axis)  # [M(heads), ...]
    return o.transpose(0, 1).reshape(B, m_sz * Hl, T // m_sz, Dh)


def _ulysses_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int, mesh: Mesh,
                             block_size: int, axis: str = MODEL_AXIS) -> torch.Tensor:
    """q, k, v ``[B, H, Tl, Dh]``, this rank's time block → ``[B, H, Tl,
    Dh]`` in q's dtype: the whole sequence of ``H / M`` heads attended
    here, blockwise at ``block_size``."""
    H, m_sz = q.shape[1], cc.axis_size(mesh, axis)
    if H % m_sz != 0:
        raise ValueError(f"ulysses needs heads ({H}) divisible by model shards ({m_sz})")
    o = blockwise_attention(*(_to_heads(t, mesh, axis) for t in (q, k, v)), window, block_size)
    return _to_seq(o.to(q.dtype), mesh, axis)


def make_sp_attention(mesh: Mesh, num_heads: int, window: int, impl: str, block_size: int = 128):
    """``mha(x, p)``: windowed causal MHA of ``x [B_local, T, D]`` (this
    data rank's rows, replicated over ``model``) with ``p["wq"]``,
    ``p["wk"]``, ``p["wv"]``, ``p["wo"]`` ``[D, D]``, time split over the
    mesh's model axis; returns ``[B_local, T, D]`` fp32, replicated over
    ``model``, computed in fp32 throughout. ``block_size`` is Ulysses'
    local blockwise block (``model.attn_block_size``)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown SP attention impl {impl!r}")
    m_sz = mesh.shape[MODEL_AXIS]

    def mha(x: torch.Tensor, p) -> torch.Tensor:
        B, T, D = x.shape
        if T % m_sz:
            raise ValueError(f"sequence-parallel attention: T={T} does not split over {MODEL_AXIS}={m_sz}")
        xl = cc.split(x, mesh, MODEL_AXIS, 1)  # [B, Tl, D]
        w = {n: cc.grad_psum(p[n], mesh, MODEL_AXIS) for n in ("wq", "wk", "wv", "wo")}
        q, k, v = (matmul_fp32(xl, w[n], torch.float32).reshape(B, T // m_sz, num_heads, D // num_heads)
                   .transpose(1, 2) for n in ("wq", "wk", "wv"))
        o = (_ring_attention_local(q, k, v, window, mesh) if impl == "ring"
             else _ulysses_attention_local(q, k, v, window, mesh, block_size))
        o = o.transpose(1, 2).reshape(B, T // m_sz, D)
        return cc.all_gather(matmul_fp32(o, w["wo"], torch.float32), mesh, MODEL_AXIS, 1)

    return mha
