"""Lookups in a vocab-sharded table, counterpart of
``poi_tpu/ops/embedding.py``.

The [Vp, D] POI table is row-sharded over the model axis in contiguous
blocks of ``Vp / M`` rows (Vp padded up to a multiple of M; the padded rows
carry a -1e30 output bias, ``models.base``). Each rank holds its block,
``table_local [Vp / M, D]``, and a lookup returns the replicated rows of its
data shard's ids, differentiable in the local block:

- ``psum``: each rank gathers the ids it owns (the others read zeros) and
  the partial rows are summed over ``model``; exact.
- ``a2a`` (MoE-style routing): the rank's flat id list is split over
  ``model``, each part bucketed by owner into fixed-capacity buckets,
  exchanged by ``all_to_all``, gathered where it lives, sent back by a second
  ``all_to_all`` and all-gathered to every model rank. Capacity
  ``cap = max(1, int(ceil(chunk / M) * capacity_factor))``; an id past its
  bucket's capacity reads zeros, and ``lookup_overflow_fraction`` counts
  those drops, as the reference's does.

Every local gather is ``models.base.lookup``, whose backward sums each
row's gradient in a fixed order.
"""

from __future__ import annotations

from typing import Callable

import torch

from poi_tpu_torch.models.base import lookup as dense_lookup
from poi_tpu_torch.parallel import collectives as cc
from poi_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh


def pad_vocab(v: int, model_shards: int) -> int:
    """Catalog rows padded up to a multiple of the model axis."""
    return -(-v // model_shards) * model_shards


def psum_lookup(table_local: torch.Tensor, ids: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``table[ids]`` of the sharded table: each rank's owned rows, summed
    over ``model``. ``ids`` may be this data shard's or replicated."""
    rows = table_local.shape[0]
    local = ids - cc.axis_index(mesh, MODEL_AXIS) * rows
    owned = (local >= 0) & (local < rows)
    vecs = torch.where(owned[..., None], dense_lookup(table_local, local.clamp(0, rows - 1)), 0.0)
    return cc.psum(vecs, mesh, MODEL_AXIS)


def route_by_owner(ids_flat: torch.Tensor, num_shards: int, rows_per_shard: int, capacity: int):
    """Bucket ids by owning shard, ``capacity`` a bucket, in their order
    (a stable sort by owner). Returns ``(send_ids [M, C], owner [N],
    rank [N], overflow [N])``: the slot of id i is ``(owner[i], rank[i])``,
    and an id past its bucket's capacity is not sent."""
    n = ids_flat.shape[0]
    owner = (ids_flat // rows_per_shard).clamp(0, num_shards - 1)
    order = torch.sort(owner, stable=True).indices
    counts = torch.bincount(owner, minlength=num_shards)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(owner).scatter_(0, order, torch.arange(n, device=ids_flat.device) - starts[owner[order]])
    overflow = rank >= capacity
    # Overflowed ids write into one spare slot past the buckets, dropped after.
    slot = torch.where(overflow, num_shards * capacity, owner * capacity + rank)
    send = torch.zeros(num_shards * capacity + 1, dtype=ids_flat.dtype, device=ids_flat.device)
    send = send.index_put_((slot,), ids_flat)[:-1].view(num_shards, capacity)
    return send, owner, rank, overflow


def a2a_capacity(chunk: int, num_shards: int, capacity_factor: float) -> int:
    return max(1, int(-(-chunk // num_shards) * capacity_factor))


def a2a_lookup(table_local: torch.Tensor, ids: torch.Tensor, mesh: Mesh, capacity_factor: float = 2.0) -> torch.Tensor:
    """``table[ids]`` of the sharded table by routing; ``ids`` are this
    data shard's, the result is replicated over ``model``. Ids past their
    bucket's capacity read zeros."""
    m = cc.axis_size(mesh, MODEL_AXIS)
    my = cc.axis_index(mesh, MODEL_AXIS)
    rows = table_local.shape[0]
    flat = ids.reshape(-1)
    nloc = flat.shape[0]
    nloc_pad = -(-nloc // m) * m
    flat = torch.nn.functional.pad(flat, (0, nloc_pad - nloc))
    chunk = nloc_pad // m
    cap = a2a_capacity(chunk, m, capacity_factor)
    send_ids, owner, rank, overflow = route_by_owner(flat[my * chunk:(my + 1) * chunk], m, rows, cap)
    recv_ids = cc.all_to_all(send_ids, mesh, MODEL_AXIS)  # [M, C]: the ids each rank asks this one for
    served = dense_lookup(table_local, (recv_ids - my * rows).clamp(0, rows - 1))  # [M, C, D]
    recv_vecs = cc.all_to_all(served, mesh, MODEL_AXIS)  # [M, C, D]: the rows this rank asked for
    vecs = torch.where(overflow[:, None], 0.0, recv_vecs[owner, rank.clamp(max=cap - 1)])
    all_vecs = cc.all_gather(vecs, mesh, MODEL_AXIS)  # [nloc_pad, D]
    return all_vecs[:nloc].reshape(*ids.shape, -1)


def lookup_overflow_count(ids: torch.Tensor, num_shards: int, rows_per_shard: int, capacity_factor: float,
                          data_shards: int = 1) -> torch.Tensor:
    """The number of ids of the global ``[B, T]`` batch ``ids`` that the a2a
    lookup drops, at its real granularity: the batch's rows split over
    ``data_shards``, each slice flattened, padded to a multiple of M and cut
    into M chunks, each chunk bucketed by owner with the lookup's capacity.
    The padding sorts after the real ids of its chunk, so it never displaces
    one, and is not counted."""
    m = num_shards
    flat = ids.reshape(-1)
    n = flat.shape[0]
    d = max(1, int(data_shards))
    nloc = -(-n // d)
    nloc_pad = -(-nloc // m) * m
    chunk = nloc_pad // m
    cap = a2a_capacity(chunk, m, capacity_factor)
    x = torch.cat([flat, flat.new_full((d * nloc - n,), -1)]).reshape(d, nloc)
    x = torch.nn.functional.pad(x, (0, nloc_pad - nloc), value=-1).reshape(d, m, chunk)
    owner = torch.where(x >= 0, (x // rows_per_shard).clamp(0, m - 1), m)
    counts = torch.nn.functional.one_hot(owner, m + 1)[..., :m].sum(dim=2)  # [d, M_src, M_owner]
    return (counts - cap).clamp_min(0).sum()


def lookup_overflow_fraction(ids: torch.Tensor, num_shards: int, rows_per_shard: int, capacity_factor: float,
                             data_shards: int = 1) -> torch.Tensor:
    """The fraction of the global batch's ids that the a2a lookup drops
    (``lookup_overflow_count`` over the id count), the capacity metric."""
    over = lookup_overflow_count(ids, num_shards, rows_per_shard, capacity_factor, data_shards)
    return over.float() / max(ids.numel(), 1)


def make_lookup(mesh: Mesh, mode: str, capacity_factor: float = 2.0) -> Callable:
    """lookup(table_local, ids) for ``mesh.embedding_mode``: the dense
    ``models.base.lookup`` on one model rank (or ``dense``), else ``psum`` or
    ``a2a``."""
    if cc.axis_size(mesh, MODEL_AXIS) == 1 or mode == "dense":
        return dense_lookup
    if mode == "psum":
        return lambda table, ids: psum_lookup(table, ids, mesh)
    if mode == "a2a":
        return lambda table, ids: a2a_lookup(table, ids, mesh, capacity_factor)
    raise ValueError(f"unknown embedding mode {mode!r}")


def make_replicated_lookup(mesh: Mesh) -> Callable:
    """Lookup of ids replicated across the mesh (the shared negative pool):
    the psum lookup, the same rows on every rank."""
    if cc.axis_size(mesh, MODEL_AXIS) == 1:
        return dense_lookup
    return lambda table, ids: psum_lookup(table, ids, mesh)


def bias_rows(lookup: Callable, bias: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``bias[ids]`` through ``lookup`` (which takes a [V, D] table)."""
    return lookup(bias[:, None], ids)[..., 0]


