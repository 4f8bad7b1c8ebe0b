"""Collectives over one axis of a ``Mesh``, counterpart of
``poi_tpu/parallel/collectives.py``.

Every rank of an axis group computes the same loss from the same
replicated tensors and backpropagates its own 1.0, so each collective on a
gradient path has the backward that makes the sharded losses' gradients
equal the dense ones (Megatron's conjugate pair):

- ``psum``: the sum over the axis forward, the identity backward: its
  result feeds replicated compute, whose gradient every rank already holds
  in full (the lookups' partial rows, the LSE's partition function, the
  owned target logit);
- ``grad_psum``: the identity forward, the sum over the axis backward: a
  replicated tensor that enters rank-local work (the queries against one
  shard's rows in the sharded CE), whose gradient each rank holds a part of;
- ``all_gather``: the concatenation forward, this rank's block of the
  gradient backward (the a2a lookup's replicated result; the output of
  sequence-parallel attention, gathered over time);
- ``split``: this rank's block forward, the gradient blocks all-gathered
  backward: ``all_gather``'s conjugate, for a replicated tensor of which
  each rank works on its block alone (sequence-parallel attention's time
  block of the replicated GRU output, whose full gradient the GRU's
  backward needs on every rank);
- ``all_to_all``: the block transpose both ways (the a2a lookup; Ulysses'
  time-to-heads exchange);
- ``ppermute_ring``: each rank's tensor to the rank ``shift`` places on,
  forward, and back by ``-shift`` backward (ring attention's rotation of
  the key and value blocks).

``torch.distributed.nn.functional.all_reduce`` is neither pair: its
backward sums the cotangent, which a replicated loss makes M times the
gradient. ``pmax`` and ``all_reduce_`` carry no gradient. An axis of size 1
without a group calls no collective.

The ops are the same for ``nccl`` and ``gloo``. ``gloo`` takes every one of
them on CUDA tensors as well (it copies them through host memory itself),
which the rig of several ranks on one card uses. The ring shift is an
``all_to_all_single`` whose split sizes are zero but toward ``rank + shift``
(and from ``rank - shift``), one mechanism for both backends: ``gloo``'s
point-to-point ``send``/``recv`` take no CUDA tensors.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from poi_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh  # noqa: F401  (re-export)

def _alone(mesh: Mesh, axis: str) -> bool:
    """This rank is the whole axis, and no group asks for a collective."""
    return mesh.shape[axis] == 1 and mesh.groups[axis] is None


def axis_index(mesh: Mesh, axis: str) -> int:
    return mesh.index[axis]


def axis_size(mesh: Mesh, axis: str) -> int:
    return mesh.shape[axis]


def all_reduce_(x: torch.Tensor, mesh: Mesh, axis: str, op: str = "sum") -> torch.Tensor:
    """``x`` reduced over ``axis`` in place (``op``: sum or max), no gradient."""
    if _alone(mesh, axis):
        return x
    dist.all_reduce(x, {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op], group=mesh.group(axis))
    return x


def _gather(x: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, x, group=mesh.group(axis))
    return torch.cat(parts, dim=dim)


def _exchange(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Block j of dim 0 to rank j; block j of the result from rank j."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=mesh.group(axis))
    return out


def _shift(x: torch.Tensor, mesh: Mesh, axis: str, shift: int) -> torch.Tensor:
    """This rank's ``x`` to the rank ``shift`` places on along ``axis``;
    the result is the tensor of the rank ``shift`` places back."""
    n, me = mesh.shape[axis], mesh.index[axis]
    flat = x.contiguous().view(1, -1)
    send, recv = [0] * n, [0] * n
    send[(me + shift) % n] = recv[(me - shift) % n] = 1
    out = torch.empty_like(flat)
    dist.all_to_all_single(out, flat, output_split_sizes=recv, input_split_sizes=send, group=mesh.group(axis))
    return out.view_as(x)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce_(x.clone(), mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GradPsum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.mesh, ctx.axis), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim, ctx.n = mesh, axis, dim, x.shape[dim]
        return _gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.mesh.index[ctx.axis] * ctx.n, ctx.n), None, None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        n = x.shape[dim] // mesh.shape[axis]
        return x.narrow(dim, mesh.index[axis] * n, n).clone()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, shift):
        ctx.mesh, ctx.axis, ctx.shift = mesh, axis, shift
        return _shift(x, mesh, axis, shift)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.mesh, ctx.axis, -ctx.shift), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _exchange(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.mesh, ctx.axis), None, None


def psum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Sum over ``axis``; the identity backward (the result feeds
    replicated compute)."""
    return x if _alone(mesh, axis) else _Psum.apply(x, mesh, axis)


def grad_psum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The identity; the backward sums the gradient over ``axis`` (a
    replicated tensor that enters rank-local work)."""
    return x if _alone(mesh, axis) else _GradPsum.apply(x, mesh, axis)


def pmax(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Max over ``axis`` of ``x`` detached (the stable LSE's shift)."""
    return all_reduce_(x.detach().clone(), mesh, axis, "max")


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """Every rank's block of ``axis`` concatenated along ``dim``, in rank
    order; the backward keeps this rank's block of the gradient."""
    return x if _alone(mesh, axis) else _AllGather.apply(x, mesh, axis, dim)


def split(x: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    """This rank's block of ``axis`` along ``dim`` of a replicated ``x``;
    the backward all-gathers the blocks' gradients, so every rank holds the
    whole gradient of ``x``."""
    if x.shape[dim] % mesh.shape[axis]:
        raise ValueError(f"split: dim {dim} of {tuple(x.shape)} does not divide over {axis}={mesh.shape[axis]}")
    return x if _alone(mesh, axis) else _Split.apply(x, mesh, axis, dim)


def ppermute_ring(x: torch.Tensor, mesh: Mesh, axis: str, shift: int = 1) -> torch.Tensor:
    """Rotate ``x`` around the ring of ``axis``: rank i's tensor goes to
    rank ``(i + shift) % n``, so this rank receives rank ``(i - shift) %
    n``'s; the backward rotates the gradient back by ``-shift``."""
    return x if _alone(mesh, axis) else _Ring.apply(x, mesh, axis, shift)


def all_to_all(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``x [M, ...]``: block j goes to rank j of ``axis``, and block j of
    the result came from rank j; the backward exchanges the gradient back."""
    return x if _alone(mesh, axis) else _AllToAll.apply(x, mesh, axis)
