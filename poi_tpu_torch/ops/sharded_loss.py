"""Losses over a vocab-sharded table and a data-sharded batch,
counterpart of ``poi_tpu/ops/sharded_loss.py``.

Each loss has the dense losses' signature, ``loss(q, table_local,
bias_local, targets, mask[, neg])``, on this rank's data rows and its
block of the catalog. The value is this rank's part of the global masked
mean: its rows' sum over the mask count of the whole batch (an all-reduce
over ``data`` with no gradient), so the losses of the data ranks add up to
the reference's global mean, and the gradients summed over ``data`` are
its gradients. The trainer sums both.

- CE: a two-pass log-sum-exp across shards. Each rank scores its block of
  the catalog (bf16 operands, fp32 sums: plain ``torch.matmul``, as the
  reference's per-shard product is plain XLA), the global max comes by
  ``pmax`` of a detached max, the partition function by ``psum``, and the
  target logit by a ``psum`` of the owning shard's.
- BPR: positive and negative rows through the sharded lookup, scores local.
- Sampled softmax: the shared pool through the replicated lookup, the
  positives through the sharded one; each data rank runs B9/B10
  (``ops.fused_sampled.sampled_nll_rows``) on its own rows, with the
  reference's dispatch, or the plain ``sampled_nll``.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from poi_tpu_torch.models.base import matmul_fp32
from poi_tpu_torch.ops.embedding import bias_rows, make_replicated_lookup
from poi_tpu_torch.ops.fused_sampled import log_q, sampled_nll_rows
from poi_tpu_torch.parallel import collectives as cc
from poi_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh
from poi_tpu_torch.train.losses import sampled_nll


def make_global_mean(mesh: Mesh) -> Callable:
    """mean(x, mask): this rank's share of the masked mean over the whole
    (data-sharded) batch, ``sum(x * m) / max(global sum(m), 1)``."""

    def mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        m = mask.float()
        den = cc.all_reduce_(m.sum().detach().clone(), mesh, DATA_AXIS)
        return (x * m).sum() / den.clamp_min(1.0)

    return mean


def sharded_ce(q, table_local, bias_local, targets, mask, mesh: Mesh, mean: Callable) -> torch.Tensor:
    """Full-softmax CE over the sharded catalog (``_sharded_ce_local``)."""
    rows = table_local.shape[0]
    lo = cc.axis_index(mesh, MODEL_AXIS) * rows
    # q is replicated over model and meets only this shard's rows here: its
    # gradient is the sum of every shard's part.
    logits = matmul_fp32(cc.grad_psum(q, mesh, MODEL_AXIS), table_local.T, torch.bfloat16) + bias_local
    gmax = cc.pmax(logits.detach().amax(dim=-1), mesh, MODEL_AXIS)
    sumexp = torch.exp(logits - gmax[..., None]).sum(dim=-1)
    lse = torch.log(cc.psum(sumexp, mesh, MODEL_AXIS)) + gmax
    local_tgt = targets - lo
    owned = (local_tgt >= 0) & (local_tgt < rows)
    tl = torch.gather(logits, -1, local_tgt.clamp(0, rows - 1)[..., None])[..., 0]
    tgt_logit = cc.psum(torch.where(owned, tl, 0.0), mesh, MODEL_AXIS)
    return mean(lse - tgt_logit, mask)


def make_sharded_ce(mesh: Mesh, mean: Callable) -> Callable:
    return lambda q, table, bias, targets, mask: sharded_ce(q, table, bias, targets, mask, mesh, mean)


def make_sharded_bpr(lookup: Callable, mean: Callable) -> Callable:
    """BPR with its rows through the sharded ``lookup``; ``neg [b, T, N]``
    are this data shard's rows of the step's negatives."""

    def loss(q, table, bias, targets, mask, neg):
        B, T, N = neg.shape
        e_pos = lookup(table, targets)
        e_neg = lookup(table, neg.reshape(B, -1)).reshape(B, T, N, -1)
        b_pos = bias_rows(lookup, bias, targets)
        b_neg = bias_rows(lookup, bias, neg.reshape(B, -1)).reshape(B, T, N)
        s_pos = (q * e_pos).sum(dim=-1) + b_pos
        s_neg = torch.einsum("btd,btnd->btn", q, e_neg) + b_neg
        pair_ok = (neg != targets[..., None]) & (mask[..., None] > 0)
        return mean(-F.logsigmoid(s_pos[..., None] - s_neg), pair_ok)

    return loss


def make_sharded_sampled_softmax(mesh: Mesh, lookup: Callable, num_sampled: int, num_pois: int, mean: Callable,
                                 fused: str = "auto", embed_dim: int | None = None) -> Callable:
    """Sampled softmax over the sharded table with the shared pool ``neg
    [S]``. ``fused``: ``auto`` takes B9/B10 where ``num_sampled >= 128`` and
    ``embed_dim % 128 == 0``, ``on`` always, ``off`` never (the reference's
    ``loss.impl`` mapping); on CPU tensors the kernels' wrappers take their
    plain versions."""
    rep_lookup = make_replicated_lookup(mesh)
    use_fused = fused == "on" or (fused == "auto" and num_sampled >= 128
                                  and (embed_dim is None or embed_dim % 128 == 0))

    def loss(q, table, bias, targets, mask, neg):
        B, T = targets.shape
        e_neg = rep_lookup(table, neg)
        b_neg = bias_rows(rep_lookup, bias, neg)
        e_pos = lookup(table, targets)
        b_pos = bias_rows(lookup, bias, targets)
        s_pos = (q.float() * e_pos.float()).sum(dim=-1) + b_pos
        if use_fused:
            nll = sampled_nll_rows(q.reshape(B * T, -1), e_neg, b_neg - log_q(num_sampled, num_pois),
                                   s_pos.reshape(-1), targets.reshape(-1), neg).reshape(B, T)
        else:
            nll = sampled_nll(q, e_neg, b_neg, s_pos, targets, neg, num_sampled, num_pois)
        return mean(nll, mask)

    loss.fused = use_fused
    return loss
