"""Training objectives, counterpart of ``poi_tpu/train/losses.py``.

Losses take ``q [B, T, D]`` queries, the output ``table [V, D]`` + ``bias
[V]``, targets and the validity ``mask [B, T]``, and reduce to a masked mean;
sampled softmax also takes the step's negative pool ``neg [S]``, BPR the
step's negatives ``neg [B, T, N]``. Softmax logits use bf16 operands with
fp32 sums; the softmax is fp32. BPR's pairwise scores are fp32, as in the
JAX package, which computes BPR outside any kernel.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch
import torch.nn.functional as F

from poi_tpu_torch.models.base import gather_rows, matmul_fp32
from poi_tpu_torch.ops.fused_ce import fused_ce_loss
from poi_tpu_torch.ops.fused_sampled import NEG, fused_sampled_softmax_loss, log_q
from poi_tpu_torch.utils.config import LossConfig

# Catalogs below this size take the dense CE, as in the TPU package
# (``poi_tpu/train/losses.py:163``). Kept at the TPU's value; PERF.md records
# the kernel and dense times on both sides of it.
FUSED_CE_MIN_VOCAB = 8192


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.float()
    return (x * m).sum() / m.sum().clamp_min(1.0)


def full_logits(q: torch.Tensor, table: torch.Tensor, bias: torch.Tensor,
                dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """[.., D] x [V, D]ᵀ → [.., V] fp32 (operands rounded to ``dtype``)."""
    return matmul_fp32(q, table.T, dtype) + bias


def ce_loss(q: torch.Tensor, table: torch.Tensor, bias: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor,
            label_smoothing: float = 0.0, mean: Callable = masked_mean) -> torch.Tensor:
    """Dense full-catalog softmax CE, the oracle: the [B, T, V] logits are
    materialised and differentiated by autograd."""
    logits = full_logits(q, table, bias)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None])[..., 0]
    nll = lse - tgt
    if label_smoothing > 0.0:
        v = logits.shape[-1]
        nll = (1.0 - label_smoothing) * nll + label_smoothing * (lse - logits.mean(dim=-1)) * (v / (v - 1.0))
    return mean(nll, mask)


def draw_bpr_negatives(generator: torch.Generator, B: int, T: int, num_negatives: int, num_pois: int,
                       device) -> torch.Tensor:
    """BPR's negatives: ``num_negatives`` ids a position, [B, T, N], drawn
    uniformly from ``[0, num_pois)``. The trainer draws them once a step and
    hands the same ids to the loss and to lazy Adam's touched rows."""
    return torch.randint(0, num_pois, (B, T, num_negatives), generator=generator, device=device)


def bpr_loss(q, table, bias, targets, mask, neg, mean: Callable = masked_mean) -> torch.Tensor:
    """Bayesian Personalized Ranking, ``-log σ(s_pos - s_neg)`` for each of
    the position's negatives ``neg [B, T, N]``, averaged over the pairs whose
    negative is not the positive and whose position is valid. The targets'
    and the negatives' rows are gathered in one ``lookup`` a tensor, whose
    backward sums each id's rows in a fixed order."""
    B, T, N = neg.shape
    rows, brows = gather_rows(table, bias, torch.cat([targets.reshape(-1), neg.reshape(-1)]))
    e_pos, e_neg = rows[:B * T].reshape(B, T, -1), rows[B * T:].reshape(B, T, N, -1)
    s_pos = (q * e_pos).sum(dim=-1) + brows[:B * T].reshape(B, T)
    s_neg = torch.einsum("btd,btnd->btn", q, e_neg) + brows[B * T:].reshape(B, T, N)
    pair_ok = (neg != targets[..., None]) & (mask[..., None] > 0)
    return mean(-F.logsigmoid(s_pos[..., None] - s_neg), pair_ok)


def draw_sampled_negatives(generator: torch.Generator, num_sampled: int, num_pois: int, device) -> torch.Tensor:
    """The shared negative pool: ``num_sampled`` ids drawn uniformly with
    replacement from ``[0, num_pois)``. The trainer draws it once a step and
    hands the same ids to the loss and to the lazy-Adam touched rows."""
    return torch.randint(0, num_pois, (num_sampled,), generator=generator, device=device)


def sampled_nll(q, e_neg, b_neg, s_pos, targets, neg, num_sampled: int, num_pois: int) -> torch.Tensor:
    """[B, T] sampled-softmax NLL from gathered rows, the plain version
    (``poi_tpu``'s ``sampled_nll_xla``): bf16 negative logits with fp32
    sums, the logQ correction, accidental hits masked to -1e30, and the
    positive column folded in by ``logaddexp``; autograd differentiates it."""
    s_neg = matmul_fp32(q, e_neg.T, torch.bfloat16) + b_neg
    hit = neg == targets[..., None]
    s_neg = torch.where(hit, NEG, s_neg - log_q(num_sampled, num_pois))
    return torch.logaddexp(torch.logsumexp(s_neg, dim=-1), s_pos) - s_pos


def sampled_softmax_loss(q, table, bias, targets, mask, neg, num_sampled: int, num_pois: int,
                         mean: Callable = masked_mean) -> torch.Tensor:
    """Sampled softmax with the shared pool ``neg``, the plain path (the
    targets' and the pool's rows in one lookup a tensor)."""
    B, T = targets.shape
    rows, brows = gather_rows(table, bias, torch.cat([targets.reshape(-1), neg]))
    s_pos = (q.float() * rows[:B * T].reshape(B, T, -1).float()).sum(dim=-1) + brows[:B * T].reshape(B, T)
    nll = sampled_nll(q, rows[B * T:], brows[B * T:], s_pos, targets, neg, num_sampled, num_pois)
    return mean(nll, mask)


def build_loss_fn(cfg: LossConfig, num_pois: int, embed_dim: int | None = None,
                  mean: Callable = masked_mean) -> Callable:
    """loss(q, table, bias, targets, mask) -> scalar; sampled softmax takes
    the step's negative pool and BPR the step's negatives as a sixth
    argument. ``mean(x, mask)`` reduces the per-position losses (this
    batch's masked mean unless the caller gives another).

    CE takes ``fused_ce_loss`` (the CUDA kernels on CUDA tensors, their plain
    versions on CPU tensors) as the TPU package dispatches it: unless
    ``impl == "xla"``, the catalog is below ``FUSED_CE_MIN_VOCAB`` or label
    smoothing is on. Sampled softmax takes ``fused_sampled_softmax_loss``
    unless ``impl == "xla"``, when ``num_sampled >= 128`` and ``embed_dim``
    is a multiple of 128 (or unknown), or always with ``impl == "fused"``.
    """
    # A mean other than this rank's own (a data-sharded batch's global one)
    # is bound in; the default keeps the one-device functions as they are.
    extra = {} if mean is masked_mean else {"mean": mean}
    if cfg.kind == "ce":
        if cfg.impl != "xla" and num_pois >= FUSED_CE_MIN_VOCAB and cfg.label_smoothing == 0.0:
            return functools.partial(fused_ce_loss, **extra) if extra else fused_ce_loss
        return lambda q, t, b, y, m: ce_loss(q, t, b, y, m, cfg.label_smoothing, mean)
    if cfg.kind == "bpr":
        return functools.partial(bpr_loss, **extra) if extra else bpr_loss
    if cfg.kind == "sampled_softmax":
        shapes_ok = cfg.num_sampled >= 128 and (embed_dim is None or embed_dim % 128 == 0)
        fused = cfg.impl != "xla" and (shapes_ok or cfg.impl == "fused")
        fn = fused_sampled_softmax_loss if fused else sampled_softmax_loss
        return functools.partial(fn, num_sampled=cfg.num_sampled, num_pois=num_pois, **extra)
    raise ValueError(f"unknown loss {cfg.kind!r}")
