"""Training objectives, counterpart of ``poi_tpu/train/losses.py``.

Losses take ``q [B, T, D]`` queries, the output ``table [V, D]`` + ``bias
[V]``, targets and the validity ``mask [B, T]``, and reduce to a masked mean.
Logits use bf16 operands with fp32 sums; the softmax is fp32.
"""

from __future__ import annotations

from typing import Callable

import torch

from poi_tpu.utils.config import LossConfig
from poi_tpu_torch.models.base import matmul_fp32
from poi_tpu_torch.ops.fused_ce import fused_ce_loss

# Catalogs below this size take the dense CE, as in the TPU package
# (``poi_tpu/train/losses.py:163``). Kept at the TPU's value; PERF.md records
# the kernel and dense times on both sides of it.
FUSED_CE_MIN_VOCAB = 8192


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.float()
    return (x * m).sum() / m.sum().clamp_min(1.0)


def full_logits(q: torch.Tensor, table: torch.Tensor, bias: torch.Tensor,
                dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """[.., D] x [V, D]ᵀ → [.., V] fp32 (operands rounded to ``dtype``)."""
    return matmul_fp32(q, table.T, dtype) + bias


def ce_loss(q: torch.Tensor, table: torch.Tensor, bias: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor,
            label_smoothing: float = 0.0) -> torch.Tensor:
    """Dense full-catalog softmax CE, the oracle: the [B, T, V] logits are
    materialised and differentiated by autograd."""
    logits = full_logits(q, table, bias)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None])[..., 0]
    nll = lse - tgt
    if label_smoothing > 0.0:
        v = logits.shape[-1]
        nll = (1.0 - label_smoothing) * nll + label_smoothing * (lse - logits.mean(dim=-1)) * (v / (v - 1.0))
    return _masked_mean(nll, mask)


def build_loss_fn(cfg: LossConfig, num_pois: int) -> Callable:
    """loss(q, table, bias, targets, mask) -> scalar.

    CE takes ``fused_ce_loss`` (the CUDA kernels on CUDA tensors, their plain
    versions on CPU tensors) as the TPU package dispatches it: unless
    ``impl == "xla"``, the catalog is below ``FUSED_CE_MIN_VOCAB`` or label
    smoothing is on.
    """
    if cfg.kind == "ce":
        if cfg.impl != "xla" and num_pois >= FUSED_CE_MIN_VOCAB and cfg.label_smoothing == 0.0:
            return fused_ce_loss
        return lambda q, t, b, y, m: ce_loss(q, t, b, y, m, cfg.label_smoothing)
    if cfg.kind == "bpr":
        raise NotImplementedError("loss.kind='bpr' comes with the config #2 slice of the port (LSTM + BPR)")
    if cfg.kind == "sampled_softmax":
        raise NotImplementedError(
            "loss.kind='sampled_softmax' comes with the configs #4/#5 slice of the port (attention + sampled softmax)"
        )
    raise ValueError(f"unknown loss {cfg.kind!r}")
