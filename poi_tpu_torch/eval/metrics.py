"""Ranking metrics: Recall@k and NDCG@k (reference R10 — BASELINE.json:2).

The reference computes these in per-user Python loops over a dense argsort;
here they are vectorized over the whole eval batch given top-K candidate ids
(produced by the fused score+top-k kernel), so metric math is O(N·K) instead
of O(N·V log V).

With a single relevant item per example (leave-out protocol), NDCG@k reduces
to 1/log2(rank+2) when the target is ranked within k, else 0 — the same
definition the reference family uses.
"""

from __future__ import annotations

import numpy as np


def recall_at_k(topk_ids: np.ndarray, targets: np.ndarray, k: int) -> float:
    """topk_ids: [N, K>=k] ranked candidate ids; targets: [N]."""
    hits = (topk_ids[:, :k] == targets[:, None]).any(axis=1)
    return float(hits.mean()) if len(targets) else 0.0


def ndcg_at_k(topk_ids: np.ndarray, targets: np.ndarray, k: int) -> float:
    eq = topk_ids[:, :k] == targets[:, None]  # [N, k]
    found = eq.any(axis=1)
    ranks = np.where(found, eq.argmax(axis=1), 0)  # 0-based
    gains = np.where(found, 1.0 / np.log2(ranks + 2.0), 0.0)
    return float(gains.mean()) if len(targets) else 0.0


def ranking_metrics(topk_ids: np.ndarray, targets: np.ndarray, ks=(1, 5, 10)) -> dict[str, float]:
    out = {}
    for k in ks:
        out[f"recall@{k}"] = recall_at_k(topk_ids, targets, k)
    out[f"ndcg@{max(ks)}"] = ndcg_at_k(topk_ids, targets, max(ks))
    return out
