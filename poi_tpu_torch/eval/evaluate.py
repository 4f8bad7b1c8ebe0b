"""Full-catalog top-k over the scoring queries, on one device.

Counterpart of the single-device part of ``poi_tpu/eval/evaluate.py``:
``prepare_catalog`` lays the output table out once, ``make_topk_fn`` maps a
batch of contexts to top-k candidate ids in the prepared table's id space.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from poi_tpu.utils.config import Config
from poi_tpu_torch.models import base as model_base
from poi_tpu_torch.ops.topk import fused_topk, pad_table_for_topk, topk_reference

TOPK_IMPLS = ("pallas", "xla")


class PreparedCatalog(NamedTuple):
    """Once-per-sweep table prep result."""

    table: torch.Tensor  # [V', D] bf16, reordered / tile-padded
    bias: torch.Tensor  # [V'] fp32
    id_map: np.ndarray | None  # kernel id -> catalog id (None = identity)
    tile_v: int


def last_valid_queries(model, batch) -> torch.Tensor:
    """[B, D] query at each sequence's final valid position."""
    return model.queries_last(batch)


def prepare_catalog(model, cfg: Config, poi_counts: np.ndarray | None) -> PreparedCatalog:
    """Popularity reorder + padding to a multiple of ``tile_v``, once.

    The CUDA kernel needs neither: it takes any V and skips nothing. Both
    stay because they fix the kernel's id space, and the tie order (lower
    id first) lives in that id space, so ``pallas`` ranks ties as the JAX
    package does. The table is stored in bf16, the type both top-k paths
    score in.
    """
    if cfg.eval.topk_impl not in TOPK_IMPLS:
        raise ValueError(f"unknown eval.topk_impl {cfg.eval.topk_impl!r}: have {TOPK_IMPLS}")
    table, bias = model_base.output_table(model.embed, cfg.model)
    table, bias = table.detach(), bias.detach()
    order = None
    tile_v = 2048
    if cfg.eval.topk_impl == "pallas":
        if poi_counts is not None:
            order = np.argsort(-poi_counts).astype(np.int32)
            pad = table.shape[0] - len(order)
            if pad > 0:  # padded vocab rows stay at the tail
                order = np.concatenate([order, np.arange(len(order), table.shape[0], dtype=np.int32)])
            idx = torch.from_numpy(order).long().to(table.device)
            table, bias = table[idx], bias[idx]
        table, bias = pad_table_for_topk(table, bias, tile_v)
    return PreparedCatalog(table.to(torch.bfloat16).contiguous(), bias.float().contiguous(), order, tile_v)


def make_topk_fn(model, cfg: Config, k: int):
    """(table, bias, batch) -> [B, k] candidate ids (int64, in the prepared
    table's id space). Cached on the model instance, keyed by (impl, k)."""
    impl = cfg.eval.topk_impl
    per_model = model.__dict__.setdefault("_topk_cache", {})
    key = (impl, k)
    if key in per_model:
        return per_model[key]
    select = fused_topk if impl == "pallas" else topk_reference

    def fn(table: torch.Tensor, bias: torch.Tensor, batch) -> torch.Tensor:
        ql = last_valid_queries(model, batch)
        return select(ql, table, bias, k)[1].long()

    per_model[key] = fn
    return fn
