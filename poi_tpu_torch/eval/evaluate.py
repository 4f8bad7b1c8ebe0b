"""Full-catalog evaluation, counterpart of ``poi_tpu/eval/evaluate.py``:
``prepare_catalog`` lays the output table out once, ``make_topk_fn`` maps a
batch of contexts to top-k candidate ids in the prepared table's id space,
and ``evaluate`` sweeps a split into Recall@k and NDCG.

On a mesh (``mesh=``, every rank calls), each data rank scores its rows of
each eval batch. With ``model > 1`` the vocab-sharded table never leaves
its rank: the popularity order and the tile padding are per shard
(``_prepare_catalog_sharded``), each shard runs the top-k over its own rows
and only the k·M candidates are gathered (``ops.topk.sharded_topk``). The
ranks' ids are all-gathered over ``data``, so every rank returns the same
metrics.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from poi_tpu_torch.data.dataset import Dataset
from poi_tpu_torch.data.pipeline import eval_batches
from poi_tpu_torch.eval.metrics import ranking_metrics
from poi_tpu_torch.models import base as model_base
from poi_tpu_torch.ops.topk import NEG, fused_topk, pad_table_for_topk, sharded_topk, topk_reference
from poi_tpu_torch.parallel import collectives as cc
from poi_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS
from poi_tpu_torch.utils.config import Config

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


def _sharded(mesh) -> bool:
    return mesh is not None and mesh.shape[MODEL_AXIS] > 1


def prepare_catalog(model, cfg: Config, poi_counts: np.ndarray | None, mesh=None) -> PreparedCatalog:
    """Popularity reorder + padding to a multiple of ``tile_v``, once.

    The CUDA kernel needs neither: it takes any V and skips nothing. Both
    stay because they fix the kernel's id space, and the tie order (lower
    id first) lives in that id space, so ``pallas`` ranks ties as the JAX
    package does. The table is stored in bf16, the type both top-k paths
    score in.
    """
    if cfg.eval.topk_impl not in TOPK_IMPLS:
        raise ValueError(f"unknown eval.topk_impl {cfg.eval.topk_impl!r}: have {TOPK_IMPLS}")
    if _sharded(mesh):
        return _prepare_catalog_sharded(model, cfg, poi_counts, mesh)
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


def _prepare_catalog_sharded(model, cfg: Config, poi_counts: np.ndarray | None, mesh) -> PreparedCatalog:
    """This rank's shard of the prepared catalog: for ``pallas``, its rows
    in popularity order within the shard and padded to the shard's tile;
    the id map takes the per-shard padded id space (``shard * rows_p +
    local row``) to catalog ids. ``xla`` keeps the shard as it is: its
    global rows are catalog ids."""
    table, bias = model_base.output_table(model.embed, cfg.model)
    table, bias = table.detach(), bias.detach()
    m = mesh.shape[MODEL_AXIS]
    rows = table.shape[0]
    vp = rows * m
    if cfg.eval.topk_impl != "pallas":
        return PreparedCatalog(table.to(torch.bfloat16).contiguous(), bias.float().contiguous(), None, 2048)
    tile_v = min(2048, -(-rows // 128) * 128)
    rows_p = -(-rows // tile_v) * tile_v
    counts = np.full(vp, -1.0)
    if poi_counts is not None:
        n = min(len(poi_counts), vp)
        counts[:n] = poi_counts[:n]
    local_order = np.argsort(-counts.reshape(m, rows), axis=1).astype(np.int32)  # [M, rows]
    idx = torch.from_numpy(local_order[mesh.index[MODEL_AXIS]]).long().to(table.device)
    table, bias = table[idx], bias[idx]
    if rows_p > rows:
        table = torch.cat([table, table.new_zeros(rows_p - rows, table.shape[1])])
        bias = torch.cat([bias, bias.new_full((rows_p - rows,), NEG)])
    id_map = np.zeros(m * rows_p, np.int32)
    for s in range(m):
        id_map[s * rows_p:s * rows_p + rows] = s * rows + local_order[s]
    return PreparedCatalog(table.to(torch.bfloat16).contiguous(), bias.float().contiguous(), id_map, tile_v)


def make_topk_fn(model, cfg: Config, k: int, mesh=None):
    """(table, bias, batch) -> [B, k] candidate ids (int64, in the prepared
    table's id space). With a vocab-sharded ``mesh`` the table and bias are
    this rank's shard, and the top-k is ``sharded_topk``'s. Cached on the
    model instance, keyed by (impl, k, mesh)."""
    impl = cfg.eval.topk_impl
    per_model = model.__dict__.setdefault("_topk_cache", {})
    sharded = _sharded(mesh)
    key = (impl, k, id(mesh) if sharded else None)
    if key in per_model:
        return per_model[key]
    select = fused_topk if impl == "pallas" else topk_reference

    def fn(table: torch.Tensor, bias: torch.Tensor, batch) -> torch.Tensor:
        ql = last_valid_queries(model, batch)
        if sharded:
            return sharded_topk(ql, table, bias, k, mesh, select)[1]
        return select(ql, table, bias, k)[1].long()

    per_model[key] = fn
    return fn


@torch.inference_mode()
def evaluate(model, dataset: Dataset, cfg: Config, split: str = "test", mesh=None) -> dict[str, float]:
    """Recall@k and NDCG@max(k) of the model's current parameters on
    ``split``, plus ``eval_examples``; at most ``eval.max_eval_users`` rows.
    ``mesh``: the model's mesh (its trainer's), on which every rank calls
    this and gets the same metrics."""
    ks = cfg.eval.recall_ks
    k = max(ks)
    examples = getattr(dataset, split)
    if examples is None:
        raise ValueError(f"dataset has no {split!r} split (set data.val_fraction > 0 for val)")
    if cfg.eval.max_eval_users and len(examples) > cfg.eval.max_eval_users:
        examples = examples.take(np.arange(cfg.eval.max_eval_users))
    prep = prepare_catalog(model, cfg, dataset.poi_counts, mesh)
    topk_fn = make_topk_fn(model, cfg, k, mesh)
    n_data = 1 if mesh is None else mesh.shape[DATA_AXIS]
    all_topk, all_tgt = [], []
    for batch, targets, n_valid in eval_batches(examples, cfg.eval.batch_size):
        if n_data > 1:  # this data rank's rows
            batch = type(batch)(*(a[mesh.rows(cfg.eval.batch_size, DATA_AXIS)] for a in batch))
        ids = topk_fn(prep.table, prep.bias, model_base.batch_to(batch, model.device))
        if n_data > 1:
            ids = cc.all_gather(ids, mesh, DATA_AXIS)
        ids = ids.cpu().numpy()[:n_valid]
        if prep.id_map is not None:
            ids = prep.id_map[ids]  # back to catalog ids
        all_topk.append(ids)
        all_tgt.append(targets[:n_valid])
    tgt = np.concatenate(all_tgt)
    metrics = ranking_metrics(np.concatenate(all_topk), tgt, ks)
    metrics["eval_examples"] = float(len(tgt))
    return metrics


def popularity_baseline(dataset: Dataset, ks=(1, 5, 10), split: str = "test") -> dict[str, float]:
    """Recall of always recommending the globally most-popular POIs, the
    floor any trained model must clear (``poi_tpu/eval/evaluate.py:310``)."""
    k = max(ks)
    examples = getattr(dataset, split)
    if examples is None:
        raise ValueError(f"dataset has no {split!r} split")
    top = np.argsort(dataset.poi_counts)[::-1][:k]
    return ranking_metrics(np.broadcast_to(top, (len(examples), k)), examples.target, ks)
