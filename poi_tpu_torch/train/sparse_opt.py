"""Touched-rows-only ("lazy") Adam for catalog-sized embedding tables,
counterpart of ``poi_tpu/train/sparse_opt.py``.

With a sampled objective only the rows a step touched (inputs ∪ targets ∪
the negative pool) can carry gradient. Lazy Adam updates those rows and
leaves every other row of the table, and of its moments, bit for bit as it
was: no moment decay, no momentum tail. Below ``DENSE_LAZY_MAX_BYTES`` a
table takes the masked-dense form: elementwise passes over the whole table
gated by a [V] touched mask. Above it (config #5's 903,889 x 512 table) the
gather/scatter form: the touched ids are deduplicated (``dedup_ids``), and
Adam reads and writes the table and its moments at those rows only. The
rows-gradient train step (``Trainer._rows_loss``) hands the table's gradient
as one row per id occurrence (``row_grads``), summed per unique id here
(``dedup_sum``), so the dense [V, D] gradient never exists.

Shapes stay static, as in the reference: the deduplicated vector has the
length of the occurrences, the unique ids first (ascending), then distinct
out-of-bounds sentinels. No ``torch.unique`` (its size depends on the data,
so the host would wait for the card every step), and the duplicate sums run
in a fixed order (a sorted segment sum, not ``index_add_``, whose fp32
atomics give other bits from run to run on the card).

Small parameters (tower, projection, time and geo tables) take plain Adam
with the same schedule and clip. The clip is ``poi_tpu``'s here:
``scale = clip / gnorm`` where ``gnorm > clip``, from the exact global norm
of every gradient.
"""

from __future__ import annotations

import numpy as np
import torch

from poi_tpu_torch.ops.segment import dedup_ids, dedup_sum
from poi_tpu_torch.train.state import ADAM_B1, ADAM_B2, ADAM_EPS, lr_schedule, named_norm
from poi_tpu_torch.utils.config import Config

# params["embed"] keys that hold catalog-sized tables -> the id set that touches them.
TABLE_ID_SOURCE = {"poi": "poi", "out": "poi", "out_bias": "poi", "user": "user"}
# Tables at or below this size take the masked-dense path: the TPU package's
# threshold (sparse_opt.py:64). On an H100 the gather/scatter path was
# already the faster at config #4's 37.9 MB table (scripts/profile_1m.py,
# PERF.md §7); the threshold stays the reference's until a change measures
# the whole step.
DENSE_LAZY_MAX_BYTES = 512 * 2**20


def validate_config(cfg: Config) -> None:
    """train.table_update="sparse" preconditions, checked at Trainer build."""
    if cfg.train.optimizer != "adam" or cfg.train.weight_decay:
        raise ValueError(
            "train.table_update='sparse' implements lazy Adam; it requires train.optimizer='adam' and "
            f"train.weight_decay=0 (got {cfg.train.optimizer!r}, wd={cfg.train.weight_decay})"
        )
    if cfg.loss.kind not in ("bpr", "sampled_softmax"):
        raise ValueError(
            "train.table_update='sparse' needs a sampled objective (bpr or sampled_softmax): full-softmax CE "
            f"gradients are dense over the catalog, so every row is touched (got loss.kind={cfg.loss.kind!r})"
        )


def rows_mode_enabled(cfg: Config, dims, n_model: int) -> bool:
    """Whether ``poi_tpu`` would differentiate w.r.t. gathered table rows
    (its rows-gradient step): sparse update, unsharded vocab, tied-table
    sampled softmax, and a table above ``DENSE_LAZY_MAX_BYTES``."""
    return (
        cfg.train.table_update == "sparse"
        and n_model == 1
        and cfg.loss.kind == "sampled_softmax"
        and cfg.model.tie_output_embedding
        and dims.num_pois_padded * cfg.model.embed_dim * 4 > DENSE_LAZY_MAX_BYTES
    )


def touched_ids(batch, neg: torch.Tensor) -> dict[str, torch.Tensor]:
    """The id sets that can carry gradient this step, per table family.

    ``neg`` must be the pool the loss received (one draw a step, shared by
    both), so the touched rows are exactly the rows with gradient."""
    ids = {"poi": torch.cat([batch.poi_in.reshape(-1), batch.poi_tgt.reshape(-1), neg.reshape(-1)])}
    if batch.user is not None:
        ids["user"] = batch.user.reshape(-1)
    return ids


def _rows_of(x: torch.Tensor, uids: torch.Tensor, n_rows: int) -> torch.Tensor:
    """The rows of ``x`` at ``uids``, 0 at the sentinels."""
    valid = (uids < n_rows).reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(valid, x[uids.clamp(max=n_rows - 1)], 0.0)


def _table_source(name: str) -> str | None:
    """The id-source name when ``name`` (a state_dict key) is a table."""
    parts = name.split(".")
    if len(parts) == 2 and parts[0] == "embed":
        return TABLE_ID_SOURCE.get(parts[1])
    return None


class SparseTableOptimizer:
    """Lazy Adam on the tables, Adam elsewhere; parameters and moments are
    updated in place. State: ``{"count", "m", "v"}``, the fields of
    ``poi_tpu``'s ``SparseAdamState``."""

    def __init__(self, cfg: Config):
        validate_config(cfg)
        self.lr = lr_schedule(cfg.train)
        self.clip = cfg.train.grad_clip_norm
        self.norm = named_norm  # the clip's global norm
        # The bytes of each table's whole catalog over its local rows: the
        # model-axis size where a trainer holds one rank's rows, so a
        # shard takes the path its whole table would.
        self.table_scale = 1

    def init(self, params: dict[str, torch.Tensor]) -> dict:
        return {
            "count": 0,
            "m": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
            "v": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
        }

    @torch.no_grad()
    def update(self, grads: dict[str, torch.Tensor], state: dict, params: dict[str, torch.Tensor],
               ids: dict[str, torch.Tensor],
               row_grads: dict[str, tuple[torch.Tensor, torch.Tensor]] | None = None) -> torch.Tensor:
        """One update of ``params`` and ``state`` in place; returns the
        global gradient norm (a device scalar: computed for the clip, so
        reported every step).

        A table's gradient comes dense in ``grads`` or, for the embed keys
        of ``row_grads`` (``{"poi": (occurrence ids, [N, D] rows), ...}``,
        the rows-gradient step), as one row per id occurrence; ``grads``
        then need not hold that table. Ids are the tables' row numbers; an
        id at or past a table's last row (a row another model rank holds)
        touches none of its rows."""
        row_grads = row_grads or {}
        masks: dict[str, torch.Tensor] = {}
        uids: dict[str, torch.Tensor] = {}
        rows: dict[str, tuple[torch.Tensor, torch.Tensor]] = {}  # name -> (unique ids, their summed grads)
        for name, p in params.items():
            src = _table_source(name)
            key = name.split(".")[-1]
            if src is not None and key in row_grads:
                rows[name] = dedup_sum(*row_grads[key], oob=p.shape[0])
            elif src is None or src not in ids:
                continue
            elif p.numel() * 4 * self.table_scale <= DENSE_LAZY_MAX_BYTES:
                if src not in masks:
                    # index_fill_, not ``mask[ids] = True``: on a CUDA tensor
                    # that assignment waits for the stream. The extra row
                    # takes the ids of rows held elsewhere.
                    n = p.shape[0]
                    masks[src] = torch.zeros(n + 1, dtype=torch.bool, device=p.device).index_fill_(
                        0, ids[src].clamp(max=n), True)[:n]
            else:
                if src not in uids:
                    uids[src] = dedup_ids(ids[src], p.shape[0])
                rows[name] = (uids[src], _rows_of(grads[name], uids[src], p.shape[0]))

        # The global norm: dense and masked leaves in full (rows outside the
        # touched set are 0), gather/scatter tables from their unique rows.
        gnorm = self.norm({k: rows[k][1] if k in rows else grads[k] for k in params})
        scale = torch.ones_like(gnorm)
        if self.clip > 0:
            scale = torch.where(gnorm > self.clip, self.clip / gnorm, scale)

        count = state["count"]
        lr = self.lr(count)
        count_inc = count + 1
        bc1 = float(np.float32(1.0) - np.float32(ADAM_B1) ** np.float32(count_inc))
        bc2 = float(np.float32(1.0) - np.float32(ADAM_B2) ** np.float32(count_inc))
        for name, p in params.items():
            m, v = state["m"][name], state["v"][name]
            if name in rows:
                self._rows_update(p, m, v, *rows[name], scale, lr, bc1, bc2)
                continue
            g = grads[name] * scale
            m_n = ADAM_B1 * m + (1 - ADAM_B1) * g
            v_n = ADAM_B2 * v + (1 - ADAM_B2) * (g * g)
            step = lr * (m_n / bc1) / (torch.sqrt(v_n / bc2) + ADAM_EPS)
            src = _table_source(name)
            if src in masks:  # lazy Adam: untouched rows keep params and moments
                mask = masks[src].reshape((p.shape[0],) + (1,) * (p.dim() - 1))
                m_n = torch.where(mask, m_n, m)
                v_n = torch.where(mask, v_n, v)
                step = torch.where(mask, step, 0.0)
            m.copy_(m_n)
            v.copy_(v_n)
            p.sub_(step)
        state["count"] = count_inc
        return gnorm

    @staticmethod
    def _rows_update(p, m, v, u, g_u, scale, lr, bc1, bc2) -> None:
        """Lazy Adam at the unique ids ``u`` (sentinels past them) with their
        summed grads ``g_u``: gather, Adam on the rows, write back. Each
        sentinel position takes the last unique id's row and values, so every
        index is in bounds and a repeated index writes equal values. With no
        unique id (a shard the step never touched) every position rewrites
        the last row as it is."""
        n_unique = (u < p.shape[0]).sum()
        src = torch.minimum(torch.arange(u.shape[0], device=u.device), (n_unique - 1).clamp_min(0))
        u, g = u[src].clamp(max=p.shape[0] - 1), g_u[src] * scale
        m_u, v_u = m[u], v[u]
        m_n = ADAM_B1 * m_u + (1 - ADAM_B1) * g
        v_n = ADAM_B2 * v_u + (1 - ADAM_B2) * (g * g)
        step = lr * (m_n / bc1) / (torch.sqrt(v_n / bc2) + ADAM_EPS)
        touched = n_unique > 0
        m_n, v_n, step = torch.where(touched, m_n, m_u), torch.where(touched, v_n, v_u), torch.where(touched, step, 0.0)
        p.index_put_((u,), p[u] - step)
        m.index_put_((u,), m_n)
        v.index_put_((u,), v_n)
