"""Touched-rows-only ("lazy") Adam for catalog-sized embedding tables,
counterpart of ``poi_tpu/train/sparse_opt.py`` on its masked-dense path.

With a sampled objective only the rows a step touched (inputs ∪ targets ∪
the negative pool) can carry gradient. Lazy Adam updates those rows and
leaves every other row of the table, and of its moments, bit for bit as it
was: no moment decay, no momentum tail. Below ``DENSE_LAZY_MAX_BYTES`` a
table takes the masked-dense form: elementwise passes over the whole table
gated by a [V] touched mask. The gather/scatter form for larger tables, and
the rows-gradient train step that goes with it (``poi_tpu``'s
``Trainer._rows_step``, config #5 at V = 1M), are not ported yet.

Small parameters (tower, projection, time and geo tables) take plain Adam
with the same schedule and clip. The clip is ``poi_tpu``'s here:
``scale = clip / gnorm`` where ``gnorm > clip``, from the exact global norm
of every gradient.
"""

from __future__ import annotations

import numpy as np
import torch

from poi_tpu_torch.train.state import ADAM_B1, ADAM_B2, ADAM_EPS, lr_schedule
from poi_tpu_torch.utils.config import Config

# params["embed"] keys that hold catalog-sized tables -> the id set that touches them.
TABLE_ID_SOURCE = {"poi": "poi", "out": "poi", "out_bias": "poi", "user": "user"}
# Tables at or below this size take the masked-dense path (the TPU package's
# threshold, sparse_opt.py:64; the H100's has not been derived).
DENSE_LAZY_MAX_BYTES = 512 * 2**20
ROWS_MODE_TODO = "ROADMAP A11"


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

    def init(self, params: dict[str, torch.Tensor]) -> dict:
        return {
            "count": 0,
            "m": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
            "v": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
        }

    @torch.no_grad()
    def update(self, grads: dict[str, torch.Tensor], state: dict, params: dict[str, torch.Tensor],
               ids: dict[str, torch.Tensor]) -> torch.Tensor:
        """One update of ``params`` and ``state`` in place; returns the
        global gradient norm (a device scalar: computed for the clip, so
        reported every step)."""
        masks: dict[str, torch.Tensor] = {}
        for name, g in grads.items():
            src = _table_source(name)
            if src is None or src not in ids or src in masks:
                continue
            if g.numel() * g.element_size() > DENSE_LAZY_MAX_BYTES:
                raise NotImplementedError(
                    f"lazy Adam on {name} ({g.numel() * g.element_size()} bytes): the gather/scatter path for "
                    f"tables above {DENSE_LAZY_MAX_BYTES} bytes is not ported yet ({ROWS_MODE_TODO})"
                )
            # index_fill_, not ``mask[ids] = True``: on a CUDA tensor that
            # assignment waits for the stream.
            masks[src] = torch.zeros(g.shape[0], dtype=torch.bool, device=g.device).index_fill_(0, ids[src], True)

        gnorm = torch.sqrt(sum((g.float() * g.float()).sum() for g in grads.values()))
        scale = torch.ones_like(gnorm)
        if self.clip > 0:
            scale = torch.where(gnorm > self.clip, self.clip / gnorm, scale)

        count = state["count"]
        lr = self.lr(count)
        count_inc = count + 1
        bc1 = float(np.float32(1.0) - np.float32(ADAM_B1) ** np.float32(count_inc))
        bc2 = float(np.float32(1.0) - np.float32(ADAM_B2) ** np.float32(count_inc))
        for name, p in params.items():
            g = grads[name] * scale
            m, v = state["m"][name], state["v"][name]
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
