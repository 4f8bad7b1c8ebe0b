"""Model machinery shared by the towers: embedding tables, the scoring
queries (at every position for training, at the last valid one for serving
and eval), and the dense projection.

Counterpart of ``poi_tpu/models/base.py``. Parameters
keep the JAX package's names and layouts, so ``convert.params_from_jax``
carries a ``poi_tpu`` param tree straight into ``Module.load_state_dict``:
``embed.poi [Vp, D]``, ``embed.out_bias [Vp]`` (-1e30 on padded rows),
``embed.time``, ``embed.geo``, ``embed.user``, ``tower.…`` and ``proj.kernel
[H, D]`` / ``proj.bias``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from poi_tpu_torch.data.pipeline import Batch
from poi_tpu_torch.utils.config import ModelConfig


@dataclass(frozen=True)
class DataDims:
    """Catalog sizes the parameter shapes depend on.

    ``num_pois_padded`` >= num_pois: rows past num_pois carry a -1e30 output
    bias and so never appear in a top-k.
    """

    num_users: int
    num_pois: int
    num_time_buckets: int
    num_geo_buckets: int
    num_tgap_buckets: int
    num_dist_buckets: int
    num_pois_padded: int = 0  # 0 → defaults to num_pois

    def __post_init__(self):
        if self.num_pois_padded == 0:
            object.__setattr__(self, "num_pois_padded", self.num_pois)

    @classmethod
    def from_dataset(cls, ds) -> "DataDims":
        return cls(
            num_users=ds.num_users,
            num_pois=ds.num_pois,
            num_time_buckets=ds.num_time_buckets,
            num_geo_buckets=ds.num_geo_buckets,
            num_tgap_buckets=ds.num_tgap_buckets,
            num_dist_buckets=ds.num_dist_buckets,
        )


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def batch_to(batch: Batch, device) -> Batch:
    """A numpy ``Batch`` as tensors on ``device``: ids as int64, floats as is."""

    def conv(a):
        a = np.asarray(a)
        t = torch.from_numpy(np.ascontiguousarray(a))
        if t.dtype in (torch.int32, torch.int64):
            t = t.long()
        return t.to(device)

    return Batch(*(conv(a) for a in batch))


def _normal(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    return scale * torch.randn(shape, generator=gen, dtype=torch.float32)


def init_embed_params(gen: torch.Generator, cfg: ModelConfig, dims: DataDims) -> dict[str, torch.Tensor]:
    """POI/user/time/geo tables + output bias (+ untied output table), at the
    JAX package's scales. Padded rows get a -1e30 bias."""
    scale = 0.02
    d = cfg.embed_dim
    vp = dims.num_pois_padded
    bias = torch.where(torch.arange(vp) < dims.num_pois, 0.0, -1e30).to(torch.float32)
    p = {"poi": _normal(gen, (vp, d), scale), "out_bias": bias}
    if cfg.use_user_embedding:
        p["user"] = _normal(gen, (dims.num_users, d), scale)
    if cfg.use_time_embedding:
        p["time"] = _normal(gen, (dims.num_time_buckets, d), scale)
    if cfg.use_geo_embedding:
        p["geo"] = _normal(gen, (dims.num_geo_buckets, d), scale)
    if not cfg.tie_output_embedding:
        p["out"] = _normal(gen, (vp, d), scale)
    return p


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout: keep each element with probability 1 - rate and
    scale it by 1 / (1 - rate). The identity without a generator (eval) or
    at rate 0, so one ``queries`` call serves train and eval."""
    if generator is None or rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


def init_linear(gen: torch.Generator, n_in: int, n_out: int) -> dict[str, torch.Tensor]:
    return {"kernel": _normal(gen, (n_in, n_out), (1.0 / n_in) ** 0.5), "bias": torch.zeros(n_out)}


def matmul_fp32(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x @ w`` with both operands rounded to ``dtype`` and an fp32 result.

    The counterpart of ``jnp.dot(..., preferred_element_type=float32)``:
    ``torch.matmul`` on bf16 tensors would round its output to bf16, so the
    rounded operands are widened back to fp32 (exact products, fp32 sums).
    """
    return x.to(dtype).float() @ w.to(dtype).float()


def linear(p, x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return matmul_fp32(x, p["kernel"], dtype) + p["bias"]


def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``. Through ``F.embedding``, whose backward sorts the ids
    and sums each run of duplicates in one pass; on an H100 the backward of
    plain indexing took half the bench workload's train step (PERF.md)."""
    return F.embedding(ids, table)


def input_embeddings(embed, batch: Batch, cfg: ModelConfig) -> torch.Tensor:
    """Sum of POI + time + geo embeddings per input step → [B, T, D]."""
    x = lookup(embed["poi"], batch.poi_in)
    if cfg.use_time_embedding:
        x = x + lookup(embed["time"], batch.time_bucket)
    if cfg.use_geo_embedding:
        x = x + lookup(embed["geo"], batch.geo_bucket)
    return x


def output_table(embed, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """The [V, D] table + [V] bias that queries are scored against."""
    table = embed["poi"] if cfg.tie_output_embedding else embed["out"]
    return table, embed["out_bias"]


def add_user_query(q: torch.Tensor, embed, batch: Batch, cfg: ModelConfig) -> torch.Tensor:
    """Add the user vector to the [B, T, D] scoring query."""
    if cfg.use_user_embedding:
        q = q + lookup(embed["user"], batch.user)[:, None, :]
    return q


def params(d: dict[str, torch.Tensor], device) -> nn.ParameterDict:
    """Trainable parameters; inference runs under ``torch.inference_mode``."""
    return nn.ParameterDict({k: nn.Parameter(v.to(device)) for k, v in d.items()})


class SequenceModel(nn.Module):
    """Embeddings + tower + optional projection to query space.

    Subclasses build ``self.tower``: a module whose ``forward(x, batch)`` maps
    [B, T, D] inputs to [B, T, H] hidden states; it reads what it needs from
    the batch (the mask, and ST-RNN's time-gap and distance buckets).
    """

    def __init__(self, cfg: ModelConfig, dims: DataDims, device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.dims = dims
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.embed = params(init_embed_params(gen, cfg, dims), device)
        self.tower = self.build_tower(gen, device)
        self.proj = None
        if cfg.hidden_dim != cfg.embed_dim or not cfg.tie_output_embedding:
            self.proj = params(init_linear(gen, cfg.hidden_dim, cfg.embed_dim), device)

    def build_tower(self, gen: torch.Generator, device) -> nn.Module:
        raise NotImplementedError

    @property
    def device(self) -> torch.device:
        return self.embed["poi"].device

    def queries(self, batch: Batch, generator: torch.Generator | None = None) -> torch.Tensor:
        """[B, T, D] fp32 scoring queries at every position, the training
        path: embed → tower → projection → user add. ``batch`` holds tensors
        on the model's device (``batch_to``). With a ``generator`` (on the
        model's device), ``model.dropout`` drops out the summed input
        embeddings and the tower output, in that order, as ``poi_tpu``
        does; without one the path is deterministic."""
        x = dropout(input_embeddings(self.embed, batch, self.cfg), self.cfg.dropout, generator)
        h = dropout(self.tower(x, batch), self.cfg.dropout, generator)
        q = linear(self.proj, h, compute_dtype(self.cfg)) if self.proj is not None else h
        return add_user_query(q.float(), self.embed, batch, self.cfg)

    def tower_last(self, x: torch.Tensor, batch: Batch, last: torch.Tensor) -> torch.Tensor:
        """[B, H] hidden state at position ``last`` of each row: the
        recurrence traverses T, then the row's position is selected."""
        h = self.tower(x, batch)
        return h[torch.arange(h.shape[0], device=h.device), last]

    def queries_last(self, batch: Batch) -> torch.Tensor:
        """[B, D] fp32 scoring query at each sequence's final valid position
        (``sum(mask) - 1``, clamped at 0). ``batch`` holds tensors on the
        model's device (``batch_to``)."""
        x = input_embeddings(self.embed, batch, self.cfg)
        last = (batch.mask.to(torch.int32).sum(dim=1) - 1).clamp_min(0)
        h = self.tower_last(x, batch, last)
        q = linear(self.proj, h, compute_dtype(self.cfg)) if self.proj is not None else h
        return add_user_query(q.float()[:, None, :], self.embed, batch, self.cfg)[:, 0]


def build_model(cfg: ModelConfig, dims: DataDims, device=None, generator: torch.Generator | None = None):
    from poi_tpu_torch.models.attention import AttentionModel
    from poi_tpu_torch.models.gru import GRUModel
    from poi_tpu_torch.models.lstm import LSTMModel
    from poi_tpu_torch.models.strnn import STRNNModel

    registry = {"gru": GRUModel, "lstm": LSTMModel, "strnn": STRNNModel, "attention": AttentionModel}
    if cfg.kind not in registry:
        raise KeyError(f"model kind {cfg.kind!r} is not ported yet: have {sorted(registry)}")
    return registry[cfg.kind](cfg, dims, device=device, generator=generator)
