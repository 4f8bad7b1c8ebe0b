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
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from poi_tpu_torch.data.pipeline import Batch
from poi_tpu_torch.ops.segment import scatter_sum
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

    def padded_to(self, model_shards: int) -> "DataDims":
        """The catalog padded up to a multiple of ``model_shards`` rows."""
        import dataclasses

        return dataclasses.replace(self, num_pois_padded=-(-self.num_pois // model_shards) * model_shards)

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


def _host_tensor(a) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(np.asarray(a)))
    return t.long() if t.dtype in (torch.int32, torch.int64) else t


def batch_to(batch: Batch, device) -> Batch:
    """A numpy ``Batch`` as tensors on ``device``: ids as int64, floats as is."""
    return Batch(*(_host_tensor(a).to(device) for a in batch))


class InFlight(NamedTuple):
    """Batches whose copy to the card was queued on a side stream
    (``batches_to_pinned``), with the event recorded after it. ``ready()``
    makes the caller's current stream wait for that event and marks the one
    device buffer that every tensor views as used on that stream
    (``record_stream``), so the caching allocator does not hand its memory
    to another tensor while work queued there may still read it."""

    batches: list[Batch]
    buffer: torch.Tensor
    event: torch.cuda.Event

    def ready(self) -> list[Batch]:
        stream = torch.cuda.current_stream(self.buffer.device)
        stream.wait_event(self.event)
        self.buffer.record_stream(stream)
        return self.batches


# Each array's offset in the pinned buffer is a multiple of this, so that
# every view of the device buffer is aligned for its dtype.
_ALIGN = 16


def batches_to_pinned(batches: list[Batch], device: torch.device, stream: torch.cuda.Stream) -> InFlight:
    """``batch_to`` of each of ``batches`` for a CUDA ``device`` in one copy:
    every array is written (ids as int64) into one pinned host buffer, which
    is copied with ``non_blocking=True`` on ``stream``, so the copy overlaps
    the work on the compute stream, and each batch's tensors are views of
    the one device buffer. The caller waits through ``InFlight.ready()``.
    Safe from another thread than the compute loop's."""
    arrays = [np.asarray(a) for b in batches for a in b]
    dtypes = [np.dtype(np.int64) if a.dtype in (np.int32, np.int64) else a.dtype for a in arrays]
    sizes = [a.size * dt.itemsize for a, dt in zip(arrays, dtypes)]
    offsets = np.cumsum([0] + [-(-n // _ALIGN) * _ALIGN for n in sizes]).tolist()
    host = torch.empty(offsets[-1], dtype=torch.uint8, pin_memory=True)
    flat = host.numpy()
    for a, dt, o, n in zip(arrays, dtypes, offsets, sizes):
        np.copyto(flat[o:o + n].view(dt).reshape(a.shape), a)
    with torch.cuda.device(device), torch.cuda.stream(stream):
        buffer = host.to(device, non_blocking=True)
        event = torch.cuda.Event()
        event.record(stream)
    views = [buffer[o:o + n].view(torch.from_numpy(np.empty(0, dt)).dtype).view(a.shape)
             for a, dt, o, n in zip(arrays, dtypes, offsets, sizes)]
    width = len(Batch._fields)
    return InFlight([Batch(*views[i:i + width]) for i in range(0, len(views), width)], buffer, event)


def _normal(gen: torch.Generator, shape, scale: float, meta: bool = False) -> torch.Tensor:
    if meta:  # shapes only: nothing drawn, nothing allocated
        return torch.empty(shape, device="meta")
    return scale * torch.randn(shape, generator=gen, dtype=torch.float32)


def init_embed_params(gen: torch.Generator, cfg: ModelConfig, dims: DataDims, meta: bool = False,
                      shard: slice | None = None) -> dict[str, torch.Tensor]:
    """POI/user/time/geo tables + output bias (+ untied output table), at the
    JAX package's scales. The catalog tables draw ``num_pois`` rows, then
    take zero rows up to ``num_pois_padded`` with a -1e30 bias, so a padded
    catalog draws what the unpadded one draws. ``shard``: keep only those
    rows of the catalog tables (one model rank's block of a vocab-sharded
    table; the whole init is drawn, so every rank draws the same).
    ``meta``: the tables' shapes on the meta device, nothing drawn."""
    scale = 0.02
    d = cfg.embed_dim
    vp = dims.num_pois_padded
    rows = shard if shard is not None else slice(0, vp)

    def catalog(t: torch.Tensor) -> torch.Tensor:
        """Rows ``rows`` of the drawn table ``t`` padded to ``vp`` rows."""
        lo, hi, _ = rows.indices(vp)
        if meta:
            return torch.empty((hi - lo,) + tuple(t.shape[1:]), device="meta")
        if lo == 0 and hi == t.shape[0]:
            return t
        part = t[lo:min(hi, t.shape[0])]
        return torch.cat([part, part.new_zeros((hi - lo - part.shape[0],) + tuple(t.shape[1:]))])

    bias = torch.where(torch.arange(vp) < dims.num_pois, 0.0, -1e30).to(torch.float32)
    p = {"poi": catalog(_normal(gen, (dims.num_pois, d), scale, meta)),
         "out_bias": bias if shard is None else bias[rows].clone()}
    if cfg.use_user_embedding:
        p["user"] = _normal(gen, (dims.num_users, d), scale, meta)
    if cfg.use_time_embedding:
        p["time"] = _normal(gen, (dims.num_time_buckets, d), scale, meta)
    if cfg.use_geo_embedding:
        p["geo"] = _normal(gen, (dims.num_geo_buckets, d), scale, meta)
    if not cfg.tie_output_embedding:
        p["out"] = catalog(_normal(gen, (dims.num_pois, d), scale, meta))
    return p


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None,
            rows: tuple[int, int] | None = None) -> torch.Tensor:
    """Inverted dropout: keep each element with probability 1 - rate and
    scale it by 1 / (1 - rate). The identity without a generator (eval) or
    at rate 0, so one ``queries`` call serves train and eval. ``rows =
    (lo, B)``: ``x`` holds rows ``lo..`` of a batch of B (one data shard's),
    and its masks are those rows of the whole batch's draw."""
    if generator is None or rate <= 0.0:
        return x
    if rows is None:
        keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    else:
        lo, full = rows
        keep = torch.rand((full,) + tuple(x.shape[1:]), generator=generator, device=x.device)[lo:lo + x.shape[0]]
        keep = keep < 1.0 - rate
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


def remat_step(step, remat: bool):
    """``step`` itself, or with ``remat`` wrapped in a non-reentrant
    ``torch.utils.checkpoint``: autograd keeps only the step's inputs and
    recomputes its intermediates in the backward, as ``jax.checkpoint``
    wraps the scan cell in the reference (``model.remat_cell``). The values
    and gradients are the same bits either way."""
    if not remat:
        return step
    from torch.utils.checkpoint import checkpoint

    return lambda *args: checkpoint(step, *args, use_reentrant=False)


def linear(p, x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return matmul_fp32(x, p["kernel"], dtype) + p["bias"]


class _Lookup(torch.autograd.Function):
    """``F.embedding`` forward; the backward sums each id's rows in a fixed
    order (``ops.segment.scatter_sum``)."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.num_rows = table.shape[0]
        return F.embedding(ids, table)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        return scatter_sum(ids, g, ctx.num_rows), None


def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``. The backward sums each id's rows in a fixed order, so
    a run gives the same bits every time: the card's ``F.embedding``
    backward gave other bits from run to run where many ids fall on few
    rows (8,192 ids into config #4's 168-row time table, PERF.md)."""
    return _Lookup.apply(table, ids)


def gather_rows(table: torch.Tensor, bias: torch.Tensor, ids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(table[ids], bias[ids])``: a loss's positive and negative rows in
    one lookup each, so each table's backward is one sorted sum."""
    return lookup(table, ids), lookup(bias[:, None], ids)[..., 0]


def input_embeddings(embed, batch: Batch, cfg: ModelConfig, poi_rows: torch.Tensor | None = None,
                     poi_lookup=None) -> torch.Tensor:
    """Sum of POI + time + geo embeddings per input step → [B, T, D].
    ``poi_rows`` ([B, T, D] = the POI table's rows at ``batch.poi_in``)
    stands in for the POI lookup where the caller gathered them: the
    rows-gradient train step differentiates those rows, so the table's
    dense gradient never exists. ``poi_lookup(table, ids)`` reads the POI
    table (``lookup``, or a vocab-sharded table's ``ops.embedding`` lookup)."""
    x = poi_rows if poi_rows is not None else (poi_lookup or lookup)(embed["poi"], batch.poi_in)
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

    def __init__(self, cfg: ModelConfig, dims: DataDims, device=None, generator: torch.Generator | None = None,
                 shard: slice | None = None, poi_lookup=None):
        super().__init__()
        self.cfg = cfg
        self.dims = dims
        # A vocab-sharded model holds its rows ``shard`` of the catalog
        # tables and reads the POI table through ``poi_lookup``.
        self.poi_lookup = poi_lookup or lookup
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        meta = device is not None and torch.device(device).type == "meta"
        self.embed = params(init_embed_params(gen, cfg, dims, meta, shard), device)
        self.tower = self.build_tower(gen, device)
        self.proj = None
        if cfg.hidden_dim != cfg.embed_dim or not cfg.tie_output_embedding:
            self.proj = params(init_linear(gen, cfg.hidden_dim, cfg.embed_dim), device)

    def build_tower(self, gen: torch.Generator, device) -> nn.Module:
        raise NotImplementedError

    @property
    def device(self) -> torch.device:
        return self.embed["poi"].device

    def queries(self, batch: Batch, generator: torch.Generator | None = None,
                poi_rows: torch.Tensor | None = None, dropout_rows: tuple[int, int] | None = None) -> torch.Tensor:
        """[B, T, D] fp32 scoring queries at every position, the training
        path: embed → tower → projection → user add. ``batch`` holds tensors
        on the model's device (``batch_to``). With a ``generator`` (on the
        model's device), ``model.dropout`` drops out the summed input
        embeddings and the tower output, in that order, as ``poi_tpu``
        does; without one the path is deterministic. ``poi_rows``:
        pre-gathered input rows, as for ``input_embeddings``. ``dropout_rows``:
        ``dropout``'s ``rows`` (a data shard's rows of the batch)."""
        x = input_embeddings(self.embed, batch, self.cfg, poi_rows, self.poi_lookup)
        x = dropout(x, self.cfg.dropout, generator, dropout_rows)
        h = dropout(self.tower(x, batch), self.cfg.dropout, generator, dropout_rows)
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
        x = input_embeddings(self.embed, batch, self.cfg, poi_lookup=self.poi_lookup)
        last = (batch.mask.to(torch.int32).sum(dim=1) - 1).clamp_min(0)
        h = self.tower_last(x, batch, last)
        q = linear(self.proj, h, compute_dtype(self.cfg)) if self.proj is not None else h
        return add_user_query(q.float()[:, None, :], self.embed, batch, self.cfg)[:, 0]


def require_device(device, what: str) -> torch.device:
    """``device`` as a ``torch.device``. The entry points run on the card
    unless the caller asks for the CPU: a CUDA device on a machine without
    CUDA raises here, before any work, and does not fall back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what}: device {str(device)!r}, but CUDA is not available; pass device=\"cpu\" to run "
                           "on the CPU")
    return device


def build_model(cfg: ModelConfig, dims: DataDims, device="cuda", generator: torch.Generator | None = None,
                shard: slice | None = None, poi_lookup=None):
    """The model of ``cfg.kind`` with its parameters on ``device`` (the card
    unless the caller asks for the CPU); ``shard`` and ``poi_lookup`` as
    for ``SequenceModel``."""
    from poi_tpu_torch.models.attention import AttentionModel
    from poi_tpu_torch.models.gru import GRUModel
    from poi_tpu_torch.models.lstm import LSTMModel
    from poi_tpu_torch.models.strnn import STRNNModel

    device = require_device(device, "build_model")
    registry = {"gru": GRUModel, "lstm": LSTMModel, "strnn": STRNNModel, "attention": AttentionModel}
    if cfg.kind not in registry:
        raise KeyError(f"model kind {cfg.kind!r} is not ported yet: have {sorted(registry)}")
    return registry[cfg.kind](cfg, dims, device=device, generator=generator, shard=shard, poi_lookup=poi_lookup)
