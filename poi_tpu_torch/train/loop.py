"""The training loop, counterpart of ``poi_tpu/train/loop.py``: on one
device, or as one rank of a ``(data, model)`` mesh on ``torch.distributed``.

``Trainer`` owns the model, the loss and the optimizer. A step runs the
queries, the loss and its backward through autograd (the recurrence, CE and
sampled-softmax kernels on a CUDA device, their plain versions on the CPU),
then the optimizer updates the parameters in place: dense Adam (or
adagrad/sgd), or lazy Adam on the tables (``train.table_update=sparse``).
``train`` drives it from the host ``TrainLoader`` or from the
``DeviceSampler`` (``data.sampler=device``).

Where ``sparse_opt.rows_mode_enabled`` holds (lazy Adam on a tied table
above ``DENSE_LAZY_MAX_BYTES``, config #5), a step differentiates the
gathered table rows instead of the table (``Trainer._rows_loss``, the
reference's ``_rows_step``): the POI table's and output bias's dense
gradients never exist, and lazy Adam takes one gradient row per id
occurrence.

A step's random draws come from generators on the device keyed by
``(seed, step, stream)``, so a step draws the same numbers whenever it runs:
the negatives (sampled softmax's pool or BPR's [B, T, N] ids, drawn once,
handed to the loss and to lazy Adam's touched rows) and, only when
``model.dropout > 0``, the dropout masks.

On a mesh (``Trainer(mesh=...)``), each rank holds its data shard's rows of
the batch and its model shard's rows of the catalog tables
(``parallel.shardings``): the POI table is read through the mesh's lookup
(``ops.embedding``), the loss is the sharded one of ``loss.kind``
(``ops.sharded_loss``), each rank's loss is its part of the global masked
mean, and the gradients are summed over ``data``. The global draws (the
device sampler's batch, BPR's negatives, the dropout masks) are drawn for
the whole batch on every rank, which keeps its rows, and the pool is the
same on every rank, so a mesh run sees a one-device run's batches. Every
rank draws the same full init and keeps its rows. Lazy Adam updates the
rows its rank holds that any data rank touched, and the clip's global norm
counts each sharded tensor once over ``model``. With ``model.attn_impl``
ring or ulysses, the attention tower's time axis is split over ``model``
(``parallel.sp_attention``). A 1 x 1 mesh is the one-device path.
"""

from __future__ import annotations

import logging
import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from poi_tpu_torch.convert import params_from_jax
from poi_tpu_torch.data.dataset import Dataset
from poi_tpu_torch.data.device_sampler import DeviceSampler, step_seed
from poi_tpu_torch.data.pipeline import Batch, make_train_loader
from poi_tpu_torch.models import base as model_base
from poi_tpu_torch.ops import sharded_loss
from poi_tpu_torch.ops.embedding import lookup_overflow_count, make_lookup
from poi_tpu_torch.ops.fused_sampled import fused_sampled_softmax_loss, log_q, sampled_nll_rows
from poi_tpu_torch.parallel import collectives as cc
from poi_tpu_torch.parallel import sp_attention
from poi_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, local_data_batch, rank_device
from poi_tpu_torch.parallel.shardings import CATALOG_TABLES, shard_state
from poi_tpu_torch.train import sparse_opt
from poi_tpu_torch.train.losses import (build_loss_fn, draw_bpr_negatives, draw_sampled_negatives, masked_mean,
                                        sampled_nll)
from poi_tpu_torch.train.state import TrainState, make_optimizer, mesh_norm
from poi_tpu_torch.utils.config import Config

# Generator streams of a step's key (seed, step, stream).
NEGATIVES_STREAM = 1
DROPOUT_STREAM = 2

log = logging.getLogger(__name__)


class FaultInjected(RuntimeError):
    """Raised by --set train.fault_inject_step=N to exercise the resume path."""


@dataclass
class Trainer:
    cfg: Config
    dims: model_base.DataDims
    device: Any = "cuda"  # the card unless the caller asks for the CPU
    sampler: DeviceSampler | None = None  # batches drawn on the device (data.sampler=device)
    # loss(q, table, bias, targets, mask[, neg]) in place of the dispatch
    # by loss.kind (on a mesh it sees this rank's rows and shard).
    loss_override: Callable | None = None
    # step -> the negatives of that step ([S] pool, or the whole batch's
    # [B, T, N] for BPR); None draws them from the step's generator. A test
    # replays poi_tpu's draws through it.
    negatives: Callable[[int], torch.Tensor] | None = None
    # --debug: raise FloatingPointError on a non-finite loss or grad norm.
    # It reads both every step, so the host waits for the card every step.
    check_finite: bool = False
    # The (data, model) mesh; None makes it from cfg.mesh over the process
    # group's ranks (1 x 1 without one).
    mesh: Mesh | None = None
    model: Any = field(init=False)
    # The host loader of the running train(), so a callback can checkpoint
    # its consumed position; None on the device-sampler path.
    active_loader: Any = field(init=False, default=None)

    def __post_init__(self):
        cfg = self.cfg
        self.device = model_base.require_device(rank_device(self.device), "Trainer")
        if cfg.train.table_update not in ("dense", "sparse"):
            raise ValueError(f"unknown train.table_update {cfg.train.table_update!r}")
        if self.mesh is None:
            self.mesh = Mesh(cfg.mesh.data, cfg.mesh.model)
        mesh = self.mesh
        n_model, n_data = mesh.shape[MODEL_AXIS], mesh.shape[DATA_AXIS]
        if n_model > 1:
            self.dims = self.dims.padded_to(n_model)
        sp = cfg.model.kind == "attention" and cfg.model.attn_impl in sp_attention.IMPLS
        if sp and n_model == 1:
            log.info("model.attn_impl=%r requested but the mesh's model axis is 1; taking single-device blockwise "
                     "attention", cfg.model.attn_impl)
        # fp32 products stay fp32 on the card (no TF32), as the reference's.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # The POI table's lookup on a vocab-sharded mesh (mesh.embedding_mode).
        lookup = make_lookup(mesh, cfg.mesh.embedding_mode, cfg.mesh.a2a_capacity_factor) if n_model > 1 else None
        gen = torch.Generator().manual_seed(cfg.train.seed)
        shard = mesh.rows(self.dims.num_pois_padded) if n_model > 1 else None
        self.model = model_base.build_model(cfg.model, self.dims, device=self.device, generator=gen, shard=shard,
                                            poi_lookup=lookup)
        if sp and n_model > 1:  # the attention's time axis split over the model axis
            self.model.tower.sp_mha = sp_attention.make_sp_attention(
                mesh, cfg.model.attn_heads, cfg.model.attn_window, cfg.model.attn_impl,
                model_base.compute_dtype(cfg.model))
        # The parameters that hold this rank's rows of a catalog table.
        self.sharded = {k for k, _ in self.model.named_parameters() if k in CATALOG_TABLES} if n_model > 1 else set()
        # Each rank's loss is its part of the whole batch's masked mean.
        self.mean = sharded_loss.make_global_mean(mesh) if n_data > 1 else masked_mean
        self.loss_fn = self.loss_override or self._mesh_loss(lookup)
        self.sparse = cfg.train.table_update == "sparse"
        self.optimizer = sparse_opt.SparseTableOptimizer(cfg) if self.sparse else make_optimizer(cfg.train)
        if self.sharded:
            self.optimizer.norm = self.norm
            if self.sparse:
                self.optimizer.table_scale = n_model
        # The rows-gradient step, and whether its NLL takes the kernels: where
        # the loss would (build_loss_fn's dispatch), on a CUDA device. It
        # runs on one model shard, as the reference's.
        self.rows_mode = sparse_opt.rows_mode_enabled(cfg, self.dims, n_model=n_model)
        self.rows_fused = (self.device.type == "cuda"
                           and getattr(self.loss_fn, "func", None) is fused_sampled_softmax_loss)
        self.a2a = n_model > 1 and cfg.mesh.embedding_mode == "a2a"
        self._gen: dict[int, torch.Generator] = {}

    def _mesh_loss(self, lookup: Callable | None) -> Callable:
        """The loss of ``loss.kind``: ``build_loss_fn``'s on one model
        rank, the sharded one of ``ops.sharded_loss`` on several."""
        cfg, mesh = self.cfg, self.mesh
        if mesh.shape[MODEL_AXIS] == 1:
            return build_loss_fn(cfg.loss, self.dims.num_pois, cfg.model.embed_dim, mean=self.mean)
        kind = cfg.loss.kind
        if kind == "ce":
            return sharded_loss.make_sharded_ce(mesh, self.mean)
        if kind == "bpr":
            return sharded_loss.make_sharded_bpr(lookup, self.mean)
        if kind == "sampled_softmax":
            return sharded_loss.make_sharded_sampled_softmax(
                mesh, lookup, cfg.loss.num_sampled, self.dims.num_pois, self.mean,
                fused={"auto": "auto", "fused": "on", "xla": "off"}[cfg.loss.impl], embed_dim=cfg.model.embed_dim)
        raise ValueError(f"unknown loss {kind!r}")

    def norm(self, named: dict[str, torch.Tensor]) -> torch.Tensor:
        """The global norm of parameters or gradients by name: each sharded
        tensor's squares summed over ``model``, each replicated one once."""
        return mesh_norm(named, self.sharded, lambda t: cc.all_reduce_(t, self.mesh, MODEL_AXIS))

    def batch_rows(self, batch: Batch) -> tuple[int, int] | None:
        """``(lo, B)``: this rank's batch is rows ``lo..`` of the global B;
        None on one data rank."""
        n_data = self.mesh.shape[DATA_AXIS]
        if n_data == 1:
            return None
        b = batch.poi_tgt.shape[0]
        return self.mesh.index[DATA_AXIS] * b, b * n_data

    def generator(self, step: int, stream: int) -> torch.Generator:
        """The device generator of ``stream``, seeded for ``step``."""
        if stream not in self._gen:
            self._gen[stream] = torch.Generator(device=self.device)
        return self._gen[stream].manual_seed(step_seed(self.cfg.train.seed, step, stream))

    def draw_negatives(self, step: int, batch: Batch | None = None) -> torch.Tensor | None:
        """The step's sampled-softmax pool, or BPR's negatives for each
        position of ``batch``; None for CE."""
        loss = self.cfg.loss
        if loss.kind not in ("sampled_softmax", "bpr"):
            return None
        if self.negatives is not None:
            neg = self.negatives(step).to(self.device)
            rows = self.batch_rows(batch) if loss.kind == "bpr" else None
            return neg if rows is None else neg[rows[0]:rows[0] + batch.poi_tgt.shape[0]]
        gen = self.generator(step, NEGATIVES_STREAM)
        if loss.kind == "bpr":
            B, T = batch.poi_tgt.shape
            rows = self.batch_rows(batch)
            if rows is None:
                return draw_bpr_negatives(gen, B, T, loss.num_negatives, self.dims.num_pois, self.device)
            neg = draw_bpr_negatives(gen, rows[1], T, loss.num_negatives, self.dims.num_pois, self.device)
            return neg[rows[0]:rows[0] + B]
        return draw_sampled_negatives(gen, loss.num_sampled, self.dims.num_pois, self.device)

    def init_state(self, tree=None) -> TrainState:
        """Step 0 with the model's parameters (``poi_tpu``'s init scales from
        the seeded generator) or, given a ``poi_tpu`` param tree (the full
        catalog's), this rank's shard of those."""
        if tree is not None:
            self.model.load_state_dict(shard_state(params_from_jax(tree), self.mesh, self.dims.num_pois_padded))
        params = dict(self.model.named_parameters())
        return TrainState(0, params, self.optimizer.init(params))

    def loss(self, batch: Batch, neg: torch.Tensor | None = None,
             dropout: torch.Generator | None = None) -> torch.Tensor:
        """The objective on ``batch`` (this rank's part of it on a mesh):
        ``neg`` is the step's negatives (sampled softmax, BPR), ``dropout``
        the generator of its dropout masks."""
        q = self.model.queries(batch, dropout, dropout_rows=self.batch_rows(batch))
        table, bias = model_base.output_table(self.model.embed, self.cfg.model)
        if neg is None:
            return self.loss_fn(q, table, bias, batch.poi_tgt, batch.mask)
        return self.loss_fn(q, table, bias, batch.poi_tgt, batch.mask, neg)

    def _rows_loss(self, batch: Batch, neg: torch.Tensor, dropout: torch.Generator | None):
        """The objective of the rows-gradient step, the reference's
        ``_rows_step``: every POI-table and bias row the step reads (inputs,
        targets, the pool) gathered once, as leaves that require grad.
        Returns the loss, the two leaves and their occurrence ids."""
        cfg = self.cfg
        B, T = batch.poi_tgt.shape
        BT = B * T
        ids_all = torch.cat([batch.poi_in.reshape(-1), batch.poi_tgt.reshape(-1), neg.reshape(-1)])
        embed = self.model.embed
        rows = embed["poi"].detach().index_select(0, ids_all).requires_grad_()
        brows = embed["out_bias"].detach().index_select(0, ids_all).requires_grad_()
        q = self.model.queries(batch, dropout, poi_rows=rows[:BT].reshape(B, T, -1),
                               dropout_rows=self.batch_rows(batch))
        e_pos, b_pos = rows[BT:2 * BT].reshape(B, T, -1), brows[BT:2 * BT].reshape(B, T)
        e_neg, b_neg = rows[2 * BT:], brows[2 * BT:]
        s_pos = (q.float() * e_pos.float()).sum(dim=-1) + b_pos
        S, V = cfg.loss.num_sampled, self.dims.num_pois
        if self.rows_fused:
            nll = sampled_nll_rows(q.reshape(BT, -1), e_neg, b_neg - log_q(S, V), s_pos.reshape(-1),
                                   batch.poi_tgt.reshape(-1), neg).reshape(B, T)
        else:
            nll = sampled_nll(q, e_neg, b_neg, s_pos, batch.poi_tgt, neg, S, V)
        return self.mean(nll, batch.mask), (rows, brows), ids_all

    def step(self, state: TrainState, batch: Batch) -> tuple[TrainState, dict]:
        """One train step on a host (numpy) or device batch. The parameter
        and gradient norms are computed only on log steps (0.0 elsewhere):
        nothing else reads them. ``lr`` is the host float the schedule gave:
        copying it to the device would wait for the step to finish."""
        if isinstance(batch.poi_in, np.ndarray):
            batch = model_base.batch_to(batch, self.device)
        params = state.params
        for p in params.values():
            p.grad = None
        neg = self.draw_negatives(state.step, batch)
        drop = self.generator(state.step, DROPOUT_STREAM) if self.cfg.model.dropout > 0.0 else None
        if self.rows_mode:
            loss, leaves, ids_all = self._rows_loss(batch, neg, drop)
        else:
            loss = self.loss(batch, neg, drop)
        if self.check_finite:
            _require_finite("loss", loss, state.step)
        loss.backward()
        mesh = self.mesh
        row_grads, row_tables = None, ()
        if self.rows_mode:
            row_tables = ("embed.poi", "embed.out_bias")
            # The point of the rows step: the tables' dense gradients never exist.
            assert all(params[k].grad is None for k in row_tables), "the rows step made a dense table gradient"
            row_grads = {"poi": (ids_all, leaves[0].grad), "out_bias": (ids_all, leaves[1].grad)}
            touched = {"user": batch.user.reshape(-1)} if batch.user is not None else {}
        elif self.sparse:
            touched = sparse_opt.touched_ids(batch, neg)
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p) for k, p in params.items()
                 if k not in row_tables}
        if mesh.shape[DATA_AXIS] > 1:
            with torch.no_grad():
                _sum_over_data(grads, mesh)
                if self.sparse:  # every data rank updates the rows any of them touched
                    touched = {k: cc.all_gather(t, mesh, DATA_AXIS) for k, t in touched.items()}
                if row_grads:  # one gradient row an occurrence: every data rank's occurrences
                    row_grads = {k: tuple(cc.all_gather(t, mesh, DATA_AXIS) for t in v) for k, v in row_grads.items()}
        if self.sharded and self.sparse:
            touched["poi"] = self._local_rows(touched["poi"])
        train = self.cfg.train
        is_log_step = (self.check_finite or (state.step + 1) % max(1, train.log_every) == 0
                       or state.step + 1 == train.num_steps)
        zero = torch.zeros((), device=self.device)
        lr = self.optimizer.lr(state.opt_state["count"])
        if self.sparse:  # lazy Adam computes the exact global norm for its clip: reported every step
            grad_norm = self.optimizer.update(grads, state.opt_state, params, touched, row_grads)
        else:
            grad_norm = self.optimizer.norm(grads) if is_log_step else zero
            self.optimizer.update(grads, state.opt_state, params)
        if self.check_finite:
            _require_finite("grad norm", grad_norm, state.step)
        for p in params.values():
            p.grad = None
        with torch.no_grad():
            param_norm = self.optimizer.norm(params) if is_log_step else zero
            # Each data rank's loss is its part of the global mean.
            loss = cc.all_reduce_(loss.detach().clone(), mesh, DATA_AXIS) if mesh.shape[DATA_AXIS] > 1 else loss
        metrics = {"loss": loss.detach(), "grad_norm": grad_norm, "param_norm": param_norm, "lr": lr}
        if self.a2a:
            metrics["a2a_overflow"] = self.a2a_overflow(batch)
        return TrainState(state.step + 1, params, state.opt_state), metrics

    def _local_rows(self, ids: torch.Tensor) -> torch.Tensor:
        """Catalog ids as this rank's rows of the sharded tables; an id
        another rank holds becomes the row count (touches none)."""
        rows = self.dims.num_pois_padded // self.mesh.shape[MODEL_AXIS]
        local = ids - self.mesh.index[MODEL_AXIS] * rows
        return torch.where((local >= 0) & (local < rows), local, rows)

    @torch.no_grad()
    def a2a_overflow(self, batch: Batch) -> torch.Tensor:
        """The fraction of the global batch's input ids that the a2a
        lookup dropped this step (the reference's capacity metric)."""
        mesh = self.mesh
        m = mesh.shape[MODEL_AXIS]
        over = lookup_overflow_count(batch.poi_in, m, self.dims.num_pois_padded // m,
                                     self.cfg.mesh.a2a_capacity_factor).float()
        over = cc.all_reduce_(over, mesh, DATA_AXIS)
        return over / max(batch.poi_in.numel() * mesh.shape[DATA_AXIS], 1)

    def step_sampled(self, state: TrainState, num_steps: int) -> tuple[TrainState, dict]:
        """``num_steps`` steps on device-sampled batches; metrics stacked
        [num_steps] (``lr`` on the host). The host reads nothing from the
        device in between."""
        if self.sampler is None:
            raise ValueError("Trainer.step_sampled needs a DeviceSampler")
        rows = []
        for _ in range(num_steps):
            state, metrics = self.step(state, self.sampler.sample(state.step))
            rows.append(metrics)
        return state, {k: torch.stack([r[k] for r in rows]) if torch.is_tensor(rows[0][k])
                       else torch.tensor([r[k] for r in rows]) for k in rows[0]}


def _sum_over_data(grads: dict[str, torch.Tensor], mesh: Mesh) -> None:
    """Each gradient summed over the data axis in place, in one all-reduce
    of their concatenation."""
    flat = torch.cat([g.reshape(-1).float() for g in grads.values()])
    cc.all_reduce_(flat, mesh, DATA_AXIS)
    at = 0
    for g in grads.values():
        g.copy_(flat[at:at + g.numel()].view_as(g))
        at += g.numel()


def _require_finite(what: str, value: torch.Tensor, step: int) -> None:
    if not bool(torch.isfinite(value)):
        raise FloatingPointError(f"non-finite {what} ({float(value.detach())}) at step {step}")


def _aligned_steps_per_call(cfg: Config, callbacks) -> int:
    """Chunk length that never strides across a checkpoint/eval/log boundary
    (callbacks see the state only at chunk ends)."""
    spc = max(1, cfg.train.steps_per_call)
    if spc == 1 or not callbacks:
        return spc
    g = 0
    for p in (cfg.train.log_every, cfg.train.checkpoint_every, cfg.train.eval_every):
        if p and p > 0:
            g = math.gcd(g, p)
    if g == 0:
        return spc
    k = min(spc, g)
    while g % k:
        k -= 1
    if k != spc:
        log.info("steps_per_call %d -> %d (aligned to checkpoint/eval/log boundaries)", spc, k)
    return k


def _log_row(row: dict) -> None:
    log.info("step %d loss %.4f grad %.3f %.1f seq/s", row["step"], row["loss"], row["grad_norm"],
             row["seqs_per_sec"])


def _train_sampled(cfg, trainer, state, start_step, num_steps, callbacks):
    """Device-sampler loop: chunks of ``steps_per_call`` steps, metrics read
    back once per chunk that holds a log boundary."""
    history: list[dict] = []
    end = start_step + num_steps
    fault = cfg.train.fault_inject_step
    spc = _aligned_steps_per_call(cfg, callbacks)
    t0 = time.perf_counter()
    seqs = 0
    i = start_step
    while i < end:
        if fault == i:
            raise FaultInjected(f"fault injected at step {i}")
        k = min(spc, end - i)
        if callbacks:
            k = min(k, spc - i % spc)  # realign after an odd resume point
        if fault > i:
            k = min(k, fault - i)
        state, metrics_k = trainer.step_sampled(state, k)
        seqs += k * cfg.train.batch_size
        i += k
        bounds = [j for j in range(1, k + 1) if (i - k + j) % cfg.train.log_every == 0 or (i - k + j) == end]
        if bounds:
            # Reading the values waits for the device: it must come BEFORE
            # the clock, or the rate would time the launches, not the work.
            rows = [{m: float(v[j - 1]) for m, v in metrics_k.items()} for j in bounds]
            rate = seqs / max(time.perf_counter() - t0, 1e-9)
            for j, row in zip(bounds, rows):
                row.update(step=i - k + j, seqs_per_sec=rate)
                history.append(row)
                _log_row(row)
            t0, seqs = time.perf_counter(), 0
        for cb in callbacks or []:
            cb(i, state, {m: v[-1] for m, v in metrics_k.items()})
    return trainer, state, history


def make_trainer(cfg: Config, dataset: Dataset, device: Any = "cuda", mesh: Mesh | None = None) -> Trainer:
    """A Trainer for ``dataset`` on ``device`` (the card unless the caller
    asks for the CPU; this rank's card under a launcher), with a
    DeviceSampler when ``data.sampler=device``. ``mesh``: as for
    ``Trainer``; the sampler keeps this rank's data rows."""
    device = model_base.require_device(rank_device(device), "make_trainer")
    mesh = mesh if mesh is not None else Mesh(cfg.mesh.data, cfg.mesh.model)
    sampler = None
    if cfg.data.sampler == "device":
        rows = mesh.rows(cfg.train.batch_size, DATA_AXIS) if mesh.shape[DATA_AXIS] > 1 else None
        sampler = DeviceSampler(dataset.train, cfg.train.batch_size, cfg.train.seed, device, rows=rows)
    elif cfg.data.sampler != "host":
        raise ValueError(f"unknown data.sampler {cfg.data.sampler!r} (host|device)")
    return Trainer(cfg, model_base.DataDims.from_dataset(dataset), device=device, sampler=sampler, mesh=mesh)


def train(
    cfg: Config,
    dataset: Dataset,
    num_steps: int | None = None,
    state: TrainState | None = None,
    trainer: Trainer | None = None,
    callbacks: list[Callable] | None = None,
    device: Any = "cuda",
    loader_state: dict | None = None,
    mesh: Mesh | None = None,
) -> tuple[Trainer, TrainState, list[dict]]:
    """Run the training loop; returns (trainer, final state, metric history).
    Without a ``trainer`` it makes one on ``device`` and ``mesh``
    (``make_trainer``): the card unless the caller asks for the CPU
    (``device="cpu"``). ``loader_state`` (from a checkpoint) restores the
    host loader's position; without it the loader seeks to the state's
    step, which is the same position for this loader. On a mesh the host
    loader is the data rank's (``host_id``/``num_hosts`` of the data axis),
    with its share of the batch."""
    num_steps = num_steps if num_steps is not None else cfg.train.num_steps
    if trainer is None:
        trainer = make_trainer(cfg, dataset, device, mesh)
    if state is None:
        state = trainer.init_state()
    start_step = state.step
    if trainer.sampler is not None:
        trainer.active_loader = None
        return _train_sampled(cfg, trainer, state, start_step, num_steps, callbacks)

    m = trainer.mesh
    loader = make_train_loader(dataset.train, batch_size=local_data_batch(cfg.train.batch_size, m),
                               seed=cfg.train.seed, host_id=m.index[DATA_AXIS], num_hosts=m.shape[DATA_AXIS],
                               backend=cfg.data.loader_backend)
    trainer.active_loader = loader
    if loader_state:
        loader.restore(loader_state)
    elif start_step:
        loader.seek(start_step)  # step N always sees batch N
    history: list[dict] = []
    end = start_step + num_steps
    fault = cfg.train.fault_inject_step
    t0 = time.perf_counter()
    seqs = 0
    try:
        for i in range(start_step, end):
            if fault == i:
                raise FaultInjected(f"fault injected at step {i}")
            state, metrics = trainer.step(state, next(loader))
            seqs += cfg.train.batch_size
            if (i + 1) % cfg.train.log_every == 0 or i + 1 == end:
                row = {k: float(v) for k, v in metrics.items()}  # waits for the device, before the clock
                row.update(step=i + 1, seqs_per_sec=seqs / max(time.perf_counter() - t0, 1e-9))
                history.append(row)
                _log_row(row)
                t0, seqs = time.perf_counter(), 0
            for cb in callbacks or []:
                cb(i + 1, state, metrics)
    finally:
        loader.close()
    return trainer, state, history
