"""The training loop on one device, counterpart of the single-device path
of ``poi_tpu/train/loop.py``.

``Trainer`` owns the model, the loss and the optimizer. A step runs the
queries, the loss and its backward through autograd (the recurrence, CE and
sampled-softmax kernels on a CUDA device, their plain versions on the CPU),
then the optimizer updates the parameters in place: dense Adam (or
adagrad/sgd), or lazy Adam on the tables (``train.table_update=sparse``).
``train`` drives it from the host ``TrainLoader`` or from the
``DeviceSampler`` (``data.sampler=device``).

A step's random draws come from generators on the device keyed by
``(seed, step, stream)``, so a step draws the same numbers whenever it runs:
the negatives (sampled softmax's pool or BPR's [B, T, N] ids, drawn once,
handed to the loss and to lazy Adam's touched rows) and, only when
``model.dropout > 0``, the dropout masks.
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
from poi_tpu_torch.train import sparse_opt
from poi_tpu_torch.train.losses import build_loss_fn, draw_bpr_negatives, draw_sampled_negatives
from poi_tpu_torch.train.state import TrainState, global_norm, make_optimizer
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
    loss_override: Callable | None = None
    # step -> the negatives of that step ([S] pool, or [B, T, N] for BPR);
    # None draws them from the step's generator. A test replays poi_tpu's
    # draws through it.
    negatives: Callable[[int], torch.Tensor] | None = None
    # --debug: raise FloatingPointError on a non-finite loss or grad norm.
    # It reads both every step, so the host waits for the card every step.
    check_finite: bool = False
    model: Any = field(init=False)
    # The host loader of the running train(), so a callback can checkpoint
    # its consumed position; None on the device-sampler path.
    active_loader: Any = field(init=False, default=None)

    def __post_init__(self):
        self.device = model_base.require_device(self.device, "Trainer")
        cfg = self.cfg
        if self.loss_override is not None:
            raise NotImplementedError("loss_override (an injected sharded loss) comes with the multi-GPU layer")
        if cfg.train.table_update not in ("dense", "sparse"):
            raise ValueError(f"unknown train.table_update {cfg.train.table_update!r}")
        if cfg.mesh.model > 1:
            raise NotImplementedError(f"mesh.model={cfg.mesh.model}: vocab-sharded tables come with the multi-GPU layer")
        if sparse_opt.rows_mode_enabled(cfg, self.dims, n_model=1):
            raise NotImplementedError(
                "train.table_update='sparse' on a tied table above "
                f"{sparse_opt.DENSE_LAZY_MAX_BYTES} bytes takes poi_tpu's rows-gradient step, "
                f"not ported yet ({sparse_opt.ROWS_MODE_TODO})"
            )
        # fp32 products stay fp32 on the card (no TF32), as the reference's.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        gen = torch.Generator().manual_seed(cfg.train.seed)
        self.model = model_base.build_model(cfg.model, self.dims, device=self.device, generator=gen)
        self.loss_fn = build_loss_fn(cfg.loss, self.dims.num_pois, cfg.model.embed_dim)
        self.sparse = cfg.train.table_update == "sparse"
        self.optimizer = sparse_opt.SparseTableOptimizer(cfg) if self.sparse else make_optimizer(cfg.train)
        self._gen = {s: torch.Generator(device=self.device) for s in (NEGATIVES_STREAM, DROPOUT_STREAM)}

    def generator(self, step: int, stream: int) -> torch.Generator:
        """The device generator of ``stream``, seeded for ``step``."""
        return self._gen[stream].manual_seed(step_seed(self.cfg.train.seed, step, stream))

    def draw_negatives(self, step: int, batch: Batch | None = None) -> torch.Tensor | None:
        """The step's sampled-softmax pool, or BPR's negatives for each
        position of ``batch``; None for CE."""
        loss = self.cfg.loss
        if loss.kind not in ("sampled_softmax", "bpr"):
            return None
        if self.negatives is not None:
            return self.negatives(step).to(self.device)
        gen = self.generator(step, NEGATIVES_STREAM)
        if loss.kind == "bpr":
            B, T = batch.poi_tgt.shape
            return draw_bpr_negatives(gen, B, T, loss.num_negatives, self.dims.num_pois, self.device)
        return draw_sampled_negatives(gen, loss.num_sampled, self.dims.num_pois, self.device)

    def init_state(self, tree=None) -> TrainState:
        """Step 0 with the model's parameters (``poi_tpu``'s init scales from
        the seeded generator) or, given a ``poi_tpu`` param tree, those."""
        if tree is not None:
            self.model.load_state_dict(params_from_jax(tree))
        params = dict(self.model.named_parameters())
        return TrainState(0, params, self.optimizer.init(params))

    def loss(self, batch: Batch, neg: torch.Tensor | None = None,
             dropout: torch.Generator | None = None) -> torch.Tensor:
        """The objective on ``batch``: ``neg`` is the step's negatives
        (sampled softmax, BPR), ``dropout`` the generator of its dropout
        masks."""
        q = self.model.queries(batch, dropout)
        table, bias = model_base.output_table(self.model.embed, self.cfg.model)
        if neg is None:
            return self.loss_fn(q, table, bias, batch.poi_tgt, batch.mask)
        return self.loss_fn(q, table, bias, batch.poi_tgt, batch.mask, neg)

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
        loss = self.loss(batch, neg, drop)
        if self.check_finite:
            _require_finite("loss", loss, state.step)
        loss.backward()
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p) for k, p in params.items()}
        train = self.cfg.train
        is_log_step = (self.check_finite or (state.step + 1) % max(1, train.log_every) == 0
                       or state.step + 1 == train.num_steps)
        zero = torch.zeros((), device=self.device)
        lr = self.optimizer.lr(state.opt_state["count"])
        if self.sparse:  # lazy Adam computes the exact global norm for its clip: reported every step
            grad_norm = self.optimizer.update(grads, state.opt_state, params, sparse_opt.touched_ids(batch, neg))
        else:
            grad_norm = global_norm(grads.values()) if is_log_step else zero
            self.optimizer.update(grads, state.opt_state, params)
        if self.check_finite:
            _require_finite("grad norm", grad_norm, state.step)
        for p in params.values():
            p.grad = None
        with torch.no_grad():
            param_norm = global_norm(params.values()) if is_log_step else zero
        metrics = {"loss": loss.detach(), "grad_norm": grad_norm, "param_norm": param_norm, "lr": lr}
        return TrainState(state.step + 1, params, state.opt_state), metrics

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


def make_trainer(cfg: Config, dataset: Dataset, device: Any = "cuda") -> Trainer:
    """A Trainer for ``dataset`` on ``device`` (the card unless the caller
    asks for the CPU), with a DeviceSampler when ``data.sampler=device``."""
    device = model_base.require_device(device, "make_trainer")
    sampler = None
    if cfg.data.sampler == "device":
        sampler = DeviceSampler(dataset.train, cfg.train.batch_size, cfg.train.seed, device)
    elif cfg.data.sampler != "host":
        raise ValueError(f"unknown data.sampler {cfg.data.sampler!r} (host|device)")
    return Trainer(cfg, model_base.DataDims.from_dataset(dataset), device=device, sampler=sampler)


def train(
    cfg: Config,
    dataset: Dataset,
    num_steps: int | None = None,
    state: TrainState | None = None,
    trainer: Trainer | None = None,
    callbacks: list[Callable] | None = None,
    device: Any = "cuda",
    loader_state: dict | None = None,
) -> tuple[Trainer, TrainState, list[dict]]:
    """Run the training loop; returns (trainer, final state, metric history).
    Without a ``trainer`` it makes one on ``device``: the card unless the
    caller asks for the CPU (``device="cpu"``). ``loader_state`` (from a
    checkpoint) restores the host loader's position; without it the loader
    seeks to the state's step, which is the same position for this loader."""
    num_steps = num_steps if num_steps is not None else cfg.train.num_steps
    if trainer is None:
        trainer = make_trainer(cfg, dataset, device)
    if state is None:
        state = trainer.init_state()
    start_step = state.step
    if trainer.sampler is not None:
        trainer.active_loader = None
        return _train_sampled(cfg, trainer, state, start_step, num_steps, callbacks)

    loader = make_train_loader(dataset.train, batch_size=cfg.train.batch_size, seed=cfg.train.seed,
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
