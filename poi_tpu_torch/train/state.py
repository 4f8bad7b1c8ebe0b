"""Train state, learning-rate schedules and optimizers, counterpart of
``poi_tpu/train/state.py``.

The update rules are optax's (``clip_by_global_norm`` → ``adam`` / ``adamw``
/ ``adagrad`` / ``sgd`` → ``scale_by_learning_rate``) written out as tensor
operations. As in optax, the schedule is read at the optimizer's own count,
which starts at 0, so a run with warmup makes its first update at lr 0.
Parameters and optimizer state are updated in place: the model owns the
parameters, and ``TrainState`` holds handles to them.
"""

from __future__ import annotations

import logging
import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from poi_tpu_torch.utils.config import TrainConfig

log = logging.getLogger(__name__)

OPTIMIZERS = ("adam", "adagrad", "sgd")
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults
ADAGRAD_INIT, ADAGRAD_EPS = 0.1, 1e-7  # optax.adagrad's defaults


class TrainState(NamedTuple):
    step: int
    params: dict[str, torch.nn.Parameter]  # the model's parameters, by state_dict name
    opt_state: dict


_F = np.float32  # optax evaluates its schedules in float32


def _linear(init: float, end: float, steps: int, step: int) -> float:
    """``optax.linear_schedule`` at ``step``, in float32 like optax."""
    frac = _F(1) - _F(min(max(step, 0), steps)) / _F(steps)
    return float(_F(init - end) * frac + _F(end))


def lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """The schedule as a callable(step) -> lr, with optax's formulas and the
    TPU package's clamp of the default warmup on short cosine runs."""
    peak = cfg.learning_rate
    if cfg.lr_schedule == "cosine":
        warmup = cfg.warmup_steps
        if warmup > cfg.num_steps // 2:
            if warmup == TrainConfig.warmup_steps:
                warmup = cfg.num_steps // 10
                log.warning("warmup_steps=%d (the default) exceeds half of num_steps=%d; clamping warmup to %d",
                            cfg.warmup_steps, cfg.num_steps, warmup)
            else:
                raise ValueError(
                    f"train.warmup_steps={cfg.warmup_steps} exceeds half the run (num_steps={cfg.num_steps}); "
                    "cosine decay would never meaningfully start"
                )
        decay = cfg.num_steps - warmup
        if decay <= 0:
            raise ValueError(f"cosine schedule needs num_steps > warmup_steps, got {cfg.num_steps} <= {warmup}")
        end = cfg.lr_min_frac * peak
        alpha = 0.0 if peak == 0.0 else end / peak

        def cosine(step: int) -> float:
            if step < warmup:
                return _linear(0.0, peak, warmup, step)
            count = _F(min(step - warmup, decay))
            decayed = _F(0.5) * (_F(1) + np.cos(_F(math.pi) * count / _F(decay)))
            return float(_F(peak) * (_F(1.0 - alpha) * decayed + _F(alpha)))

        return cosine
    if cfg.lr_schedule != "constant":
        raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")
    if cfg.warmup_steps > 0:
        return lambda step: _linear(0.0, peak, cfg.warmup_steps, step)
    return lambda step: float(_F(peak))


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (``optax.global_norm``)."""
    return torch.sqrt(sum((t.float() * t.float()).sum() for t in tensors))


class Optimizer:
    """Global-norm clip, then adam / adamw / adagrad / sgd, then the
    scheduled learning rate, as ``poi_tpu.train.state.make_optimizer``
    chains them in optax."""

    def __init__(self, cfg: TrainConfig):
        if cfg.optimizer not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
        self.kind = cfg.optimizer
        self.lr = lr_schedule(cfg)
        self.clip = cfg.grad_clip_norm
        self.weight_decay = cfg.weight_decay if cfg.optimizer == "adam" else 0.0

    def init(self, params: dict[str, torch.Tensor]) -> dict:
        state: dict = {"count": 0}
        if self.kind == "adam":
            state["mu"] = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
            state["nu"] = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
        elif self.kind == "adagrad":
            state["sum_of_squares"] = {k: torch.full_like(p, ADAGRAD_INIT, dtype=torch.float32)
                                       for k, p in params.items()}
        return state

    @torch.no_grad()
    def update(self, grads: dict[str, torch.Tensor], state: dict, params: dict[str, torch.Tensor]) -> None:
        """One update of ``params`` and ``state``, in place."""
        if self.clip > 0:
            norm = global_norm(grads.values())
            keep = norm < self.clip
            grads = {k: torch.where(keep, g, g / norm * self.clip) for k, g in grads.items()}
        count = state["count"]
        lr = self.lr(count)
        count_inc = count + 1
        if self.kind == "adam":
            bc1 = float(np.float32(1.0) - np.float32(ADAM_B1) ** np.float32(count_inc))
            bc2 = float(np.float32(1.0) - np.float32(ADAM_B2) ** np.float32(count_inc))
        for k, p in params.items():
            g = grads[k]
            if self.kind == "adam":
                mu = state["mu"][k]
                nu = state["nu"][k]
                mu.copy_((1.0 - ADAM_B1) * g + ADAM_B1 * mu)
                nu.copy_((1.0 - ADAM_B2) * (g * g) + ADAM_B2 * nu)
                upd = (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)
                if self.weight_decay:
                    upd = upd + self.weight_decay * p
            elif self.kind == "adagrad":
                sos = state["sum_of_squares"][k]
                sos.add_(g * g)
                upd = torch.where(sos > 0, torch.rsqrt(sos + ADAGRAD_EPS), 0.0) * g
            else:
                upd = g
            p.add_(-lr * upd)
        state["count"] = count_inc


def make_optimizer(cfg: TrainConfig) -> Optimizer:
    return Optimizer(cfg)
