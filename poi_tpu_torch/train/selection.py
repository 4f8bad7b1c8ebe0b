"""Best-on-validation model selection, counterpart of
``poi_tpu/train/selection.py``.

A train-loop callback that evaluates the val split every ``eval_every``
steps and keeps a copy of the best parameters. The copy stays on the
parameters' device: nothing crosses to the host.
"""

from __future__ import annotations

import logging

import torch

from poi_tpu_torch.eval.evaluate import evaluate

log = logging.getLogger(__name__)


class BestOnVal:
    def __init__(self, trainer, dataset, cfg, metric: str | None = None):
        if dataset.val is None:
            raise ValueError("BestOnVal needs data.val_fraction > 0 (Dataset.val)")
        ks = tuple(cfg.eval.recall_ks)
        available = {f"recall@{k}" for k in ks} | {f"ndcg@{max(ks)}"}
        if metric is None:
            metric = f"recall@{max(ks)}"
        elif metric not in available:
            raise ValueError(
                f"BestOnVal metric {metric!r} will not be in evaluate()'s output; "
                f"available with eval.recall_ks={ks}: {sorted(available)}"
            )
        self.trainer = trainer
        self.ds = dataset
        self.cfg = cfg
        self.metric = metric
        self.every = max(1, cfg.train.eval_every)
        self.best_score = float("-inf")
        self.best_step = -1
        self._best: dict[str, torch.Tensor] | None = None
        self.history: list[dict] = []

    def seed(self, step: int, score: float, params: dict[str, torch.Tensor]) -> None:
        """Adopt a persisted selection as the incumbent best (a resumed run),
        so a worse later-segment val peak never replaces it. ``params`` may
        lie on the host; the copy kept goes to the trainer's device."""
        self.best_step = step
        self.best_score = score
        self._best = {k: p.detach().to(self.trainer.device, copy=True) for k, p in params.items()}

    def __call__(self, step: int, state, metrics) -> None:
        if step % self.every:
            return
        m = evaluate(self.trainer.model, self.ds, self.cfg, split="val", mesh=getattr(self.trainer, "mesh", None))
        m["step"] = step
        self.history.append(m)
        score = m[self.metric]
        log.info("val @%d: %s=%.4f (best %.4f @%d)", step, self.metric, score, self.best_score, self.best_step)
        if score > self.best_score:
            self.best_score = score
            self.best_step = step
            with torch.no_grad():
                self._best = {k: p.detach().clone() for k, p in state.params.items()}

    def best_params(self, fallback_params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """The selected parameters (on their device), or ``fallback_params``
        when no evaluation ran."""
        return fallback_params if self._best is None else self._best
