"""Observability: structured metrics, throughput, profiling hooks,
counterpart of ``poi_tpu/utils/obs.py``.

- ``MetricsLogger`` — per-step scalars to JSONL (one file per process) +
  rank-0 console summaries; TensorBoard scalars on request.
- ``device_memory_stats`` — the card's allocator readings under the TPU
  package's key names, so one dashboard reads both packages' rows.
- ``profile_window`` — wraps steps [start, stop) in ``torch.profiler`` and
  writes a Chrome trace.
- ``StepTimer`` — wall-time + examples/s accounting.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any

import torch

log = logging.getLogger(__name__)


def _rank() -> int:
    """This process's rank in ``torch.distributed`` when initialised, else 0."""
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class MetricsLogger:
    """Append-only JSONL metric stream + console summary on rank 0, with an
    optional TensorBoard scalar stream (``tensorboard=True``; rank 0 only)."""

    def __init__(self, directory: str | None, run_name: str = "train", tensorboard: bool = False):
        self.directory = directory
        self._fh = None
        self._tb = None
        if directory is not None:
            os.makedirs(directory, exist_ok=True)
            path = os.path.join(directory, f"{run_name}_host{_rank()}.jsonl")
            self._fh = open(path, "a", buffering=1)
            if tensorboard and _rank() == 0:
                try:  # imported only here: it pulls in TensorFlow when that is installed
                    from torch.utils.tensorboard import SummaryWriter

                    self._tb = SummaryWriter(os.path.join(directory, "tb"))
                except ImportError:
                    log.warning("torch tensorboard writer unavailable; JSONL only")

    def write(self, step: int, scalars: dict[str, Any]) -> None:
        row = {"step": step, "time": time.time(), **{k: _to_py(v) for k, v in scalars.items()}}
        if self._fh is not None:
            self._fh.write(json.dumps(row) + "\n")
        if self._tb is not None:
            for k, v in row.items():
                if k not in ("step", "time") and isinstance(v, float):
                    self._tb.add_scalar(k, v, step)
        if _rank() == 0:
            log.info(" ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                              for k, v in row.items() if k != "time"))

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
        if self._tb is not None:
            self._tb.close()


def _to_py(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return v


def device_memory_stats(device=None) -> dict[str, float]:
    """The card's allocator readings in GiB, under the TPU package's keys
    (``hbm_bytes_in_use_gib``, ``hbm_peak_bytes_in_use_gib``,
    ``hbm_bytes_limit_gib``); empty for a CPU device, or with no card."""
    if device is None:
        if not torch.cuda.is_available():
            return {}
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    ms = torch.cuda.memory_stats(device)
    return {
        "hbm_bytes_in_use_gib": ms.get("allocated_bytes.all.current", 0) / 2**30,
        "hbm_peak_bytes_in_use_gib": ms.get("allocated_bytes.all.peak", 0) / 2**30,
        "hbm_bytes_limit_gib": torch.cuda.get_device_properties(device).total_memory / 2**30,
    }


class StepTimer:
    """Tracks steps/s and examples/s over a rolling window."""

    def __init__(self, examples_per_step: int):
        self.examples_per_step = examples_per_step
        self._t0 = time.perf_counter()
        self._steps = 0

    def tick(self) -> None:
        self._steps += 1

    def rates(self) -> dict[str, float]:
        dt = time.perf_counter() - self._t0
        out = {
            "steps_per_sec": self._steps / max(dt, 1e-9),
            "seqs_per_sec": self._steps * self.examples_per_step / max(dt, 1e-9),
        }
        self._t0 = time.perf_counter()
        self._steps = 0
        return out


class profile_window:
    """Trace steps [start, stop) with ``torch.profiler`` (host activity, and
    the card's kernels when CUDA is available) into a Chrome trace,
    ``<logdir>/trace_steps_<start>_<stop>.json``.

    Usage: ``pw = profile_window(logdir, 10, 15)`` then ``pw.step(i)`` once
    per train step (rank 0 only traces), ``pw.close()`` at the end.
    """

    def __init__(self, logdir: str | None, start: int, stop: int):
        self.logdir = logdir
        self.start, self.stop = start, stop
        self._prof = None

    def step(self, i: int) -> None:
        if self.logdir is None or _rank() != 0:
            return
        if i == self.start and self._prof is None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.start()
        elif i >= self.stop and self._prof is not None:
            self._finish()

    def _finish(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the window's last kernels belong in it
        prof, self._prof = self._prof, None
        prof.stop()
        os.makedirs(self.logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(self.logdir, f"trace_steps_{self.start}_{self.stop}.json"))

    def close(self) -> None:
        if self._prof is not None:
            self._finish()
