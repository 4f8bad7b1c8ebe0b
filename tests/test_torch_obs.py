"""poi_tpu_torch.utils.obs held against poi_tpu.utils.obs on the CPU, and
the train verb's --debug."""

import json
import logging
import os
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poi_tpu.utils.obs import MetricsLogger as JaxMetricsLogger
from poi_tpu.utils.obs import StepTimer as JaxStepTimer
from poi_tpu_torch import cli
from poi_tpu_torch.configs.presets import get_config
from poi_tpu_torch.data.dataset import load_dataset
from poi_tpu_torch.data.pipeline import make_batch
from poi_tpu_torch.models.base import DataDims
from poi_tpu_torch.train import loop
from poi_tpu_torch.utils.obs import MetricsLogger, StepTimer, device_memory_stats, profile_window

torch.set_num_threads(1)


def _rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("run_name", ["train", "eval"])
def test_metrics_logger_rows_match_poi_tpus(tmp_path, run_name):
    """The same scalars give the same rows but for ``time``, in a file of
    the same name, appended across loggers."""
    writes = [(10, {"loss": 1.5, "n": np.float32(2.0), "i": 3, "tag": "a"}), (20, {"val/recall@10": 0.25})]
    for d, cls, tensor in ((tmp_path / "port", MetricsLogger, torch.tensor(1.25)),
                           (tmp_path / "jax", JaxMetricsLogger, jnp.asarray(1.25))):
        for _ in range(2):
            logger = cls(str(d), run_name=run_name)
            for step, scalars in writes:
                logger.write(step, {**scalars, "t": tensor})
            logger.close()
    assert os.listdir(tmp_path / "port") == os.listdir(tmp_path / "jax") == [f"{run_name}_host0.jsonl"]
    got, want = (_rows(tmp_path / d / f"{run_name}_host0.jsonl") for d in ("port", "jax"))
    assert len(got) == len(want) == 4
    assert all(isinstance(r.pop("time"), float) for r in got + want)
    assert got == want
    assert got[0] == {"step": 10, "loss": 1.5, "n": 2.0, "i": 3.0, "tag": "a", "t": 1.25}


def test_metrics_logger_without_a_directory_writes_nothing(tmp_path, caplog):
    logger = MetricsLogger(None, tensorboard=True)
    with caplog.at_level(logging.INFO, logger="poi_tpu_torch.utils.obs"):
        logger.write(5, {"loss": 2.0})
    logger.close()
    assert "step=5 loss=2" in caplog.text


def test_tensorboard_missing_warns_and_keeps_jsonl(tmp_path, monkeypatch, caplog):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # import raises ImportError
    with caplog.at_level(logging.WARNING, logger="poi_tpu_torch.utils.obs"):
        logger = MetricsLogger(str(tmp_path), tensorboard=True)
    logger.write(1, {"loss": 3.0})
    logger.close()
    assert "tensorboard writer unavailable; JSONL only" in caplog.text
    assert os.listdir(tmp_path) == ["train_host0.jsonl"]
    assert _rows(tmp_path / "train_host0.jsonl")[0]["loss"] == 3.0


def test_tensorboard_gets_the_float_scalars(tmp_path, monkeypatch):
    calls = []

    class SummaryWriter:
        def __init__(self, logdir):
            calls.append(("init", logdir))

        def add_scalar(self, tag, value, step):
            calls.append((tag, value, step))

        def close(self):
            calls.append(("close",))

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", types.SimpleNamespace(SummaryWriter=SummaryWriter))
    logger = MetricsLogger(str(tmp_path), tensorboard=True)
    logger.write(7, {"loss": 2.5, "tag": "x"})
    logger.close()
    assert calls == [("init", os.path.join(str(tmp_path), "tb")), ("loss", 2.5, 7), ("close",)]


def test_device_memory_stats_is_empty_on_the_cpu():
    assert device_memory_stats("cpu") == {}
    assert device_memory_stats(torch.device("cpu")) == {}
    assert torch.cuda.is_available() or device_memory_stats() == {}


def test_step_timer_rates_have_poi_tpus_keys():
    t, j = StepTimer(16), JaxStepTimer(16)
    for _ in range(3):
        t.tick()
        j.tick()
    got, want = t.rates(), j.rates()
    assert got.keys() == want.keys() == {"steps_per_sec", "seqs_per_sec"}
    assert got["seqs_per_sec"] == pytest.approx(16 * got["steps_per_sec"])
    assert t.rates()["steps_per_sec"] == 0.0  # the window restarts


def test_profile_window_traces_only_its_steps(tmp_path):
    pw = profile_window(str(tmp_path), 3, 5)
    for i in range(8):
        pw.step(i)
        with torch.profiler.record_function(f"step_{i}"):
            torch.ones(4).add_(1)
    pw.close()
    assert os.listdir(tmp_path) == ["trace_steps_3_5.json"]
    with open(tmp_path / "trace_steps_3_5.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {f"step_{i}" for i in range(8)} & names == {"step_3", "step_4"}

    off = profile_window(None, 0, 2)
    for i in range(3):
        off.step(i)
    off.close()
    unfinished = profile_window(str(tmp_path / "u"), 1, 5)
    for i in range(3):
        unfinished.step(i)
    unfinished.close()  # the run ended inside the window: the trace is written at close
    assert os.listdir(tmp_path / "u") == ["trace_steps_1_5.json"]


def test_debug_raises_on_a_nan_parameter(monkeypatch):
    """train --debug: a NaN parameter stops the run with FloatingPointError
    at the first step's loss, and anomaly detection is on during the run
    only."""
    seen = []

    def poisoned(*args, **kwargs):
        trainer = make_trainer(*args, **kwargs)
        with torch.no_grad():
            trainer.model.embed.poi[0, 0] = float("nan")
        loss = trainer.loss

        def loss_seen(*a, **k):
            seen.append(torch.is_anomaly_enabled())
            return loss(*a, **k)

        trainer.loss = loss_seen
        return trainer

    make_trainer = loop.make_trainer
    monkeypatch.setattr(loop, "make_trainer", poisoned)
    with pytest.raises(FloatingPointError, match="non-finite loss .* at step 0"):
        cli.main(["train", "--config", "smoke", "--device", "cpu", "--no-checkpoint", "--debug"])
    assert seen == [True] and not torch.is_anomaly_enabled()


def test_check_finite_reads_the_grad_norm_every_step():
    cfg = get_config("smoke").with_overrides({"train.log_every": "10"})
    ds = load_dataset(cfg.data)
    batch = make_batch(ds.train, np.arange(cfg.train.batch_size))
    for check in (False, True):
        t = loop.Trainer(cfg, DataDims.from_dataset(ds), device="cpu", check_finite=check)
        _, m = t.step(t.init_state(), batch)
        assert (float(m["grad_norm"]) > 0) == check  # step 1 is no log step
