"""scripts/export_params_npz.py: a poi_tpu checkpoint reaches the PyTorch
port, and both packages' `recommend` return the same ids from it."""

import contextlib
import importlib.util
import io
import json
import os

import numpy as np
import torch

from poi_tpu.configs.presets import get_config
from poi_tpu.data.dataset import load_dataset
from poi_tpu.models.base import DataDims
from poi_tpu.train.loop import Trainer
from poi_tpu.utils.checkpoint import CheckpointManager

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_script():
    spec = importlib.util.spec_from_file_location("export_params_npz", os.path.join(REPO, "scripts", "export_params_npz.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_export_checkpoint_then_both_packages_recommend_the_same(tmp_path):
    from poi_tpu.cli import run_recommend
    from poi_tpu_torch import cli as torch_cli

    cfg = get_config("smoke")
    ckdir = str(tmp_path / "ckpt")
    cfg = cfg.with_overrides({"checkpoint.directory": ckdir})
    ds = load_dataset(cfg.data)
    state = Trainer(cfg, DataDims.from_dataset(ds)).init_state()
    mgr = CheckpointManager(ckdir)
    mgr.save(0, state)
    mgr.wait()
    mgr.close()

    out = tmp_path / "params.npz"
    assert _load_script().main(["--config", "smoke", "--checkpoint-dir", ckdir, "--out", str(out)]) == 0
    with np.load(out) as f:
        np.testing.assert_array_equal(f["embed/poi"], np.asarray(state.params["embed"]["poi"]))

    inp = tmp_path / "histories.json"
    inp.write_text(json.dumps([
        [{"poi": 1, "timestamp": 1000.0}, {"poi": 2, "timestamp": 5000.0}],
        [{"poi": 7, "timestamp": 90000.0}],
        [{"poi": 3, "timestamp": 2000.0}, {"poi": 9, "timestamp": 9000.0}, {"poi": 4, "timestamp": 20000.0}],
    ]))
    outputs = []
    for run in (
        lambda: run_recommend(cfg, str(inp), 5, True),
        lambda: torch_cli.main(["recommend", "--config", "smoke", "--params", str(out), "--device", "cpu",
                                "--input", str(inp), "--k", "5"]),
    ):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert run() == 0
        outputs.append(json.loads(buf.getvalue().strip().splitlines()[-1]))
    jax_ids, torch_ids = outputs
    assert np.asarray(torch_ids).shape == (3, 5)
    assert torch_ids == jax_ids
