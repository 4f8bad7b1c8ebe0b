"""The port's CLI verbs on a checkpoint directory (train's save and resume,
eval, recommend, serve, configs), in process through cli.main on the CPU
at the smoke config, held against poi_tpu where both compute the same
thing; one subprocess run checks that train and eval import no JAX."""

import io
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from poi_tpu.configs.presets import list_configs as jax_list_configs
from poi_tpu.eval.evaluate import evaluate as jax_evaluate
from poi_tpu.models.base import DataDims as JaxDataDims
from poi_tpu.train.loop import Trainer as JaxTrainer
from poi_tpu.utils.config import Config as JaxConfig
from poi_tpu_torch import cli
from poi_tpu_torch.configs.presets import get_config
from poi_tpu_torch.convert import unflatten
from poi_tpu_torch.data.dataset import load_dataset
from poi_tpu_torch.eval.evaluate import evaluate
from poi_tpu_torch.eval.serve import Checkin, Recommender
from poi_tpu_torch.train.loop import FaultInjected, train
from poi_tpu_torch.utils.checkpoint import CheckpointManager

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = ["train.num_steps=8", "train.checkpoint_every=2", "train.log_every=2"]


def _main(capsys, *argv):
    """cli.main in process; returns its exit code and its last stdout line."""
    rc = cli.main(list(argv))
    lines = capsys.readouterr().out.strip().splitlines()
    return rc, (lines[-1] if lines else "")


def _train(capsys, ckpt, *sets, config="smoke"):
    rc, line = _main(capsys, "train", "--config", config, "--device", "cpu", "--checkpoint-dir", str(ckpt),
                     "--set", *STEPS, *sets)
    assert rc == 0
    return json.loads(line)


def _tensors(saved):
    """{path: tensor} of a step file's params and optimizer moments."""
    out = {f"params.{k}": v for k, v in saved["params"].items()}
    for part, d in saved["opt_state"].items():
        if part != "count":
            out.update({f"{part}.{k}": v for k, v in d.items()})
    return out


def _histories(ds, n):
    """Check-in histories rebuilt from the first ``n`` test rows."""
    ex = ds.test
    out = []
    for i in range(n):
        m = int(ex.mask[i].sum())
        out.append([Checkin(int(p), float(tb) * 3600.0 + 1800.0)
                    for p, tb in zip(ex.poi_in[i, :m], ex.time_bucket[i, :m])])
    return out


def _recommender(cfg, ds, params):
    return Recommender(cli.model_with_params(cfg, ds, params, torch.device("cpu")), cfg, ds)


@pytest.mark.parametrize("sampler", ["host", "device"])
def test_fault_drill_resumes_to_the_continuous_runs_bits(capsys, tmp_path, sampler):
    """train with checkpoint_every=2 and a fault at step 5 raises
    FaultInjected; the rerun resumes from step 4, and its step-8 file equals
    a continuous run's bit for bit (all but the config, whose directory
    differs)."""
    sets = [f"data.sampler={sampler}"]
    out = _train(capsys, tmp_path / "a", *sets)
    assert out["steps"] == 8 and out["resumed_from"] is None
    with pytest.raises(FaultInjected, match="step 5"):
        _train(capsys, tmp_path / "b", *sets, "train.fault_inject_step=5")
    assert CheckpointManager(str(tmp_path / "b")).latest_step() == 4
    out = _train(capsys, tmp_path / "b", *sets)
    assert out["steps"] == 8 and out["resumed_from"] == 4
    a, b = CheckpointManager(str(tmp_path / "a")).load(8), CheckpointManager(str(tmp_path / "b")).load(8)
    assert a["step"] == b["step"] == 8 and a["loader"] == b["loader"]
    assert a["opt_state"]["count"] == b["opt_state"]["count"] == 8
    ta, tb = _tensors(a), _tensors(b)
    assert ta.keys() == tb.keys() and len(ta) == 3 * len(a["params"])
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k


def test_eval_step_matches_poi_tpus_evaluate(capsys, tmp_path):
    """eval --step N prints evaluate() of that step's params (not the latest
    step's), within 1/n of poi_tpu's evaluate on the same params: the top-k
    kernel's plain version against JAX's Pallas top-k in interpret mode."""
    sets = ["eval.topk_impl=pallas"]
    _train(capsys, tmp_path, *sets)
    rc, line = _main(capsys, "eval", "--config", "smoke", "--device", "cpu", "--checkpoint-dir", str(tmp_path),
                     "--step", "4", "--set", *sets)
    assert rc == 0
    out = json.loads(line)
    assert out["step"] == 4
    cfg = get_config("smoke").with_overrides({"eval.topk_impl": "pallas"})
    ds = load_dataset(cfg.data)
    params = CheckpointManager(str(tmp_path)).load(4)["params"]
    model = cli.model_with_params(cfg, ds, params, torch.device("cpu"))
    assert out["metrics"] == evaluate(model, ds, cfg)
    latest = cli.model_with_params(cfg, ds, CheckpointManager(str(tmp_path)).load(8)["params"], torch.device("cpu"))
    assert out["metrics"] != evaluate(latest, ds, cfg)

    jcfg = JaxConfig.from_dict(cfg.to_dict())
    tree = jax.tree.map(jax.numpy.asarray, unflatten({k.replace(".", "/"): v.numpy() for k, v in params.items()}))
    want = jax_evaluate(JaxTrainer(jcfg, JaxDataDims.from_dataset(ds)).model, tree, ds, jcfg)
    n = want["eval_examples"]
    assert out["metrics"]["eval_examples"] == n
    for k in want:
        assert abs(out["metrics"][k] - want[k]) <= 1.0 / n + 1e-9, (k, out["metrics"][k], want[k])


def test_recommend_and_serve_read_the_selected_params_and_the_step_sequence(capsys, tmp_path, monkeypatch):
    """With a val split, train saves the best-on-val params to selected/ and
    ends the step sequence at the true end-of-run state (an uninterrupted
    train()'s params). recommend --checkpoint-dir answers with the selected
    params; serve --step 8 with the end-of-run ones."""
    sets = ["data.val_fraction=0.1", "train.eval_every=2"]
    out = _train(capsys, tmp_path, *sets)
    cfg = get_config("smoke").with_overrides(dict(s.split("=") for s in STEPS + sets))
    ds = load_dataset(cfg.data)
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.selected_info() == {"step": out["selected_step"], "metric": "recall@10",
                                   "score": max(e["recall@10"] for e in out["periodic_evals"])}
    _, end, _ = train(cfg, ds, device="cpu")
    saved = mgr.load(8)["params"]
    assert all(torch.equal(saved[k], p) for k, p in end.params.items())
    assert out["selected_step"] < 8 and not torch.equal(mgr.restore_selected()["embed.poi"], saved["embed.poi"])

    hist = _histories(ds, 2)
    request = json.dumps([[{"poi": c.poi, "timestamp": c.timestamp} for c in h] for h in hist])
    monkeypatch.setattr(sys, "stdin", io.StringIO(request))
    rc, line = _main(capsys, "recommend", "--config", "smoke", "--device", "cpu", "--checkpoint-dir", str(tmp_path),
                     "--set", *sets)
    assert rc == 0
    want = _recommender(cfg, ds, mgr.restore_selected()).recommend(hist, k=10)
    assert np.array_equal(np.asarray(json.loads(line)), want)

    monkeypatch.setattr(sys, "stdin", io.StringIO(request + "\n{not json\n"))
    rc = cli.main(["serve", "--config", "smoke", "--device", "cpu", "--checkpoint-dir", str(tmp_path), "--step", "8",
                   "--set", *sets])
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert rc == 0 and len(lines) == 2 and "error" in lines[1]
    assert np.array_equal(np.asarray(lines[0]["ids"]), _recommender(cfg, ds, saved).recommend(hist, k=10))


def test_configs_lists_the_presets(capsys):
    assert cli.main(["configs"]) == 0
    assert capsys.readouterr().out.split() == jax_list_configs()


@pytest.mark.parametrize("argv", [
    ["recommend", "--params", "p.npz", "--checkpoint-dir", "d"],
    ["serve", "--params", "p.npz", "--checkpoint-dir", "d"],
    ["recommend"],
    ["serve"],
    ["serve", "--params", "p.npz", "--step", "4"],
])
def test_params_and_checkpoint_dir_are_one_source(capsys, argv):
    with pytest.raises(SystemExit) as e:
        cli.main([*argv, "--config", "smoke", "--device", "cpu"])
    assert e.value.code == 2
    assert "--params" in capsys.readouterr().err


def test_train_then_eval_in_a_subprocess_import_no_jax(tmp_path):
    code = (
        "import json, sys; from poi_tpu_torch.cli import main; d = sys.argv[1]; "
        "rc = main(['train', '--config', 'smoke', '--device', 'cpu', '--checkpoint-dir', d, '--set', "
        "'train.num_steps=6', 'train.checkpoint_every=3']); "
        "rc = rc or main(['eval', '--config', 'smoke', '--device', 'cpu', '--checkpoint-dir', d]); "
        "assert 'jax' not in sys.modules, 'jax was imported'; sys.exit(rc)"
    )
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", POI_TPU_TORCH_DATA_CACHE="off")
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True, text=True, cwd=REPO,
                          env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    train_out, eval_out = (json.loads(x) for x in proc.stdout.strip().splitlines()[-2:])
    assert eval_out["step"] == train_out["steps"] == 6
    assert eval_out["metrics"] == train_out["final"]
    assert sorted(os.listdir(tmp_path)) == ["step_3.pt", "step_6.pt"]
