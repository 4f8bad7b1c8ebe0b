"""The port's Trainer on a mesh of 4 gloo ranks on the CPU (``Trainer(mesh=
...)``, the sharded loss dispatch, the gradient sum over data, lazy Adam on
a shard, the mesh-aware norms, ``evaluate(mesh=...)`` and the checkpoint of
a sharded state), held against ``poi_tpu``'s Trainer on the same mesh shapes
of the fake CPU devices and against the port's own one-rank run, with the
same params, batches and negatives injected; and the ``train`` CLI under
``torch.distributed.run`` against the one-rank API run.

Three cases, each 3 steps of the smoke config in fp32: 2 x 2 with psum
lookups, the sharded full CE and dense Adam; 1 x 4 with a2a lookups, sampled
softmax and lazy Adam; 4 x 1 with the rows-gradient step and lazy Adam. One 4-rank job (``tests/torch_mesh_jobs.py:train_job``)
runs both, then saves the 2 x 2 state and restores it on one rank and on
1 x 4."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from poi_tpu.models.base import DataDims as JaxDataDims
from poi_tpu.parallel.mesh import make_mesh
from poi_tpu.train import sparse_opt as jax_sparse_opt
from poi_tpu.train.loop import Trainer as JaxTrainer
from poi_tpu.utils.config import Config as JaxConfig
from poi_tpu_torch.configs.presets import get_config
from poi_tpu_torch.convert import flatten
from poi_tpu_torch.data.dataset import load_dataset
from poi_tpu_torch.data.pipeline import Batch, make_train_loader
from poi_tpu_torch.parallel.launch import spawn
from poi_tpu_torch.train.loop import train

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3
BASE = {"model.compute_dtype": "float32", "train.warmup_steps": "0", "train.log_every": "1",
        "train.num_steps": str(STEPS)}
CASES = {
    "a2a_lazy": {"mesh": [1, 4], "overrides": {
        **BASE, "mesh.model": "4", "mesh.embedding_mode": "a2a", "mesh.a2a_capacity_factor": "8.0",
        "loss.kind": "sampled_softmax", "loss.num_sampled": "16", "train.table_update": "sparse",
        "eval.topk_impl": "pallas"}},
    # Data parallelism alone (4 x 1) with the rows-gradient step, forced by a
    # threshold of 0 on both sides: each rank's occurrence rows, gathered.
    "rows_dp": {"mesh": [4, 1], "dense_lazy_max_bytes": 0, "overrides": {
        **BASE, "mesh.data": "4", "loss.kind": "sampled_softmax", "loss.num_sampled": "16",
        "train.table_update": "sparse"}},
    # Last: the job saves its state and restores it on one rank and on 1 x 4.
    "psum_dense": {"mesh": [2, 2], "overrides": {
        **BASE, "mesh.data": "2", "mesh.model": "2", "mesh.embedding_mode": "psum"}},
}
METRICS = ("loss", "grad_norm", "param_norm")
TOL = {"loss": 1e-5, "grad_norm": 1e-4, "param_norm": 1e-5}  # tests/test_torch_train.py's trajectory tolerances


def _cfg(name):
    return get_config("smoke").with_overrides(CASES[name]["overrides"])


def _adam_close(got, want, lr: float, tight: float, key: str) -> None:
    """Params after STEPS Adam steps: within ``tight`` (relative and
    absolute) but for the elements whose gradient is near zero, where Adam's
    update is lr times the gradient's sign and a last-bit difference of the
    gradient can flip it; no element past 2 lr a step."""
    d = np.abs(got - want)
    off = d > tight * (1.0 + np.abs(want))
    assert off.mean() <= 1e-3, (key, int(off.sum()), float(d.max()))
    assert d.max() <= 2 * lr * STEPS, (key, float(d.max()))


def _jax_run(name, case, ds, batches, devices):
    """poi_tpu's Trainer on the case's mesh of the fake devices: its init
    params, its pools (sampled softmax) and its STEPS steps' metrics and
    params."""
    jcfg = JaxConfig.from_dict(_cfg(name).to_dict())
    jt = JaxTrainer(jcfg, JaxDataDims.from_dataset(ds), mesh=make_mesh(*case["mesh"], devices=devices[:4]))
    js = jt.init_state()
    params = flatten(jax.tree.map(np.asarray, js.params))
    pools = None
    if jcfg.loss.kind == "sampled_softmax":
        V, S = jt.dims.num_pois, jcfg.loss.num_sampled
        pools = np.stack([np.asarray(jax.random.randint(jax.random.fold_in(js.rng, s), (S,), 0, V))
                          for s in range(STEPS)])
    rows = []
    for b in batches:
        js, m = jt.step(js, b)
        rows.append({k: float(v) for k, v in m.items()})
    return ({"metrics": rows, "params": flatten(jax.tree.map(np.asarray, js.params)), "num_pois": jt.dims.num_pois},
            params, pools)


@pytest.fixture(scope="module")
def rig(tmp_path_factory, eight_devices):
    """poi_tpu's runs on the fake devices, then the port's 4-rank job on the
    same params, batches and pools."""
    d = tmp_path_factory.mktemp("torch_train_sharded")
    ds = load_dataset(get_config("smoke").data)
    loader = make_train_loader(ds.train, batch_size=16, seed=0)
    batches = [next(loader) for _ in range(STEPS)]
    loader.close()
    inp = {"steps": np.asarray(STEPS)}
    for s, b in enumerate(batches):
        inp.update({f"batch{s}/{f}": np.asarray(getattr(b, f)) for f in Batch._fields})
    want = {}
    for name, case in CASES.items():
        with pytest.MonkeyPatch.context() as mp:
            if "dense_lazy_max_bytes" in case:
                mp.setattr(jax_sparse_opt, "DENSE_LAZY_MAX_BYTES", case["dense_lazy_max_bytes"])
            want[name], params, pools = _jax_run(name, case, ds, batches, eight_devices)
        inp.update({f"{name}/params/{k}": v for k, v in params.items()})
        if pools is not None:
            inp[f"{name}/pools"] = pools
    np.savez(d / "inp.npz", **inp)

    spawn("tests.torch_mesh_jobs:train_job", 4,
          {"inp": str(d / "inp.npz"), "out": str(d / "out.npz"), "cases": json.dumps(CASES)}, timeout=300, cwd=REPO,
          log_dir=str(d))
    with np.load(d / "out.npz") as f:
        out = {k: f[k] for k in f.files}
    return want, out


@pytest.mark.parametrize("name", CASES)
def test_trajectory_matches_poi_tpu_on_the_same_mesh(rig, name):
    """Per-step loss, grad norm and param norm within test_torch_train.py's
    tolerances of poi_tpu's Trainer on the same mesh shape; the a2a overflow
    metric equal; the params after 3 steps within 1e-5 (``_adam_close``)."""
    want, out = rig
    assert bool(out[f"{name}/mesh/rows_mode"]) == ("dense_lazy_max_bytes" in CASES[name])
    for s, row in enumerate(want[name]["metrics"]):
        for k in METRICS:
            assert float(out[f"{name}/mesh/{k}/{s}"]) == pytest.approx(row[k], rel=TOL[k]), (name, s, k)
        if "a2a_overflow" in row:
            assert float(out[f"{name}/mesh/a2a_overflow/{s}"]) == row["a2a_overflow"]
    n = want[name]["num_pois"]
    for k, v in want[name]["params"].items():
        key = k.replace("/", ".")
        ref = v[:n] if key in ("embed.poi", "embed.out_bias") else v
        _adam_close(out[f"{name}/mesh/params/{key}"], ref, _cfg(name).train.learning_rate, 1e-5, key)


@pytest.mark.parametrize("name", CASES)
def test_mesh_run_matches_the_one_rank_run(rig, name):
    """The mesh run and the port's own one-rank run from the same params,
    batches and pools: the same per-step loss, grad norm and param norm at
    the same tolerances. The a2a/sampled run's params agree to 1e-5; the
    sharded CE rounds the queries' cotangent to bf16 on each model shard
    before the sum (as poi_tpu's does) where the dense CE rounds it once,
    so the CE run's params are held to 2 lr a step (Adam's update is lr
    times the sign of a near-zero gradient) and the trajectory carries the
    check."""
    _, out = rig
    for s in range(STEPS):
        for k in METRICS:
            assert float(out[f"{name}/mesh/{k}/{s}"]) == pytest.approx(float(out[f"{name}/one/{k}/{s}"]), rel=TOL[k])
    lr = _cfg(name).train.learning_rate
    for key in [k for k in out if k.startswith(f"{name}/one/params/")]:
        got, want = out[key.replace("/one/", "/mesh/")], out[key]
        if name == "psum_dense":
            assert np.abs(got - want).max() <= 2 * lr * STEPS, key
        else:
            _adam_close(got, want, lr, 1e-5, key)


@pytest.mark.parametrize("name", CASES)
def test_evaluate_on_the_mesh_equals_one_rank(rig, name):
    """evaluate(mesh=...) of the mesh run's params (each data rank its rows,
    the vocab-sharded top-k; for a2a_lazy B11's plain version on the
    per-shard popularity-ordered catalog) gives the one-rank evaluate's
    metrics on the same params."""
    _, out = rig
    keys = [k for k in out if k.startswith(f"{name}/one/eval/")]
    assert keys
    for k in keys:
        assert float(out[k.replace("/one/", "/mesh/")]) == float(out[k]), k


@pytest.mark.parametrize("target", ["one", "other"])
def test_checkpoint_from_2x2_restores_bit_for_bit(rig, target):
    """The step file saved on 2 x 2 (one file, the tables put back together)
    restores on one rank and on 1 x 4: params, Adam moments, step and count
    the same bits."""
    _, out = rig
    assert bool(out[f"ckpt/{target}/same"])


def test_cli_under_torch_distributed_run_gives_the_api_loss_history(tmp_path):
    """``python -m torch.distributed.run --nproc-per-node 2 -m poi_tpu_torch
    train --platform cpu --config smoke --set mesh.model=2`` (gloo, the
    vocab-sharded CE on 2 ranks) prints the loss history of the one-rank
    ``train()``; only rank 0 prints. Its checkpoint (one file, the table put
    back together) gives ``eval`` under the launcher, and ``eval`` in one
    process, the run's final metrics."""
    sets = ["train.num_steps=4", "train.log_every=1", "train.warmup_steps=0", "model.compute_dtype=float32"]
    env = {**os.environ, "OMP_NUM_THREADS": "1", "POI_TPU_TORCH_DATA_CACHE": "off"}
    ckpt = ["--checkpoint-dir", str(tmp_path / "ckpt")]
    launch = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2"]

    def run(cmd):
        proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
        assert proc.returncode == 0, proc.stderr[-3000:]
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        assert len(lines) == 1, (proc.stdout, proc.stderr[-3000:])
        return json.loads(lines[0])

    got = run([*launch, "-m", "poi_tpu_torch", "train", "--platform", "cpu", "--config", "smoke", *ckpt, "--set",
               "mesh.model=2", *sets])
    cfg = get_config("smoke").with_overrides(dict(s.split("=") for s in sets))
    _, _, hist = train(cfg, load_dataset(cfg.data), device="cpu")
    assert [r["step"] for r in got["history"]] == [r["step"] for r in hist] == [1, 2, 3, 4]
    for a, b in zip(got["history"], hist):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-5), (a, b)
    evals = [run([*launch, "-m", "poi_tpu_torch", "eval", "--platform", "cpu", "--config", "smoke", *ckpt, "--set",
                  "mesh.model=2"]),
             run([sys.executable, "-m", "poi_tpu_torch", "eval", "--platform", "cpu", "--config", "smoke", *ckpt])]
    for e in evals:
        assert e["step"] == 4 and e["metrics"] == got["final"], (e, got["final"])
