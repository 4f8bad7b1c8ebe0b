"""Config #4's training and serving path in the port (attention tower,
sampled softmax, lazy Adam, dropout) held against poi_tpu's Trainer on the
same batches, the same parameters (convert) and the same negative pools.

Config #4 (attention_gowalla) shrunk in size only: a 410-POI synthetic
catalog, T=16, 32-d, batch 16, S=128, dropout 0 for the comparisons (the two
packages draw dropout masks from different generators). poi_tpu's step draws
its pool with jax.random.randint(fold_in(state.rng, step), ...); the port's
Trainer replays those ids through its ``negatives`` hook."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from poi_tpu.eval.evaluate import evaluate as jax_evaluate
from poi_tpu.models.base import DataDims as JaxDataDims
from poi_tpu.train.loop import Trainer as JaxTrainer
from poi_tpu.train.loop import train as jax_train
from poi_tpu.utils.config import Config as JaxConfig
from poi_tpu_torch.configs.presets import get_config
from poi_tpu_torch.convert import flatten, params_to_numpy, sparse_adam_state_to_numpy
from poi_tpu_torch.data.dataset import load_dataset
from poi_tpu_torch.data.pipeline import make_batch
from poi_tpu_torch.eval.evaluate import evaluate
from poi_tpu_torch.eval.serve import Checkin, Recommender
from poi_tpu_torch.models.base import DataDims, batch_to
from poi_tpu_torch.parallel.mesh import Mesh
from poi_tpu_torch.train.loop import DROPOUT_STREAM, Trainer, train

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {
    "data.dataset": "synthetic", "data.num_users": 64, "data.num_pois": 512, "data.mean_checkins_per_user": 30,
    "data.max_seq_len": 16, "data.min_user_checkins": 4, "data.min_poi_checkins": 1,
    "model.embed_dim": 32, "model.hidden_dim": 32, "model.attn_window": 4, "model.dropout": 0.0,
    "loss.num_sampled": 128, "train.batch_size": 16, "train.num_steps": 5, "train.log_every": 1,
    "train.warmup_steps": 0, "eval.max_eval_users": 200,
}
# fp32 compute: both packages run the same fp32 arithmetic up to summation
# order (the sampled logits' bf16 operands round at the same points).
REL_TOL = 1e-5


def _jax(cfg):
    """The same configuration as poi_tpu's own Config."""
    return JaxConfig.from_dict(cfg.to_dict())


def _cfg(**overrides):
    return get_config("attention_gowalla").with_overrides({k: str(v) for k, v in {**SMALL, **overrides}.items()})


@pytest.fixture(scope="module")
def ds():
    return load_dataset(_cfg().data)


def _pair(cfg, ds):
    """poi_tpu's Trainer and state, and the port's Trainer on the same
    params whose negative pools replay poi_tpu's draws."""
    jt = JaxTrainer(_jax(cfg), JaxDataDims.from_dataset(ds))
    js = jt.init_state()
    tree = jax.tree.map(np.asarray, js.params)
    S, V = cfg.loss.num_sampled, ds.num_pois
    pools = [np.array(jax.random.randint(jax.random.fold_in(js.rng, s), (S,), 0, V)) for s in range(8)]
    tt = Trainer(cfg, DataDims.from_dataset(ds), device="cpu", negatives=lambda step: torch.from_numpy(pools[step]))
    return jt, js, tt, tt.init_state(tree), tree


def _leaves(tree):
    return {k: np.asarray(v, np.float32) for k, v in flatten(tree).items()}


def _assert_trees_close(got, want, tol, what):
    for name, w in _leaves(want).items():
        g = _leaves(got)[name]
        np.testing.assert_allclose(g, w, atol=tol * (np.abs(w).max() + 1e-30), rtol=0, err_msg=f"{what} {name}")


@pytest.mark.parametrize("impl", ["auto", "fused"])
def test_trainer_step_matches_jax(ds, impl):
    """One step from the same params on the same host batch: loss, updated
    params and the lazy-Adam state. ``auto`` at D=32 takes the plain sampled
    path on both sides; ``fused`` takes the port's fused path (its kernels'
    plain versions), whose dq and table cotangent stay fp32 where poi_tpu's
    XLA autodiff rounds them to bf16: gradients agree at bf16 resolution, and
    Adam's first step moves an element by lr·g/(|g| + eps), so elements whose
    gradient is within that noise may move differently (by at most 2·lr)."""
    cfg = _cfg(**{"model.compute_dtype": "float32", "loss.impl": impl})
    jt, js, tt, st, tree = _pair(cfg, ds)
    batch = make_batch(ds.train, np.arange(cfg.train.batch_size))
    js2, jm = jt.step(js, batch)
    st2, tm = tt.step(st, batch)
    assert st2.step == 1 and st2.opt_state["count"] == 1
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= REL_TOL * float(jm["loss"])
    lazy = sparse_adam_state_to_numpy(st2.opt_state)
    assert lazy["count"] == int(js2.opt_state.count) == 1
    if impl == "auto":
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-4)
        _assert_trees_close(params_to_numpy(tt.model), js2.params, REL_TOL, "params")
        for which in ("m", "v"):
            _assert_trees_close(lazy[which], getattr(js2.opt_state, which), 1e-4, which)
    else:
        lr = cfg.train.learning_rate
        for name, w in _leaves(js2.params).items():
            g = _leaves(params_to_numpy(tt.model))[name]
            assert np.abs(g - w).max() <= 2 * lr + 1e-6, name
        _assert_trees_close(lazy["m"], js2.opt_state.m, 1e-2, "m")
    # Lazy Adam: the POI rows no input, target or negative touched keep their
    # params and zero moments, on both sides.
    touched = np.unique(np.concatenate([batch.poi_in.ravel(), batch.poi_tgt.ravel(), tt.negatives(0).numpy()]))
    cold = np.setdiff1d(np.arange(ds.num_pois), touched)
    assert len(cold) > 0
    poi0 = tt.model.embed["poi"].detach().numpy()[cold]
    np.testing.assert_array_equal(poi0, tree["embed"]["poi"][cold])
    assert not lazy["m"]["embed"]["poi"][cold].any()
    assert not np.asarray(js2.opt_state.m["embed"]["poi"])[cold].any()


def test_train_trajectory_and_evaluate_match_jax(ds):
    """Five host-loader steps through train() on the same seeded batches,
    then the lazy-Adam state and evaluate() on val."""
    cfg = _cfg(**{"model.compute_dtype": "float32"})
    jt, js, tt, st, _ = _pair(cfg, ds)
    _, jfinal, jhist = jax_train(_jax(cfg), ds, state=js, trainer=jt)
    _, final, hist = train(cfg, ds, trainer=tt, state=st)
    assert final.step == 5 and [r["step"] for r in hist] == [r["step"] for r in jhist] == [1, 2, 3, 4, 5]
    for a, b in zip(hist, jhist):
        assert abs(a["loss"] - b["loss"]) <= REL_TOL * b["loss"], (a, b)
        assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=1e-4)
        assert a["param_norm"] == pytest.approx(b["param_norm"], rel=1e-5)
    assert hist[-1]["loss"] < hist[0]["loss"]
    lazy = sparse_adam_state_to_numpy(final.opt_state)
    assert lazy["count"] == int(jfinal.opt_state.count) == 5
    for which in ("m", "v"):
        _assert_trees_close(lazy[which], getattr(jfinal.opt_state, which), 1e-3, which)
    got = evaluate(tt.model, ds, cfg, split="val")
    want = jax_evaluate(jt.model, jfinal.params, ds, _jax(cfg), split="val")
    n = want["eval_examples"]
    assert got["eval_examples"] == n
    for k in want:  # a near-tie may swap between the packages: one row's hit per metric
        assert abs(got[k] - want[k]) <= 1.0 / n + 1e-9, (k, got[k], want[k])


def test_dropout_draws_are_keyed_by_step(ds):
    """With dropout on, a step's masks come from its own generator: the same
    step gives the same loss, another step another."""
    tt = Trainer(_cfg(**{"model.dropout": 0.3}), DataDims.from_dataset(ds), device="cpu")
    tt.init_state()
    batch = batch_to(make_batch(ds.train, np.arange(16)), "cpu")
    with torch.no_grad():
        losses = [float(tt.loss(batch, tt.draw_negatives(0), tt.generator(s, DROPOUT_STREAM))) for s in (0, 0, 1)]
        plain = float(tt.loss(batch, tt.draw_negatives(0)))
    assert losses[0] == losses[1] != losses[2] and plain not in losses
    state, m = tt.step(tt.init_state(), make_batch(ds.train, np.arange(16)))
    assert state.step == 1 and np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0


def test_trainer_rejects_the_rows_gradient_step(ds):
    """The rows-gradient step (a tied table above DENSE_LAZY_MAX_BYTES) is
    a one-shard path: the Trainer takes it on one device; its vocab-sharded
    form (mesh.model > 1) builds on one rank of a (1, 4) mesh without it
    (the dense-gradient lazy Adam on the rank's rows), and without a
    process group mesh.model=4 is a mesh that does not fit one device. The
    2 GB table is built on the meta device."""
    big = DataDims(num_users=1, num_pois=1_000_000, num_time_buckets=1, num_geo_buckets=1, num_tgap_buckets=1,
                   num_dist_buckets=1)
    wide = {"model.embed_dim": 512, "model.hidden_dim": 512}
    assert Trainer(_cfg(**wide), big, device="meta").rows_mode
    sharded = Trainer(_cfg(**wide, **{"mesh.model": 4}), big, device="meta", mesh=Mesh(1, 4, world_size=4, rank=3))
    assert not sharded.rows_mode and sharded.model.embed["poi"].shape == (250_000, 512)
    with pytest.raises(ValueError, match="1 devices not divisible by model=4"):
        Trainer(_cfg(**wide, **{"mesh.model": 4}), big, device="meta")


def test_recommender_rescores_rows_beyond_the_kernels_fetch(ds):
    """Histories of 150 distinct POIs need a fetch of 160 > the top-k
    kernel's 128: the capped path (pallas) rescoring short rows must return
    what the uncapped plain path (xla) returns."""
    cfg = _cfg(**{"data.max_seq_len": 160})
    long_ds = load_dataset(cfg.data)
    tt = Trainer(cfg, DataDims.from_dataset(long_ds), device="cpu")
    tt.init_state()
    rng = np.random.default_rng(0)
    histories = [[Checkin(int(p), 3600.0 * i) for i, p in enumerate(rng.permutation(long_ds.num_pois)[:150])]
                 for _ in range(3)] + [[Checkin(1, 0.0)]]
    got = Recommender(tt.model, cfg.with_overrides({"eval.topk_impl": "pallas"}), long_ds).recommend(histories, k=10)
    want = Recommender(tt.model, cfg.with_overrides({"eval.topk_impl": "xla"}), long_ds).recommend(histories, k=10)
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).all()
    for row, hist in zip(got, histories):
        assert not set(row.tolist()) & {c.poi for c in hist}


def test_cli_train_config4_on_cpu_without_jax():
    code = (
        "import sys; from poi_tpu_torch.cli import main; rc = main(sys.argv[1:]); "
        "assert 'jax' not in sys.modules, 'jax was imported'; sys.exit(rc)"
    )
    sets = [f"{k}={v}" for k, v in {**SMALL, "train.num_steps": 20, "train.log_every": 10,
                                     "train.eval_every": 10, "data.sampler": "device",
                                     "model.dropout": 0.3}.items()]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", POI_TPU_TORCH_DATA_CACHE="off")
    proc = subprocess.run([sys.executable, "-c", code, "train", "--config", "attention_gowalla", "--device", "cpu",
                           "--no-checkpoint", "--set", *sets], capture_output=True, text=True, cwd=REPO, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["steps"] == 20 and [r["step"] for r in out["history"]] == [10, 20]
    assert out["history"][-1]["loss"] < out["history"][0]["loss"]
    assert [e["step"] for e in out["periodic_evals"]] == [10, 20] and out["selected_step"] in (10, 20)
    assert all(np.isfinite(v) for v in out["final"].values())
