"""Config #2's path in the port (LSTM tower with the user embedding, BPR,
dense Adam) held against poi_tpu on the same parameters (convert), the same
seeded TrainLoader batches and the same BPR negatives.

Config #2 (lstm_bpr_foursquare) shrunk in size only: a 64-user, 512-POI
foursquare-shaped catalog, T=16, 32-d, 4 negatives a position, batch 16.
poi_tpu's step draws its negatives with jax.random.randint(fold_in(state.rng,
step), (B, T, N), 0, V); the port's Trainer replays those ids through its
``negatives`` hook."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from poi_tpu.eval.evaluate import evaluate as jax_evaluate
from poi_tpu.eval.serve import Checkin as JaxCheckin
from poi_tpu.eval.serve import Recommender as JaxRecommender
from poi_tpu.models.base import DataDims as JaxDataDims
from poi_tpu.train.loop import Trainer as JaxTrainer
from poi_tpu.train.loop import train as jax_train
from poi_tpu.utils.config import Config as JaxConfig
from poi_tpu_torch.configs.presets import get_config
from poi_tpu_torch.convert import adam_state_from_jax, adam_state_to_numpy, flatten, params_to_numpy
from poi_tpu_torch.data.dataset import load_dataset
from poi_tpu_torch.data.pipeline import make_batch
from poi_tpu_torch.eval.evaluate import evaluate
from poi_tpu_torch.eval.serve import Checkin, Recommender
from poi_tpu_torch.models.base import DataDims, batch_to
from poi_tpu_torch.train.loop import Trainer, train

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = "lstm_bpr_foursquare"
SMALL = {
    "data.num_users": 64, "data.num_pois": 512, "data.max_seq_len": 16, "model.embed_dim": 32,
    "model.hidden_dim": 32, "loss.num_negatives": 4, "train.batch_size": 16, "train.num_steps": 5,
    "train.log_every": 1, "train.warmup_steps": 0, "eval.max_eval_users": 200,
}
# fp32 compute: both packages run the same fp32 arithmetic up to summation
# order. bf16 compute: both round h and wh to bf16 at the same points in the
# forward (poi_tpu's scan cell, the port's fused path), so the queries agree
# to fp32 summation noise unless a bf16 rounding of h flips, which moves a
# query by ~1e-3 of its scale.
REL_TOL = 1e-5
BF16_TOL = 5e-3


def _jax(cfg):
    """The same configuration as poi_tpu's own Config."""
    return JaxConfig.from_dict(cfg.to_dict())


def _cfg(**overrides):
    return get_config(CONFIG).with_overrides({k: str(v) for k, v in {**SMALL, **overrides}.items()})


@pytest.fixture(scope="module")
def ds():
    return load_dataset(_cfg().data)


def _pair(cfg, ds):
    """poi_tpu's Trainer and state, and the port's Trainer on the same
    params whose negatives replay poi_tpu's draws."""
    jt = JaxTrainer(_jax(cfg), JaxDataDims.from_dataset(ds))
    js = jt.init_state()
    tree = jax.tree.map(np.asarray, js.params)
    shape = (cfg.train.batch_size, ds.max_seq_len, cfg.loss.num_negatives)
    negs = [np.array(jax.random.randint(jax.random.fold_in(js.rng, s), shape, 0, ds.num_pois)) for s in range(8)]
    tt = Trainer(cfg, DataDims.from_dataset(ds), device="cpu", negatives=lambda step: torch.from_numpy(negs[step]))
    return jt, js, tt, tt.init_state(tree), tree


def _leaves(tree):
    return {k: np.asarray(v, np.float32) for k, v in flatten(tree).items()}


def _close(got, want, tol, what):
    scale = np.abs(want).max() + 1e-30
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=0, err_msg=what)


@pytest.mark.parametrize("dtype, tol", [("float32", REL_TOL), ("bfloat16", BF16_TOL)])
def test_queries_match_jax(ds, dtype, tol):
    """``queries`` at the valid positions and ``queries_last``, with the user
    vector added, from poi_tpu's init carried across."""
    cfg = _cfg(**{"model.compute_dtype": dtype})
    jt, js, tt, _, _ = _pair(cfg, ds)
    batch = make_batch(ds.train, np.arange(16))
    assert len(np.unique(batch.user)) > 1
    want = np.asarray(jt.model.queries(js.params, batch))
    want_last = np.asarray(jt.model.queries_last(js.params, batch))
    with torch.no_grad():
        got = tt.model.queries(batch_to(batch, "cpu")).numpy()
        got_last = tt.model.queries_last(batch_to(batch, "cpu")).numpy()
    m = batch.mask[:, :, None]
    _close(got * m, want * m, tol, "queries")
    _close(got_last, want_last, tol, "queries_last")


def test_trainer_step_matches_jax(ds):
    """One step from the same params on the same host batch and negatives:
    loss, updated params and Adam moments, in fp32."""
    cfg = _cfg(**{"model.compute_dtype": "float32"})
    jt, js, tt, st, _ = _pair(cfg, ds)
    batch = make_batch(ds.train, np.arange(cfg.train.batch_size))
    js2, jm = jt.step(js, batch)
    st2, tm = tt.step(st, batch)
    assert st2.step == 1 and st2.opt_state["count"] == 1
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= REL_TOL * float(jm["loss"])
    got, want = _leaves(params_to_numpy(tt.model)), _leaves(js2.params)
    assert got.keys() == want.keys() and "tower/layers/0/wh" in got and "embed/user" in got
    for name, w in want.items():
        assert np.abs(got[name] - w).max() <= 1e-6, name
    jadam, tadam = adam_state_to_numpy(adam_state_from_jax(js2.opt_state)), adam_state_to_numpy(st2.opt_state)
    for which in ("mu", "nu"):
        for name, w in _leaves(jadam[which]).items():
            _close(_leaves(tadam[which])[name], w, 1e-5, f"{which} {name}")


def test_train_trajectory_and_evaluate_match_jax(ds):
    """Five host-loader steps through train() on the same seeded batches and
    negatives, then evaluate() on val."""
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
    got = evaluate(tt.model, ds, cfg, split="val")
    want = jax_evaluate(jt.model, jfinal.params, ds, _jax(cfg), split="val")
    n = want["eval_examples"]
    assert got["eval_examples"] == n
    for k in want:  # a near-tie may swap between the packages: one row's hit per metric
        assert abs(got[k] - want[k]) <= 1.0 / n + 1e-9, (k, got[k], want[k])


def test_recommender_matches_jax_with_user_vectors(ds):
    """The featurizer array-equal to poi_tpu's, and recommend() with and
    without user ids equal to poi_tpu's: the user vector reaches the serve
    query as it reaches the train query."""
    cfg = _cfg(**{"model.compute_dtype": "float32", "eval.topk_impl": "pallas"})
    jt, js, tt, _, _ = _pair(cfg, ds)
    ex = ds.test
    hist = []
    for i in range(6):
        n = int(ex.mask[i].sum())
        hist.append([(int(p), 3600.0 * j + 60.0 * i) for j, p in enumerate(ex.poi_in[i, :n])])
    jrec, rec = JaxRecommender(jt.model, js.params, _jax(cfg), ds), Recommender(tt.model, cfg, ds)
    want_b = jrec._featurize([[JaxCheckin(*c) for c in h] for h in hist])
    got_b = rec._featurize([[Checkin(*c) for c in h] for h in hist])
    for name in want_b._fields:
        np.testing.assert_array_equal(getattr(got_b, name), getattr(want_b, name), err_msg=name)
    users = [3, 1, 4, 1, 5, 9]
    for ids in (None, users):
        want = jrec.recommend([[JaxCheckin(*c) for c in h] for h in hist], k=10, user_ids=ids)
        got = rec.recommend([[Checkin(*c) for c in h] for h in hist], k=10, user_ids=ids)
        np.testing.assert_array_equal(got, want)
    with torch.no_grad():
        b = batch_to(got_b, "cpu")
        q0 = tt.model.queries_last(b)
        q1 = tt.model.queries_last(b._replace(user=torch.tensor(users)))
        user = tt.model.embed["user"]
        torch.testing.assert_close(q1 - q0, user[users] - user[0], rtol=0, atol=1e-6)


def test_cli_train_config2_on_cpu_without_jax():
    code = (
        "import sys; from poi_tpu_torch.cli import main; rc = main(sys.argv[1:]); "
        "assert not any(m == 'jax' or m.startswith(('jax.', 'poi_tpu.')) or m == 'poi_tpu' for m in sys.modules), "
        "'jax or poi_tpu was imported'; sys.exit(rc)"
    )
    sets = [f"{k}={v}" for k, v in {**SMALL, "train.num_steps": 20, "train.log_every": 10,
                                     "train.eval_every": 10}.items()]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", POI_TPU_TORCH_DATA_CACHE="off")
    proc = subprocess.run([sys.executable, "-c", code, "train", "--config", CONFIG, "--device", "cpu",
                           "--no-checkpoint", "--set", *sets], capture_output=True, text=True, cwd=REPO, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["steps"] == 20 and [r["step"] for r in out["history"]] == [10, 20]
    assert out["history"][-1]["loss"] < out["history"][0]["loss"]
    assert all(np.isfinite(v) for v in out["final"].values())
