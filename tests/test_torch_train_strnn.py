"""Config #3's path in the port (ST-RNN tower: interpolated spatial and
temporal transitions and the RNN recurrence, the user embedding, full CE,
dense Adam) held against poi_tpu on the same parameters (convert) and the
same seeded TrainLoader batches.

Config #3 (strnn_gowalla) shrunk in size only: a 64-user, 512-POI
gowalla-shaped catalog, T=16, 32-d, 8 time-gap and 8 distance buckets,
batch 16; dropout 0 for the comparisons (the two packages draw dropout masks
from different generators)."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poi_tpu.eval.evaluate import evaluate as jax_evaluate
from poi_tpu.eval.serve import Checkin as JaxCheckin
from poi_tpu.eval.serve import Recommender as JaxRecommender
from poi_tpu.models.base import DataDims as JaxDataDims
from poi_tpu.models.strnn import apply_interpolated as jax_apply_interpolated
from poi_tpu.train.loop import Trainer as JaxTrainer
from poi_tpu.train.loop import train as jax_train
from poi_tpu.utils.config import Config as JaxConfig
from poi_tpu_torch.configs.presets import get_config
from poi_tpu_torch.convert import flatten, params_to_numpy
from poi_tpu_torch.data.dataset import load_dataset
from poi_tpu_torch.data.pipeline import make_batch
from poi_tpu_torch.eval.evaluate import evaluate
from poi_tpu_torch.eval.serve import Checkin, Recommender
from poi_tpu_torch.models.base import DataDims, batch_to
from poi_tpu_torch.models.strnn import apply_interpolated
from poi_tpu_torch.train.loop import DROPOUT_STREAM, Trainer, train

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = "strnn_gowalla"
SMALL = {
    "data.num_users": 64, "data.num_pois": 512, "data.max_seq_len": 16, "model.embed_dim": 32,
    "model.hidden_dim": 32, "model.dropout": 0.0, "train.batch_size": 16, "train.num_steps": 5,
    "train.log_every": 1, "train.warmup_steps": 0, "eval.max_eval_users": 200,
}
# fp32 compute: both packages run the same fp32 arithmetic up to summation
# order. bf16 compute: both round the transition and projection operands and
# h to bf16 at the same points, so queries agree to fp32 summation noise
# unless a bf16 rounding flips, which moves a query by ~1e-3 of its scale.
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
    jt = JaxTrainer(_jax(cfg), JaxDataDims.from_dataset(ds))
    js = jt.init_state()
    tree = jax.tree.map(np.asarray, js.params)
    tt = Trainer(cfg, DataDims.from_dataset(ds))
    return jt, js, tt, tt.init_state(tree)


def _close(got, want, tol, what):
    scale = np.abs(want).max() + 1e-30
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=0, err_msg=what)


@pytest.mark.parametrize("dtype, tol", [("float32", REL_TOL), ("bfloat16", BF16_TOL)])
def test_apply_interpolated_matches_jax(dtype, tol):
    """One product over all K+1 endpoints, the gather of idx and idx + 1,
    the lerp; idx reaches K-1, frac reaches 0 and 1."""
    rng = np.random.default_rng(0)
    K, D = 8, 16
    tables = (np.eye(D)[None] + 0.1 * rng.normal(size=(K + 1, D, D))).astype(np.float32)
    x = rng.normal(size=(4, 6, D)).astype(np.float32)
    idx = rng.integers(0, K, size=(4, 6)).astype(np.int32)
    idx[0, 0] = K - 1
    frac = rng.uniform(size=(4, 6)).astype(np.float32)
    frac[0, :2] = (0.0, 1.0)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = np.asarray(jax_apply_interpolated(*(jnp.asarray(a) for a in (tables, x, idx, frac)), jd))
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    got = apply_interpolated(*(torch.from_numpy(a) for a in (tables, x, idx, frac)), td).numpy()
    _close(got, want, tol, "apply_interpolated")


@pytest.mark.parametrize("dtype, tol", [("float32", REL_TOL), ("bfloat16", BF16_TOL)])
def test_queries_match_jax(ds, dtype, tol):
    """``queries`` at the valid positions and ``queries_last`` from poi_tpu's
    init carried across (``tower/layer/{t_tab, s_tab, w_in, c, b}``,
    ``embed/user``)."""
    cfg = _cfg(**{"model.compute_dtype": dtype})
    jt, js, tt, _ = _pair(cfg, ds)
    names = set(flatten(jax.tree.map(np.asarray, js.params)))
    assert {"tower/layer/t_tab", "tower/layer/s_tab", "tower/layer/c", "embed/user"} <= names
    batch = make_batch(ds.train, np.arange(16))
    assert batch.tgap_idx.any() and batch.dist_idx.any() and (batch.tgap_frac > 0).any()
    want = np.asarray(jt.model.queries(js.params, batch))
    want_last = np.asarray(jt.model.queries_last(js.params, batch))
    with torch.no_grad():
        got = tt.model.queries(batch_to(batch, "cpu")).numpy()
        got_last = tt.model.queries_last(batch_to(batch, "cpu")).numpy()
    m = batch.mask[:, :, None]
    _close(got * m, want * m, tol, "queries")
    _close(got_last, want_last, tol, "queries_last")


def test_trainer_step_matches_jax(ds):
    """One step from the same params on the same host batch: loss and
    updated params, in fp32."""
    cfg = _cfg(**{"model.compute_dtype": "float32"})
    jt, js, tt, st = _pair(cfg, ds)
    batch = make_batch(ds.train, np.arange(cfg.train.batch_size))
    js2, jm = jt.step(js, batch)
    st2, tm = tt.step(st, batch)
    assert st2.step == 1
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= REL_TOL * float(jm["loss"])
    got = flatten(params_to_numpy(tt.model))
    for name, w in flatten(jax.tree.map(np.asarray, js2.params)).items():
        assert np.abs(got[name] - w).max() <= 1e-6, name


def test_train_trajectory_and_evaluate_match_jax(ds):
    """Five host-loader steps through train() on the same seeded batches,
    then evaluate() on val."""
    cfg = _cfg(**{"model.compute_dtype": "float32"})
    jt, js, tt, st = _pair(cfg, ds)
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


def test_featurize_and_recommend_match_jax(ds):
    """The featurizer array-equal to poi_tpu's Batch, the time-gap and
    distance buckets and fractions included (timestamps irregular, some
    check-ins with their own coordinates); recommend() equal to poi_tpu's."""
    cfg = _cfg(**{"model.compute_dtype": "float32", "eval.topk_impl": "pallas"})
    jt, js, tt, _ = _pair(cfg, ds)
    rng = np.random.default_rng(5)
    raw = []
    for i in range(8):
        pois = rng.integers(0, ds.num_pois, size=int(rng.integers(1, 24)))
        ts = np.cumsum(rng.exponential(7200.0, size=len(pois)))
        raw.append([(int(p), float(t), float(rng.uniform(-60, 60)) if j % 4 == 1 else None,
                     float(rng.uniform(-120, 120)) if j % 4 == 1 else None) for j, (p, t) in enumerate(zip(pois, ts))])
    jrec, rec = JaxRecommender(jt.model, js.params, _jax(cfg), ds), Recommender(tt.model, cfg, ds)
    want = jrec._featurize([[JaxCheckin(*c) for c in h] for h in raw])
    got = rec._featurize([[Checkin(*c) for c in h] for h in raw])
    assert want.tgap_idx.any() and want.dist_idx.any()
    for name in want._fields:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_array_equal(rec.recommend([[Checkin(*c) for c in h] for h in raw], k=10),
                                  jrec.recommend([[JaxCheckin(*c) for c in h] for h in raw], k=10))


def test_dropout_step_is_keyed_and_finite(ds):
    """Config #3's dropout 0.5 through the step-keyed generator: the same
    step gives the same loss, another step another; a step trains."""
    tt = Trainer(_cfg(**{"model.dropout": 0.5}), DataDims.from_dataset(ds))
    state = tt.init_state()
    batch = batch_to(make_batch(ds.train, np.arange(16)), "cpu")
    with torch.no_grad():
        losses = [float(tt.loss(batch, None, tt.generator(s, DROPOUT_STREAM))) for s in (0, 0, 1)]
    assert losses[0] == losses[1] != losses[2]
    state, m = tt.step(state, make_batch(ds.train, np.arange(16)))
    assert state.step == 1 and np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0


def test_cli_train_config3_on_cpu_without_jax():
    code = (
        "import sys; from poi_tpu_torch.cli import main; rc = main(sys.argv[1:]); "
        "assert not any(m == 'jax' or m.startswith(('jax.', 'poi_tpu.')) or m == 'poi_tpu' for m in sys.modules), "
        "'jax or poi_tpu was imported'; sys.exit(rc)"
    )
    sets = [f"{k}={v}" for k, v in {**SMALL, "model.dropout": 0.5, "train.num_steps": 20, "train.log_every": 10,
                                     "train.eval_every": 10, "data.sampler": "device"}.items()]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", POI_TPU_TORCH_DATA_CACHE="off")
    proc = subprocess.run([sys.executable, "-c", code, "train", "--config", CONFIG, "--device", "cpu",
                           "--no-checkpoint", "--set", *sets], capture_output=True, text=True, cwd=REPO, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["steps"] == 20 and [r["step"] for r in out["history"]] == [10, 20]
    assert out["history"][-1]["loss"] < out["history"][0]["loss"]
    assert all(np.isfinite(v) for v in out["final"].values())
