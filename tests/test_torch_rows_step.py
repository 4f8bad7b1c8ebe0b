"""Config #5's rows-gradient step in the port (``Trainer._rows_loss`` and
lazy Adam's gather/scatter path with ``row_grads``) held against poi_tpu's
``_step_core`` rows step on the same params (convert), the same batches and
the same negative pools, and against the port's own dense-gradient sparse
path.

Config #5 (multihost_1m at mesh.model=1) shrunk in size only: a 512-POI
synthetic catalog, T=16, 32-d attention with 2 heads, user embedding,
sampled softmax over 64 negatives, batch 16. Rows mode needs a table above
``DENSE_LAZY_MAX_BYTES``; both packages' thresholds are set to 0 here, which
also sends the user table down the gather/scatter path. poi_tpu's step draws
its pool with jax.random.randint(fold_in(state.rng, step), ...); the port's
Trainer replays those ids through its ``negatives`` hook."""

import jax
import numpy as np
import pytest
import torch

from poi_tpu.models.base import DataDims as JaxDataDims
from poi_tpu.train import sparse_opt as jax_sparse
from poi_tpu.train.loop import Trainer as JaxTrainer
from poi_tpu.utils.config import Config as JaxConfig
from poi_tpu_torch.configs.presets import get_config
from poi_tpu_torch.convert import flatten, params_to_numpy, sparse_adam_state_to_numpy
from poi_tpu_torch.data.dataset import load_dataset
from poi_tpu_torch.data.pipeline import make_train_loader
from poi_tpu_torch.models.base import DataDims
from poi_tpu_torch.parallel.mesh import Mesh
from poi_tpu_torch.train import sparse_opt
from poi_tpu_torch.train.loop import Trainer, train
from poi_tpu_torch.train.state import ADAM_B1, first_step_apart

torch.set_num_threads(1)

SMALL = {
    "mesh.model": 1, "mesh.embedding_mode": "psum",
    "data.num_users": 64, "data.num_pois": 512, "data.mean_checkins_per_user": 30, "data.max_seq_len": 16,
    "data.min_user_checkins": 4, "data.min_poi_checkins": 1,
    "model.embed_dim": 32, "model.hidden_dim": 32, "model.attn_heads": 2, "model.attn_window": 4,
    "model.compute_dtype": "float32", "loss.num_sampled": 64, "train.batch_size": 16, "train.num_steps": 5,
    "train.log_every": 1, "train.warmup_steps": 0, "train.learning_rate": 1e-2,
}
STEPS = 5
# Both packages run the same fp32 arithmetic up to summation order (the
# sampled logits' bf16 operands round at the same points; the duplicate
# rows' sums run in the same sorted order).
REL_TOL = 1e-5
# Params after the first step: an entry past REL_TOL passes only where the
# two packages' gradients, equal up to summation order, explain it
# (``first_step_apart``: Adam's first step multiplies a gradient near or
# below eps by up to lr / eps = 1e6 here; with the presets' blockwise
# attention 4 gru.wh entries whose gradients lie near 1e-8 move up to
# 3.3e-5 apart against REL_TOL's 6.4e-6), and at most this many such
# entries.
EPS_REGIME_MAX = 16


def _cfg(attn_impl: str | None = None):
    """Config #5 at SMALL, its attention the preset's form unless given."""
    sets = {**SMALL, **({"model.attn_impl": attn_impl} if attn_impl else {})}
    return get_config("multihost_1m").with_overrides({k: str(v) for k, v in sets.items()})


def _jax(cfg):
    return JaxConfig.from_dict(cfg.to_dict())


def _leaves(tree):
    return {k: np.asarray(v, np.float32) for k, v in flatten(tree).items()}


def _assert_trees_close(got, want, tol, what):
    got = _leaves(got)
    for name, w in _leaves(want).items():
        np.testing.assert_allclose(got[name], w, atol=tol * (np.abs(w).max() + 1e-30), rtol=0,
                                   err_msg=f"{what} {name}")


@pytest.fixture(scope="module")
def ds():
    return load_dataset(_cfg().data)


@pytest.fixture(scope="module")
def batches(ds):
    loader = make_train_loader(ds.train, batch_size=SMALL["train.batch_size"], seed=_cfg().train.seed)
    out = [next(loader) for _ in range(STEPS)]
    loader.close()
    return out


def _reference(ds, batches, attn_impl: str | None = None):
    """poi_tpu's rows step, traced and compiled once: its initial params,
    its pools, and its state and metrics after each of the STEPS steps."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_sparse, "DENSE_LAZY_MAX_BYTES", 0)
        cfg = _cfg(attn_impl)
        jt = JaxTrainer(_jax(cfg), JaxDataDims.from_dataset(ds))
        assert jax_sparse.rows_mode_enabled(jt.cfg, jt.dims, 1)
        js = jt.init_state()
        tree = jax.tree.map(np.asarray, js.params)
        S, V = cfg.loss.num_sampled, ds.num_pois
        pools = [np.array(jax.random.randint(jax.random.fold_in(js.rng, s), (S,), 0, V)) for s in range(STEPS)]
        states, metrics = [], []
        for batch in batches:
            js, m = jt.step(js, batch)
            states.append(jax.tree.map(np.asarray, (js.params, js.opt_state)))
            metrics.append({k: float(v) for k, v in m.items()})
    return tree, pools, states, metrics


@pytest.fixture(scope="module")
def reference(ds, batches):
    return _reference(ds, batches)


@pytest.fixture(scope="module")
def reference_vanilla(ds, batches):
    return _reference(ds, batches, "vanilla")


def _port(ds, reference, monkeypatch, attn_impl: str | None = None):
    monkeypatch.setattr(sparse_opt, "DENSE_LAZY_MAX_BYTES", 0)
    tree, pools = reference[:2]
    tt = Trainer(_cfg(attn_impl), DataDims.from_dataset(ds), device="cpu",
                 negatives=lambda step: torch.from_numpy(pools[step]))
    assert tt.rows_mode
    return tt, tt.init_state(tree)


def test_rows_step_matches_poi_tpu(ds, batches, reference, monkeypatch):
    """One rows step from the same params on the same batch and pool: the
    loss, the grad norm, every parameter (``EPS_REGIME_MAX``) and both
    moments."""
    tt, st = _port(ds, reference, monkeypatch)
    st, m = tt.step(st, batches[0])
    (jparams, jopt), jm = reference[2][0], reference[3][0]
    assert abs(float(m["loss"]) - jm["loss"]) <= REL_TOL * jm["loss"]
    assert float(m["grad_norm"]) == pytest.approx(jm["grad_norm"], rel=1e-4)
    lazy = sparse_adam_state_to_numpy(st.opt_state)
    got, g, g_ref = _leaves(params_to_numpy(tt.model)), _leaves(lazy["m"]), _leaves(jopt.m)
    explained = 0
    for name, w in _leaves(jparams).items():
        off, ok = first_step_apart(*(torch.from_numpy(a) for a in (got[name], w, g[name] / (1 - ADAM_B1),
                                                                   g_ref[name] / (1 - ADAM_B1))),
                                   tt.optimizer.lr(0), REL_TOL * (np.abs(w).max() + 1e-30), 0.0)
        assert off == 0, f"params {name}: {off} entries past the tolerance that the gradients do not explain"
        explained += ok
    assert explained <= EPS_REGIME_MAX, explained
    assert lazy["count"] == int(jopt.count) == 1
    for which in ("m", "v"):
        _assert_trees_close(lazy[which], getattr(jopt, which), 1e-4, which)


def test_rows_trajectory_matches_poi_tpu(ds, batches, reference_vanilla, monkeypatch):
    """Five steps through train() on the seeded numpy TrainLoader: each
    step's loss and grad norm, then the lazy-Adam state. (The params are not
    compared after five steps: where an element's gradient is within
    summation noise of 0, Adam's normalised step lr·m/(√v + eps) may move
    it differently on the two sides, as test_torch_train_attention.py
    notes. For the same reason both packages run the vanilla attention
    here: with the presets' blockwise form, which the one-step tests run,
    the params after step 1 part at a few gru.wh entries whose gradients
    lie near eps, and later steps' gradients carry that into 12 of 3,072
    entries of m past 1e-3 of its largest after five steps.)"""
    reference = reference_vanilla
    tt, st = _port(ds, reference, monkeypatch, "vanilla")
    _, final, hist = train(_cfg("vanilla"), ds, trainer=tt, state=st)
    assert [r["step"] for r in hist] == list(range(1, STEPS + 1))
    for row, want in zip(hist, reference[3]):
        assert abs(row["loss"] - want["loss"]) <= REL_TOL * want["loss"], (row, want)
        assert row["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-4)
    assert hist[-1]["loss"] < hist[0]["loss"]
    jopt = reference[2][-1][1]
    lazy = sparse_adam_state_to_numpy(final.opt_state)
    assert lazy["count"] == int(jopt.count) == STEPS
    for which in ("m", "v"):
        _assert_trees_close(lazy[which], getattr(jopt, which), 1e-3, which)


def test_rows_step_matches_the_dense_grad_sparse_path(ds, batches, reference, monkeypatch):
    """The port's rows step against its own dense-gradient sparse step
    (autograd's [V, D] table gradient, gathered at the deduplicated touched
    ids) from the same state, batch and pool, within the reference's
    tolerances for the same comparison (tests/test_sparse_opt.py); the
    tables' dense gradients never exist on the rows path."""
    out = []
    for rows in (True, False):
        tt, st = _port(ds, reference, monkeypatch)
        tt.rows_mode = rows
        made = []
        for k in ("embed.poi", "embed.out_bias"):
            st.params[k].register_post_accumulate_grad_hook(lambda p, k=k: made.append(k))
        st, m = tt.step(st, batches[0])
        assert sorted(made) == ([] if rows else ["embed.out_bias", "embed.poi"]), made
        assert all(p.grad is None for p in st.params.values())
        out.append((m, {k: p.detach().clone() for k, p in st.params.items()}))
    (m_rows, p_rows), (m_dense, p_dense) = out
    assert abs(float(m_rows["loss"]) - float(m_dense["loss"])) < 1e-5
    assert abs(float(m_rows["grad_norm"]) - float(m_dense["grad_norm"])) < 1e-4 * max(1.0, float(m_dense["grad_norm"]))
    for k, want in p_dense.items():
        torch.testing.assert_close(p_rows[k], want, atol=2e-6, rtol=2e-5, msg=k)


def test_config5_full_dims_trainer_builds_without_allocating():
    """Config #5's Trainer at its full dims (V = 903,889, D = 512) builds in
    rows mode, its 1.85 GB table on the meta device; the preset's own mesh
    (mesh.model=4, a2a) builds on rank 0 of a (1, 4) mesh with a quarter of
    the padded catalog (903,892 rows) and no rows step."""
    dims = DataDims(num_users=99_988, num_pois=903_889, num_time_buckets=168, num_geo_buckets=1024,
                    num_tgap_buckets=1, num_dist_buckets=1)
    cfg = get_config("multihost_1m").with_overrides({"mesh.model": "1", "mesh.embedding_mode": "psum"})
    tt = Trainer(cfg, dims, device="meta")
    assert tt.rows_mode and tt.model.embed["poi"].shape == (903_889, 512) and tt.model.embed["poi"].is_meta
    state = tt.init_state()
    assert state.opt_state["m"]["embed.poi"].is_meta
    sharded = Trainer(get_config("multihost_1m"), dims, device="meta", mesh=Mesh(1, 4, world_size=4, rank=0))
    assert not sharded.rows_mode and sharded.a2a and sharded.model.embed["poi"].shape == (225_973, 512)
