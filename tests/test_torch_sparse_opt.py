"""The port's lazy Adam (poi_tpu_torch.train.sparse_opt) held against
poi_tpu's SparseTableOptimizer on its masked-dense path: the same params,
gradients and touched ids, and the state carried across by convert."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poi_tpu.models.base import DataDims
from poi_tpu.train import sparse_opt as jax_sparse
from poi_tpu.utils.config import Config as JaxConfig
from poi_tpu_torch.convert import flatten, params_from_jax, sparse_adam_state_from_jax, sparse_adam_state_to_numpy
from poi_tpu_torch.data.pipeline import Batch
from poi_tpu_torch.train import sparse_opt
from poi_tpu_torch.utils.config import Config, LossConfig, ModelConfig, TrainConfig

torch.set_num_threads(1)

# Both sides evaluate the same fp32 formulas; sqrt, the bias-correction
# powers and the global norm's summation order may differ in the last bit.
REL_TOL = 1e-6
V, D = 40, 8


def _jax(cfg):
    """The same configuration as poi_tpu's own Config."""
    return JaxConfig.from_dict(cfg.to_dict())


def _cfg(clip=1.0, **train):
    return Config(loss=LossConfig(kind="sampled_softmax", num_sampled=16),
                  train=TrainConfig(learning_rate=1e-2, warmup_steps=0, grad_clip_norm=clip, table_update="sparse",
                                    **train))


def _tree(rng):
    return {
        "embed": {"poi": rng.normal(size=(V, D)).astype(np.float32),
                  "out_bias": rng.normal(size=V).astype(np.float32),
                  "time": rng.normal(size=(6, D)).astype(np.float32)},
        "tower": {"w": rng.normal(size=(D, D)).astype(np.float32)},
    }


def _grads(rng, ids, scale):
    """Gradients as a sampled step leaves them: the tables' rows outside
    ``ids`` are exactly zero."""
    g = jax.tree.map(lambda a: (rng.normal(size=a.shape) * scale).astype(np.float32), _tree(rng))
    untouched = np.setdiff1d(np.arange(V), ids)
    g["embed"]["poi"][untouched] = 0.0
    g["embed"]["out_bias"][untouched] = 0.0
    return g


def _flat(tree):
    return {k.replace("/", "."): v for k, v in flatten(tree).items()}


@pytest.mark.parametrize("clip, grad_scale", [(1.0, 1.0), (1e3, 0.1), (0.0, 0.1)],
                         ids=["clip_engaged", "clip_not_engaged", "no_clip"])
def test_update_matches_poi_tpu_masked_dense(clip, grad_scale):
    """Three updates with a different touched set each: params and both
    moments against update_apply; untouched table rows bit-unchanged."""
    rng = np.random.default_rng(0)
    tree = _tree(rng)
    jopt = jax_sparse.SparseTableOptimizer(_jax(_cfg(clip)))
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jopt.init(jparams)
    opt = sparse_opt.SparseTableOptimizer(_cfg(clip))
    params = {k: torch.from_numpy(v.copy()) for k, v in _flat(tree).items()}
    state = opt.init(params)
    for step in range(3):
        ids = rng.integers(0, V, 12)  # duplicates: each touched row still takes one update
        grads = _grads(rng, ids, grad_scale)
        jparams, jstate, jnorm = jopt.update_apply(jax.tree.map(jnp.asarray, grads), jstate, jparams,
                                                   {"poi": jnp.asarray(ids, jnp.int32)})
        before = {k: p.clone() for k, p in params.items()}
        norm = opt.update({k: torch.from_numpy(v) for k, v in _flat(grads).items()}, state, params,
                          {"poi": torch.from_numpy(ids)})
        assert float(norm) == pytest.approx(float(jnorm), rel=REL_TOL)
        if clip:
            assert (float(norm) > clip) == (clip == 1.0), "the case does not engage the clip as named"
        want_state = jax.tree.map(np.asarray, jstate)
        got_state = sparse_adam_state_to_numpy(state)
        assert got_state["count"] == int(want_state.count) == step + 1
        for name, want in _flat(jax.tree.map(np.asarray, jparams)).items():
            scale = np.abs(want).max()
            np.testing.assert_allclose(params[name].numpy(), want, atol=REL_TOL * scale, rtol=0, err_msg=name)
        for which in ("m", "v"):
            for name, want in _flat(getattr(want_state, which)).items():
                got = _flat(got_state[which])[name]
                np.testing.assert_allclose(got, want, atol=REL_TOL * (np.abs(want).max() + 1e-30), rtol=0,
                                           err_msg=f"{which} {name}")
        untouched = torch.from_numpy(np.setdiff1d(np.arange(V), ids))
        for name in ("embed.poi", "embed.out_bias"):
            assert torch.equal(params[name][untouched], before[name][untouched]), name
            if step == 0:  # never touched yet: the moments stay exactly zero
                assert not state["m"][name][untouched].any() and not state["v"][name][untouched].any()
        assert not torch.equal(params["embed.time"], before["embed.time"])  # dense leaves: ordinary Adam


def test_state_carried_from_poi_tpu_continues_identically():
    """A poi_tpu SparseAdamState → convert → the port's next update equals
    poi_tpu's next update."""
    rng = np.random.default_rng(1)
    tree = _tree(rng)
    jopt = jax_sparse.SparseTableOptimizer(_jax(_cfg()))
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jopt.init(jparams)
    for _ in range(2):
        ids = rng.integers(0, V, 10)
        jparams, jstate, _ = jopt.update_apply(jax.tree.map(jnp.asarray, _grads(rng, ids, 1.0)), jstate, jparams,
                                               {"poi": jnp.asarray(ids, jnp.int32)})
    state = sparse_adam_state_from_jax(jax.tree.map(np.asarray, jstate))
    assert state["count"] == 2 and sorted(state["m"]) == sorted(_flat(tree))
    back = sparse_adam_state_to_numpy(state)
    for which in ("m", "v"):
        for name, want in _flat(jax.tree.map(np.asarray, getattr(jstate, which))).items():
            assert np.array_equal(_flat(back[which])[name], want)
    params = {k: v.clone() for k, v in params_from_jax(jax.tree.map(np.asarray, jparams)).items()}
    ids = rng.integers(0, V, 10)
    grads = _grads(rng, ids, 1.0)
    jparams, _, _ = jopt.update_apply(jax.tree.map(jnp.asarray, grads), jstate, jparams,
                                      {"poi": jnp.asarray(ids, jnp.int32)})
    sparse_opt.SparseTableOptimizer(_cfg()).update({k: torch.from_numpy(v) for k, v in _flat(grads).items()}, state,
                                                   params, {"poi": torch.from_numpy(ids)})
    for name, want in _flat(jax.tree.map(np.asarray, jparams)).items():
        np.testing.assert_allclose(params[name].numpy(), want, atol=REL_TOL * np.abs(want).max(), rtol=0)
    with pytest.raises(ValueError, match="SparseAdamState"):
        sparse_adam_state_from_jax({"count": 0})


@pytest.mark.parametrize("overrides, match", [
    (dict(optimizer="sgd"), "optimizer"),
    (dict(weight_decay=0.01), "weight_decay"),
    ("ce", "sampled objective"),
])
def test_validate_config_matches_poi_tpu(overrides, match):
    cfg = _cfg() if overrides == "ce" else _cfg(**overrides)
    if overrides == "ce":
        cfg = dataclasses.replace(cfg, loss=LossConfig(kind="ce"))
    for validate, c in ((sparse_opt.validate_config, cfg), (jax_sparse.validate_config, _jax(cfg))):
        with pytest.raises(ValueError, match=match):
            validate(c)


@pytest.mark.parametrize("num_pois, embed_dim, tied, loss", [
    (36969, 256, True, "sampled_softmax"),  # config #4: masked-dense
    (1_000_000, 512, True, "sampled_softmax"),  # config #5: rows mode
    (1_000_000, 512, False, "sampled_softmax"),
    (1_000_000, 512, True, "bpr"),
])
def test_rows_mode_dispatch_matches_poi_tpu(num_pois, embed_dim, tied, loss):
    cfg = dataclasses.replace(_cfg(), model=ModelConfig(embed_dim=embed_dim, tie_output_embedding=tied),
                              loss=LossConfig(kind=loss))
    dims = DataDims(num_users=1, num_pois=num_pois, num_time_buckets=1, num_geo_buckets=1, num_tgap_buckets=1,
                    num_dist_buckets=1)
    assert sparse_opt.DENSE_LAZY_MAX_BYTES == jax_sparse.DENSE_LAZY_MAX_BYTES
    assert sparse_opt.rows_mode_enabled(cfg, dims, 1) == jax_sparse.rows_mode_enabled(_jax(cfg), dims, 1)
    assert not sparse_opt.rows_mode_enabled(cfg, dims, 4)


def test_touched_ids_match_poi_tpu_on_the_same_pool():
    rng = np.random.default_rng(2)
    B, T, S = 3, 5, 16
    batch = Batch(user=rng.integers(0, 9, B), poi_in=rng.integers(0, V, (B, T)), poi_tgt=rng.integers(0, V, (B, T)),
                  mask=np.ones((B, T), np.float32), time_bucket=None, geo_bucket=None, tgap_idx=None,
                  tgap_frac=None, dist_idx=None, dist_frac=None)
    key = jax.random.key(3)
    want = jax_sparse.touched_ids(_jax(_cfg()), jax.tree.map(lambda a: a if a is None else jnp.asarray(a), batch), key, V)
    neg = torch.from_numpy(np.array(jax.random.randint(key, (S,), 0, V)))
    tb = batch._replace(**{f: torch.from_numpy(getattr(batch, f)) for f in ("user", "poi_in", "poi_tgt")})
    got = sparse_opt.touched_ids(tb, neg)
    assert sorted(got) == sorted(want) == ["poi", "user"]
    for k in got:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k]))
