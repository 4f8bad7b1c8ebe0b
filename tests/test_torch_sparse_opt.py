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


def test_dedup_matches_poi_tpu():
    """dedup_ids and dedup_sum on the same ids: the sorted unique ids, the
    distinct out-of-bounds sentinels after them, and the same summed rows
    (both sum each id's rows in occurrence order)."""
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 30, 90).astype(np.int32)
    g = rng.normal(size=(90, D)).astype(np.float32)
    got = sparse_opt.dedup_ids(torch.from_numpy(ids), 30).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_sparse.dedup_ids(jnp.asarray(ids), 30)))
    n = len(np.unique(ids))
    np.testing.assert_array_equal(got[:n], np.unique(ids))
    assert (got[n:] >= 30).all() and (np.diff(got) > 0).all()
    for rows in (g, g[:, 0]):  # table rows and bias entries
        u, s = sparse_opt.dedup_sum(torch.from_numpy(ids), torch.from_numpy(rows), 30)
        ju, js = jax_sparse.dedup_sum(jnp.asarray(ids), jnp.asarray(rows), 30)
        np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0, atol=1e-6)
        assert not s[n:].any()


@pytest.mark.parametrize("threshold", [None, 0], ids=["masked_dense", "gather_scatter"])
def test_all_rows_touched_matches_dense_adam(threshold, monkeypatch):
    """With ids covering every row (with duplicates, unsorted), lazy Adam is
    optax.chain(clip_by_global_norm, adam) on both table paths, as
    tests/test_sparse_opt.py holds poi_tpu's."""
    import optax

    from poi_tpu.train.state import lr_schedule as jax_lr_schedule

    if threshold is not None:
        monkeypatch.setattr(sparse_opt, "DENSE_LAZY_MAX_BYTES", threshold)
    cfg = _cfg(clip=1.0)
    rng = np.random.default_rng(5)
    tree = {"embed": {"poi": rng.normal(size=(V, D)).astype(np.float32),
                      "out_bias": rng.normal(size=V).astype(np.float32),
                      "user": rng.normal(size=(5, D)).astype(np.float32)},
            "tower": {"w": rng.normal(size=(D, D)).astype(np.float32)}}
    dense = optax.chain(optax.clip_by_global_norm(cfg.train.grad_clip_norm), optax.adam(jax_lr_schedule(cfg.train)))
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = dense.init(jparams)
    opt = sparse_opt.SparseTableOptimizer(cfg)
    params = {k: torch.from_numpy(v.copy()) for k, v in _flat(tree).items()}
    state = opt.init(params)
    ids = {"poi": torch.from_numpy(np.concatenate([np.arange(V), rng.integers(0, V, 7)])),
           "user": torch.from_numpy(np.array([4, 0, 1, 2, 3, 2, 2]))}
    for _ in range(4):
        grads = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), tree)
        upd, jstate = dense.update(jax.tree.map(jnp.asarray, grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        opt.update({k: torch.from_numpy(v) for k, v in _flat(grads).items()}, state, params, ids)
    for name, want in _flat(jax.tree.map(np.asarray, jparams)).items():
        np.testing.assert_allclose(params[name].numpy(), want, rtol=2e-6, atol=2e-7, err_msg=name)


def test_masked_and_gather_scatter_paths_agree(monkeypatch):
    """Partly touched tables, two steps: the masked-dense and the
    gather/scatter paths give the same params and moments (the port of
    tests/test_sparse_opt.py's test for poi_tpu)."""
    rng = np.random.default_rng(3)
    Vm = 64
    tree = {"embed": {"poi": rng.normal(size=(Vm, D)).astype(np.float32),
                      "out_bias": rng.normal(size=Vm).astype(np.float32)},
            "tower": {"w": rng.normal(size=(D, D)).astype(np.float32)}}
    grads = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), tree)
    touched = np.sort(rng.choice(Vm, 17, replace=False))
    cold = np.setdiff1d(np.arange(Vm), touched)
    grads["embed"]["poi"][cold] = 0.0
    grads["embed"]["out_bias"][cold] = 0.0
    ids = {"poi": torch.from_numpy(np.concatenate([touched, touched[:5]]))}
    opt = sparse_opt.SparseTableOptimizer(_cfg())
    outs = []
    for threshold in (10**9, 0):
        monkeypatch.setattr(sparse_opt, "DENSE_LAZY_MAX_BYTES", threshold)
        params = {k: torch.from_numpy(v.copy()) for k, v in _flat(tree).items()}
        state = opt.init(params)
        g = {k: torch.from_numpy(v) for k, v in _flat(grads).items()}
        norms = [opt.update(g, state, params, ids) for _ in range(2)]
        outs.append((params, state["m"], state["v"], norms))
    for which in range(3):
        for name, want in outs[0][which].items():
            torch.testing.assert_close(outs[1][which][name], want, rtol=1e-6, atol=1e-7, msg=name)
    torch.testing.assert_close(torch.stack(outs[1][3]), torch.stack(outs[0][3]), rtol=1e-6, atol=0)


@pytest.mark.parametrize("clip", [1.0, 0.0], ids=["clip_engaged", "no_clip"])
def test_row_grads_update_matches_poi_tpu(clip, monkeypatch):
    """The rows-gradient form: the tables' gradients as one row per id
    occurrence (``row_grads``), the user table dense at its touched ids, on
    the gather/scatter path in both packages; three updates of params and
    both moments against update_apply's."""
    monkeypatch.setattr(sparse_opt, "DENSE_LAZY_MAX_BYTES", 0)
    monkeypatch.setattr(jax_sparse, "DENSE_LAZY_MAX_BYTES", 0)
    rng = np.random.default_rng(6)
    tree = _tree(rng)
    tree["embed"]["user"] = rng.normal(size=(9, D)).astype(np.float32)
    jopt = jax_sparse.SparseTableOptimizer(_jax(_cfg(clip)))
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jopt.init(jparams)
    opt = sparse_opt.SparseTableOptimizer(_cfg(clip))
    params = {k: torch.from_numpy(v.copy()) for k, v in _flat(tree).items()}
    state = opt.init(params)
    seen = set()
    for _ in range(3):
        occ = rng.integers(0, V, 50).astype(np.int32)  # duplicates: summed per unique id
        rows, brows = rng.normal(size=(50, D)).astype(np.float32), rng.normal(size=50).astype(np.float32)
        users = rng.integers(0, 6, 4).astype(np.int32)  # users 6-8 never touched
        seen.update(occ.tolist())
        g = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), tree)
        g["embed"]["user"][np.setdiff1d(np.arange(9), users)] = 0.0
        jg = jax.tree.map(jnp.asarray, g)
        # Placeholders, as poi_tpu's rows step passes them.
        jg["embed"]["poi"], jg["embed"]["out_bias"] = jnp.zeros(()), jnp.zeros(())
        jparams, jstate, jnorm = jopt.update_apply(
            jg, jstate, jparams, {"user": jnp.asarray(users)},
            row_grads={"poi": (jnp.asarray(occ), jnp.asarray(rows)),
                       "out_bias": (jnp.asarray(occ), jnp.asarray(brows))})
        tg = {k: torch.from_numpy(v) for k, v in _flat(g).items() if k not in ("embed.poi", "embed.out_bias")}
        t_occ = torch.from_numpy(occ).long()
        norm = opt.update(tg, state, params, {"user": torch.from_numpy(users).long()},
                          row_grads={"poi": (t_occ, torch.from_numpy(rows)),
                                     "out_bias": (t_occ, torch.from_numpy(brows))})
        assert float(norm) == pytest.approx(float(jnorm), rel=REL_TOL)
    for name, want in _flat(jax.tree.map(np.asarray, jparams)).items():
        np.testing.assert_allclose(params[name].numpy(), want, atol=REL_TOL * np.abs(want).max(), rtol=0,
                                   err_msg=name)
    got_state = sparse_adam_state_to_numpy(state)
    for which in ("m", "v"):
        for name, want in _flat(jax.tree.map(np.asarray, getattr(jstate, which))).items():
            np.testing.assert_allclose(_flat(got_state[which])[name], want,
                                       atol=REL_TOL * (np.abs(want).max() + 1e-30), rtol=0,
                                       err_msg=f"{which} {name}")
    cold = np.setdiff1d(np.arange(V), sorted(seen))  # lazy Adam: never-touched rows keep their bits
    assert cold.size and np.array_equal(params["embed.poi"].numpy()[cold], tree["embed"]["poi"][cold])
    assert np.array_equal(params["embed.user"].numpy()[6:], tree["embed"]["user"][6:])


@pytest.mark.parametrize("num_rows, skew", [(40, False), (6, False), (300, True)],
                         ids=["table", "few_rows", "one_id_holds_half"])
def test_lookup_gradient_matches_jax_take(num_rows, skew):
    """The embedding lookup's fixed-order backward (``ops.segment``: sorted
    ids, each id's rows summed in runs, then the runs) against ``jax.grad``
    of ``jnp.take``: the same row sums, within fp32 summation order. Half
    the ids one id, as a batch's padded positions make them, and a table of
    fewer rows than ids."""
    from poi_tpu_torch.models.base import lookup

    rng = np.random.default_rng(7)
    ids = rng.integers(0, num_rows, (9, 13))
    if skew:
        ids.reshape(-1)[: ids.size // 2] = 0
    table = rng.normal(size=(num_rows, D)).astype(np.float32)
    g = rng.normal(size=(9, 13, D)).astype(np.float32)
    want = jax.grad(lambda t: jnp.sum(jnp.take(t, jnp.asarray(ids), axis=0) * jnp.asarray(g)))(jnp.asarray(table))
    t = torch.from_numpy(table).requires_grad_()
    lookup(t, torch.from_numpy(ids)).backward(torch.from_numpy(g))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    again = torch.from_numpy(table).requires_grad_()
    lookup(again, torch.from_numpy(ids)).backward(torch.from_numpy(g))
    assert torch.equal(again.grad, t.grad)


def _first_adam_step(p0: torch.Tensor, g: torch.Tensor, lr: float) -> torch.Tensor:
    from poi_tpu_torch.train.state import Optimizer

    opt = Optimizer(TrainConfig(learning_rate=lr, warmup_steps=0, grad_clip_norm=0.0, lr_schedule="constant"))
    p = {"w": p0.clone()}
    opt.update({"w": g}, opt.init(p), p)
    return p["w"]


@pytest.mark.parametrize("fault", [None, "untouched_row_moved", "touched_in_one_run", "move_past_the_gap"])
def test_first_step_apart_explains_only_a_gradient_gap(fault):
    """``state.first_step_apart`` on two first Adam steps (the port's
    optimizer, lr 1e-3, no clip) from one tensor: gradients near eps that
    differ by summation-order noise (~5e-11) put entries past 2e-6 + 2e-5
    relative, and the gap explains each; a moved row whose gradient is 0 in
    both runs, a row one run left untouched, and a move past what the gap
    allows are not explained."""
    from poi_tpu_torch.train.state import first_step_apart

    lr = 1e-3
    p0 = torch.full((3, 3), 0.01)
    g = torch.tensor([[2e-9, -3e-9, 1.5e-8], [0.0, 0.0, 0.0], [0.3, -0.2, 0.1]])
    g2 = g.clone()
    g2[0] += torch.tensor([5e-11, -4e-11, 6e-11])
    if fault == "touched_in_one_run":
        g2[1, 1] = 5e-10
    p1, p2 = _first_adam_step(p0, g, lr), _first_adam_step(p0, g2, lr)
    if fault == "untouched_row_moved":
        p2[1, 0] += 1e-5
    if fault == "move_past_the_gap":
        p2[0, 0] += 1e-4
    unexplained, explained = first_step_apart(p2, p1, g2, g, lr, 2e-6, 2e-5)
    if fault is None:
        assert unexplained == 0 and explained == 2, (unexplained, explained)
    else:
        assert unexplained == 1, (fault, unexplained, explained)
