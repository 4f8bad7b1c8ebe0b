"""The port's vocab-sharded lookups, losses and top-k (ops/embedding.py,
ops/sharded_loss.py, ops/topk.py ``sharded_topk``, the per-shard catalog of
eval/evaluate.py) on 4 gloo ranks on the CPU, held against ``poi_tpu``'s on
the same mesh shapes (2 x 2 and 1 x 4 of the fake CPU devices) and against
the dense one-rank values, from the same numpy inputs and negatives.

One 4-rank job computes every case (``tests/torch_mesh_jobs.py:ops_job``);
each case is its own test here."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poi_tpu.eval.evaluate import _prepare_catalog_sharded as jax_prepare_catalog_sharded
from poi_tpu.ops import embedding as jemb
from poi_tpu.ops import sharded_loss as jsl
from poi_tpu.ops.topk import make_sharded_topk
from poi_tpu.parallel.mesh import make_mesh
from poi_tpu.train import losses as jlosses
from poi_tpu.utils.config import Config as JaxConfig
from poi_tpu_torch.configs.presets import get_config
from poi_tpu_torch.ops import embedding as emb
from poi_tpu_torch.parallel.launch import spawn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, D, B, T = 64, 16, 8, 5
N_BPR, S, K = 4, 16, 5
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
LOSSES = ("ce", "bpr", "sampled_on", "sampled_off")


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    skew = rng.integers(0, V // 4, (B, T))  # every id on model rank 0 of either mesh
    tq = rng.normal(size=(B, D)).astype(np.float32)
    ttable = rng.normal(size=(V, D)).astype(np.float32)
    ttable[V // 2:] = ttable[:V // 2]  # each row also on another shard: ties across shards
    ttable[1] = ttable[0]  # and within one
    tbias = rng.normal(size=(V,)).astype(np.float32)
    tbias[V // 2:] = tbias[:V // 2]
    tbias[1] = tbias[0]
    return {
        "table": rng.normal(size=(V, D)).astype(np.float32),
        "bias": rng.normal(size=(V,)).astype(np.float32),
        "ids": rng.integers(0, V, (B, T)),
        "skew": skew,
        "cot": rng.normal(size=(B, T, D)).astype(np.float32),
        "q": rng.normal(size=(B, T, D)).astype(np.float32),
        "tgt": rng.integers(0, V, (B, T)),
        # Rows of different mask counts: each data rank's share of the global mean differs.
        "mask": (rng.random((B, T)) > np.linspace(0.1, 0.8, B)[:, None]).astype(np.float32),
        "bpr_neg": np.asarray(jlosses.draw_bpr_negatives(jax.random.key(3), B, T, N_BPR, V)),
        "pool": np.asarray(jlosses.draw_sampled_negatives(jax.random.key(4), S, V)),
        "tq": tq, "ttable": ttable, "tbias": tbias, "k": np.asarray(K),
        "counts": rng.integers(0, 4, V).astype(np.float64),
    }


@pytest.fixture(scope="module")
def rig(tmp_path_factory, eight_devices):
    d = tmp_path_factory.mktemp("torch_sharded")
    inp = _inputs()
    np.savez(d / "inp.npz", **inp)
    spawn("tests.torch_mesh_jobs:ops_job", 4, {"inp": str(d / "inp.npz"), "out": str(d / "out.npz")}, timeout=300,
          cwd=REPO, log_dir=str(d))
    with np.load(d / "out.npz") as f:
        out = {k: f[k] for k in f.files}
    meshes = {tag: make_mesh(*shape, devices=eight_devices[:4]) for tag, shape in MESHES.items()}
    return inp, out, meshes


def _close(got, want, rel: float) -> None:
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * max(float(np.abs(want).max()), 1e-30))


def _dense_grad(ids, cot) -> np.ndarray:
    g = np.zeros((V, D), np.float32)
    np.add.at(g, ids.reshape(-1), cot.reshape(-1, D))
    return g


@pytest.mark.parametrize("tag", MESHES)
@pytest.mark.parametrize("mode", ["psum", "a2a"])
def test_lookup_equals_dense_and_poi_tpu(rig, tag, mode):
    """Values exact against the dense gather and poi_tpu's lookup; the
    table's gradient (summed over data, gathered over model) against the
    dense one-rank gradient to 1e-6."""
    inp, out, meshes = rig
    table, ids = jnp.asarray(inp["table"]), jnp.asarray(inp["ids"], jnp.int32)
    ref = jemb.make_psum_lookup(meshes[tag]) if mode == "psum" else jemb.make_a2a_lookup(meshes[tag], 16.0)
    got = out[f"{tag}/{mode}/out"]
    np.testing.assert_array_equal(got, inp["table"][inp["ids"]])
    np.testing.assert_array_equal(got, np.asarray(jax.jit(ref)(table, ids)))
    _close(out[f"{tag}/{mode}/grad"], _dense_grad(inp["ids"], inp["cot"]), 1e-6)


@pytest.mark.parametrize("tag", MESHES)
def test_a2a_drops_what_poi_tpu_drops(rig, tag):
    """Skewed ids (all on model rank 0) at capacity factor 1: the port's a2a
    lookup reads zeros at exactly poi_tpu's dropped positions, its gradient
    is the dense one of the ids it read, and the overflow fraction at the real granularity
    (data shards included) is poi_tpu's."""
    inp, out, meshes = rig
    data, model = MESHES[tag]
    table, skew = jnp.asarray(inp["table"]), jnp.asarray(inp["skew"], jnp.int32)
    lookup = jemb.make_a2a_lookup(meshes[tag], 1.0)
    want = np.asarray(jax.jit(lookup)(table, skew))
    got = out[f"{tag}/a2a_skew/out"]
    dropped = ~want.any(axis=-1)
    assert dropped.any() and not dropped.all()
    np.testing.assert_array_equal(got, want)
    # The gradient of what was read: the dense one of the ids that were not dropped.
    _close(out[f"{tag}/a2a_skew/grad"], _dense_grad(inp["skew"][~dropped], inp["cot"][~dropped]), 1e-6)
    frac = emb.lookup_overflow_fraction(torch.from_numpy(inp["skew"]), model, V // model, 1.0, data_shards=data)
    want_frac = jemb.lookup_overflow_fraction(skew, model, V // model, 1.0, data_shards=data)
    assert float(frac) == float(want_frac) == pytest.approx(dropped.mean())


@pytest.mark.parametrize("ids, m, rows, cap", [
    (np.repeat([0, 16, 32, 48], 4), 4, 16, 4),  # one owner a chunk of 16: 12 over
    (np.tile([0, 32], 8), 2, 32, 4),  # interleaved owners
    (np.arange(16)[::-1] % 5, 2, 3, 3),  # owners past the last shard clip to it
])
def test_route_by_owner_matches_poi_tpu(ids, m, rows, cap):
    """The bucketing itself: send buffer, slots and overflow as poi_tpu's."""
    got = emb.route_by_owner(torch.from_numpy(ids).long(), m, rows, cap)
    want = jemb._route_by_owner(jnp.asarray(ids, jnp.int32), m, rows, cap)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _jax_loss(name: str, mesh, sharded: bool):
    psum = jemb.make_psum_lookup(mesh)
    if name == "ce":
        return jsl.make_sharded_ce(mesh) if sharded else (lambda q, t, b, y, m, k: jlosses.ce_loss(q, t, b, y, m))
    if name == "bpr":
        return jsl.make_sharded_bpr(mesh, psum, N_BPR, V) if sharded else (
            lambda q, t, b, y, m, k: jlosses.bpr_loss(q, t, b, y, m, k, N_BPR, V))
    fused = name.split("_")[1]
    if sharded:
        return jsl.make_sharded_sampled_softmax(mesh, psum, S, V, fused=fused, interpret=True)
    return lambda q, t, b, y, m, k: jlosses.sampled_softmax_loss(q, t, b, y, m, k, S, V)


@pytest.mark.parametrize("tag", MESHES)
@pytest.mark.parametrize("name", LOSSES)
def test_sharded_loss_matches_poi_tpu(rig, tag, name):
    """The loss (each data rank's part summed) equals poi_tpu's sharded loss
    and the dense loss; its gradients in q, the table and the bias equal
    jax.grad of poi_tpu's sharded loss to 1e-5 relative. The negatives are
    poi_tpu's draws from the same keys, injected. One exception, set by the
    dtype: the plain sampled softmax rounds the table's cotangent to bf16
    (as poi_tpu's does), poi_tpu once for the whole batch and the port once
    a data rank before the sum over data, so on a mesh with data > 1 that
    gradient is held to bf16's resolution, 2^-8 of its largest entry."""
    inp, out, meshes = rig
    key = jax.random.key(3 if name == "bpr" else 4)
    args = [jnp.asarray(inp[k]) for k in ("q", "table", "bias")]
    rest = (jnp.asarray(inp["tgt"], jnp.int32), jnp.asarray(inp["mask"]), key)
    sharded = _jax_loss(name, meshes[tag], True)
    want, grads = jax.jit(jax.value_and_grad(lambda q, t, b: sharded(q, t, b, *rest), argnums=(0, 1, 2)))(*args)
    dense = float(_jax_loss(name, meshes[tag], False)(*args, *rest))
    got = float(out[f"{tag}/{name}/loss"])
    assert got == pytest.approx(float(want), rel=1e-5) and got == pytest.approx(dense, rel=1e-5)
    for k, g in zip(("dq", "dtable", "dbias"), grads):
        bf16_rounded = name == "sampled_off" and k == "dtable" and MESHES[tag][0] > 1
        _close(out[f"{tag}/{name}/{k}"], np.asarray(g), 2.0**-8 if bf16_rounded else 1e-5)


def _jax_cfg(impl: str):
    cfg = get_config("smoke").with_overrides({"eval.topk_impl": impl})
    return JaxConfig.from_dict(cfg.to_dict())


@pytest.mark.parametrize("tag", MESHES)
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_sharded_topk_ids_and_tie_order_match_poi_tpu(rig, tag, impl):
    """Rows duplicated across shards and within one tie on purpose. The
    sharded top-k gives poi_tpu's ids exactly: xla over the shards as they
    are, pallas (B11's plain version against the Pallas kernel in interpret
    mode) in ``_prepare_catalog_sharded``'s per-shard popularity id space,
    whose id map is poi_tpu's."""
    inp, out, meshes = rig
    mesh = meshes[tag]
    q, table, bias = (jnp.asarray(inp[k]) for k in ("tq", "ttable", "tbias"))
    if impl == "xla":
        want = make_sharded_topk(mesh, K, impl="xla")(q, table, bias)[1]
    else:
        params = {"embed": {"poi": table, "out_bias": bias}}
        prep = jax_prepare_catalog_sharded(params, _jax_cfg("pallas"), inp["counts"], mesh)
        want = make_sharded_topk(mesh, K, impl="pallas", tile_v=prep.tile_v, interpret=True)(q, prep.table, prep.bias)[1]
        np.testing.assert_array_equal(out[f"{tag}/id_map"], prep.id_map)
    got = out[f"{tag}/topk_{impl}"]
    np.testing.assert_array_equal(got, np.asarray(want))
    if impl == "pallas":
        vals = out[f"{tag}/topk_pallas_vals"]
        assert (np.diff(vals, axis=1) <= 0).all() and (np.diff(vals, axis=1) == 0).any()  # ties were met


def test_pad_vocab_matches_poi_tpu():
    for v, m in ((903_889, 4), (410, 2), (64, 4), (1, 3)):
        assert emb.pad_vocab(v, m) == jemb.pad_vocab(v, m)


