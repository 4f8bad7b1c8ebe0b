"""The port's sequence-parallel attention (``parallel/sp_attention.py``, ring
and Ulysses, and ``collectives.ppermute_ring`` and ``split`` under them) on
4 gloo ranks on the CPU, held against ``poi_tpu``'s ``make_sp_attention`` on
the same mesh shapes of the fake CPU devices (2 x 2 and 1 x 4), from the
same numpy inputs and ``init_mha`` parameters: the forward within 1e-4 and
the gradients of x and of ``wq``..``wo`` within 1e-3, the tolerances of
``tests/test_sp_attention.py``; a window longer than a shard; the Ulysses
refusal of heads that do not split; a narrow attention tower's output and
GRU and projection gradients on the mesh against one rank's, and at bf16
compute against ``poi_tpu``'s tower with its SP attention (fp32 in both
packages whatever the compute dtype). Then a 3-step ``Trainer`` trajectory of
a small attention config with ring on 2 x 2 and Ulysses on 1 x 4, against
``poi_tpu``'s Trainer on the same mesh and the port's one-rank run, at
``tests/test_torch_train_sharded.py``'s tolerances.

Two 4-rank jobs (``tests/torch_mesh_jobs.py``: ``sp_job``, ``train_job``)
compute every case; each case is its own test here."""

import dataclasses
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poi_tpu.models.attention import init_mha
from poi_tpu.models.base import DataDims as JaxDataDims
from poi_tpu.models.base import build_model as jax_build_model
from poi_tpu.parallel.mesh import make_mesh
from poi_tpu.parallel.sp_attention import make_sp_attention as jax_make_sp_attention
from poi_tpu.train.loop import Trainer as JaxTrainer
from poi_tpu.utils.config import Config as JaxConfig
from poi_tpu.utils.config import ModelConfig as JaxModelConfig
from poi_tpu_torch.configs.presets import get_config
from poi_tpu_torch.convert import flatten
from poi_tpu_torch.data.dataset import load_dataset
from poi_tpu_torch.data.pipeline import Batch, make_train_loader
from poi_tpu_torch.models.attention import AttentionTower
from poi_tpu_torch.parallel.launch import spawn
from poi_tpu_torch.parallel.mesh import Mesh
from poi_tpu_torch.parallel.sp_attention import make_sp_attention

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T, D = 4, 16, 16
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
# name -> impl, window, heads, Ulysses' local block. Window 13 spans more
# than one shard on either mesh (T / M = 8 and 4); 2 heads do not split over
# the 1 x 4 mesh's 4.
CASES = {
    "ring_w5": {"impl": "ring", "window": 5, "heads": 4, "block": 4},
    "ulysses_w5": {"impl": "ulysses", "window": 5, "heads": 4, "block": 4},
    "ring_w13": {"impl": "ring", "window": 13, "heads": 4, "block": 4},
    "ulysses_w13": {"impl": "ulysses", "window": 13, "heads": 4, "block": 4},
    "ulysses_h2": {"impl": "ulysses", "window": 5, "heads": 2, "block": 4},
}
FWD_TOL, GRAD_TOL = 1e-4, 1e-3  # tests/test_sp_attention.py's
BF16_GRAD_TOL = 2 ** -8  # a bf16 cotangent's last bit, relative to the largest
WEIGHTS = ("wq", "wk", "wv", "wo")

STEPS = 3
TRAIN_BASE = {"model.kind": "attention", "model.attn_heads": "4", "model.attn_window": "6",
              "model.embed_dim": "32", "model.hidden_dim": "32", "model.compute_dtype": "float32",
              "train.warmup_steps": "0", "train.log_every": "1", "train.num_steps": str(STEPS)}
# Sampled softmax, whose sharded form rounds nothing the one-rank form does
# not (the sharded CE rounds the queries' cotangent to bf16 on each model
# shard, which alone moves the grad norm by ~1e-4 against one rank).
TRAIN_CASES = {
    "ring_2x2": {"mesh": [2, 2], "overrides": {
        **TRAIN_BASE, "mesh.data": "2", "mesh.model": "2", "mesh.embedding_mode": "psum",
        "model.attn_impl": "ring", "loss.kind": "sampled_softmax", "loss.num_sampled": "16"}},
    "ulysses_1x4": {"mesh": [1, 4], "overrides": {
        **TRAIN_BASE, "mesh.model": "4", "mesh.embedding_mode": "a2a", "mesh.a2a_capacity_factor": "8.0",
        "model.attn_impl": "ulysses", "loss.kind": "sampled_softmax", "loss.num_sampled": "16",
        "train.table_update": "sparse"}},
}
METRICS = ("loss", "grad_norm", "param_norm")
TOL = {"loss": 1e-5, "grad_norm": 1e-4, "param_norm": 1e-5}  # tests/test_torch_train_sharded.py's


# Config #4's tower (GRU + attention + LayerNorm), narrow, in fp32: its
# GRU and projections' gradients on the mesh must be one rank's (each model
# rank backpropagates the same loss, so a collective with the wrong
# backward would scale them by M).
TOWER = {"model.embed_dim": "16", "model.hidden_dim": "16", "model.attn_heads": "4", "model.attn_window": "6",
         "model.compute_dtype": "float32", "model.dropout": "0.0"}
# The same tower at bf16 compute, Ulysses' local blockwise at a block of 3
# (below T / M on both meshes, so it runs 6 blocks, the last ragged): the
# GRU rounds to bf16, the SP attention after it stays fp32 as the
# reference's does, so both packages' towers agree at FWD_TOL / GRAD_TOL.
# The GRU runs the scan on both sides (poi_tpu's pick off the TPU), whose
# cotangents are bf16 where its operands are. At a padded position the
# port's GRU carries h and poi_tpu's emits the raw step, so the outputs are
# compared at the valid positions and this tower's cotangent is zero at the
# padded ones.
TOWER_BF16 = {**TOWER, "model.compute_dtype": "bfloat16", "model.attn_block_size": "3", "model.cell_impl": "scan"}
# key prefix -> the tower's overrides and the cotangent of its output.
TOWERS = {"": {"sets": TOWER, "cot": "tcot"}, "bf16_": {"sets": TOWER_BF16, "cot": "tcot_valid"}}


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    p = {k: np.asarray(v) for k, v in init_mha(jax.random.key(1), D).items()}
    lengths = rng.integers(1, T + 1, B)
    z = {"x": rng.normal(size=(B, T, D)).astype(np.float32),
         "cot": rng.normal(size=(B, T, D)).astype(np.float32), **p,
         "tx": rng.normal(size=(B, T, 16)).astype(np.float32),
         "tmask": (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32),
         "tcot": rng.normal(size=(B, T, 16)).astype(np.float32)}
    return {**z, "tcot_valid": z["tcot"] * z["tmask"][:, :, None]}


def _jax_case(z, mesh, case):
    """poi_tpu's forward and gradients of x and the projections, or its
    error."""
    sp = jax_make_sp_attention(mesh, num_heads=case["heads"], window=case["window"], impl=case["impl"],
                               block_size=case["block"])
    x = jnp.asarray(z["x"])
    p = {w: jnp.asarray(z[w]) for w in WEIGHTS}
    cot = jnp.asarray(z["cot"])
    try:
        out = jax.jit(sp)(x, p)
    except ValueError as e:
        return {"error": str(e)}
    dx, dp = jax.jit(jax.grad(lambda xx, pp: jnp.sum(sp(xx, pp) * cot), argnums=(0, 1)))(x, p)
    return {"out": np.asarray(out), "dx": np.asarray(dx), **{f"d{w}": np.asarray(dp[w]) for w in WEIGHTS}}


def _tower(overrides):
    """The port's tower of ``overrides`` from the rig's seed, on one rank."""
    model_cfg = get_config("attention_gowalla").with_overrides(overrides).model
    return model_cfg, AttentionTower(model_cfg, torch.Generator().manual_seed(0), "cpu")


def _jax_tower(z, mesh, impl):
    """poi_tpu's attention tower with its SP attention ``impl`` on ``mesh``,
    at TOWER_BF16 and the port tower's parameters: its output and the
    gradients of its GRU and projections under ``tcot``."""
    model_cfg, tower = _tower(TOWER_BF16)
    jm = jax_build_model(JaxModelConfig(**dataclasses.asdict(model_cfg)), JaxDataDims(
        num_users=2, num_pois=8, num_time_buckets=2, num_geo_buckets=2, num_tgap_buckets=2, num_dist_buckets=2))
    jm.sp_mha = jax_make_sp_attention(mesh, num_heads=model_cfg.attn_heads, window=model_cfg.attn_window,
                                      impl=impl, block_size=model_cfg.attn_block_size)
    tp = {}
    for k, v in tower.named_parameters():
        group, name = k.split(".")
        tp.setdefault(group, {})[name] = jnp.asarray(v.detach().numpy())
    batch = types.SimpleNamespace(mask=jnp.asarray(z["tmask"]))
    out, vjp = jax.vjp(jax.jit(lambda p: jm.tower(p, jnp.asarray(z["tx"]), batch)), tp)
    (g,) = vjp(jnp.asarray(z["tcot_valid"]))
    return {"out": np.asarray(out), **{f"d{grp}.{n}": np.asarray(v) for grp in ("gru", "mha")
                                       for n, v in g[grp].items()}}


@pytest.fixture(scope="module")
def rig(tmp_path_factory, eight_devices):
    d = tmp_path_factory.mktemp("torch_sp_attention")
    z = _inputs()
    np.savez(d / "inp.npz", **z)
    want = {(tag, name): _jax_case(z, make_mesh(*shape, devices=eight_devices[:4]), case)
            for tag, shape in MESHES.items() for name, case in CASES.items()}
    want.update({(tag, f"tower_bf16_{impl}"): _jax_tower(z, make_mesh(*shape, devices=eight_devices[:4]), impl)
                 for tag, shape in MESHES.items() for impl in ("ring", "ulysses")})
    spawn("tests.torch_mesh_jobs:sp_job", 4, {"inp": str(d / "inp.npz"), "out": str(d / "out.npz"),
                                              "cases": json.dumps(CASES), "towers": json.dumps(TOWERS)},
          timeout=180, cwd=REPO, log_dir=str(d))
    with np.load(d / "out.npz") as f:
        return want, {k: f[k] for k in f.files}, z


# Every case on both meshes but the one that raises (held by the refusal test).
PAIRS = [(tag, name) for tag in MESHES for name in CASES if (tag, name) != ("1x4", "ulysses_h2")]


@pytest.mark.parametrize("tag,name", PAIRS)
def test_sp_attention_matches_poi_tpu(rig, tag, name):
    """Forward within 1e-4 and the gradients of x, wq, wk, wv and wo within
    1e-3 of poi_tpu's make_sp_attention on the same mesh shape; every model
    rank holds the same whole gradient of its rows of x."""
    want, out, _ = rig
    ref = want[(tag, name)]
    np.testing.assert_allclose(out[f"{tag}/{name}/out"], ref["out"], atol=FWD_TOL, rtol=FWD_TOL)
    for g in ("dx", *(f"d{w}" for w in WEIGHTS)):
        np.testing.assert_allclose(out[f"{tag}/{name}/{g}"], ref[g], atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=g)
    assert float(out[f"{tag}/{name}/dx_model_max_diff"]) == 0.0


def test_ulysses_refuses_heads_that_do_not_split(rig):
    """2 heads on a model axis of 4: both packages raise the same
    ValueError, before any collective (the ranks go on to the next case)."""
    want, out, _ = rig
    assert want[("1x4", "ulysses_h2")] == {"error": "ulysses needs heads (2) divisible by model shards (4)"}
    assert str(out["1x4/ulysses_h2/error"]) == want[("1x4", "ulysses_h2")]["error"]


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
@pytest.mark.parametrize("tag", MESHES)
def test_sp_tower_gradients_equal_one_rank(rig, tag, impl):
    """The attention tower with SP attention on the mesh (each data rank its
    rows, the gradients summed over data) against the same tower with
    blockwise attention on one rank over the whole batch: the output within
    1e-4 and the GRU's and wq..wo's gradients within 1e-3."""
    _, out, z = rig
    _, tower = _tower(TOWER)
    o = tower(torch.from_numpy(z["tx"]), types.SimpleNamespace(mask=torch.from_numpy(z["tmask"])))
    (o * torch.from_numpy(z["tcot"])).sum().backward()
    np.testing.assert_allclose(out[f"{tag}/tower_{impl}/out"], o.detach().numpy(), atol=FWD_TOL, rtol=FWD_TOL)
    grads = {k: p.grad.numpy() for k, p in tower.named_parameters() if k.startswith(("gru.", "mha."))}
    assert len(grads) == 7
    for k, g in grads.items():
        np.testing.assert_allclose(out[f"{tag}/tower_{impl}/d{k}"], g, atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=k)


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
@pytest.mark.parametrize("tag", MESHES)
def test_sp_tower_bf16_matches_poi_tpu(rig, tag, impl):
    """The tower at bf16 compute (TOWER_BF16: Ulysses' blockwise at a block
    of 3) with SP attention on the mesh against poi_tpu's tower with its
    make_sp_attention on the same mesh shape, from the same parameters:
    the output at the valid positions within FWD_TOL, and the gradients of
    wq..wo and of the GRU's b under a cotangent zero at the padded ones
    within GRAD_TOL. The port's SP path rounding q, k, v, p or wo to bf16
    misses this by ~1e-2. The GRU's wx enters its product as bf16, so both
    packages' gradients of it are bf16 cotangents: held at bf16's
    resolution, BF16_GRAD_TOL of the largest. Its wh is not held here:
    poi_tpu's scan sums wh's bf16 cotangent over the steps in bf16, where
    torch's autograd sums it in fp32 (6e-3 of the largest apart), a
    difference of the GRU's scan, not of the attention."""
    want, out, z = rig
    ref = want[(tag, f"tower_bf16_{impl}")]
    valid = z["tmask"].astype(bool)
    np.testing.assert_allclose(out[f"{tag}/tower_bf16_{impl}/out"][valid], ref["out"][valid], atol=FWD_TOL,
                               rtol=FWD_TOL)
    assert len(ref) == 8
    for k, g in ref.items():
        got = out[f"{tag}/tower_bf16_{impl}/{k}"]
        if k == "dgru.wx":
            assert np.abs(got - g).max() <= BF16_GRAD_TOL * np.abs(g).max(), (k, np.abs(got - g).max())
        elif k not in ("out", "dgru.wh"):
            np.testing.assert_allclose(got, g, atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=k)


def test_sp_attention_refuses_a_sequence_that_does_not_split():
    """T = 18 over a model axis of 4 raises before any collective (the
    reference's shard_map refuses the same shape); so does an unknown impl."""
    mesh = Mesh(1, 4, world_size=4, rank=0)
    p = {w: torch.zeros(D, D) for w in WEIGHTS}
    with pytest.raises(ValueError, match="T=18 does not split over model=4"):
        make_sp_attention(mesh, 4, 5, "ring")(torch.zeros(2, 18, D), p)
    with pytest.raises(ValueError, match="unknown SP attention impl"):
        make_sp_attention(mesh, 4, 5, "blockwise")


@pytest.mark.parametrize("tag", MESHES)
def test_ppermute_ring_forward_and_backward(rig, tag):
    """Rank i of a model group receives the tensor of the rank ``shift``
    places back and, backward, the gradient of the rank ``shift`` places
    on."""
    _, out, _ = rig
    d, m = MESHES[tag]
    for shift in (1, -1):
        got = out[f"{tag}/ring{shift}"]
        for r in range(d * m):
            group, i = divmod(r, m)
            src, dst = group * m + (i - shift) % m, group * m + (i + shift) % m
            assert got[r].tolist() == [float(src), 10.0 * dst], (tag, shift, r)


def _train_cfg(name):
    return get_config("smoke").with_overrides(TRAIN_CASES[name]["overrides"])


def _adam_close(got, want, lr: float, tight: float, key: str) -> None:
    """tests/test_torch_train_sharded.py's rule for params after STEPS Adam
    steps: within ``tight`` but for at most 0.1% of the entries (where a
    near-zero gradient's sign can flip Adam's update), none past 2 lr a
    step."""
    d = np.abs(got - want)
    off = d > tight * (1.0 + np.abs(want))
    assert off.mean() <= 1e-3, (key, int(off.sum()), float(d.max()))
    assert d.max() <= 2 * lr * STEPS, (key, float(d.max()))


@pytest.fixture(scope="module")
def train_rig(tmp_path_factory, eight_devices):
    """poi_tpu's Trainer with SP attention on the fake devices, then the
    port's 4-rank job (the mesh run and the one-rank run) from its init
    params on the same batches."""
    d = tmp_path_factory.mktemp("torch_sp_train")
    ds = load_dataset(_train_cfg("ring_2x2").data)
    loader = make_train_loader(ds.train, batch_size=16, seed=0)
    batches = [next(loader) for _ in range(STEPS)]
    loader.close()
    inp = {"steps": np.asarray(STEPS)}
    for s, b in enumerate(batches):
        inp.update({f"batch{s}/{f}": np.asarray(getattr(b, f)) for f in Batch._fields})
    want = {}
    for name, case in TRAIN_CASES.items():
        jt = JaxTrainer(JaxConfig.from_dict(_train_cfg(name).to_dict()), JaxDataDims.from_dataset(ds),
                        mesh=make_mesh(*case["mesh"], devices=eight_devices[:4]))
        assert jt.model.sp_mha is not None
        js = jt.init_state()
        inp.update({f"{name}/params/{k}": v for k, v in flatten(jax.tree.map(np.asarray, js.params)).items()})
        V, S = jt.dims.num_pois, jt.cfg.loss.num_sampled  # poi_tpu's pools, replayed by the port
        inp[f"{name}/pools"] = np.stack([np.asarray(jax.random.randint(jax.random.fold_in(js.rng, s), (S,), 0, V))
                                         for s in range(STEPS)])
        rows = []
        for b in batches:
            js, m = jt.step(js, b)
            rows.append({k: float(v) for k, v in m.items()})
        want[name] = {"metrics": rows, "params": flatten(jax.tree.map(np.asarray, js.params)),
                      "num_pois": jt.dims.num_pois}
    np.savez(d / "inp.npz", **inp)
    spawn("tests.torch_mesh_jobs:train_job", 4, {"inp": str(d / "inp.npz"), "out": str(d / "out.npz"),
                                                 "cases": json.dumps(TRAIN_CASES)}, timeout=300, cwd=REPO,
          log_dir=str(d))
    with np.load(d / "out.npz") as f:
        return want, {k: f[k] for k in f.files}


@pytest.mark.parametrize("name", TRAIN_CASES)
def test_sp_trajectory_matches_poi_tpu_and_one_rank(train_rig, name):
    """3 steps with SP attention on the mesh: per-step loss, grad norm and
    param norm within the trajectory tolerances of poi_tpu's Trainer on the
    same mesh and of the port's one-rank run (blockwise attention); the
    params after 3 steps within 1e-5 (``_adam_close``) of poi_tpu's and of
    one rank's."""
    want, out = train_rig
    for s, row in enumerate(want[name]["metrics"]):
        for k in METRICS:
            got = float(out[f"{name}/mesh/{k}/{s}"])
            assert got == pytest.approx(row[k], rel=TOL[k]), (name, s, k, "poi_tpu")
            assert got == pytest.approx(float(out[f"{name}/one/{k}/{s}"]), rel=TOL[k]), (name, s, k, "one rank")
    n = want[name]["num_pois"]
    lr = _train_cfg(name).train.learning_rate
    for k, v in want[name]["params"].items():
        key = k.replace("/", ".")
        ref = v[:n] if key in ("embed.poi", "embed.out_bias") else v
        _adam_close(out[f"{name}/mesh/params/{key}"], ref, lr, 1e-5, key)
        _adam_close(out[f"{name}/mesh/params/{key}"], out[f"{name}/one/params/{key}"], lr, 1e-5, key)
