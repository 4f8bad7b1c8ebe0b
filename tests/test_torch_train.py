"""The port's training path (poi_tpu_torch.train, data.device_sampler,
eval.evaluate, the train CLI) held against the JAX package on the same
numpy inputs and the same parameters (carried across with convert).

Smoke config: a 410-POI synthetic catalog, so the CE is the dense one on
both sides. The JAX side runs on the CPU with its lax.scan cell; the port
runs its GRU Function (the kernels' plain versions on the CPU)."""

import dataclasses
import inspect
import json
import os
import subprocess
import sys

import jax
import numpy as np
import optax
import pytest
import torch

from poi_tpu.eval.evaluate import evaluate as jax_evaluate
from poi_tpu.eval.evaluate import popularity_baseline as jax_popularity_baseline
from poi_tpu.models.base import DataDims as JaxDataDims
from poi_tpu.train.loop import Trainer as JaxTrainer
from poi_tpu.train.loop import train as jax_train
from poi_tpu.train.state import lr_schedule as jax_lr_schedule
from poi_tpu.train.state import make_optimizer as jax_make_optimizer
from poi_tpu.utils.config import Config as JaxConfig
from poi_tpu.utils.config import TrainConfig as JaxTrainConfig
from poi_tpu_torch.configs.presets import get_config
from poi_tpu_torch.convert import adam_state_from_jax, adam_state_to_numpy, params_to_numpy
from poi_tpu_torch.data.dataset import load_dataset
from poi_tpu_torch.data.device_sampler import DeviceSampler
from poi_tpu_torch.data.pipeline import make_batch
from poi_tpu_torch.eval.evaluate import evaluate, popularity_baseline
from poi_tpu_torch.models.base import DataDims, build_model
from poi_tpu_torch.models.gru import GRUModel
from poi_tpu_torch.parallel.mesh import Mesh
from poi_tpu_torch.train import loop
from poi_tpu_torch.train.loop import FaultInjected, Trainer, train
from poi_tpu_torch.train.selection import BestOnVal
from poi_tpu_torch.train.state import lr_schedule, make_optimizer
from poi_tpu_torch.utils.config import TrainConfig

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax(cfg):
    """The same configuration as poi_tpu's own Config (or TrainConfig)."""
    if isinstance(cfg, TrainConfig):
        return JaxTrainConfig(**dataclasses.asdict(cfg))
    return JaxConfig.from_dict(cfg.to_dict())


def _smoke(**overrides):
    return get_config("smoke").with_overrides({k: str(v) for k, v in overrides.items()})


@pytest.fixture(scope="module")
def smoke_ds():
    return load_dataset(get_config("smoke").data)


# ----------------------------------------------------------------- optimizer

OPT_CASES = {
    "adam_warmup": dict(warmup_steps=3),  # lr 0 at the first update
    "adamw": dict(warmup_steps=0, weight_decay=0.01),
    "adagrad": dict(warmup_steps=0, optimizer="adagrad"),
    "sgd": dict(warmup_steps=0, optimizer="sgd"),
    "cosine_default_warmup_clamped": dict(lr_schedule="cosine", num_steps=20, lr_min_frac=0.1),
    "clip_active": dict(warmup_steps=0, grad_clip_norm=0.05),
    "clip_inactive": dict(warmup_steps=0, grad_clip_norm=1e3),
    "no_clip": dict(warmup_steps=0, grad_clip_norm=0.0),
}


@pytest.mark.parametrize("clip", [1e-5, 1e3])
def test_clip_matches_optax_on_tiny_gradients(clip):
    """optax's rule g / norm * max, not torch's clip_grad_norm_ (norm + 1e-6):
    with gradients of norm ~4e-4 the two differ by 2.5e-3. SGD from zero
    params makes the parameters the update itself, so nothing hides it."""
    cfg = TrainConfig(learning_rate=1e-2, warmup_steps=0, optimizer="sgd", grad_clip_norm=clip)
    rng = np.random.default_rng(1)
    grads = {k: (1e-4 * rng.normal(size=s)).astype(np.float32) for k, s in (("a", (4, 3)), ("b", (5,)))}
    zeros = {k: np.zeros_like(g) for k, g in grads.items()}
    jopt = jax_make_optimizer(_jax(cfg))
    updates, _ = jopt.update(jax.tree.map(jax.numpy.asarray, grads), jopt.init(zeros), zeros)
    opt = make_optimizer(cfg)
    params = {k: torch.from_numpy(v.copy()) for k, v in zeros.items()}
    opt.update({k: torch.from_numpy(g) for k, g in grads.items()}, opt.init(params), params)
    for k in grads:
        np.testing.assert_allclose(params[k].numpy(), np.asarray(updates[k]), rtol=1e-6, atol=0)


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_optimizer_matches_optax(case):
    """5 updates of a small random tree: the port's update rules against
    poi_tpu's optax chain. Same fp32 formulas; sqrt and the bias-correction
    powers may differ in the last bit, so 1e-6 relative."""
    cfg = TrainConfig(learning_rate=1e-2, **OPT_CASES[case])
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(4, 3)).astype(np.float32), "b": rng.normal(size=5).astype(np.float32)}
    jopt = jax_make_optimizer(_jax(cfg))
    jparams = jax.tree.map(jax.numpy.asarray, tree)
    jstate = jopt.init(jparams)
    opt = make_optimizer(cfg)
    params = {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
    state = opt.init(params)
    for step in range(5):
        grads = {k: (rng.normal(size=v.shape) * 0.3).astype(np.float32) for k, v in tree.items()}
        updates, jstate = jopt.update(jax.tree.map(jax.numpy.asarray, grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        before = {k: p.clone() for k, p in params.items()}
        opt.update({k: torch.from_numpy(g) for k, g in grads.items()}, state, params)
        for k in tree:
            np.testing.assert_allclose(params[k].numpy(), np.asarray(jparams[k]), rtol=1e-6, atol=1e-7,
                                       err_msg=f"{case} step {step} {k}")
        if case == "adam_warmup" and step == 0:
            assert all(torch.equal(params[k], before[k]) for k in tree), "first update must use lr 0"
    assert state["count"] == 5


@pytest.mark.parametrize("overrides", [
    dict(),
    dict(warmup_steps=0),
    dict(lr_schedule="cosine", num_steps=20),
    dict(lr_schedule="cosine", num_steps=1000, warmup_steps=50, lr_min_frac=0.05),
])
def test_lr_schedule_matches_jax(overrides):
    cfg = TrainConfig(**overrides)
    mine, theirs = lr_schedule(cfg), jax_lr_schedule(_jax(cfg))
    for step in list(range(0, 120)) + [cfg.num_steps - 1, cfg.num_steps, cfg.num_steps + 5]:
        np.testing.assert_allclose(mine(step), float(theirs(step)), rtol=1e-6, atol=0, err_msg=f"step {step}")


def test_cosine_warmup_longer_than_half_the_run_raises_unless_default():
    with pytest.raises(ValueError, match="exceeds half"):
        lr_schedule(TrainConfig(lr_schedule="cosine", num_steps=20, warmup_steps=15))


# ----------------------------------------------------------------- one step


def _jax_trainer_and_tree(cfg, ds):
    jt = JaxTrainer(_jax(cfg), JaxDataDims.from_dataset(ds))
    js = jt.init_state()
    return jt, js, jax.tree.map(np.asarray, js.params)


def _leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(v, np.float32)) for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trainer_step_matches_jax(smoke_ds, dtype):
    """One step from the same params on the same host batch: loss, updated
    params and Adam moments.

    fp32: both sides run the same fp32 arithmetic up to summation order.
    bf16: JAX's scan autodiff rounds the recurrent cotangent and dwh to bf16
    each step, while the port's fused backward keeps its cotangents fp32 by
    design, so gradients (and the moments, linear in them) differ at bf16
    resolution, within 1% of each tensor's largest moment. Adam's first step
    moves an element by lr·g/(|g| + eps), so elements whose gradient is
    within that noise may move differently (by at most 2·lr); elements with
    |mu| above 5% of the tensor's largest agree to 1e-6."""
    cfg = _smoke(**{"model.compute_dtype": dtype, "train.warmup_steps": 0})
    jt, js, tree = _jax_trainer_and_tree(cfg, smoke_ds)
    batch = make_batch(smoke_ds.train, np.arange(cfg.train.batch_size))
    js2, jm = jt.step(js, batch)

    tt = Trainer(cfg, DataDims.from_dataset(smoke_ds), device="cpu")
    st, tm = tt.step(tt.init_state(tree), batch)
    assert st.step == 1 and st.opt_state["count"] == 1
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-6 * float(jm["loss"])
    assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-7)

    lr = cfg.train.learning_rate
    mom_tol = 1e-5 if dtype == "float32" else 1e-2
    jadam = adam_state_to_numpy(adam_state_from_jax(js2.opt_state))
    tadam = adam_state_to_numpy(st.opt_state)
    assert jadam["count"] == tadam["count"] == 1
    for which in ("mu", "nu"):
        for (name, a), (_, b) in zip(_leaves(tadam[which]), _leaves(jadam[which])):
            scale = np.abs(b).max() + 1e-30
            assert np.abs(a - b).max() <= mom_tol * scale, (which, name)
    for (name, a), (_, b), (_, mu) in zip(_leaves(params_to_numpy(tt.model)), _leaves(js2.params),
                                           _leaves(jadam["mu"])):
        diff = np.abs(a - b)
        if dtype == "float32":
            assert diff.max() <= 1e-6, name
        else:
            clear = np.abs(mu) > 0.05 * np.abs(mu).max()
            assert diff[clear].max(initial=0.0) <= 1e-6, name
            assert diff.max() <= 2 * lr + 1e-6, name


def test_train_trajectory_matches_jax(smoke_ds):
    """Five host-loader steps, same seeded TrainLoader batches and the same
    initial params: the per-step losses in fp32. Both sides do the same fp32
    arithmetic up to summation order; over five Adam steps the difference
    stays at the 1e-6 relative level."""
    cfg = _smoke(**{"model.compute_dtype": "float32", "train.warmup_steps": 0, "train.log_every": 1,
                    "train.num_steps": 5})
    jt, js, tree = _jax_trainer_and_tree(cfg, smoke_ds)
    _, _, jhist = jax_train(_jax(cfg), smoke_ds, state=js, trainer=jt)
    tt = Trainer(cfg, DataDims.from_dataset(smoke_ds), device="cpu")
    _, state, hist = train(cfg, smoke_ds, trainer=tt, state=tt.init_state(tree))
    assert state.step == 5
    assert [r["step"] for r in hist] == [r["step"] for r in jhist] == [1, 2, 3, 4, 5]
    for a, b in zip(hist, jhist):
        assert abs(a["loss"] - b["loss"]) <= 1e-5 * b["loss"], (a, b)
        assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=1e-4)
        assert a["param_norm"] == pytest.approx(b["param_norm"], rel=1e-5)
        assert a["seqs_per_sec"] > 0
    assert hist[-1]["loss"] < hist[0]["loss"]


def test_evaluate_matches_jax(smoke_ds):
    """evaluate() on the same params: popularity-ordered catalog, the top-k
    kernel's plain version against JAX's Pallas top-k in interpret mode."""
    cfg = _smoke(**{"eval.topk_impl": "pallas"})
    jt, js, tree = _jax_trainer_and_tree(cfg, smoke_ds)
    want = jax_evaluate(jt.model, js.params, smoke_ds, _jax(cfg))
    tt = Trainer(cfg, DataDims.from_dataset(smoke_ds), device="cpu")
    tt.init_state(tree)
    got = evaluate(tt.model, smoke_ds, cfg)
    assert got.keys() == want.keys()
    n = want["eval_examples"]
    assert got["eval_examples"] == n
    # Scores of two candidates can tie to fp32 noise and swap between the
    # packages: allow one row's hit to move per metric.
    for k in want:
        assert abs(got[k] - want[k]) <= 1.0 / n + 1e-9, (k, got[k], want[k])
    assert popularity_baseline(smoke_ds) == jax_popularity_baseline(smoke_ds)


# ----------------------------------------------------------------- pieces


def test_device_sampler_is_deterministic_per_step(smoke_ds):
    s = DeviceSampler(smoke_ds.train, 16, seed=3, device="cpu")
    a, b, c = s.sample(7), s.sample(7), s.sample(8)
    assert torch.equal(a.poi_in, b.poi_in) and not torch.equal(a.poi_in, c.poi_in)
    assert a.mask.dtype == torch.float32 and a.poi_in.shape == (16, smoke_ds.max_seq_len)
    assert a.poi_tgt.dtype == torch.int64
    assert int(a.poi_in.max()) < smoke_ds.num_pois and int(a.user.max()) < smoke_ds.num_users
    other = DeviceSampler(smoke_ds.train, 16, seed=4, device="cpu")
    assert not torch.equal(other.sample(7).poi_in, a.poi_in)
    # Rows are whole training examples.
    ex = smoke_ds.train
    rows = {tuple(r) for r in ex.poi_in}
    assert all(tuple(r.tolist()) in rows for r in a.poi_in)


def test_sampled_training_drops_the_loss(smoke_ds):
    cfg = _smoke(**{"data.sampler": "device", "train.steps_per_call": 8, "train.num_steps": 24,
                    "train.log_every": 8, "train.warmup_steps": 0})
    trainer, state, hist = train(cfg, smoke_ds, device="cpu")
    assert state.step == 24 and [r["step"] for r in hist] == [8, 16, 24]
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert all(r["grad_norm"] > 0 and r["param_norm"] > 0 for r in hist)
    _, metrics = trainer.step_sampled(state, 3)
    assert metrics["loss"].shape == (3,)
    # The learning rate stays a host value: a device copy would wait for each step.
    assert metrics["lr"].device.type == "cpu" and metrics["lr"].shape == (3,)
    assert float(metrics["lr"][0]) == pytest.approx(cfg.train.learning_rate)
    # Steps 25-27 are no log steps: the norms are not computed there.
    assert not metrics["grad_norm"].any() and not metrics["param_norm"].any()


def test_best_on_val_keeps_a_copy_on_the_device(smoke_ds):
    cfg = _smoke(**{"data.val_fraction": 0.1, "train.eval_every": 5})
    ds = load_dataset(cfg.data)
    trainer = Trainer(cfg, DataDims.from_dataset(ds), device="cpu")
    state = trainer.init_state()
    tracker = BestOnVal(trainer, ds, cfg)
    tracker(3, state, {})
    assert tracker.best_step == -1  # not an eval step
    tracker(5, state, {})
    assert tracker.best_step == 5 and tracker.history[0]["step"] == 5
    best = tracker.best_params(state.params)
    with torch.no_grad():
        state.params["embed.poi"].add_(1.0)
    assert not torch.equal(best["embed.poi"], state.params["embed.poi"])
    assert best["embed.poi"].device == state.params["embed.poi"].device
    with pytest.raises(ValueError, match="metric"):
        BestOnVal(trainer, ds, cfg, metric="recall@50")


@pytest.mark.parametrize("sampler", ["host", "device"])
def test_fault_injection_raises_at_the_step_and_resume_continues(smoke_ds, sampler):
    """train.fault_inject_step=N raises before step N on both loop paths; a
    second train() from the surviving state picks up at that step."""
    cfg = _smoke(**{"data.sampler": sampler, "train.fault_inject_step": 3, "train.num_steps": 5,
                    "train.log_every": 1, "train.steps_per_call": 2})
    trainer = Trainer(cfg, DataDims.from_dataset(smoke_ds), device="cpu",
                      sampler=DeviceSampler(smoke_ds.train, 16, 0, "cpu") if sampler == "device" else None)
    seen = []
    with pytest.raises(FaultInjected, match="step 3"):
        train(cfg, smoke_ds, trainer=trainer, callbacks=[lambda step, st, m: seen.append((step, st))])
    step, state = seen[-1]
    assert step == 3 and state.step == 3
    resumed = cfg.with_overrides({"train.fault_inject_step": "-1"})
    _, final, hist = train(resumed, smoke_ds, num_steps=2, trainer=trainer, state=state)
    assert final.step == 5 and [r["step"] for r in hist] == [4, 5]


@pytest.mark.parametrize("case", [pytest.param("sharded_sparse_tied", id="overrides0-sparse"),
                                  pytest.param("unfit_mesh", id="overrides1-mesh.model")])
def test_trainer_rejects_what_is_not_ported(smoke_ds, case):
    """What took the place of the two refusals: mesh.model=2 without a
    process group is a mesh that does not fit the world size (the
    reference's ValueError); lazy Adam on a vocab-sharded tied table above
    512 MiB (1,100,000 POIs x 128 x 4 bytes) builds on one rank of a (1, 2)
    mesh (shape only, on the meta device) without the rows-gradient step,
    which stays a one-shard path (rows_mode_enabled), and with half the
    padded catalog a rank."""
    dims = DataDims.from_dataset(smoke_ds)
    if case == "unfit_mesh":
        with pytest.raises(ValueError, match="1 devices not divisible by model=2"):
            Trainer(_smoke(**{"mesh.model": 2}), dims, device="cpu")
        return
    cfg = _smoke(**{"train.table_update": "sparse", "loss.kind": "sampled_softmax", "model.embed_dim": 128,
                    "mesh.model": 2})
    big = dataclasses.replace(dims, num_pois=1_100_001, num_pois_padded=0)
    one = Trainer(cfg.with_overrides({"mesh.model": "1"}), big, device="meta")
    tt = Trainer(cfg, big, device="meta", mesh=Mesh(1, 2, world_size=2, rank=0))
    assert one.rows_mode and not tt.rows_mode and tt.sparse
    assert tt.dims.num_pois_padded == 1_100_002 and tt.model.embed["poi"].shape == (550_001, 128)
    assert tt.model.embed["out_bias"].shape == (550_001,) and tt.sharded == {"embed.poi", "embed.out_bias"}


ENTRY_POINTS = {
    "train": lambda ds: train(_smoke(**{"data.sampler": "device"}), ds),
    "make_trainer": lambda ds: loop.make_trainer(_smoke(**{"data.sampler": "device"}), ds),
    "Trainer": lambda ds: Trainer(_smoke(), DataDims.from_dataset(ds)),
    "build_model": lambda ds: build_model(_smoke().model, DataDims.from_dataset(ds)),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_cuda_and_refuse_without_it(smoke_ds, monkeypatch, name):
    """The Python entry points run on the card unless the caller asks for
    the CPU: device defaults to "cuda", and without CUDA a call that names no
    device raises before it builds a sampler, a loader or a model."""
    fn = {"train": train, "make_trainer": loop.make_trainer, "build_model": build_model}.get(name)
    default = (inspect.signature(fn).parameters["device"].default if fn else
               Trainer.__dataclass_fields__["device"].default)
    assert default == "cuda"
    work = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(loop, "DeviceSampler", lambda *a, **k: work.append("sampler"))
    monkeypatch.setattr(loop, "make_train_loader", lambda *a, **k: work.append("loader"))
    monkeypatch.setattr(GRUModel, "__init__", lambda *a, **k: work.append("model"))
    with pytest.raises(RuntimeError, match=r"device 'cuda', but CUDA is not available; pass device=\"cpu\""):
        ENTRY_POINTS[name](smoke_ds)
    assert work == []


# ----------------------------------------------------------------- CLI


def _run_cli(*argv):
    code = (
        "import sys; from poi_tpu_torch.cli import main; rc = main(sys.argv[1:]); "
        "assert 'jax' not in sys.modules, 'jax was imported'; sys.exit(rc)"
    )
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", POI_TPU_TORCH_DATA_CACHE="off")
    return subprocess.run([sys.executable, "-c", code, *argv], capture_output=True, text=True, cwd=REPO, env=env,
                          timeout=300)


def test_cli_train_on_cpu_drops_the_loss_without_jax():
    proc = _run_cli("train", "--config", "smoke", "--device", "cpu", "--no-checkpoint", "--set",
                    "train.num_steps=30", "train.log_every=10", "train.eval_every=15", "train.warmup_steps=0")
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["steps"] == 30 and [r["step"] for r in out["history"]] == [10, 20, 30]
    assert out["history"][-1]["loss"] < out["history"][0]["loss"]
    assert [e["step"] for e in out["periodic_evals"]] == [15, 30]
    assert all(np.isfinite(v) for v in out["final"].values())
    assert set(out["popularity_baseline"]) == {"recall@1", "recall@5", "recall@10", "ndcg@10"}


def test_cli_train_checkpoints_by_default(tmp_path, capsys, caplog):
    """With no flag, train saves into --checkpoint-dir (the end-of-run step,
    50); the same command again finds the run finished and returns 0."""
    from poi_tpu_torch.cli import main

    argv = ["train", "--config", "smoke", "--device", "cpu", "--checkpoint-dir", str(tmp_path)]
    assert main(argv) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["steps"] == 50
    assert os.listdir(tmp_path) == ["step_50.pt"]
    caplog.clear()
    with caplog.at_level("INFO", logger="poi_tpu_torch.cli"):
        assert main(argv) == 0
    assert "already at step 50" in caplog.text and capsys.readouterr().out == ""
