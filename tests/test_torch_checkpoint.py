"""The port's checkpoint and resume (poi_tpu_torch.utils.checkpoint, the
loader restore in train(), BestOnVal.seed) on the CPU at the smoke config,
and the resumed trajectory and the config-drift check held against
poi_tpu's."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from poi_tpu.models.base import DataDims as JaxDataDims
from poi_tpu.train.loop import Trainer as JaxTrainer
from poi_tpu.train.loop import train as jax_train
from poi_tpu.utils.checkpoint import warn_config_mismatch as jax_warn_config_mismatch
from poi_tpu.utils.config import Config as JaxConfig
from poi_tpu_torch.configs.presets import get_config
from poi_tpu_torch.data.dataset import load_dataset
from poi_tpu_torch.data.device_sampler import DeviceSampler
from poi_tpu_torch.models.base import DataDims
from poi_tpu_torch.train.loop import Trainer, train
from poi_tpu_torch.train.selection import BestOnVal
from poi_tpu_torch.utils.checkpoint import CheckpointManager, warn_config_mismatch

torch.set_num_threads(1)

SPARSE = {"train.table_update": "sparse", "loss.kind": "sampled_softmax", "loss.num_sampled": 64}


def _smoke(**overrides):
    return get_config("smoke").with_overrides({k: str(v) for k, v in overrides.items()})


@pytest.fixture(scope="module")
def smoke_ds():
    return load_dataset(get_config("smoke").data)


def _trainer(cfg, ds, seed=None):
    if seed is not None:
        cfg = cfg.with_overrides({"train.seed": str(seed)})
    sampler = DeviceSampler(ds.train, cfg.train.batch_size, cfg.train.seed, "cpu") \
        if cfg.data.sampler == "device" else None
    return Trainer(cfg, DataDims.from_dataset(ds), device="cpu", sampler=sampler)


def _leaves(tree, prefix=""):
    """{dotted path: value} of a nested dict (the optimizer state)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _assert_states_equal(a, b):
    assert a.step == b.step
    assert a.params.keys() == b.params.keys()
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    la, lb = _leaves(a.opt_state), _leaves(b.opt_state)
    assert la.keys() == lb.keys()
    for k in la:
        if torch.is_tensor(la[k]):
            assert torch.equal(la[k], lb[k]), k
        else:
            assert la[k] == lb[k], k


# ----------------------------------------------------------------- round trip


@pytest.mark.parametrize("update, async_save", [("dense", False), ("sparse", False), ("dense", True)])
def test_round_trip_restores_in_place(smoke_ds, tmp_path, update, async_save):
    """Params, the optimizer state (dense Adam's mu/nu or lazy Adam's m/v,
    and count), the step, the loader state and the config come back
    torch.equal, into the fresh model's own nn.Parameter objects. The file
    loads with weights_only=True and holds only CPU tensors, copies taken
    at save time (the live params move on after an asynchronous save)."""
    cfg = _smoke(**(SPARSE if update == "sparse" else {}), **{"train.warmup_steps": 0})
    t = _trainer(cfg, smoke_ds)
    _, state, _ = train(cfg, smoke_ds, num_steps=2, trainer=t)
    saved = {k: v.clone() for k, v in _leaves({"params": state.params, **state.opt_state}).items()
             if torch.is_tensor(v)}
    mgr = CheckpointManager(str(tmp_path), async_save=async_save)
    loader = {"epoch": 1, "pos": 3, "seed": 0}
    mgr.save(2, state, loader_state=loader, config_json=cfg.to_json())
    with torch.no_grad():
        for p in state.params.values():
            p.add_(1.0)  # the next step's in-place update must not reach the file
    mgr.wait()

    fresh = _trainer(cfg, smoke_ds, seed=7)
    objects = dict(fresh.model.named_parameters())
    assert not torch.equal(objects["embed.poi"], saved["params.embed.poi"])
    restored, loader_state = mgr.restore(fresh)
    assert restored.step == 2 and loader_state == loader
    assert restored.opt_state["count"] == 2 and isinstance(restored.opt_state["count"], int)
    assert set(restored.opt_state) == ({"count", "m", "v"} if update == "sparse" else {"count", "mu", "nu"})
    for k, p in fresh.model.named_parameters():
        assert restored.params[k] is objects[k] is p, k
    for k, v in _leaves({"params": restored.params, **restored.opt_state}).items():
        if torch.is_tensor(v):
            assert torch.equal(v, saved[k]), k
    assert json.loads(mgr.saved_config()) == json.loads(cfg.to_json())

    raw = torch.load(os.path.join(str(tmp_path), "step_2.pt"), weights_only=True)
    assert set(raw) == {"step", "params", "opt_state", "loader", "config"}
    tensors = [v for v in _leaves({"params": raw["params"], **raw["opt_state"]}).values() if torch.is_tensor(v)]
    assert len(tensors) == len(saved) and all(v.device.type == "cpu" for v in tensors)
    mgr.close()


def test_restore_refuses_another_optimizer_or_shape(smoke_ds, tmp_path):
    cfg = _smoke()
    t = _trainer(cfg, smoke_ds)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, t.init_state())
    with pytest.raises(KeyError, match="opt_state"):
        mgr.restore(_trainer(_smoke(**SPARSE), smoke_ds))
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(_trainer(_smoke(**{"model.embed_dim": 16, "model.hidden_dim": 16}), smoke_ds))


# --------------------------------------------------------- resume continuity

RESUME_CASES = {
    "host-dense": {"data.sampler": "host"},
    "host-sparse-dropout": {"data.sampler": "host", "model.dropout": 0.3, **SPARSE},
    "device-dense-dropout": {"data.sampler": "device", "model.dropout": 0.3},
    "device-sparse": {"data.sampler": "device", **SPARSE},
}


@pytest.mark.parametrize("case", sorted(RESUME_CASES))
def test_resume_is_bit_exact(smoke_ds, tmp_path, case):
    """Six steps straight against three steps, a save, a fresh Trainer, a
    restore and three more: params and moments torch.equal, and the losses
    of steps 4-6 identical (same batches, same step-keyed draws)."""
    cfg = _smoke(**RESUME_CASES[case], **{"train.warmup_steps": 0, "train.log_every": 1, "train.num_steps": 6})
    _, straight, hist = train(cfg, smoke_ds, trainer=_trainer(cfg, smoke_ds))

    t = _trainer(cfg, smoke_ds)
    mgr = CheckpointManager(str(tmp_path))
    _, s3, _ = train(cfg, smoke_ds, num_steps=3, trainer=t,
                     callbacks=[lambda step, st, m: step == 3 and mgr.save(
                         step, st, loader_state=t.active_loader and t.active_loader.state_at(step))])
    assert mgr.latest_step() == 3
    fresh = _trainer(cfg, smoke_ds)
    state, loader_state = mgr.restore(fresh)
    assert bool(loader_state) == (cfg.data.sampler == "host")
    _, resumed, rhist = train(cfg, smoke_ds, num_steps=3, trainer=fresh, state=state, loader_state=loader_state)
    _assert_states_equal(straight, resumed)
    assert [r["step"] for r in rhist] == [4, 5, 6]
    assert [r["loss"] for r in rhist] == [r["loss"] for r in hist[3:]]


def test_resumed_run_matches_poi_tpus_uninterrupted_run(smoke_ds, tmp_path):
    """The port resumed (3 steps, save, fresh Trainer, restore, 3 steps;
    host loader; fp32) against poi_tpu's uninterrupted 6-step train() from
    the same params on the same seeded batches, at
    test_train_trajectory_matches_jax's tolerances: loss 1e-5 relative,
    grad norm 1e-4, param norm 1e-5."""
    cfg = _smoke(**{"model.compute_dtype": "float32", "train.warmup_steps": 0, "train.log_every": 1,
                    "train.num_steps": 6})
    jt = JaxTrainer(JaxConfig.from_dict(cfg.to_dict()), JaxDataDims.from_dataset(smoke_ds))
    js = jt.init_state()
    tree = jax.tree.map(np.asarray, js.params)
    _, _, jhist = jax_train(JaxConfig.from_dict(cfg.to_dict()), smoke_ds, state=js, trainer=jt)

    t = Trainer(cfg, DataDims.from_dataset(smoke_ds), device="cpu")
    _, s3, hist = train(cfg, smoke_ds, num_steps=3, trainer=t, state=t.init_state(tree))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, s3, loader_state=t.active_loader.state_at(3), config_json=cfg.to_json())
    fresh = Trainer(cfg, DataDims.from_dataset(smoke_ds), device="cpu")
    state, loader_state = mgr.restore(fresh)
    _, final, rest = train(cfg, smoke_ds, num_steps=3, trainer=fresh, state=state, loader_state=loader_state)
    hist += rest
    assert final.step == 6
    assert [r["step"] for r in hist] == [r["step"] for r in jhist] == [1, 2, 3, 4, 5, 6]
    for a, b in zip(hist, jhist):
        assert abs(a["loss"] - b["loss"]) <= 1e-5 * b["loss"], (a, b)
        assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=1e-4)
        assert a["param_norm"] == pytest.approx(b["param_norm"], rel=1e-5)


# ----------------------------------------------------------------- bookkeeping


def test_max_to_keep_and_latest_step(smoke_ds, tmp_path):
    state = _trainer(_smoke(), smoke_ds).init_state()
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    assert mgr.latest_step() is None and mgr.saved_config() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(state)
    for step in (2, 4, 6):
        mgr.save(step, state)
    assert mgr.latest_step() == 6
    assert sorted(os.listdir(tmp_path)) == ["step_4.pt", "step_6.pt"]
    mgr.delete(6)
    assert mgr.latest_step() == 4
    with pytest.raises(FileNotFoundError, match="no step 6"):
        mgr.load(6)
    keep_all = CheckpointManager(str(tmp_path), max_to_keep=None)
    for step in (8, 10, 12):
        keep_all.save(step, state)
    assert sorted(os.listdir(tmp_path)) == sorted(f"step_{s}.pt" for s in (4, 8, 10, 12))


def test_selected_is_kept_apart_from_the_step_sequence(smoke_ds, tmp_path):
    state = _trainer(_smoke(), smoke_ds).init_state()
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.selected_step() is None and mgr.selected_info() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore_selected()
    mgr.save(10, state)
    mgr.save_selected(4, state.params, metric="recall@10", score=0.25)
    best = {k: v.clone() for k, v in state.params.items()}
    with torch.no_grad():
        state.params["embed.poi"].add_(1.0)
    mgr.save_selected(8, state.params, metric="recall@10", score=0.5)
    assert mgr.latest_step() == 10
    assert mgr.selected_step() == 8 and os.listdir(tmp_path / "selected") == ["step_8.pt"]
    assert mgr.selected_info() == {"step": 8, "metric": "recall@10", "score": 0.5}
    got = mgr.restore_selected()
    assert torch.equal(got["embed.poi"], state.params["embed.poi"])
    assert not torch.equal(got["embed.poi"], best["embed.poi"])
    # A selection by another metric, at an earlier step, replaces it all the same.
    mgr.save_selected(6, best, metric="ndcg@10", score=0.1)
    assert os.listdir(tmp_path / "selected") == ["step_6.pt"]
    assert torch.equal(mgr.restore_selected()["embed.poi"], best["embed.poi"])


def test_best_on_val_seed_keeps_the_better_selection(tmp_path):
    cfg = _smoke(**{"data.val_fraction": 0.1, "train.eval_every": 5})
    ds = load_dataset(cfg.data)
    trainer = _trainer(cfg, ds)
    state = trainer.init_state()
    tracker = BestOnVal(trainer, ds, cfg)
    host = {k: v.detach().clone() for k, v in state.params.items()}
    host["embed.poi"] += 1.0
    tracker.seed(3, 2.0, host)  # no recall exceeds 2.0
    tracker(5, state, {})
    assert tracker.history[0]["step"] == 5
    assert tracker.best_step == 3 and tracker.best_score == 2.0
    best = tracker.best_params(state.params)
    assert torch.equal(best["embed.poi"], host["embed.poi"]) and best["embed.poi"] is not host["embed.poi"]
    tracker.seed(3, -1.0, host)  # any val score beats this one
    tracker(10, state, {})
    assert tracker.best_step == 10 and torch.equal(tracker.best_params(state.params)["embed.poi"],
                                                   state.params["embed.poi"])


@pytest.mark.parametrize("where", ["", "selected"])
def test_orbax_directory_is_refused_naming_the_export_script(tmp_path, where):
    (tmp_path / where / "100" / "state").mkdir(parents=True)
    with pytest.raises(ValueError, match="scripts/export_params_npz.py"):
        CheckpointManager(str(tmp_path))


# --------------------------------------------------------- config drift


def _drift_pairs():
    base = get_config("smoke")
    return {
        "none": (None, base),
        "empty": ("", base),
        "not_json": ("{oops", base),
        "identical": (base.to_json(), base),
        "model_and_data": (base.to_json(), base.with_overrides({"model.hidden_dim": "48", "data.max_seq_len": "8"})),
        "loss": (base.to_json(), base.with_overrides({"loss.kind": "sampled_softmax"})),
        "train_only": (base.to_json(), base.with_overrides({"train.num_steps": "500"})),
        "missing_section": (json.dumps({"model": dataclasses.asdict(base.model)}), base),
    }


@pytest.mark.parametrize("case", sorted(_drift_pairs()))
def test_warn_config_mismatch_matches_poi_tpu(case, caplog):
    saved, cfg = _drift_pairs()[case]
    got = warn_config_mismatch(saved, cfg)
    assert got == jax_warn_config_mismatch(saved, JaxConfig.from_dict(cfg.to_dict()))
    assert bool(got) == (case in ("model_and_data", "loss", "missing_section"))
    warned = [r for r in caplog.records if r.name == "poi_tpu_torch.utils.checkpoint"]
    assert bool(warned) == bool(got)
    assert all("config differs from the one this checkpoint was trained with" in r.getMessage() for r in warned)
