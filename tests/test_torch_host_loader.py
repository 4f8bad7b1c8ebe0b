"""The host loader's dispatch in ``poi_tpu_torch.train.loop.train``: chunks
of ``train.steps_per_call`` steps (K ``Trainer.step`` calls, metrics read
once a chunk), tails and misaligned resumes, held against
``poi_tpu.train.loop.train`` on the same params and seeded loader; and
``data.pipeline.DevicePrefetcher``, which feeds those steps on every
device and in the fault drill."""

from __future__ import annotations

import time

import jax
import numpy as np
import pytest
import torch

from poi_tpu.models.base import DataDims as JaxDataDims
from poi_tpu.train.loop import Trainer as JaxTrainer
from poi_tpu.train.loop import train as jax_train
from poi_tpu.utils.config import Config as JaxConfig
from poi_tpu_torch.configs.presets import get_config
from poi_tpu_torch.convert import params_to_numpy
from poi_tpu_torch.data.dataset import load_dataset
from poi_tpu_torch.data.pipeline import DevicePrefetcher, make_batch
from poi_tpu_torch.models.base import DataDims
from poi_tpu_torch.train.loop import FaultInjected, Trainer, train

torch.set_num_threads(1)

STEPS = 5


def _cfg(spc: int, **extra):
    sets = {"model.compute_dtype": "float32", "model.dropout": 0.0, "train.warmup_steps": 0, "train.log_every": 1,
            "train.num_steps": STEPS, "train.steps_per_call": spc, **extra}
    return get_config("smoke").with_overrides({k: str(v) for k, v in sets.items()})


@pytest.fixture(scope="module")
def smoke_ds():
    return load_dataset(get_config("smoke").data)


@pytest.fixture(scope="module")
def init_tree(smoke_ds):
    jt = JaxTrainer(JaxConfig.from_dict(_cfg(1).to_dict()), JaxDataDims.from_dataset(smoke_ds))
    return jax.tree.map(np.asarray, jt.init_state().params)


def _port_run(cfg, ds, tree, callbacks=None, state=None, trainer=None):
    tt = trainer or Trainer(cfg, DataDims.from_dataset(ds), device="cpu")
    state = state or tt.init_state(tree)
    return train(cfg, ds, num_steps=cfg.train.num_steps - state.step, trainer=tt, state=state,
                 callbacks=callbacks)


@pytest.mark.parametrize("spc", [1, 4])
def test_host_loader_matches_jax_and_chunks_equal_single_steps(smoke_ds, init_tree, spc):
    """Five host-loader steps from the same params on the same seeded
    loader, at steps_per_call 1 and 4 (a chunk of 4, then a tail of 1): each
    step's loss within 1e-5 relative of ``poi_tpu``'s ``train`` at the same
    steps_per_call (both fp32, the same arithmetic up to summation order, as
    ``test_train_trajectory_matches_jax``), the final params within 1e-4
    (a tenth of one Adam step at the smoke config's lr of 1e-3: an element
    whose gradient is at the level of summation noise may take a different
    Adam direction on each side; 8e-6 seen); and at 4 the same bits as the
    port's run at 1, history and params."""
    cfg = _cfg(spc)
    jt = JaxTrainer(JaxConfig.from_dict(cfg.to_dict()), JaxDataDims.from_dataset(smoke_ds))
    js = jt.init_state()
    _, js_end, jhist = jax_train(JaxConfig.from_dict(cfg.to_dict()), smoke_ds, state=js, trainer=jt)
    tt, state, hist = _port_run(cfg, smoke_ds, init_tree)
    assert state.step == STEPS and int(js_end.step) == STEPS
    assert [r["step"] for r in hist] == [r["step"] for r in jhist] == list(range(1, STEPS + 1))
    for a, b in zip(hist, jhist):
        assert abs(a["loss"] - b["loss"]) <= 1e-5 * b["loss"], (a, b)
        assert a["seqs_per_sec"] > 0
    want = {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(js_end.params)[0]}
    got = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
           jax.tree_util.tree_flatten_with_path(params_to_numpy(tt.model))[0]}
    assert got.keys() == want.keys()
    for k in want:
        assert np.abs(got[k] - want[k]).max() <= 1e-4, k
    if spc > 1:
        t1, _, hist1 = _port_run(_cfg(1), smoke_ds, init_tree)
        assert [{k: v for k, v in r.items() if k != "seqs_per_sec"} for r in hist] == \
               [{k: v for k, v in r.items() if k != "seqs_per_sec"} for r in hist1]
        for k, v in t1.model.state_dict().items():
            assert torch.equal(v, tt.model.state_dict()[k]), k


def test_misaligned_resume_steps_singly_and_matches_an_uninterrupted_run(smoke_ds, init_tree):
    """With callbacks and steps_per_call 4 (every period 4), a run resumed at
    step 3 (off a chunk boundary) steps singly, as the reference's does, and
    ends with the bits of an uninterrupted run; the callbacks see every step
    once, in order, the chunked run's at its chunk ends' state."""
    cfg = _cfg(4, **{"train.num_steps": 8, "train.log_every": 4, "train.checkpoint_every": 4,
                     "train.eval_every": 4})
    seen: list[tuple[int, int]] = []
    cb = [lambda step, st, m: seen.append((step, st.step))]
    t_full, s_full, _ = _port_run(cfg, smoke_ds, init_tree, callbacks=cb)
    # Chunks of 4: the callbacks of a chunk's steps all see its end state.
    assert seen == [(1, 4), (2, 4), (3, 4), (4, 4), (5, 8), (6, 8), (7, 8), (8, 8)]
    seen.clear()
    t_part, s_part, _ = _port_run(_cfg(1, **{"train.num_steps": 3}), smoke_ds, init_tree)
    t_rest, s_rest, _ = _port_run(cfg, smoke_ds, None, callbacks=cb, state=s_part, trainer=t_part)
    assert s_rest.step == s_full.step == 8
    assert seen == [(s, s) for s in range(4, 9)]  # singly: each step's own state
    for k, v in t_full.model.state_dict().items():
        assert torch.equal(v, t_rest.model.state_dict()[k]), k


def test_step_chunk_of_a_put_chunk_equals_single_steps(smoke_ds, init_tree):
    """``put_chunk`` puts K host batches on the device and ``step_chunk``
    runs them as K steps: the same bits as K ``step`` calls, its metrics
    stacked [K]."""
    cfg = _cfg(3)
    batches = [make_batch(smoke_ds.train, np.arange(j * 16, j * 16 + cfg.train.batch_size)) for j in range(3)]
    ta = Trainer(cfg, DataDims.from_dataset(smoke_ds), device="cpu")
    sa, ma = ta.step_chunk(ta.init_state(init_tree), ta.put_chunk(batches))
    tb = Trainer(cfg, DataDims.from_dataset(smoke_ds), device="cpu")
    sb = tb.init_state(init_tree)
    losses = []
    for b in batches:
        sb, m = tb.step(sb, b)
        losses.append(m["loss"])
    assert sa.step == sb.step == 3
    assert ma["loss"].shape == (3,) and torch.equal(ma["loss"], torch.stack(losses))
    for k, v in ta.model.state_dict().items():
        assert torch.equal(v, tb.model.state_dict()[k]), k


def test_fault_drill_through_the_prefetcher_resumes_to_an_uninterrupted_runs_bits(smoke_ds, init_tree):
    """At steps_per_call 4 the fault at step 6 ends the second chunk after
    its two leading batches (the prefetcher has assembled more); a run
    resumed from the state at step 6, whose loader seeks to batch 6, ends
    with the bits of an uninterrupted run."""
    cfg = _cfg(4, **{"train.num_steps": 8, "train.fault_inject_step": 6, "train.log_every": 4,
                     "train.checkpoint_every": 4, "train.eval_every": 4})
    seen = []
    tt = Trainer(cfg, DataDims.from_dataset(smoke_ds), device="cpu")
    with pytest.raises(FaultInjected, match="step 6"):
        train(cfg, smoke_ds, trainer=tt, state=tt.init_state(init_tree),
              callbacks=[lambda step, st, m: seen.append(st)])
    assert [st.step for st in seen] == [4, 4, 4, 4, 5, 6]  # a chunk of 4, then two single steps
    resumed = cfg.with_overrides({"train.fault_inject_step": "-1"})
    _, end, hist = train(resumed, smoke_ds, num_steps=2, trainer=tt, state=seen[-1])
    assert end.step == 8 and [r["step"] for r in hist] == [8]
    t_full, _, _ = _port_run(resumed, smoke_ds, init_tree)
    for k, v in t_full.model.state_dict().items():
        assert torch.equal(v, tt.model.state_dict()[k]), k


def test_device_prefetcher_keeps_order_and_closes():
    """Items come out in the order ``produce`` made them, at most ``depth``
    ahead; ``close`` joins the worker."""
    made = iter(range(1000))
    feed = DevicePrefetcher(lambda: next(made), depth=3)
    assert [next(feed) for _ in range(50)] == list(range(50))
    time.sleep(0.2)
    assert next(made) <= 50 + 3 + 1 + 1  # the queue, one held by a blocked put, one being made
    feed.close()
    assert not feed._thread.is_alive()


def test_device_prefetcher_surfaces_a_workers_exception():
    """The worker's exception is raised by the consumer's next ``next()``
    once it is caught (the items queued before it may be dropped), and the
    worker has ended."""
    calls = []

    def produce():
        calls.append(1)
        if len(calls) == 3:
            raise OSError("disk gone")
        return len(calls)

    feed = DevicePrefetcher(produce, depth=2)
    got = []
    with pytest.raises(OSError, match="disk gone"):
        for _ in range(10):
            got.append(next(feed))
    assert got == [1, 2][:len(got)]
    feed.close()
    assert not feed._thread.is_alive() and len(calls) == 3
