"""``model.remat_cell`` in the port: on the scan path each recurrent step
runs under ``torch.utils.checkpoint`` (``models.base.remat_step``), as
``jax.checkpoint`` wraps the scan cell in ``poi_tpu``; the values and
gradients are the same bits as without it, and ``poi_tpu``'s remat run's
at fp32's tolerance. The kernel path keeps no per-step residuals and
ignores the flag, as the reference's fused path does."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import checkpoint as torch_checkpoint

from poi_tpu.models import base as jax_base
from poi_tpu.utils.config import ModelConfig as JaxModelConfig
from poi_tpu_torch.convert import flatten, params_from_jax
from poi_tpu_torch.data.pipeline import Batch
from poi_tpu_torch.models import base
from poi_tpu_torch.utils.config import ModelConfig

torch.set_num_threads(1)

# fp32 against poi_tpu: the same arithmetic up to summation order, relative
# to each gradient's largest entry (tests/test_torch_lstm.py's REL_TOL).
REL_TOL = 1e-5
KINDS = ("gru", "lstm", "strnn", "attention")
DIMS = jax_base.DataDims(num_users=5, num_pois=40, num_time_buckets=6, num_geo_buckets=8, num_tgap_buckets=3,
                         num_dist_buckets=3)
B, T = 4, 9


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    lens = np.array([T, 1, 5, 7])
    return Batch(
        user=rng.integers(0, DIMS.num_users, B).astype(np.int32),
        poi_in=rng.integers(0, DIMS.num_pois, (B, T)).astype(np.int32),
        poi_tgt=rng.integers(0, DIMS.num_pois, (B, T)).astype(np.int32),
        mask=(np.arange(T)[None, :] < lens[:, None]).astype(np.float32),
        time_bucket=rng.integers(0, DIMS.num_time_buckets, (B, T)).astype(np.int32),
        geo_bucket=rng.integers(0, DIMS.num_geo_buckets, (B, T)).astype(np.int32),
        tgap_idx=rng.integers(0, 2, (B, T)).astype(np.int32),
        tgap_frac=rng.random((B, T)).astype(np.float32),
        dist_idx=rng.integers(0, 2, (B, T)).astype(np.int32),
        dist_frac=rng.random((B, T)).astype(np.float32),
    )


def _cfg(kind, remat, cell_impl="scan", dtype="float32"):
    return ModelConfig(kind=kind, embed_dim=16, hidden_dim=16, attn_window=4, attn_heads=2, attn_block_size=4,
                       use_user_embedding=kind == "lstm", compute_dtype=dtype, cell_impl=cell_impl,
                       remat_cell=remat)


def _port_grads(cfg, params, batch, cot):
    """The port's queries and the gradients of sum(queries · cot) by
    parameter name, from poi_tpu's ``params``."""
    tm = base.build_model(cfg, base.DataDims(**dataclasses.asdict(DIMS)), device="cpu")
    tm.load_state_dict(params_from_jax(params))
    q = tm.queries(base.batch_to(batch, "cpu"))
    (q * torch.from_numpy(cot)).sum().backward()
    return q.detach(), {k: p.grad for k, p in tm.named_parameters() if p.grad is not None}


def _count_checkpoints(monkeypatch):
    calls = []
    fn = torch_checkpoint.checkpoint
    monkeypatch.setattr(torch_checkpoint, "checkpoint", lambda *a, **kw: (calls.append(kw), fn(*a, **kw))[1])
    return calls


@pytest.mark.parametrize("kind", KINDS)
def test_remat_scan_gradients_match_without_it_and_poi_tpu(monkeypatch, kind):
    """The scan path (fp32): with ``remat_cell`` every step is checkpointed
    (non-reentrant) and the queries and every gradient are the bits of the
    run without it; both are poi_tpu's remat run's within REL_TOL (the
    cotangent zero at padded positions, where the port's scan carries h and
    poi_tpu's emits the raw step)."""
    batch = _batch()
    cot = np.random.default_rng(1).normal(size=(B, T, 16)).astype(np.float32) * batch.mask[:, :, None]
    jm = jax_base.build_model(JaxModelConfig(**dataclasses.asdict(_cfg(kind, True))), DIMS)
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    q0, g0 = _port_grads(_cfg(kind, False), params, batch, cot)
    calls = _count_checkpoints(monkeypatch)
    q1, g1 = _port_grads(_cfg(kind, True), params, batch, cot)
    assert len(calls) == T and all(kw == {"use_reentrant": False} for kw in calls), calls
    assert torch.equal(q0, q1)
    assert g0.keys() == g1.keys() and all(torch.equal(g0[k], g1[k]) for k in g0), \
        [k for k in g0 if not torch.equal(g0[k], g1[k])]

    want = jax.grad(lambda p: jnp.sum(jm.queries(p, batch) * cot))(params)
    want = {k.replace("/", "."): np.asarray(v) for k, v in flatten(jax.tree.map(np.asarray, want)).items()}
    assert set(g1) <= set(want)
    for k, g in g1.items():
        scale = np.abs(want[k]).max() + 1e-12
        np.testing.assert_allclose(g.numpy() / scale, want[k] / scale, atol=REL_TOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("kind", KINDS)
def test_remat_changes_no_bit_on_the_kernel_path(monkeypatch, kind):
    """``cell_impl="pallas"`` at bf16 (the kernels' plain versions on the
    CPU): ``remat_cell`` checkpoints nothing and changes no bit."""
    batch = _batch(2)
    cot = np.random.default_rng(3).normal(size=(B, T, 16)).astype(np.float32)
    jm = jax_base.build_model(JaxModelConfig(**dataclasses.asdict(_cfg(kind, False))), DIMS)
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(1)))
    q0, g0 = _port_grads(_cfg(kind, False, "pallas", "bfloat16"), params, batch, cot)
    calls = _count_checkpoints(monkeypatch)
    q1, g1 = _port_grads(_cfg(kind, True, "pallas", "bfloat16"), params, batch, cot)
    assert not calls
    assert torch.equal(q0, q1) and g0.keys() == g1.keys() and all(torch.equal(g0[k], g1[k]) for k in g0)
