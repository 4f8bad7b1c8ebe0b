"""The port's cross-entropy (poi_tpu_torch.ops.fused_ce and train.losses) held
against the JAX package on the same numpy inputs.

The JAX side runs the Pallas CE kernels in interpret mode
(fused_ce_loss_pallas(..., interpret=True)), as tests/test_fused_ce.py does,
and the dense ce_loss oracle. On the CPU the port's fused_ce_loss runs the
kernels' plain versions; the CUDA kernels are compared with those plain
versions on the card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poi_tpu.ops.fused_ce import fused_ce_loss_pallas
from poi_tpu.train.losses import ce_loss as jax_ce_loss
from poi_tpu_torch.ops.fused_ce import ce_bwd, ce_bwd_reference, ce_lse, ce_lse_reference, fused_ce_loss
from poi_tpu_torch.train.losses import FUSED_CE_MIN_VOCAB, bpr_loss, build_loss_fn, ce_loss
from poi_tpu_torch.utils.config import LossConfig

torch.set_num_threads(1)

# Port and Pallas kernel share the rounding points (bf16 q and table in the
# logits and in gp for the products, fp32 everywhere else); they differ in
# fp32 summation order over D and V and in exp: ~1e-7 relative here.
REL_TOL = 1e-5
# The fused path against the dense oracle, whose autodiff rounds dq and dtable
# to bf16: tests/test_fused_ce.py:73's tolerance.
DENSE_ATOL, DENSE_RTOL = 2e-3, 2e-2


def _case(B=3, T=4, D=32, V=180, seed=4):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, T, D)).astype(np.float32)
    table = rng.normal(size=(V, D)).astype(np.float32)
    bias = rng.normal(size=(V,)).astype(np.float32)
    y = rng.integers(0, V, (B, T)).astype(np.int32)
    mask = (rng.random((B, T)) > 0.2).astype(np.float32)
    return q, table, bias, y, mask


def _port_value_and_grads(loss_fn, q, table, bias, y, mask):
    args = [torch.from_numpy(a).requires_grad_() for a in (q, table, bias)]
    loss = loss_fn(*args, torch.from_numpy(y).long(), torch.from_numpy(mask))
    loss.backward()
    return float(loss.detach()), [a.grad.numpy() for a in args]


def _jax_value_and_grads(loss_fn, q, table, bias, y, mask):
    val, grads = jax.value_and_grad(lambda *a: loss_fn(*a, jnp.asarray(y), jnp.asarray(mask)), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(table), jnp.asarray(bias))
    return float(val), [np.asarray(g) for g in grads]


def _close(got, want, name):
    scale = np.abs(want).max() + 1e-12
    np.testing.assert_allclose(got / scale, want / scale, atol=REL_TOL, rtol=0, err_msg=name)


def test_fused_ce_matches_pallas_interpret_and_dense():
    q, table, bias, y, mask = _case()
    got, g_port = _port_value_and_grads(fused_ce_loss, q, table, bias, y, mask)
    want, g_pal = _jax_value_and_grads(lambda *a: fused_ce_loss_pallas(*a, interpret=True), q, table, bias, y, mask)
    assert abs(got - want) <= REL_TOL * abs(want)
    for a, b, name in zip(g_port, g_pal, ("dq", "dtable", "dbias")):
        _close(a, b, name)
    dense, g_dense = _jax_value_and_grads(jax_ce_loss, q, table, bias, y, mask)
    assert abs(got - dense) < 1e-3 * max(1.0, abs(dense))
    for a, b, name in zip(g_port, g_dense, ("dq", "dtable", "dbias")):
        np.testing.assert_allclose(a, b, atol=DENSE_ATOL, rtol=DENSE_RTOL, err_msg=name)


def test_padded_vocab_rows_get_exactly_zero_gradient():
    """-1e30 bias rows (vocab padding) change neither value nor gradient, in
    the port's fused and dense paths as in the JAX kernel."""
    q, table, bias, y, mask = _case(V=96, seed=2)
    table_p = np.concatenate([table, np.full((32, table.shape[1]), 0.5, np.float32)])
    bias_p = np.concatenate([bias, np.full(32, -1e30, np.float32)])
    for fn, jax_fn in ((fused_ce_loss, lambda *a: fused_ce_loss_pallas(*a, interpret=True)), (ce_loss, jax_ce_loss)):
        want = float(jax_fn(jnp.asarray(q), jnp.asarray(table), jnp.asarray(bias), jnp.asarray(y), jnp.asarray(mask)))
        got, (_, dt, db) = _port_value_and_grads(fn, q, table_p, bias_p, y, mask)
        assert abs(got - want) <= REL_TOL * abs(want)
        assert np.abs(dt[96:]).max() == 0.0 and np.abs(db[96:]).max() == 0.0
    _, (_, dt_j, _) = _jax_value_and_grads(lambda *a: fused_ce_loss_pallas(*a, interpret=True),
                                           q, table_p, bias_p, y, mask)
    assert np.abs(dt_j[96:]).max() == 0.0


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_dense_ce_matches_jax(smoothing):
    q, table, bias, y, mask = _case(seed=5)
    got, g_port = _port_value_and_grads(lambda *a: ce_loss(*a, label_smoothing=smoothing), q, table, bias, y, mask)
    want, g_jax = _jax_value_and_grads(lambda *a: jax_ce_loss(*a, label_smoothing=smoothing), q, table, bias, y, mask)
    assert abs(got - want) <= REL_TOL * abs(want)
    for a, b, name in zip(g_port, g_jax, ("dq", "dtable", "dbias")):
        # Both autodiffs round dq and dtable to bf16 at the logits' operands;
        # an fp32 order difference can move one across a rounding boundary.
        np.testing.assert_allclose(a, b, atol=2 ** -8 * np.abs(b).max(), rtol=0, err_msg=name)


def test_plain_versions_do_not_depend_on_the_chunk():
    q, table, bias, _, _ = _case(B=2, T=5, D=16, V=77, seed=6)
    qt, tt, bt = (torch.from_numpy(a) for a in (q.reshape(10, 16), table, bias))
    lse = ce_lse_reference(qt, tt, bt, chunk=77)
    torch.testing.assert_close(ce_lse_reference(qt, tt, bt, chunk=16), lse, rtol=0, atol=1e-6)
    g = torch.linspace(0.1, 1.0, 10)
    whole = ce_bwd_reference(qt, tt, bt, lse, g, chunk=77)
    for a, b in zip(ce_bwd_reference(qt, tt, bt, lse, g, chunk=16), whole):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    # The wrappers take the plain versions for CPU tensors.
    assert torch.equal(ce_lse(qt, tt, bt), ce_lse_reference(qt, tt, bt))
    for a, b in zip(ce_bwd(qt, tt, bt, lse, g), ce_bwd_reference(qt, tt, bt, lse, g)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("num_pois, kind, smoothing, impl, fused", [
    (FUSED_CE_MIN_VOCAB - 1, "ce", 0.0, "auto", False),
    (FUSED_CE_MIN_VOCAB, "ce", 0.0, "auto", True),
    (FUSED_CE_MIN_VOCAB, "ce", 0.1, "auto", False),
    (FUSED_CE_MIN_VOCAB, "ce", 0.0, "xla", False),
    (FUSED_CE_MIN_VOCAB, "ce", 0.0, "fused", True),
])
def test_build_loss_fn_dispatch_matches_the_tpu_package(num_pois, kind, smoothing, impl, fused):
    assert FUSED_CE_MIN_VOCAB == 8192
    fn = build_loss_fn(LossConfig(kind=kind, label_smoothing=smoothing, impl=impl), num_pois)
    assert (fn is fused_ce_loss) == fused


@pytest.mark.parametrize("kind", ["bpr"])
def test_unported_losses_raise(kind):
    """Every objective of poi_tpu is ported now (BPR came with config #2's
    slice): ``kind`` builds its loss, and only an unknown kind raises."""
    assert build_loss_fn(LossConfig(kind=kind), 100) is bpr_loss
    with pytest.raises(ValueError, match="unknown loss"):
        build_loss_fn(LossConfig(kind="hinge"), 100)
