"""Widths the kernels are not built for, held against the JAX package:
B7/B8 at any D <= 1024 (the wrappers pad to 32, 64, 128, 192, 256, 384,
512, 768 or 1024), B9/B10 at any D <= 1024 (config #5's 384 pads to 512,
600 and 640 to 768, 1000 to 1024) and B11 at any D <= 1024 (to a multiple
of 8).

On the CPU the wrappers take the plain versions, which take any width; the
CUDA wrappers pad ``q`` and the table with zero columns, launch at the
padded width and drop the padded columns of the gradients. Each test runs
that same padding around the plain versions (``widths.pad_cols``), and the
plain versions at the width itself, against the reference's Pallas kernels
in interpret mode at the width itself. Tolerances are the suites' own
(``tests/test_torch_ce.py``, ``test_torch_sampled.py``,
``test_torch_topk.py``): both sides round the operands to bf16 and sum in
fp32 in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poi_tpu.ops.fused_ce import fused_ce_loss_pallas
from poi_tpu.ops.fused_sampled import sampled_nll_rows as jax_sampled_nll_rows
from poi_tpu.ops.topk import fused_topk as jax_fused_topk
from poi_tpu_torch.ops import fused_ce, fused_sampled, topk
from poi_tpu_torch.ops.fused_ce import fused_ce_loss
from poi_tpu_torch.ops.widths import pad_cols, padded_dim

torch.set_num_threads(1)

REL_TOL = 1e-5
SCORE_TOL = 1e-4


def _close(got, want, name, tol=REL_TOL):
    scale = np.abs(want).max() + 1e-12
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=0, err_msg=name)


def test_ce_padded_dim_maps_every_width_and_refuses_past_256():
    """Every D up to 1024 goes to a width the kernels are built for (past 256
    since 384 and 512 were added, past 512 since 768 and 1024 were: the name
    keeps the limit this test was written for); past 1024 the wrappers
    refuse, naming the limit."""
    want = {1: 32, 32: 32, 33: 64, 64: 64, 65: 128, 128: 128, 129: 192, 192: 192, 193: 256, 200: 256, 256: 256,
            257: 384, 300: 384, 384: 384, 385: 512, 512: 512, 513: 768, 600: 768, 768: 768, 769: 1024, 1000: 1024,
            1024: 1024}
    assert {d: padded_dim(d, fused_ce.KERNEL_DIMS, "ce_lse") for d in want} == want
    assert all(padded_dim(d, fused_ce.KERNEL_DIMS, "ce_lse") <= 1.5 * d for d in range(129, 1025))  # the new widths pad by at most 1.5x
    assert fused_ce.lse_rows(256) == fused_ce.lse_rows(200) == 128 and fused_ce.lse_rows(192) == 256
    assert fused_ce.lse_rows(384) == fused_ce.lse_rows(300) == 128 and fused_ce.lse_rows(512) == fused_ce.lse_rows(385) == 64
    assert fused_ce.lse_rows(768) == fused_ce.lse_rows(600) == fused_ce.lse_rows(1024) == 64
    for D in (1025, 2048):
        with pytest.raises(ValueError, match=rf"D <= 1024 .*got D={D}"):
            padded_dim(D, fused_ce.KERNEL_DIMS, "ce_lse")


class _PaddedCE(torch.autograd.Function):
    """``FusedCERows``' CUDA path on the CPU: q and the table padded to the
    kernels' width, the plain forward and backward there, the padded
    gradient columns dropped."""

    @staticmethod
    def forward(ctx, q, table, bias, targets):
        Dp = padded_dim(q.shape[1], fused_ce.KERNEL_DIMS, "ce_lse")
        qp, tp = pad_cols(q.detach(), Dp), pad_cols(table.detach(), Dp)
        lse = fused_ce.ce_lse_reference(qp, tp, bias)
        ctx.save_for_backward(q, table, bias, targets, lse)
        ctx.Dp = Dp
        return lse - ((q.float() * table[targets].float()).sum(dim=1) + bias[targets])

    @staticmethod
    def backward(ctx, g):
        q, table, bias, targets, lse = ctx.saved_tensors
        dq, dtable, dbias = fused_ce.ce_bwd_reference(pad_cols(q, ctx.Dp), pad_cols(table, ctx.Dp), bias, lse, g)
        assert not dq[:, q.shape[1]:].any() and not dtable[:, q.shape[1]:].any()  # zero columns get zero gradient
        dq, dtable = dq[:, :q.shape[1]], dtable[:, :q.shape[1]].clone()
        dq -= g[:, None] * table[targets].float()
        dtable.index_add_(0, targets, -g[:, None] * q.float())
        dbias.index_add_(0, targets, -g)
        return dq, dtable, dbias, None


def _padded_ce_loss(q, table, bias, targets, mask):
    B, T, D = q.shape
    nll = _PaddedCE.apply(q.reshape(B * T, D), table, bias, targets.reshape(-1))
    m = mask.reshape(-1).float()
    return (nll * m).sum() / m.sum().clamp_min(1.0)


@pytest.mark.parametrize("D", [200, 256, 300, 384, 512, 600, 768, 1000, 1024])
@pytest.mark.parametrize("path", ["plain", "padded"])
def test_fused_ce_at_wide_widths_matches_pallas_interpret(D, path):
    """``fused_ce_loss`` (the plain versions at D) and the padded dispatch
    against ``fused_ce_loss_pallas`` at D: the loss and the three
    gradients."""
    rng = np.random.default_rng(D)
    B, T, V = 3, 4, 180
    q = rng.normal(size=(B, T, D)).astype(np.float32)
    table = (rng.normal(size=(V, D)) * 0.3).astype(np.float32)
    bias = rng.normal(size=V).astype(np.float32)
    y = rng.integers(0, V, (B, T)).astype(np.int32)
    mask = (rng.random((B, T)) > 0.2).astype(np.float32)
    want, g_pal = jax.value_and_grad(
        lambda *a: fused_ce_loss_pallas(*a, jnp.asarray(y), jnp.asarray(mask), interpret=True), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(table), jnp.asarray(bias))
    args = [torch.from_numpy(a).requires_grad_() for a in (q, table, bias)]
    fn = fused_ce_loss if path == "plain" else _padded_ce_loss
    got = fn(*args, torch.from_numpy(y).long(), torch.from_numpy(mask))
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= REL_TOL * abs(float(want))
    for a, b, name in zip(args, g_pal, ("dq", "dtable", "dbias")):
        _close(a.grad.numpy(), np.asarray(b), name)


@pytest.mark.parametrize("D", [384, 100, 600, 640, 768, 1000, 1024])
def test_sampled_nll_rows_padded_to_the_kernels_width_matches_pallas_interpret(D):
    """B9/B10's dispatch at a width the kernels are not built for (384 runs
    at 512, 100 at 128, 600 and 640 at 768, 1000 at 1024) and at 768 and
    1024: the padded plain forward and backward, and the CPU wrapper (the
    plain versions) at D itself, against ``sampled_nll_rows`` of the
    reference at D, all four cotangents."""
    Dp = padded_dim(D, fused_sampled.KERNEL_DIMS, "sampled_lse")
    assert Dp == {384: 512, 100: 128, 600: 768, 640: 768, 768: 768, 1000: 1024, 1024: 1024}[D]
    rng = np.random.default_rng(D)
    N, S = 24, 200
    q = rng.normal(size=(N, D)).astype(np.float32)
    e_neg = (rng.normal(size=(S, D)) * 0.3).astype(np.float32)
    b_neg = (rng.normal(size=S) * 0.1 + 1.3).astype(np.float32)
    s_pos = rng.normal(size=N).astype(np.float32)
    targets = rng.integers(0, 40, N).astype(np.int32)
    ids = rng.integers(0, 40, S).astype(np.int32)
    w = rng.random(N).astype(np.float32)

    def jax_fn(q, e, b, s):
        return jnp.sum(jax_sampled_nll_rows(q, e, b, s, (jnp.asarray(targets), jnp.asarray(ids)), True) * w)

    want, g_pal = jax.value_and_grad(jax_fn, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (q, e_neg, b_neg, s_pos)))
    qt, et, bt, st = (torch.from_numpy(a) for a in (q, e_neg, b_neg, s_pos))
    tt, it, wt = torch.from_numpy(targets), torch.from_numpy(ids), torch.from_numpy(w)
    # The CUDA wrappers' arithmetic at the padded width, on the plain versions.
    qp, ep = pad_cols(qt, Dp), pad_cols(et, Dp)
    lse_tot = torch.logaddexp(fused_sampled.sampled_lse_reference(qp, ep, bt, it, tt), st)
    got = ((lse_tot - st) * wt).sum()
    dq, de, db = fused_sampled.sampled_bwd_reference(qp, ep, bt, it, tt, lse_tot, wt)
    assert not dq[:, D:].any() and not de[:, D:].any()
    ds = wt * (torch.exp(st - lse_tot) - 1.0)
    assert abs(float(got) - float(want)) <= REL_TOL * abs(float(want))
    for a, b, name in zip((dq[:, :D], de[:, :D], db, ds), g_pal, ("dq", "de_neg", "db_neg", "ds_pos")):
        _close(a.numpy(), np.asarray(b), name)
    # The CPU wrapper at D itself.
    leaves = [t.clone().requires_grad_() for t in (qt, et, bt, st)]
    at_d = (fused_sampled.sampled_nll_rows(*leaves, tt, it) * wt).sum()
    at_d.backward()
    assert abs(float(at_d.detach()) - float(want)) <= REL_TOL * abs(float(want))
    for a, b, name in zip(leaves, g_pal, ("dq", "de_neg", "db_neg", "ds_pos")):
        _close(a.grad.numpy(), np.asarray(b), name)


def test_topk_pads_any_width_to_a_multiple_of_8_and_matches_pallas_interpret():
    """B11 at D = 100 (the kernel runs at 104): the top-k of the padded
    operands, and ``fused_topk`` at D, against the reference's kernel at
    D; ids equal but for near-ties."""
    assert [padded_dim(d, topk.KERNEL_DIMS, "fused_topk") for d in (1, 8, 100, 1023, 1024)] == [8, 8, 104, 1024, 1024]
    with pytest.raises(ValueError, match=r"D <= 1024 .*got D=1025"):
        padded_dim(1025, topk.KERNEL_DIMS, "fused_topk")
    rng = np.random.default_rng(7)
    B, D, V, k = 8, 100, 2048, 10
    q = rng.normal(size=(B, D)).astype(np.float32)
    table = rng.normal(size=(V, D)).astype(np.float32)
    bias = rng.normal(size=V).astype(np.float32)
    vj, ij = jax_fused_topk(jnp.asarray(q), jnp.asarray(table), jnp.asarray(bias), k, tile_v=512, interpret=True)
    exact = (torch.from_numpy(q).to(torch.bfloat16).double() @ torch.from_numpy(table).to(torch.bfloat16).double().T
             + torch.from_numpy(bias).double()).numpy()
    Dp = padded_dim(D, topk.KERNEL_DIMS, "fused_topk")
    for vals, ids in (topk.fused_topk(torch.from_numpy(q), torch.from_numpy(table), torch.from_numpy(bias), k),
                      topk.topk_reference(pad_cols(torch.from_numpy(q), Dp), pad_cols(torch.from_numpy(table), Dp),
                                          torch.from_numpy(bias), k)):
        np.testing.assert_allclose(vals.numpy(), np.asarray(vj), atol=SCORE_TOL, rtol=0)
        rows = np.arange(B)[:, None]
        near = np.abs(exact[rows, ids.numpy()] - exact[rows, np.asarray(ij)]) < SCORE_TOL
        assert ((ids.numpy() == np.asarray(ij)) | near).all()
