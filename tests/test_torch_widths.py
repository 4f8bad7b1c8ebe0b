"""Widths the kernels are not built for, held against the JAX package:
B7/B8 at any D (the wrappers pad to 32, 64, 128, 192, 256, 384, 512, 768 or
1024, and past 1024 to a multiple of 256: 1100 runs at 1280), B9/B10 at any
D <= 1024 (config #5's 384 pads to 512, 600 and 640 to 768, 1000 to 1024;
past 1024 in ``tests/test_torch_wider_losses.py``) and B11 at any D (to a
multiple of 8, past 1024 of 256).

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
    """Every D goes to a width the kernels are built for (past 256 since 384
    and 512 were added, past 512 since 768 and 1024 were, past 1024 since
    the streamed kernels take every multiple of 256: the name keeps the
    limit this test was written for). Past 1024 ``kernel_dim`` pads to the
    next multiple of 256, by at most 1.25x; ``padded_dim`` without
    ``chunked`` still refuses there, naming the limit."""
    want = {1: 32, 32: 32, 33: 64, 64: 64, 65: 128, 128: 128, 129: 192, 192: 192, 193: 256, 200: 256, 256: 256,
            257: 384, 300: 384, 384: 384, 385: 512, 512: 512, 513: 768, 600: 768, 768: 768, 769: 1024, 1000: 1024,
            1024: 1024, 1025: 1280, 1100: 1280, 1280: 1280, 1281: 1536, 2047: 2048, 2048: 2048, 4096: 4096}
    assert {d: fused_ce.kernel_dim(d) for d in want} == want
    assert all(fused_ce.kernel_dim(d) <= 1.5 * d for d in range(129, 1025))  # the new widths pad by at most 1.5x
    past = {d: fused_ce.kernel_dim(d) for d in range(1025, 4097)}
    assert all(Dp % 256 == 0 and d <= Dp <= 1.25 * d for d, Dp in past.items())
    assert fused_ce.lse_rows(256) == fused_ce.lse_rows(200) == 128 and fused_ce.lse_rows(192) == 256
    assert fused_ce.lse_rows(384) == fused_ce.lse_rows(300) == 128 and fused_ce.lse_rows(512) == fused_ce.lse_rows(385) == 64
    assert fused_ce.lse_rows(768) == fused_ce.lse_rows(600) == fused_ce.lse_rows(1024) == 64
    assert fused_ce.lse_rows(1100) == fused_ce.lse_rows(2048) == fused_ce.lse_rows(4096) == 64
    for D in (1025, 2048):
        with pytest.raises(ValueError, match=rf"D <= 1024 .*got D={D}"):
            padded_dim(D, fused_ce.KERNEL_DIMS, "ce_lse")


class _PaddedCE(torch.autograd.Function):
    """``FusedCERows``' CUDA path on the CPU: q and the table padded to the
    kernels' width, the plain forward and backward there, the padded
    gradient columns dropped."""

    @staticmethod
    def forward(ctx, q, table, bias, targets):
        Dp = fused_ce.kernel_dim(q.shape[1])
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


@pytest.mark.parametrize("D", [200, 256, 300, 384, 512, 600, 768, 1000, 1024, 1100, 1280, 2048])
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
    reference at D, all four cotangents (``_sampled_against_pallas``)."""
    Dp = padded_dim(D, fused_sampled.KERNEL_DIMS, "sampled_lse")
    assert Dp == {384: 512, 100: 128, 600: 768, 640: 768, 768: 768, 1000: 1024, 1024: 1024}[D]
    _sampled_against_pallas(D, Dp)


def _sampled_against_pallas(D: int, Dp: int) -> None:
    """The CUDA wrappers' arithmetic at the kernels' width ``Dp`` (the plain
    forward and backward on zero-padded operands) and the CPU wrapper at
    ``D``, against ``sampled_nll_rows`` of the reference at D in interpret
    mode: the loss and all four cotangents at ``REL_TOL``, on a pool of 200
    with accidental hits on most rows."""
    rng = np.random.default_rng(D)
    N, S = 24, 200
    q = rng.normal(size=(N, D)).astype(np.float32)
    e_neg = (rng.normal(size=(S, D)) * 0.3).astype(np.float32)
    b_neg = (rng.normal(size=S) * 0.1 + 1.3).astype(np.float32)
    s_pos = rng.normal(size=N).astype(np.float32)
    targets = rng.integers(0, 40, N).astype(np.int32)
    ids = rng.integers(0, 40, S).astype(np.int32)
    w = rng.random(N).astype(np.float32)
    assert (ids[None, :] == targets[:, None]).any(axis=1).sum() >= N // 2

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
    D; ids equal but for near-ties. Up to 1024 the kernel pads to a multiple
    of 8; past it (where it used to refuse) to one of 256, by at most
    1.25x."""
    assert [topk.kernel_dim(d) for d in (1, 8, 100, 1023, 1024)] == [8, 8, 104, 1024, 1024]
    assert [topk.kernel_dim(d) for d in (1025, 1100, 1280, 2048, 2049, 4096)] == [1280, 1280, 1280, 2048, 2304, 4096]
    assert all(d <= topk.kernel_dim(d) <= 1.25 * d and topk.kernel_dim(d) % 256 == 0 for d in range(1025, 4097))
    _topk_against_pallas(100, B=8, V=2048, seed=7)


@pytest.mark.parametrize("D", [1100, 1280, 2048])
def test_topk_past_1024_pads_to_a_multiple_of_256_and_matches_pallas_interpret(D):
    """B11 past 1024 (1100 runs at 1280 on the K-chunked kernel): the top-k
    of the padded operands, and ``fused_topk`` at D, against the
    reference's kernel at D, which checks no width; ids equal but for
    near-ties, under the same ``SCORE_TOL``."""
    assert topk.kernel_dim(D) == {1100: 1280, 1280: 1280, 2048: 2048}[D]
    _topk_against_pallas(D, B=5, V=1024, seed=D)


def _topk_against_pallas(D: int, B: int, V: int, seed: int, k: int = 10):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(B, D)) * (100 / D) ** 0.5).astype(np.float32)  # scores of one spread at every width
    table = rng.normal(size=(V, D)).astype(np.float32)
    bias = rng.normal(size=V).astype(np.float32)
    vj, ij = jax_fused_topk(jnp.asarray(q), jnp.asarray(table), jnp.asarray(bias), k, tile_v=512, interpret=True)
    exact = (torch.from_numpy(q).to(torch.bfloat16).double() @ torch.from_numpy(table).to(torch.bfloat16).double().T
             + torch.from_numpy(bias).double()).numpy()
    Dp = topk.kernel_dim(D)
    for vals, ids in (topk.fused_topk(torch.from_numpy(q), torch.from_numpy(table), torch.from_numpy(bias), k),
                      topk.topk_reference(pad_cols(torch.from_numpy(q), Dp), pad_cols(torch.from_numpy(table), Dp),
                                          torch.from_numpy(bias), k)):
        np.testing.assert_allclose(vals.numpy(), np.asarray(vj), atol=SCORE_TOL, rtol=0)
        rows = np.arange(B)[:, None]
        near = np.abs(exact[rows, ids.numpy()] - exact[rows, np.asarray(ij)]) < SCORE_TOL
        assert ((ids.numpy() == np.asarray(ij)) | near).all()
