"""The port's GRU backward (poi_tpu_torch.ops.fused_gru: gru_bwd_reference and
the FusedGRU autograd Function, and models.gru.gru_layer under autograd) held
against the JAX package on the same numpy inputs.

The JAX side is jax.vjp of the Pallas recurrence in interpret mode, as
tests/test_fused_gru.py runs it, and the lax.scan cell's autodiff. On the CPU
the port runs the backward kernel's plain version; the CUDA kernel itself is
compared with that plain version on the card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poi_tpu.models.gru import gru_layer as jax_gru_layer
from poi_tpu.ops.fused_gru import fused_gru_scan as jax_fused_gru_scan
from poi_tpu_torch.models.gru import gru_layer
from poi_tpu_torch.ops.fused_gru import MASK_NEG, fused_gru, fused_gru_bwd, gru_bwd_reference, gru_scan_reference

torch.set_num_threads(1)

# The port's plain backward and the TPU kernel share every formula and every
# rounding point (bf16 h_prev and wh in the gate recompute, fp32 cotangents);
# they differ in fp32 summation order and in the exp/tanh libraries, which
# measures ~1e-7 on these seeds. Over 12 reverse steps that stays below 1e-5
# of the largest gradient; a wrong gate formula moves it by ~1e-1.
REL_TOL = 1e-5
# Normalised tolerance of tests/test_fused_gru.py:58-61, for the Pallas-style
# recurrence (bf16 wh and h in the gates) against the fp32 lax.scan cell.
SCAN_TOL = 5e-2


def _case(B=8, T=12, D=16, H=16, seed=0):
    rng = np.random.default_rng(seed)
    p = {
        "wx": (rng.normal(size=(D, 3 * H)) / np.sqrt(D)).astype(np.float32),
        "wh": (rng.normal(size=(H, 3 * H)) / np.sqrt(H)).astype(np.float32),
        "b": (0.1 * rng.normal(size=3 * H)).astype(np.float32),
    }
    x = (0.5 * rng.normal(size=(B, T, D))).astype(np.float32)
    lengths = rng.integers(3, T + 1, size=B)
    lengths[0] = T
    mask = np.arange(T)[None, :] < lengths[:, None]
    return p, x, mask, rng


def _folded_xw(p, x, mask):
    H = p["wh"].shape[0]
    xw = (x @ p["wx"] + p["b"]).astype(np.float32)
    xw[:, :, :H] = np.where(mask[:, :, None], xw[:, :, :H], MASK_NEG)
    return xw


def _close(got, want, tol, name):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = np.abs(want).max() + 1e-12
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=0, err_msg=name)


@pytest.mark.parametrize("wh_dtype", ["float32", "bfloat16"])
def test_backward_matches_pallas_vjp(wh_dtype):
    """Plain backward and the Function's grads vs jax.vjp of the Pallas
    recurrence; dwh comes back in wh's dtype on both sides."""
    p, x, mask, rng = _case(seed=1)
    xw = _folded_xw(p, x, mask)
    dhs = rng.normal(size=(8, 12, 16)).astype(np.float32)
    jdtype = jnp.float32 if wh_dtype == "float32" else jnp.bfloat16
    tdtype = torch.float32 if wh_dtype == "float32" else torch.bfloat16

    hs_j, vjp = jax.vjp(lambda a, w: jax_fused_gru_scan(a, w, True), jnp.asarray(xw), jnp.asarray(p["wh"], jdtype))
    dxw_j, dwh_j = vjp(jnp.asarray(dhs))
    assert dwh_j.dtype == jdtype

    wh16 = torch.from_numpy(p["wh"]).to(torch.bfloat16)
    hs = gru_scan_reference(torch.from_numpy(xw), wh16)
    dxw_r, dwh_r = gru_bwd_reference(torch.from_numpy(xw), wh16, hs, torch.from_numpy(dhs))
    _close(dxw_r, dxw_j, REL_TOL, "plain dxw")
    _close(dwh_r, np.asarray(dwh_j, np.float32), REL_TOL if wh_dtype == "float32" else 2 ** -8, "plain dwh")
    # The wrapper takes the plain version for CPU tensors.
    dxw_w, dwh_w = fused_gru_bwd(torch.from_numpy(xw), wh16, hs, torch.from_numpy(dhs))
    assert torch.equal(dxw_w, dxw_r) and torch.equal(dwh_w, dwh_r)

    xw_t = torch.from_numpy(xw).requires_grad_()
    wh_t = torch.from_numpy(p["wh"]).to(tdtype).requires_grad_()
    out = fused_gru(xw_t, wh_t)
    np.testing.assert_allclose(out.detach().numpy() * mask[:, :, None], np.asarray(hs_j) * mask[:, :, None],
                               atol=1e-5, rtol=0)
    out.backward(torch.from_numpy(dhs))
    assert wh_t.grad.dtype == tdtype
    _close(xw_t.grad, dxw_j, REL_TOL, "Function dxw")
    # With bf16 wh both sides round the fp32 dwh to bf16: one bf16 ulp apart at most.
    _close(wh_t.grad.float(), np.asarray(dwh_j, np.float32), REL_TOL if wh_dtype == "float32" else 2 ** -8,
           "Function dwh")


@pytest.mark.parametrize("cell_impl, tol", [("pallas", SCAN_TOL), ("scan", REL_TOL)])
def test_gru_layer_grads_match_jax_scan(cell_impl, tol):
    """dwx, dwh, db and dx of the port's gru_layer vs JAX's lax.scan cell in
    fp32: the fused path (bf16 gates) at the JAX package's own normalised
    tolerance, the port's scan oracle tightly."""
    p, x, mask, _ = _case(seed=7)

    def jloss(pp, xx):
        hs = jax_gru_layer(pp, xx, jnp.asarray(mask), jnp.float32, cell_impl="scan")
        return jnp.sum(hs * jnp.asarray(mask)[:, :, None] * 0.1)

    gp_j, gx_j = jax.grad(jloss, argnums=(0, 1))({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))

    pt = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    xt = torch.from_numpy(x).requires_grad_()
    m = torch.from_numpy(mask.astype(np.float32))
    hs = gru_layer(pt, xt, m, torch.float32, cell_impl=cell_impl)
    (hs * m[:, :, None] * 0.1).sum().backward()
    for got, want, name in ((pt["wx"].grad, gp_j["wx"], "dwx"), (pt["wh"].grad, gp_j["wh"], "dwh"),
                            (pt["b"].grad, gp_j["b"], "db"), (xt.grad, gx_j, "dx")):
        _close(got, want, tol, name)


def test_padded_steps_zero_dxw_and_pass_the_carry():
    """On padded steps the folded -1e9 makes z == 0: dxw is exactly 0 there,
    and a cotangent that arrives on a padded step reaches the last valid step
    unchanged, in the port and in the JAX kernel."""
    p, x, _, rng = _case(seed=3)
    T = x.shape[1]
    L = T // 2
    mask = np.zeros((8, T), bool)
    mask[:, :L] = True
    xw = torch.from_numpy(_folded_xw(p, x, mask))
    wh16 = torch.from_numpy(p["wh"]).to(torch.bfloat16)
    hs = gru_scan_reference(xw, wh16)
    g = rng.normal(size=(8, 16)).astype(np.float32)
    at_last_valid = np.zeros((8, T, 16), np.float32)
    at_last_valid[:, L - 1] = g
    at_end = np.zeros((8, T, 16), np.float32)
    at_end[:, T - 1] = g
    dxw_a, dwh_a = gru_bwd_reference(xw, wh16, hs, torch.from_numpy(at_last_valid))
    dxw_b, dwh_b = gru_bwd_reference(xw, wh16, hs, torch.from_numpy(at_end))
    assert (dxw_b[:, L:] == 0).all() and (dxw_a[:, L:] == 0).all()
    assert torch.equal(dxw_a, dxw_b) and torch.equal(dwh_a, dwh_b)

    _, vjp = jax.vjp(lambda a: jax_fused_gru_scan(a, jnp.asarray(p["wh"]), True), jnp.asarray(xw.numpy()))
    (dxw_j,) = vjp(jnp.asarray(at_end))
    assert (np.asarray(dxw_j)[:, L:] == 0).all()
    _close(dxw_b, dxw_j, REL_TOL, "dxw")


def test_fused_gru_bwd_rejects_bad_shapes():
    with pytest.raises(ValueError, match="3H"):
        fused_gru_bwd(torch.zeros(2, 3, 12), torch.zeros(4, 12, dtype=torch.bfloat16), torch.zeros(2, 3, 5),
                      torch.zeros(2, 3, 4))


def _three_bf16_terms(x: torch.Tensor):
    """The backward kernel's split of an fp32 cotangent (csrc/gru_bwd.cu):
    b0 = bf16(x), b1 = bf16(x - b0), b2 = bf16(x - b0 - b1)."""
    b0 = x.to(torch.bfloat16)
    r = x - b0.float()
    b1 = r.to(torch.bfloat16)
    return b0, b1, (r - b1.float()).to(torch.bfloat16)


@pytest.mark.parametrize("H", [16, 100, 128])
def test_three_term_split_keeps_the_carry_product_fp32(H):
    """The CUDA kernel computes dhw @ whᵀ as three exact bf16 products (the
    split terms times bf16 wh) summed in fp32. Emulated here, it matches the
    TPU kernel's product (fused_gru.py:121-128: fp32 dhw, wh widened from
    bf16, Precision.HIGHEST, evaluated by XLA on the CPU as interpret mode
    does) to 1e-6 of the largest element, fp32 summation order only; the
    first term alone, a bf16-rounded cotangent, misses by more than 1e-3."""
    rng = np.random.default_rng(H)
    dhw = rng.normal(size=(16, 3 * H)).astype(np.float32)
    wh = torch.from_numpy((rng.normal(size=(H, 3 * H)) / np.sqrt(H)).astype(np.float32)).to(torch.bfloat16).float()
    want = np.asarray(jax.lax.dot_general(jnp.asarray(dhw), jnp.asarray(wh.numpy()), (((1,), (1,)), ((), ())),
                                          precision=jax.lax.Precision.HIGHEST, preferred_element_type=jnp.float32))
    b0, b1, b2 = _three_bf16_terms(torch.from_numpy(dhw))
    # Together the terms hold x to its last bit or so: a relative residual of ~2^-24.
    resid = (torch.from_numpy(dhw).double() - b0.double() - b1.double() - b2.double()).abs()
    assert float((resid / torch.from_numpy(dhw).double().abs().clamp_min(1e-30)).max()) < 2 ** -23
    scale = np.abs(want).max()
    three = (b2.float() @ wh.T + b1.float() @ wh.T + b0.float() @ wh.T).numpy()
    assert np.abs(three - want).max() / scale < 1e-6
    one = (b0.float() @ wh.T).numpy()
    assert np.abs(one - want).max() / scale > 1e-3


def _three_pass_bwd(xw, wh16, hs, dhs):
    """The CUDA backward's arithmetic (csrc/gru_bwd.cu), emulated in torch:
    the gates of every step at once and their coefficients (pass 1), the
    serial carry with dhw = d [alpha, beta, gamma] split into three bf16
    terms times bf16 wh (pass 2), dxw and dhw from d (pass 3), then dwh."""
    B, T, H3 = xw.shape
    H = H3 // 3
    w = wh16.float()
    h_prev = torch.cat([torch.zeros(B, 1, H), hs[:, :-1]], dim=1)
    hw = h_prev.to(torch.bfloat16).float() @ w
    z = torch.sigmoid(xw[..., :H] + hw[..., :H])
    r = torch.sigmoid(xw[..., H:2 * H] + hw[..., H:2 * H])
    hn = hw[..., 2 * H:]
    n = torch.tanh(xw[..., 2 * H:] + r * hn)
    delta = z * (1.0 - n * n)
    alpha = (n - h_prev) * z * (1.0 - z)
    beta = delta * hn * r * (1.0 - r)
    gamma = delta * r
    d = torch.empty(B, T, H)
    dh = torch.zeros(B, H)
    for t in range(T - 1, -1, -1):
        d[:, t] = dh + dhs[:, t]
        terms = _three_bf16_terms(torch.cat([d[:, t] * alpha[:, t], d[:, t] * beta[:, t], d[:, t] * gamma[:, t]], 1))
        carry = (terms[2].float() @ w.T + terms[1].float() @ w.T) + terms[0].float() @ w.T
        dh = d[:, t] * (1.0 - z[:, t]) + carry
    dxw = torch.cat([d * alpha, d * beta, d * delta], dim=2)
    dhw = torch.cat([d * alpha, d * beta, d * gamma], dim=2)
    dwh = (h_prev.reshape(-1, H).T @ dhw.reshape(-1, H3))
    return dxw, dwh


@pytest.mark.parametrize("H", [16, 20])
def test_three_pass_arithmetic_matches_pallas_vjp(H):
    """The CUDA kernel's restructured backward (gates of all steps first,
    then the carry on split bf16 terms, then the outputs), emulated on the
    CPU, against jax.vjp of the Pallas recurrence in interpret mode, at a
    multiple of 16 and at a ragged width; dxw is exactly 0 on padded steps."""
    p, x, mask, rng = _case(H=H, seed=11)
    xw = _folded_xw(p, x, mask)
    dhs = rng.normal(size=(8, 12, H)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, wgt: jax_fused_gru_scan(a, wgt, True), jnp.asarray(xw), jnp.asarray(p["wh"]))
    dxw_j, dwh_j = vjp(jnp.asarray(dhs))
    wh16 = torch.from_numpy(p["wh"]).to(torch.bfloat16)
    hs = gru_scan_reference(torch.from_numpy(xw), wh16)
    dxw, dwh = _three_pass_bwd(torch.from_numpy(xw), wh16, hs, torch.from_numpy(dhs))
    _close(dxw, dxw_j, REL_TOL, "dxw")
    _close(dwh, np.asarray(dwh_j, np.float32), REL_TOL, "dwh")
    assert (dxw.numpy()[~mask] == 0).all()
