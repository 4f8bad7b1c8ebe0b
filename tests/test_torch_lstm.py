"""The port's LSTM recurrence (poi_tpu_torch.ops.fused_lstm: the plain versions
of the forward and backward kernels and the FusedLSTM autograd Function, and
models.lstm.lstm_layer) held against the JAX package on the same numpy
inputs.

The JAX side runs the Pallas kernels in interpret mode (fused_lstm_scan and
its custom VJP), as tests/test_fused_lstm.py runs them, and the lax.scan
cell's autodiff. On the CPU the port runs the kernels' plain versions; the
CUDA kernels themselves are compared with those on the card by
chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poi_tpu.models.lstm import lstm_layer as jax_lstm_layer
from poi_tpu.ops.fused_lstm import fused_lstm_scan as jax_fused_lstm_scan
from poi_tpu_torch.models.lstm import init_lstm_layer, lstm_layer
from poi_tpu_torch.ops.fused_lstm import (fused_lstm, fused_lstm_bwd, fused_lstm_scan, lstm_bwd_reference,
                                          lstm_scan_reference)

torch.set_num_threads(1)

# Forward: both sides round h and wh to bf16 and sum exact products in fp32,
# in different orders, with sigmoid/tanh from different libraries: ~1e-7 on
# these seeds. 1e-5 leaves room for that drift over T steps; a wrong gate
# order, bias placement or carry blend moves h by ~1e-1.
ATOL = 1e-5
# Backward, relative to each output's largest element: the same formulas and
# rounding points (bf16 h_prev and wh in the gate recompute, fp32
# cotangents), fp32 summation order only; a bf16 cotangent would show at ~4e-3.
REL_TOL = 1e-5
# The Pallas-style recurrence (bf16 h and wh in the gates) against the fp32
# lax.scan cell: tests/test_fused_lstm.py's normalised tolerance.
SCAN_TOL = 5e-2


def _case(B=8, T=12, D=16, H=16, seed=0, min_len=1):
    rng = np.random.default_rng(seed)
    p = {
        "wx": (rng.normal(size=(D, 4 * H)) / np.sqrt(D)).astype(np.float32),
        "wh": (rng.normal(size=(H, 4 * H)) / np.sqrt(H)).astype(np.float32),
        "b": (0.1 * rng.normal(size=4 * H)).astype(np.float32),
    }
    x = (0.5 * rng.normal(size=(B, T, D))).astype(np.float32)
    lengths = rng.integers(min_len, T + 1, size=B)
    lengths[0] = T  # one full row
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    return p, x, mask, rng


def _xw(p, x):
    return (x @ p["wx"] + p["b"]).astype(np.float32)


def _mask_bh(mask, H):
    return jnp.broadcast_to(jnp.asarray(mask)[:, :, None], mask.shape + (H,))


def _close(got, want, tol, name):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = np.abs(want).max() + 1e-12
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=0, err_msg=name)


@pytest.mark.parametrize("H", [16, 64, 20])  # 20: no multiple of 8, as the CUDA backward's ragged last octet
def test_lstm_scan_reference_matches_pallas_interpret(H):
    """hs at every step, padded ones included: both carry h through them."""
    p, x, mask, _ = _case(H=H, seed=H)
    xw = _xw(p, x)
    want = np.asarray(jax_fused_lstm_scan(jnp.asarray(xw), _mask_bh(mask, H), jnp.asarray(p["wh"]), True))
    wh16 = torch.from_numpy(p["wh"]).to(torch.bfloat16)
    hs, cs = lstm_scan_reference(torch.from_numpy(xw), torch.from_numpy(mask), wh16)
    np.testing.assert_allclose(hs.numpy(), want, atol=ATOL, rtol=0)
    # On a padded step both carries pass through exactly.
    for b in range(mask.shape[0]):
        n = int(mask[b].sum())
        assert torch.equal(hs[b, n:], hs[b, n - 1].expand_as(hs[b, n:]))
        assert torch.equal(cs[b, n:], cs[b, n - 1].expand_as(cs[b, n:]))
    # The wrapper takes the plain version for CPU tensors.
    got_hs, got_cs = fused_lstm_scan(torch.from_numpy(xw), torch.from_numpy(mask), wh16)
    assert torch.equal(got_hs, hs) and torch.equal(got_cs, cs)


@pytest.mark.parametrize("wh_dtype, H", [("float32", 16), ("bfloat16", 16), ("float32", 20)],
                         ids=["float32", "bfloat16", "float32-H20"])
def test_backward_matches_pallas_vjp(wh_dtype, H):
    """The plain backward and the Function's grads vs jax.vjp of the Pallas
    recurrence; dwh comes back in wh's dtype on both sides. H = 20 is no
    multiple of 8, as the CUDA backward's ragged last octet."""
    p, x, mask, rng = _case(H=H, seed=1)
    xw = _xw(p, x)
    dhs = rng.normal(size=(8, 12, H)).astype(np.float32)
    jdtype = jnp.float32 if wh_dtype == "float32" else jnp.bfloat16
    tdtype = torch.float32 if wh_dtype == "float32" else torch.bfloat16

    hs_j, vjp = jax.vjp(lambda a, w: jax_fused_lstm_scan(a, _mask_bh(mask, H), w, True), jnp.asarray(xw),
                        jnp.asarray(p["wh"], jdtype))
    dxw_j, dwh_j = vjp(jnp.asarray(dhs))
    assert dwh_j.dtype == jdtype

    m = torch.from_numpy(mask)
    wh16 = torch.from_numpy(p["wh"]).to(torch.bfloat16)
    hs, cs = lstm_scan_reference(torch.from_numpy(xw), m, wh16)
    dxw_r, dwh_r = lstm_bwd_reference(torch.from_numpy(xw), m, wh16, hs, cs, torch.from_numpy(dhs))
    _close(dxw_r, dxw_j, REL_TOL, "plain dxw")
    _close(dwh_r, np.asarray(dwh_j, np.float32), REL_TOL if wh_dtype == "float32" else 2 ** -8, "plain dwh")
    got = fused_lstm_bwd(torch.from_numpy(xw), m, wh16, hs, cs, torch.from_numpy(dhs))
    assert torch.equal(got[0], dxw_r) and torch.equal(got[1], dwh_r)

    xw_t = torch.from_numpy(xw).requires_grad_()
    wh_t = torch.from_numpy(p["wh"]).to(tdtype).requires_grad_()
    out = fused_lstm(xw_t, m, wh_t)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(hs_j), atol=ATOL, rtol=0)
    out.backward(torch.from_numpy(dhs))
    assert wh_t.grad.dtype == tdtype
    _close(xw_t.grad, dxw_j, REL_TOL, "Function dxw")
    # With bf16 wh both sides round the fp32 dwh to bf16: one bf16 ulp apart at most.
    _close(wh_t.grad.float(), np.asarray(dwh_j, np.float32), REL_TOL if wh_dtype == "float32" else 2 ** -8,
           "Function dwh")


@pytest.mark.parametrize("cell_impl, tol", [("pallas", SCAN_TOL), ("scan", REL_TOL)])
def test_lstm_layer_matches_jax_scan(cell_impl, tol):
    """hs at the valid steps and dwx, dwh, db, dx of the port's lstm_layer
    vs JAX's lax.scan cell in fp32: the fused path (bf16 gates) at the JAX
    package's own normalised tolerance, the port's scan oracle tightly."""
    p, x, mask, _ = _case(seed=7, min_len=3)
    jm = jnp.asarray(mask > 0)

    def jloss(pp, xx):
        hs = jax_lstm_layer(pp, xx, jm, jnp.float32, cell_impl="scan")
        return jnp.sum(hs * jm[:, :, None] * 0.1), hs

    (_, hs_j), (gp_j, gx_j) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))

    pt = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    xt = torch.from_numpy(x).requires_grad_()
    m = torch.from_numpy(mask)
    hs = lstm_layer(pt, xt, m, torch.float32, cell_impl=cell_impl)
    # The scan oracle emits the raw step output on padded steps: valid ones only.
    _close(hs.detach() * m[:, :, None], np.asarray(hs_j) * mask[:, :, None], tol, "hs")
    (hs * m[:, :, None] * 0.1).sum().backward()
    for got, want, name in ((pt["wx"].grad, gp_j["wx"], "dwx"), (pt["wh"].grad, gp_j["wh"], "dwh"),
                            (pt["b"].grad, gp_j["b"], "db"), (xt.grad, gx_j, "dx")):
        _close(got, want, tol, name)


def test_padded_steps_zero_dxw_and_pass_the_carries():
    """On padded steps dxw is exactly 0, and a cotangent that arrives on a
    padded step reaches the last valid step unchanged (through dh and dc),
    in the port and in the JAX kernel."""
    p, x, _, rng = _case(seed=3)
    T = x.shape[1]
    L = T // 2
    mask = np.zeros((8, T), np.float32)
    mask[:, :L] = 1.0
    xw = torch.from_numpy(_xw(p, x))
    m = torch.from_numpy(mask)
    wh16 = torch.from_numpy(p["wh"]).to(torch.bfloat16)
    hs, cs = lstm_scan_reference(xw, m, wh16)
    g = rng.normal(size=(8, 16)).astype(np.float32)
    at_last_valid = np.zeros((8, T, 16), np.float32)
    at_last_valid[:, L - 1] = g
    at_end = np.zeros((8, T, 16), np.float32)
    at_end[:, T - 1] = g
    dxw_a, dwh_a = lstm_bwd_reference(xw, m, wh16, hs, cs, torch.from_numpy(at_last_valid))
    dxw_b, dwh_b = lstm_bwd_reference(xw, m, wh16, hs, cs, torch.from_numpy(at_end))
    assert (dxw_b[:, L:] == 0).all() and (dxw_a[:, L:] == 0).all()
    assert torch.equal(dxw_a, dxw_b) and torch.equal(dwh_a, dwh_b)

    _, vjp = jax.vjp(lambda a: jax_fused_lstm_scan(a, _mask_bh(mask, 16), jnp.asarray(p["wh"]), True),
                     jnp.asarray(xw.numpy()))
    (dxw_j,) = vjp(jnp.asarray(at_end))
    assert (np.asarray(dxw_j)[:, L:] == 0).all()
    _close(dxw_b, dxw_j, REL_TOL, "dxw")


def _three_bf16_terms(x: torch.Tensor):
    """The CUDA backward's split of an fp32 cotangent (csrc/cluster_carry.cuh
    split3): b0 = bf16(x), b1 = bf16(x - b0), b2 = bf16(x - b0 - b1)."""
    b0 = x.to(torch.bfloat16)
    r = x - b0.float()
    b1 = r.to(torch.bfloat16)
    return b0, b1, (r - b1.float()).to(torch.bfloat16)


def _coefficient_bwd(xw, mask, wh16, hs, cs, dhs):
    """The CUDA backward's arithmetic (csrc/lstm.cu), emulated in torch.
    Pass 1: every step's gates at once and the coefficients that depend on
    the forward alone, kappa = o(1 - tc^2), omega = tc o(1 - o), iota = g i(1 - i),
    phi = c_prev f(1 - f), gamma = i(1 - g^2) and f. Pass 2: the serial carry,
    dxw[t] = [dc_raw iota, dc_raw phi, dc_raw gamma, dh_raw omega] and
    dxw[t] @ whᵀ as the sum of three bf16-term products, smallest first.
    Then dwh."""
    B, T, H4 = xw.shape
    H = H4 // 4
    w = wh16.float()
    h_prev = torch.cat([torch.zeros(B, 1, H), hs[:, :-1]], dim=1)
    c_prev = torch.cat([torch.zeros(B, 1, H), cs[:, :-1]], dim=1)
    pre = xw + h_prev.to(torch.bfloat16).float() @ w
    i, f, g, o = (torch.sigmoid(pre[..., :H]), torch.sigmoid(pre[..., H:2 * H]), torch.tanh(pre[..., 2 * H:3 * H]),
                  torch.sigmoid(pre[..., 3 * H:]))
    tc = torch.tanh(f * c_prev + i * g)
    kappa, omega = o * (1.0 - tc * tc), tc * o * (1.0 - o)
    iota, phi, gamma = g * i * (1.0 - i), c_prev * f * (1.0 - f), i * (1.0 - g * g)
    dxw = torch.empty(B, T, H4)
    dh = torch.zeros(B, H)
    dc = torch.zeros(B, H)
    for t in range(T - 1, -1, -1):
        m = mask[:, t, None]
        d = dh + dhs[:, t]
        dh_raw = d * m
        dc_raw = dc * m + dh_raw * kappa[:, t]
        x = torch.cat([dc_raw * iota[:, t], dc_raw * phi[:, t], dc_raw * gamma[:, t], dh_raw * omega[:, t]], 1)
        dxw[:, t] = x
        terms = _three_bf16_terms(x)
        dh = d * (1.0 - m) + ((terms[2].float() @ w.T + terms[1].float() @ w.T) + terms[0].float() @ w.T)
        dc = dc * (1.0 - m) + dc_raw * f[:, t]
    dwh = h_prev.reshape(-1, H).T @ dxw.reshape(-1, H4)
    return dxw, dwh


@pytest.mark.parametrize("H", [16, 20])
def test_coefficient_bwd_matches_pallas_vjp(H):
    """The CUDA backward's restructured arithmetic (per-element coefficients
    from the forward, then the carry on split bf16 terms), emulated on the
    CPU, against jax.vjp of the Pallas recurrence in interpret mode, padded
    steps included (every row has some, and dhs is nonzero there), at a
    multiple of 8 and at a ragged width; dxw is exactly 0 on padded steps."""
    p, x, mask, rng = _case(H=H, seed=13, min_len=2)
    mask[:, -1] = 0.0  # a padded tail on every row
    mask[0, :-1] = 1.0
    xw = _xw(p, x)
    dhs = rng.normal(size=(8, 12, H)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, w: jax_fused_lstm_scan(a, _mask_bh(mask, H), w, True), jnp.asarray(xw),
                     jnp.asarray(p["wh"]))
    dxw_j, dwh_j = vjp(jnp.asarray(dhs))
    wh16 = torch.from_numpy(p["wh"]).to(torch.bfloat16)
    m = torch.from_numpy(mask)
    hs, cs = lstm_scan_reference(torch.from_numpy(xw), m, wh16)
    dxw, dwh = _coefficient_bwd(torch.from_numpy(xw), m, wh16, hs, cs, torch.from_numpy(dhs))
    _close(dxw, dxw_j, REL_TOL, "dxw")
    _close(dwh, np.asarray(dwh_j, np.float32), REL_TOL, "dwh")
    assert (dxw.numpy()[mask == 0] == 0).all()


def test_init_lstm_layer_layout():
    """poi_tpu's layout and scales: [D, 4H], [H, 4H], the forget block of
    the bias at 1.0."""
    p = init_lstm_layer(torch.Generator().manual_seed(0), 8, 6)
    assert p["wx"].shape == (8, 24) and p["wh"].shape == (6, 24) and p["b"].shape == (24,)
    assert torch.equal(p["b"][6:12], torch.ones(6)) and not p["b"][:6].any() and not p["b"][12:].any()


def test_fused_lstm_rejects_bad_shapes():
    with pytest.raises(ValueError, match="4H"):
        fused_lstm_scan(torch.zeros(2, 3, 12), torch.ones(2, 3), torch.zeros(4, 12, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="mask"):
        fused_lstm_scan(torch.zeros(2, 3, 16), torch.ones(2, 4), torch.zeros(4, 16, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="hs, cs and dhs"):
        fused_lstm_bwd(torch.zeros(2, 3, 16), torch.ones(2, 3), torch.zeros(4, 16, dtype=torch.bfloat16),
                       torch.zeros(2, 3, 4), torch.zeros(2, 3, 4), torch.zeros(2, 3, 5))
