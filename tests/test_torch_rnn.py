"""The port's ST-RNN recurrence (poi_tpu_torch.ops.fused_rnn: the plain versions
of the forward and backward kernels and the FusedRNN autograd Function) held
against the JAX package on the same numpy inputs.

The JAX side runs the Pallas kernels in interpret mode (fused_rnn_scan and
its custom VJP), as tests/test_fused_rnn.py runs them, and a lax.scan cell
with its autodiff. On the CPU the port runs the kernels' plain versions; the
CUDA kernels themselves are compared with those on the card by
chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poi_tpu.models.base import scan_time_major
from poi_tpu.ops.fused_rnn import fused_rnn_scan as jax_fused_rnn_scan
from poi_tpu_torch.ops.fused_rnn import fused_rnn, fused_rnn_bwd, fused_rnn_scan, rnn_bwd_reference, rnn_scan_reference

torch.set_num_threads(1)

# Forward: both sides round h and C to bf16 and sum exact products in fp32
# in different orders, tanh from different libraries: ~1e-7 on these seeds;
# a wrong blend or a missing input moves h by ~1e-1.
ATOL = 1e-5
# Backward, relative to each output's largest element: the same formulas and
# rounding points, fp32 summation order only.
REL_TOL = 1e-5
# The Pallas-style recurrence (bf16 h and C) against the fp32 lax.scan cell.
SCAN_TOL = 5e-2


def _case(B=8, T=12, H=16, seed=0, min_len=1):
    rng = np.random.default_rng(seed)
    xin = (0.8 * rng.normal(size=(B, T, H))).astype(np.float32)
    c = (rng.normal(size=(H, H)) / np.sqrt(H)).astype(np.float32)
    lengths = rng.integers(min_len, T + 1, size=B)
    lengths[0] = T
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    return xin, c, mask, rng


def _mask_bh(mask, H):
    return jnp.broadcast_to(jnp.asarray(mask)[:, :, None], mask.shape + (H,))


def _close(got, want, tol, name):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = np.abs(want).max() + 1e-12
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=0, err_msg=name)


@pytest.mark.parametrize("H", [16, 64, 20, 352])
def test_rnn_scan_reference_matches_pallas_interpret(H):
    """hs at every step: both carry h through the padded ones; also at a
    ragged width and at one past the kernels' old limit of 339."""
    xin, c, mask, _ = _case(H=H, seed=H)
    want = np.asarray(jax_fused_rnn_scan(jnp.asarray(xin), _mask_bh(mask, H), jnp.asarray(c), True))
    c16 = torch.from_numpy(c).to(torch.bfloat16)
    hs = rnn_scan_reference(torch.from_numpy(xin), torch.from_numpy(mask), c16)
    np.testing.assert_allclose(hs.numpy(), want, atol=ATOL, rtol=0)
    for b in range(mask.shape[0]):
        n = int(mask[b].sum())
        assert torch.equal(hs[b, n:], hs[b, n - 1].expand_as(hs[b, n:]))
    assert torch.equal(fused_rnn_scan(torch.from_numpy(xin), torch.from_numpy(mask), c16), hs)


@pytest.mark.parametrize("c_dtype", ["float32", "bfloat16"])
def test_backward_matches_pallas_vjp(c_dtype):
    """The plain backward and the Function's grads vs jax.vjp of the Pallas
    recurrence; dC comes back in C's dtype on both sides."""
    xin, c, mask, rng = _case(seed=1)
    dhs = rng.normal(size=xin.shape).astype(np.float32)
    jdtype = jnp.float32 if c_dtype == "float32" else jnp.bfloat16
    tdtype = torch.float32 if c_dtype == "float32" else torch.bfloat16

    hs_j, vjp = jax.vjp(lambda a, w: jax_fused_rnn_scan(a, _mask_bh(mask, 16), w, True), jnp.asarray(xin),
                        jnp.asarray(c, jdtype))
    dxin_j, dc_j = vjp(jnp.asarray(dhs))
    assert dc_j.dtype == jdtype

    m = torch.from_numpy(mask)
    c16 = torch.from_numpy(c).to(torch.bfloat16)
    hs = rnn_scan_reference(torch.from_numpy(xin), m, c16)
    dxin_r, dc_r = rnn_bwd_reference(torch.from_numpy(xin), m, c16, hs, torch.from_numpy(dhs))
    _close(dxin_r, dxin_j, REL_TOL, "plain dxin")
    _close(dc_r, np.asarray(dc_j, np.float32), REL_TOL if c_dtype == "float32" else 2 ** -8, "plain dC")
    got = fused_rnn_bwd(torch.from_numpy(xin), m, c16, hs, torch.from_numpy(dhs))
    assert torch.equal(got[0], dxin_r) and torch.equal(got[1], dc_r)

    xin_t = torch.from_numpy(xin).requires_grad_()
    c_t = torch.from_numpy(c).to(tdtype).requires_grad_()
    out = fused_rnn(xin_t, m, c_t)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(hs_j), atol=ATOL, rtol=0)
    out.backward(torch.from_numpy(dhs))
    assert c_t.grad.dtype == tdtype
    _close(xin_t.grad, dxin_j, REL_TOL, "Function dxin")
    _close(c_t.grad.float(), np.asarray(dc_j, np.float32), REL_TOL if c_dtype == "float32" else 2 ** -8,
           "Function dC")


def test_plain_recurrence_matches_jax_scan_autodiff():
    """The plain forward under autograd (the port's ``scan`` path) vs a
    masked lax.scan cell in fp32, as poi_tpu's ST-RNN tower runs it, at the
    valid steps; and the fused Function (bf16 C) at the scan tolerance."""
    xin, c, mask, _ = _case(seed=7, min_len=3)
    jm = jnp.asarray(mask > 0)

    def jloss(a, w):
        def step(h, x_t):
            h_new = jnp.tanh(x_t + jnp.dot(h, w, preferred_element_type=jnp.float32))
            return h_new, h_new

        hs = scan_time_major(step, jnp.zeros((a.shape[0], a.shape[2]), jnp.float32), a, jm)
        return jnp.sum(hs * jm[:, :, None] * 0.1), hs

    (_, hs_j), (gx_j, gc_j) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(xin),
                                                                                     jnp.asarray(c))
    m = torch.from_numpy(mask)
    for fn, tol in ((lambda a, w: rnn_scan_reference(a, m, w), REL_TOL), (lambda a, w: fused_rnn(a, m, w), SCAN_TOL)):
        xt = torch.from_numpy(xin).requires_grad_()
        ct = torch.from_numpy(c).requires_grad_()
        hs = fn(xt, ct)
        _close(hs.detach() * m[:, :, None], np.asarray(hs_j) * mask[:, :, None], tol, "hs")
        (hs * m[:, :, None] * 0.1).sum().backward()
        _close(xt.grad, gx_j, tol, "dxin")
        _close(ct.grad, gc_j, tol, "dC")


def test_padded_steps_zero_dxin_and_pass_the_carry():
    xin, c, _, rng = _case(seed=3)
    T = xin.shape[1]
    L = T // 2
    mask = np.zeros((8, T), np.float32)
    mask[:, :L] = 1.0
    x, m = torch.from_numpy(xin), torch.from_numpy(mask)
    c16 = torch.from_numpy(c).to(torch.bfloat16)
    hs = rnn_scan_reference(x, m, c16)
    g = rng.normal(size=(8, 16)).astype(np.float32)
    at_last_valid = np.zeros((8, T, 16), np.float32)
    at_last_valid[:, L - 1] = g
    at_end = np.zeros((8, T, 16), np.float32)
    at_end[:, T - 1] = g
    da = rnn_bwd_reference(x, m, c16, hs, torch.from_numpy(at_last_valid))
    db = rnn_bwd_reference(x, m, c16, hs, torch.from_numpy(at_end))
    assert (da[0][:, L:] == 0).all() and (db[0][:, L:] == 0).all()
    assert torch.equal(da[0], db[0]) and torch.equal(da[1], db[1])
    _, vjp = jax.vjp(lambda a: jax_fused_rnn_scan(a, _mask_bh(mask, 16), jnp.asarray(c), True), jnp.asarray(xin))
    (dxin_j,) = vjp(jnp.asarray(at_end))
    assert (np.asarray(dxin_j)[:, L:] == 0).all()
    _close(db[0], dxin_j, REL_TOL, "dxin")


def test_fused_rnn_rejects_bad_shapes():
    with pytest.raises(ValueError, match="C \\[H,H\\]"):
        fused_rnn_scan(torch.zeros(2, 3, 8), torch.ones(2, 3), torch.zeros(8, 4, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="hs and dhs"):
        fused_rnn_bwd(torch.zeros(2, 3, 8), torch.ones(2, 3), torch.zeros(8, 8, dtype=torch.bfloat16),
                      torch.zeros(2, 3, 8), torch.zeros(2, 3, 7))


def _three_bf16_terms(x: torch.Tensor):
    """The CUDA backward's split of an fp32 tensor (csrc/cluster_carry.cuh
    split3): b0 = bf16(x), b1 = bf16(x - b0), b2 = bf16(x - b0 - b1)."""
    b0 = x.to(torch.bfloat16)
    r = x - b0.float()
    b1 = r.to(torch.bfloat16)
    return b0, b1, (r - b1.float()).to(torch.bfloat16)


def _three_part_bwd(xin, mask, c16, hs, dhs, dc_dtype=torch.float32):
    """csrc/rnn.cu's backward emulated in torch. Part 1: the coefficient
    a = m (1 - h_raw²) of every step at once, h_raw from bf16(h_prev).
    Part 2: the serial carry, dpre(t) = d a[t] with d = dh + dhs[t], and
    dh = d (1 - m) + dpre @ Cᵀ as three bf16-term products, the smallest
    first. Part 3: dC = h_prevᵀ dpre over all (b, t), its operands rounded
    to ``dc_dtype`` (the kernel's: fp32)."""
    B, T, H = xin.shape
    w = c16.float()
    h_prev = torch.cat([torch.zeros(B, 1, H), hs[:, :-1]], dim=1)
    h_raw = torch.tanh(xin + h_prev.to(torch.bfloat16).float() @ w)
    a = mask[:, :, None] * (1.0 - h_raw * h_raw)
    dxin = torch.empty(B, T, H)
    keep = torch.zeros(B, H)
    for t in range(T - 1, -1, -1):
        dh = keep
        if t < T - 1:
            terms = _three_bf16_terms(dxin[:, t + 1])
            dh = keep + ((terms[2].float() @ w.T + terms[1].float() @ w.T) + terms[0].float() @ w.T)
        d = dh + dhs[:, t]
        dxin[:, t] = d * a[:, t]
        keep = d * (1.0 - mask[:, t, None])
    dc = h_prev.reshape(-1, H).to(dc_dtype).float().T @ dxin.reshape(-1, H).to(dc_dtype).float()
    return dxin, dc


@pytest.mark.parametrize("H", [16, 20, 400])
def test_three_part_bwd_matches_pallas_vjp(H):
    """The CUDA backward's restructured arithmetic (the coefficients from all
    steps at once, the carry on split bf16 terms, dC in fp32), emulated on
    the CPU, against jax.vjp of the Pallas recurrence in interpret mode, at a
    multiple of 8, at a ragged width, and at one past 24 k-steps (the carry's
    wide instantiation, 8 warps a block), on the hs of the Pallas forward the
    VJP saved. Every row has a padded tail with
    nonzero dhs there, and dxin is exactly 0 on padded steps. dC from bf16
    operands misses the tolerance, so it stays in fp32."""
    xin, c, mask, rng = _case(H=H, seed=17, min_len=2)
    mask[:, -2:] = 0.0  # a padded tail on every row
    mask[0, :-2] = 1.0
    dhs = rng.normal(size=xin.shape).astype(np.float32)
    hs_j, vjp = jax.vjp(lambda a, w: jax_fused_rnn_scan(a, _mask_bh(mask, H), w, True), jnp.asarray(xin),
                        jnp.asarray(c))
    dxin_j, dc_j = vjp(jnp.asarray(dhs))
    x, m = torch.from_numpy(xin), torch.from_numpy(mask)
    c16 = torch.from_numpy(c).to(torch.bfloat16)
    # The forward the VJP saved: at H = 400 the plain forward's h rounds to
    # bf16 apart from the Pallas one's at a few elements (summation order).
    hs = torch.from_numpy(np.array(hs_j))
    dxin, dc = _three_part_bwd(x, m, c16, hs, torch.from_numpy(dhs))
    _close(dxin, dxin_j, REL_TOL, "dxin")
    _close(dc, np.asarray(dc_j, np.float32), REL_TOL, "dC")
    assert (dxin.numpy()[mask == 0] == 0).all()
    _, dc_one = _three_part_bwd(x, m, c16, hs, torch.from_numpy(dhs), dc_dtype=torch.bfloat16)
    scale = np.abs(np.asarray(dc_j)).max()
    assert np.abs(dc_one.numpy() - np.asarray(dc_j)).max() / scale > 10 * REL_TOL


def _tanh_fast(x: torch.Tensor) -> torch.Tensor:
    """csrc/cluster_carry.cuh's tanh_fast in fp32: 1 - 2 / (1 + 2^(2 log2(e) x)),
    infinite powers of two giving exactly -1 and 1."""
    e = torch.exp2(x * (2.0 * 1.4426950408889634))
    return 1.0 - 2.0 * torch.reciprocal(1.0 + e)


def _two_chain_fwd(xin, mask, c16):
    """csrc/rnn.cu's forward (B5) emulated in torch: bf16(h) @ C as two fp32
    chains over the even and odd 16-wide k-steps (K zero-padded to 16),
    added at the end, then tanh_fast and the blend with the mask."""
    B, T, H = xin.shape
    Hk = -(-H // 16) * 16
    w = torch.zeros(Hk, H)
    w[:H] = c16.float()
    h = torch.zeros(B, H)
    hs = torch.empty(B, T, H)
    for t in range(T):
        hb = torch.zeros(B, Hk)
        hb[:, :H] = h.to(torch.bfloat16).float()
        chains = [torch.zeros(B, H), torch.zeros(B, H)]
        for kb in range(Hk // 16):
            ks = slice(16 * kb, 16 * kb + 16)
            chains[kb % 2] = chains[kb % 2] + hb[:, ks] @ w[ks]
        h_raw = _tanh_fast(xin[:, t] + (chains[0] + chains[1]))
        m = mask[:, t, None]
        h = m * h_raw + (1.0 - m) * h
        hs[:, t] = h
    return hs


@pytest.mark.parametrize("H", [16, 20, 352])
def test_two_chain_fwd_matches_pallas_interpret(H):
    """The CUDA forward's restructured arithmetic (two mma chains, tanh from
    ex2 and a reciprocal), emulated on the CPU, against the Pallas forward in
    interpret mode at the valid steps, at a multiple of 16, at a ragged width
    and past the old limit; padded steps pass h through exactly. Both round h
    to bf16 before the product and differ in fp32 summation order and tanh
    only, so they agree to ATOL unless h straddles a bf16 rounding boundary,
    which these seeds do not hit."""
    xin, c, mask, _ = _case(H=H, seed=40 + H)
    want = np.asarray(jax_fused_rnn_scan(jnp.asarray(xin), _mask_bh(mask, H), jnp.asarray(c), True))
    hs = _two_chain_fwd(torch.from_numpy(xin), torch.from_numpy(mask), torch.from_numpy(c).to(torch.bfloat16))
    valid = mask[:, :, None] > 0
    np.testing.assert_allclose(np.where(valid, hs.numpy(), 0), np.where(valid, want, 0), atol=ATOL, rtol=0)
    for b in range(mask.shape[0]):
        n = int(mask[b].sum())
        assert torch.equal(hs[b, n:], hs[b, n - 1].expand_as(hs[b, n:]))
