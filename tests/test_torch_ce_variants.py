"""The CE forward's tuning variants (B12): the port's plain versions, and
the arithmetic of ``csrc/ce.cu``'s kernel written out in torch, held against
``scripts/sweep_ce_fwd.py``'s Pallas kernels in interpret mode.

The JAX script is loaded from its path as it stands. Its module-level shape
(``N, V, D``) is set small, and the loaded module's ``pl`` is replaced by a
namespace whose ``pallas_call`` runs in interpret mode; nothing in the file
changes. On the CPU ``ce_lse_variant`` takes the same plain versions; the
CUDA kernels are compared with them on the card by ``chip_smoke.py``."""

import functools
import importlib.util
import os
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from poi_tpu_torch.ops.fused_ce import (LOG2E, ROWS, VARIANT_REFERENCES, VARIANTS, ce_lse, ce_lse_exp2_reference,
                                        ce_lse_nomax_reference, ce_lse_reference, ce_lse_variant, lse_merge_reference,
                                        lse_partials_reference)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Both sides round q (exp2: q · log2(e)) and the table to bf16 at the same
# points and sum in fp32 in different orders (lse ~ 7 here: ulps of 5e-7).
ATOL = 2e-5


@functools.cache
def _sweep_module():
    """``scripts/sweep_ce_fwd.py`` loaded from its path, its ``pallas_call``
    in interpret mode. No bytecode is written into ``scripts/``."""
    path = os.path.join(REPO, "scripts", "sweep_ce_fwd.py")
    spec = importlib.util.spec_from_file_location("_sweep_ce_fwd_ref", path)
    mod = importlib.util.module_from_spec(spec)
    saved = sys.dont_write_bytecode
    sys.dont_write_bytecode = True
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.dont_write_bytecode = saved
    ns = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl) if not k.startswith("__")})
    ns.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    mod.pl = ns
    return mod


def _case(N, V, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(N, D)).astype(np.float32)
    table = (0.1 * rng.normal(size=(V, D))).astype(np.float32)
    bias = (0.5 * rng.normal(size=(V,))).astype(np.float32)
    return q, table, bias


def _jax_lse(kind, q, table, bias, rb, cv):
    mod = _sweep_module()
    mod.N, mod.V, mod.D = q.shape[0], table.shape[0], q.shape[1]
    call, vp = mod.build(kind, rb, cv)
    tc, bc, _, _ = mod.fc._chunk(jnp.asarray(table), jnp.asarray(bias), cv)
    return np.asarray(call(jnp.asarray(q), tc.reshape(-1, q.shape[1]).astype(jnp.bfloat16), bc.reshape(1, vp)))


# V = 700 is ragged against the chunk of 256: the JAX side pads the catalog
# to 768 with -1e30 bias rows. The port takes V as is, and the padded
# catalog too.
@pytest.mark.parametrize("D", [32, 128])
@pytest.mark.parametrize("kind, reference", [("base", ce_lse_reference), ("exp2", ce_lse_exp2_reference),
                                             ("nomax", ce_lse_nomax_reference)])
def test_plain_variant_matches_the_sweeps_kernel(kind, reference, D):
    q, table, bias = _case(64, 700, D, seed=D)
    want = _jax_lse(kind, q, table, bias, rb=32, cv=256)
    got = reference(*(torch.from_numpy(a) for a in (q, table, bias)), chunk=300)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    table_p = np.concatenate([table, np.full((68, D), 0.5, np.float32)])
    bias_p = np.concatenate([bias, np.full(68, -1e30, np.float32)])
    padded = reference(*(torch.from_numpy(a) for a in (q, table_p, bias_p)), chunk=256)
    np.testing.assert_allclose(padded.numpy(), want, atol=ATOL, rtol=0)


TILE = 64  # catalog rows a streamed tile of the kernel (kLseStr, the wgmma's N)
LOG2E_F32 = float(np.float32(LOG2E))
LN2_F32 = float(np.float32(np.log(2.0)))


def _ranges(V, S):
    """The catalog ranges a launch with S ranges cuts (fill_splits in
    csrc/wgmma_tiles.cuh): whole 64-row tiles, at most S ranges, none empty."""
    tiles = -(-V // TILE)
    per = -(-tiles // min(S, tiles))
    return [(t0 * TILE, min(V, (t0 + per) * TILE)) for t0 in range(0, tiles, per)]


def _kernel_lse(variant, q, table, bias, S):
    """``ce_lse_wg_kernel``'s arithmetic for ``variant`` in torch (exact
    ``exp2`` for the kernel's ``ex2.approx``): the four threads of a row's
    quad each hold columns 8j + 2t + e of a 64-column tile and two sums (e);
    each logit goes to base 2 (base and nomax: one FMA with the bias scaled
    by log2(e); exp2: q and bias arrive scaled, an add), ragged columns are
    -inf; base and exp2 keep a running max from -3e38 and rescale the sum,
    nomax keeps its max at 0; the quad merges by shuffles (t ^ 1, then t ^
    2); each catalog range writes its partial (max, sum) and the ranges merge
    in order, ``(M + log2(sum_s l_s 2^(m_s - M))) ln 2``."""
    scale = np.float32(LOG2E) if variant == "exp2" else np.float32(1.0)
    qb = torch.from_numpy(q * scale).to(torch.bfloat16).float()
    tb = torch.from_numpy(table).to(torch.bfloat16).float()
    b = torch.from_numpy(bias * scale)
    N, V = q.shape[0], table.shape[0]
    ms, ls = [], []
    for v0, v1 in _ranges(V, S):
        m = torch.full((N, 4), 0.0 if variant == "nomax" else -3.0e38)
        l = torch.zeros(N, 4)
        for c0 in range(v0, v1, TILE):
            cols = torch.arange(c0, c0 + TILE)
            ok = cols < V
            x = qb @ tb[cols.clamp(max=V - 1)].T
            bb = b[cols.clamp(max=V - 1)]
            if variant == "exp2":
                t = x + bb
            else:  # fmaf: the product exact in fp64, one rounding to fp32
                t = (x.double() * LOG2E_F32 + (bb * LOG2E_F32).double()).float()
            t = torch.where(ok, t, float("-inf")).view(N, 8, 4, 2)  # [row, j, thread t, e]
            if variant == "nomax":
                mn, acc0 = m, l
            else:
                mn = torch.maximum(m, t.amax(dim=(1, 3)))
                acc0 = l * torch.exp2(m - mn)
            e2 = torch.exp2(t - mn[:, None, :, None])
            acc1 = torch.zeros_like(l)
            for j in range(8):
                acc0, acc1 = acc0 + e2[:, j, :, 0], acc1 + e2[:, j, :, 1]
            m, l = mn, acc0 + acc1
        for off in (1, 2):
            other = torch.arange(4) ^ off
            lo, mo = l[:, other], m[:, other]
            if variant == "nomax":
                l = l + lo
            else:
                mn = torch.maximum(m, mo)
                m, l = mn, l * torch.exp2(m - mn) + lo * torch.exp2(mo - mn)
        ms.append(m[:, 0])
        ls.append(l[:, 0])
    M = torch.stack(ms).max(dim=0).values
    L = torch.zeros(N)
    for m_s, l_s in zip(ms, ls):
        L = L + l_s * torch.exp2(m_s - M)
    return (M + torch.log2(L)) * LN2_F32


# V = 700 is ragged against the 64-row tile (the last of 60 columns); with
# S = 3 the ranges are 256, 256 and 188 columns, and the last lies wholly in
# the -1e30 tail past POI 500.
@pytest.mark.parametrize("D", [32, 128])
@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("variant", VARIANTS)
def test_kernel_arithmetic_matches_the_sweeps_kernel(variant, S, D):
    q, table, bias = _case(64, 700, D, seed=10 * D + S)
    bias[500:] = -1e30
    bounds = _ranges(700, S)
    assert len(bounds) == S and (S == 1 or bounds[-1][0] >= 500)
    got = _kernel_lse(variant, q, table, bias, S)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), _jax_lse(variant, q, table, bias, rb=32, cv=256), atol=ATOL, rtol=0)
    args = [torch.from_numpy(a) for a in (q, table, bias)]
    torch.testing.assert_close(got, VARIANT_REFERENCES[variant](*args), atol=ATOL, rtol=0)
    m, l = lse_partials_reference(*args, bounds, variant)
    if variant == "nomax":
        assert bool((m == 0).all())
    elif S > 1:
        assert bool((m[-1] < -1e29).all())  # the tail range's max is the -1e30 bias
    torch.testing.assert_close(lse_merge_reference(m, l, variant), got, atol=ATOL, rtol=0)


def test_exp2_carries_the_rounding_of_the_scaled_query():
    """exp2's plain version is not the exact LSE: it rounds q · log2(e) to
    bf16, as the sweep's exp2 kernel does, and so differs from base by more
    than the tolerance; a query that is exact in bf16 after scaling (0)
    gives the same LSE."""
    q, table, bias = (torch.from_numpy(a) for a in _case(64, 700, 32, seed=3))
    base, exp2 = ce_lse_reference(q, table, bias), ce_lse_exp2_reference(q, table, bias)
    assert float((base - exp2).abs().max()) > 10 * ATOL
    zero = torch.zeros_like(q)
    torch.testing.assert_close(ce_lse_exp2_reference(zero, table, bias), ce_lse_reference(zero, table, bias),
                               rtol=0, atol=1e-5)
    assert LOG2E == pytest.approx(np.log2(np.e), rel=1e-15)


def test_wrapper_takes_the_plain_versions_on_the_cpu():
    q, table, bias = (torch.from_numpy(a) for a in _case(10, 77, 32, seed=5))
    bias[70:] = -1e30  # a padded catalog tail
    assert VARIANTS == ("base", "exp2", "nomax") and ROWS == (128, 256)
    for variant in VARIANTS:
        want = VARIANT_REFERENCES[variant](q, table, bias)
        for rows in ROWS:
            assert torch.equal(ce_lse_variant(q, table, bias, variant, rows), want)
    assert torch.equal(ce_lse_variant(q, table, bias), ce_lse(q, table, bias))
    assert ce_lse_variant.launches == 0
    with pytest.raises(ValueError, match="variant in"):
        ce_lse_variant(q, table, bias, "exp3")
    with pytest.raises(ValueError, match="rows in"):
        ce_lse_variant(q, table, bias, "base", 96)


def test_nomax_overflows_where_base_does_not():
    """The documented hazard: with a logit past ~88 the sum without a
    running max overflows fp32."""
    q = torch.zeros(2, 32)
    table = torch.zeros(5, 32)
    bias = torch.tensor([0.0, 1.0, 95.0, 2.0, 3.0])
    assert torch.isfinite(ce_lse_reference(q, table, bias)).all()
    assert torch.isinf(ce_lse_nomax_reference(q, table, bias)).all()
