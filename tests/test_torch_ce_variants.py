"""The CE forward's tuning variants (B12): the port's plain versions held
against ``scripts/sweep_ce_fwd.py``'s Pallas kernels in interpret mode.

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
                                        ce_lse_nomax_reference, ce_lse_reference, ce_lse_variant)

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
    assert VARIANTS == ("base", "exp2", "nomax") and ROWS == (64, 128)
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
