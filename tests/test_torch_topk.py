"""The port's score + top-k (poi_tpu_torch.ops.topk) held against the JAX
package's Pallas kernel, run in interpret mode as tests/test_topk.py runs it.
The port's CPU path is the kernel's plain PyTorch version; the CUDA kernel is
compared with it on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poi_tpu.ops.topk import NEG as JAX_NEG
from poi_tpu.ops.topk import fused_topk as jax_fused_topk
from poi_tpu.ops.topk import pad_table_for_topk as jax_pad_table_for_topk
from poi_tpu_torch.ops.topk import NEG, fused_topk, pad_table_for_topk, topk_reference

torch.set_num_threads(1)

# Both sides score bf16-rounded operands (exact products) with fp32 sums in
# different orders: over D=32 terms of magnitude <= ~10 the sums differ by a
# few fp32 ulps of the total, far below 1e-4.
SCORE_TOL = 1e-4


def _case(B, D, V, seed):
    rng = np.random.default_rng(seed)
    return (
        rng.normal(size=(B, D)).astype(np.float32),
        rng.normal(size=(V, D)).astype(np.float32),
        rng.normal(size=V).astype(np.float32),
    )


def _exact_scores(q, table, bias):
    """fp64 scores of the bf16-rounded operands (the contract's products)."""
    r = lambda a: torch.from_numpy(a).to(torch.bfloat16).double().numpy()  # noqa: E731
    return r(q) @ r(table).T + bias.astype(np.float64)


def assert_same_topk(ids_a, ids_b, scores, tol):
    """Ids equal, except where the two swapped candidates whose scores differ
    by less than ``tol``."""
    ids_a, ids_b = np.asarray(ids_a), np.asarray(ids_b)
    assert ids_a.shape == ids_b.shape
    rows = np.arange(len(scores))[:, None]
    diff = np.abs(scores[rows, ids_a] - scores[rows, ids_b])
    bad = (ids_a != ids_b) & (diff >= tol)
    assert not bad.any(), f"{bad.sum()} id mismatches beyond near-ties, first at {np.argwhere(bad)[0]}"


def test_neg_matches_jax():
    assert NEG == JAX_NEG


@pytest.mark.parametrize("k", [10, 128])
def test_topk_reference_matches_pallas_interpret(k):
    q, table, bias = _case(B=8, D=32, V=2048, seed=k)
    vals_j, ids_j = jax_fused_topk(jnp.asarray(q), jnp.asarray(table), jnp.asarray(bias), k,
                                   tile_v=512, interpret=True)
    vals_p, ids_p = topk_reference(torch.from_numpy(q), torch.from_numpy(table), torch.from_numpy(bias), k)
    assert vals_p.dtype == torch.float32 and ids_p.dtype == torch.int32
    assert tuple(ids_p.shape) == (8, k)
    np.testing.assert_allclose(vals_p.numpy(), np.asarray(vals_j), atol=SCORE_TOL, rtol=0)
    assert_same_topk(ids_p.numpy(), np.asarray(ids_j), _exact_scores(q, table, bias), SCORE_TOL)
    # Values come out descending.
    assert (np.diff(vals_p.numpy(), axis=1) <= 0).all()


@pytest.mark.parametrize("k", [6, 40])
def test_tie_order_matches_pallas_interpret_exactly(k):
    """Duplicated rows spread across vocab tiles: equal scores must come out
    lower id first, exactly as the TPU kernel orders them."""
    rng = np.random.default_rng(1)
    B, D, V = 4, 8, 2048
    q = rng.normal(size=(B, D)).astype(np.float32)
    base = rng.normal(size=(16, D)).astype(np.float32)
    table = base[rng.integers(0, 16, size=V)]  # every row repeats ~128 times
    bias = np.zeros(V, np.float32)
    _, ids_j = jax_fused_topk(jnp.asarray(q), jnp.asarray(table), jnp.asarray(bias), k,
                              tile_v=512, interpret=True)
    _, ids_p = fused_topk(torch.from_numpy(q), torch.from_numpy(table), torch.from_numpy(bias), k)
    np.testing.assert_array_equal(ids_p.numpy(), np.asarray(ids_j))


def test_all_equal_scores_give_lowest_ids():
    B, D, V, k = 4, 8, 512, 6
    _, ids = fused_topk(torch.ones(B, D), torch.zeros(V, D), torch.zeros(V), k)
    np.testing.assert_array_equal(ids.numpy(), np.tile(np.arange(k), (B, 1)))


def test_pad_table_for_topk_matches_jax():
    _, table, bias = _case(B=1, D=16, V=1000, seed=2)
    tj, bj = jax_pad_table_for_topk(jnp.asarray(table), jnp.asarray(bias), 512)
    tp, bp = pad_table_for_topk(torch.from_numpy(table), torch.from_numpy(bias), 512)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(tj))
    np.testing.assert_array_equal(bp.numpy(), np.asarray(bj))
    same_t, same_b = pad_table_for_topk(tp, bp, 512)  # already a multiple: unchanged
    assert same_t is tp and same_b is bp


def test_padded_rows_never_win():
    q, table, bias = _case(B=4, D=16, V=1000, seed=4)
    tp, bp = pad_table_for_topk(torch.from_numpy(table), torch.from_numpy(bias), 512)
    _, ids = fused_topk(torch.from_numpy(q), tp, bp, 128)
    assert int(ids.max()) < 1000


def test_k_above_128_raises():
    q, table, bias = _case(B=2, D=8, V=512, seed=0)
    with pytest.raises(ValueError, match="k=129"):
        fused_topk(torch.from_numpy(q), torch.from_numpy(table), torch.from_numpy(bias), 129)
