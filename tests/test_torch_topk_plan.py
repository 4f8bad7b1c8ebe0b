"""The launch plan of the port's score + top-k (poi_tpu_torch.ops.topk
``topk_plan``) at every shape the card's measurements list, and the plain
version against the JAX package's Pallas kernel, run in interpret mode as
tests/test_topk.py runs it, at catalogs of a few ragged wgmma-design tiles.
The kernels themselves run only on the card (chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poi_tpu.ops.topk import fused_topk as jax_fused_topk
from poi_tpu.ops.topk import pad_table_for_topk as jax_pad_table_for_topk
from poi_tpu_torch.ops.topk import (
    SLICE_MAX_D,
    SMEM_OPT_IN,
    SMS,
    WG_MIN_TILES,
    WG_TILE,
    kernel_dim,
    list_len,
    topk_plan,
    topk_reference,
    wg_smem,
)

torch.set_num_threads(1)

# (B, V, D, k): every B11 shape of PERF.md's kernel table. Config #1 served
# (the padded 8,192 catalog, batch 256 and 1), the bench eval, bench_serve,
# config #5's eval, the wider and widest bench paths' eval and serving, D =
# 4096, config #5's and the bench's mesh shards (eval and serving), and
# config #5 served on one card.
SHAPES = [
    (256, 8192, 64, 128), (1, 8192, 64, 128), (256, 8192, 64, 10), (1, 8192, 64, 10),
    (32, 45056, 128, 10), (256, 45056, 128, 10), (256, 38912, 256, 10), (1, 71680, 256, 32), (256, 71680, 256, 32),
    (512, 905216, 512, 10), (32, 45056, 1024, 10), (32, 45056, 2048, 10), (1, 45056, 2048, 128),
    (256, 45056, 2048, 128), (256, 8192, 4096, 10), (512, 227328, 512, 10), (16, 22528, 128, 10),
    (1, 227328, 512, 64), (256, 227328, 512, 128), (1, 905216, 512, 128), (256, 905216, 512, 128),
]
# Both designs where both take the shape (the mma.sync one to D = 128): the card's
# check holds one against the other there.
DESIGNS = ("wg", "slice")


def _designs(D):
    return (None, "wg", "slice") if kernel_dim(D) <= SLICE_MAX_D else (None, "wg")

SCORE_TOL = 1e-4  # as tests/test_torch_topk.py: fp32 sums of D=32 exact products in other orders


def _plan(B, V, D, k, design=None):
    return topk_plan(B, V, kernel_dim(D), k, design)


@pytest.mark.parametrize("B,V,D,k,design", [(*s, d) for s in SHAPES for d in _designs(s[2])])
def test_slices_cover_the_catalog_in_whole_tiles(B, V, D, k, design):
    plan = _plan(B, V, D, k, design)
    ranges = plan.ranges(V)
    assert len(ranges) == plan.slices >= 1
    assert ranges[0][0] == 0 and ranges[-1][1] == V
    for (s0, e0), (s1, _) in zip(ranges, ranges[1:]):
        assert e0 == s1  # contiguous, no overlap
    for s, e in ranges:
        assert s < e and s % plan.tile == 0
        assert (e - s) % plan.tile == 0 or e == V  # whole tiles; the last ends at V


@pytest.mark.parametrize("design", (None, "wg"))
@pytest.mark.parametrize("B,V,D,k", SHAPES)
def test_grid_fills_the_card_in_whole_waves(B, V, D, k, design):
    """Row groups x slices fit one wave of one block an SM (the 144-block
    grid of config #5's eval, a second wave of 12 blocks, does not recur),
    or every row group is its own block and the waves are whole but the last."""
    plan = _plan(B, V, D, k, design)
    blocks = plan.groups(B) * plan.slices
    assert blocks <= SMS or plan.slices == 1, f"{plan}: {blocks} blocks"


@pytest.mark.parametrize("B,V,D,k", SHAPES)
def test_wg_scratch_and_smem_fit(B, V, D, k):
    plan = _plan(B, V, D, k, "wg")
    Dk = kernel_dim(D)
    assert plan.smem == wg_smem(plan.qrows, Dk, plan.unit_boxes, plan.stages, plan.resident, plan.surv_rows) <= SMEM_OPT_IN
    assert plan.stages >= 4 and 1 <= plan.unit_boxes <= max(1, -(-Dk // 64))
    assert plan.scratch(B, k) == (B, plan.slices, list_len(k))
    assert B * plan.slices * list_len(k) < 2**31  # the kernel indexes the lists with 64-bit offsets, the count as int
    # The query rows stay resident exactly where they fit beside the stages.
    assert plan.resident == (wg_smem(plan.qrows, Dk, min(2, -(-Dk // 64)), 4, True) <= SMEM_OPT_IN), plan
    # The table is read B / 128 times from B = 128 (B / 64 below); a block
    # holds 8 query rows at B <= 8.
    assert plan.rows == (128 if B > 64 else 64) and plan.qrows == (8 if B <= 8 else plan.rows)
    assert plan.surv_rows in (0, plan.qrows)
    assert plan.survivors(B) == (0 if plan.surv_rows else plan.groups(B) * plan.slices * plan.rows * 64)


@pytest.mark.parametrize("B,V,D,k", [s for s in SHAPES if s[0] == 1])
def test_batch_one_streams_on_every_sm(B, V, D, k):
    plan = _plan(B, V, D, k, "wg")
    tiles = -(-V // WG_TILE)
    if tiles >= SMS * WG_MIN_TILES:
        assert plan.slices >= SMS
    else:
        assert plan.slices == tiles // WG_MIN_TILES


def test_the_rule_sends_a_mesh_shard_and_its_catalog_to_one_design():
    """config #5 on 1 x 4 (each rank a quarter of the catalog, the whole
    batch) and the bench on 2 x 2 (half the rows, half the catalog) take the
    design the one-card call takes."""
    for whole, shard in (((512, 905216, 512, 10), (512, 227328, 512, 10)),
                         ((512, 45056, 128, 10), (256, 22528, 128, 10))):
        assert _plan(*whole).design == _plan(*shard).design


def test_plan_refuses_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="D >= 64"):
        topk_plan(4, 1024, 32, 10, "wg")
    with pytest.raises(ValueError, match="D <= 128"):
        topk_plan(4, 1024, 136, 10, "slice")
    with pytest.raises(ValueError, match="unknown design"):
        topk_plan(4, 1024, 64, 10, "other")


def _two_pass(q, table, bias, k, plan):
    """The designs' two passes in torch: each slice's sorted list of
    list_len(k) (the plain version on the slice, its -inf tail as the kernel's
    empty slots), then the k best of the lists, value desc, id asc."""
    V = table.shape[0]
    kp = list_len(k) if plan.design == "wg" else k
    vals, ids = [], []
    for s, e in plan.ranges(V):
        n = min(kp, e - s)
        v, i = topk_reference(q, table[s:e], bias[s:e], n)
        pad = kp - n
        vals.append(torch.cat([v, torch.full((q.shape[0], pad), -float("inf"))], 1))
        ids.append(torch.cat([i + s, torch.full((q.shape[0], pad), 2**31 - 1, dtype=torch.int32)], 1))
    v, i = torch.cat(vals, 1), torch.cat(ids, 1)
    order = np.lexsort((i.numpy(), -v.numpy()), axis=1)[:, :k]
    return torch.gather(v, 1, torch.from_numpy(order)), torch.gather(i, 1, torch.from_numpy(order))


def _case(B, D, V, seed, dup=False):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, D)).astype(np.float32)
    if dup:  # every row repeats: the tie order decides
        table = rng.normal(size=(16, D)).astype(np.float32)[rng.integers(0, 16, size=V)]
    else:
        table = rng.normal(size=(V, D)).astype(np.float32)
    bias = np.zeros(V, np.float32) if dup else rng.normal(size=V).astype(np.float32)
    return q, table, bias


def _exact_scores(q, table, bias):
    r = lambda a: torch.from_numpy(a).to(torch.bfloat16).double().numpy()  # noqa: E731
    return r(q) @ r(table).T + bias.astype(np.float64)


@pytest.mark.parametrize("k", [10, 128])
@pytest.mark.parametrize("B", [1, 37])
def test_reference_matches_pallas_interpret_on_ragged_wg_tiles(B, k):
    """A catalog of 5 wgmma-design tiles and 17 rows (no multiple of 64),
    padded for the TPU kernel as the eval code pads it (-1e30 rows); the
    plain version, and the two passes cut as each design's plan cuts them,
    give the TPU kernel's top-k."""
    D, V = 64, 5 * WG_TILE + 17
    q, table, bias = _case(B, D, V, seed=B * 1000 + k)
    tj, bj = jax_pad_table_for_topk(jnp.asarray(table), jnp.asarray(bias), WG_TILE)
    vals_j, ids_j = jax_fused_topk(jnp.asarray(q), tj, bj, k, tile_v=WG_TILE, interpret=True)
    vals_j, ids_j = np.asarray(vals_j), np.asarray(ids_j)
    tq, tt, tb = torch.from_numpy(q), torch.from_numpy(table), torch.from_numpy(bias)
    vals_p, ids_p = topk_reference(tq, tt, tb, k)
    exact = _exact_scores(q, table, bias)
    rows = np.arange(B)[:, None]

    def same(vals, ids):
        np.testing.assert_allclose(vals.numpy(), vals_j, atol=SCORE_TOL, rtol=0)
        ids = ids.numpy()
        bad = (ids != ids_j) & (np.abs(exact[rows, ids] - exact[rows, ids_j]) >= SCORE_TOL)
        assert not bad.any()
        assert ids.max() < V

    same(vals_p, ids_p)
    for design in DESIGNS:
        plan = topk_plan(B, V, D, k, design)
        v2, i2 = _two_pass(tq, tt, tb, k, plan)
        same(v2, i2)
        assert torch.equal(v2, vals_p) and torch.equal(i2, ids_p)  # the slicing moves no bit


@pytest.mark.parametrize("k", [10, 128])
def test_two_pass_tie_order_matches_pallas_interpret_exactly(k):
    """Duplicated rows across the slices of both plans: equal scores come out
    lower id first, as the TPU kernel orders them."""
    B, D, V = 3, 64, 6 * WG_TILE + 40
    q, table, bias = _case(B, D, V, seed=k, dup=True)
    tj, bj = jax_pad_table_for_topk(jnp.asarray(table), jnp.asarray(bias), WG_TILE)
    _, ids_j = jax_fused_topk(jnp.asarray(q), tj, bj, k, tile_v=WG_TILE, interpret=True)
    tq, tt, tb = torch.from_numpy(q), torch.from_numpy(table), torch.from_numpy(bias)
    for design in DESIGNS:
        _, ids = _two_pass(tq, tt, tb, k, topk_plan(B, V, D, k, design))
        np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_j))
