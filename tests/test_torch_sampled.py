"""The port's sampled softmax (poi_tpu_torch.ops.fused_sampled and
train.losses) held against the JAX package on the same numpy inputs and the
same negative pool ids.

The JAX side runs the Pallas kernels in interpret mode
(fused_sampled_softmax_loss(..., interpret=True), sampled_nll_rows(...,
True)), as tests/test_fused_sampled.py does, and the XLA sampled_softmax_loss.
On the CPU the port's fused path runs the kernels' plain versions; the CUDA
kernels are compared with those plain versions on the card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poi_tpu.ops.fused_sampled import fused_sampled_softmax_loss as jax_fused_loss
from poi_tpu.ops.fused_sampled import sampled_nll_rows as jax_sampled_nll_rows
from poi_tpu.train.losses import sampled_softmax_loss as jax_sampled_loss
from poi_tpu_torch.ops.fused_sampled import (
    NEG,
    fused_sampled_softmax_loss,
    sampled_bwd,
    sampled_bwd_reference,
    sampled_lse,
    sampled_lse_reference,
    sampled_nll_rows,
)
from poi_tpu_torch.ops import fused_sampled
from poi_tpu_torch.ops.widths import padded_dim
from poi_tpu_torch.train.losses import build_loss_fn, draw_sampled_negatives, sampled_softmax_loss
from poi_tpu_torch.utils.config import LossConfig

torch.set_num_threads(1)

# Port and Pallas kernel share the rounding points (bf16 q and pool rows in
# the logits and bf16 gp in the products, fp32 elsewhere); they differ in
# fp32 summation order and in exp: ~1e-7 relative to each tensor's largest
# element here.
REL_TOL = 1e-5
# The plain path against the XLA path: both autodiffs round dq and the table
# cotangent to bf16 at the logits' operands, and an fp32 order difference can
# move one element across a rounding boundary (2^-8 of the tensor's scale).
BF16_REL = 2 ** -8
# The fused path against the XLA path (tests/test_fused_sampled.py:47).
XLA_ATOL, XLA_RTOL = 3e-3, 2e-2


def _case(B=2, T=8, D=128, V=300, S=256, seed=0):
    """Small V makes accidental hits and duplicate pool ids certain."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, T, D)).astype(np.float32)
    table = (rng.normal(size=(V, D)) * 0.3).astype(np.float32)
    bias = (rng.normal(size=(V,)) * 0.1).astype(np.float32)
    targets = rng.integers(0, V, size=(B, T)).astype(np.int32)
    mask = (rng.random((B, T)) < 0.8).astype(np.float32)
    key = jax.random.key(seed + 7)
    neg = np.array(jax.random.randint(key, (S,), 0, V))  # poi_tpu's draw, replayed in the port
    return q, table, bias, targets, mask, key, neg


def _port(loss_fn, q, table, bias, targets, mask, neg, S, V):
    args = [torch.from_numpy(a).requires_grad_() for a in (q, table, bias)]
    loss = loss_fn(*args, torch.from_numpy(targets).long(), torch.from_numpy(mask), torch.from_numpy(neg).long(),
                   S, V)
    loss.backward()
    return float(loss.detach()), [a.grad.numpy() for a in args]


def _jax(loss_fn, q, table, bias):
    val, grads = jax.value_and_grad(loss_fn, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(table),
                                                                jnp.asarray(bias))
    return float(val), [np.asarray(g) for g in grads]


def _close(got, want, tol, name):
    scale = np.abs(want).max() + 1e-12
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=0, err_msg=name)


@pytest.mark.parametrize("num_sampled", [256, 200])  # 200: no multiple of the kernels' tiles
def test_sampled_loss_matches_pallas_interpret_and_xla(num_sampled):
    q, table, bias, targets, mask, key, neg = _case(S=num_sampled)
    V = table.shape[0]
    assert (neg[None, None, :] == targets[..., None]).any(), "the case needs accidental hits"
    assert len(np.unique(neg)) < len(neg), "the case needs duplicate pool ids"
    jt, jm = jnp.asarray(targets), jnp.asarray(mask)
    want_f, g_pal = _jax(lambda *a: jax_fused_loss(*a, jt, jm, key, num_sampled, V, interpret=True), q, table, bias)
    want_x, g_xla = _jax(lambda *a: jax_sampled_loss(*a, jt, jm, key, num_sampled, V), q, table, bias)

    got_f, g_fused = _port(fused_sampled_softmax_loss, q, table, bias, targets, mask, neg, num_sampled, V)
    assert abs(got_f - want_f) <= REL_TOL * abs(want_f)
    for a, b, name in zip(g_fused, g_pal, ("dq", "dtable", "dbias")):
        _close(a, b, REL_TOL, name)
    for a, b, name in zip(g_fused, g_xla, ("dq", "dtable", "dbias")):
        np.testing.assert_allclose(a, b, atol=XLA_ATOL, rtol=XLA_RTOL, err_msg=name)

    got_x, g_plain = _port(sampled_softmax_loss, q, table, bias, targets, mask, neg, num_sampled, V)
    assert abs(got_x - want_x) <= REL_TOL * abs(want_x)
    for a, b, name in zip(g_plain, g_xla, ("dq", "dtable", "dbias")):
        _close(a, b, BF16_REL, name)


@pytest.mark.parametrize("num_sampled", [256, 200])  # 200: a ragged pool
def test_d512_loss_matches_pallas_interpret_and_xla(num_sampled):
    """Config #5's width, D = 512, at N = 64 rows: the port's fused path
    (sampled_lse / sampled_bwd's plain versions inside sampled_nll_rows)
    against poi_tpu's Pallas kernels in interpret mode, and its plain path
    against poi_tpu's XLA sampled_softmax_loss, at the tolerances of the
    D = 128 test above."""
    q, table, bias, targets, mask, key, neg = _case(B=4, T=16, D=512, S=num_sampled)
    V = table.shape[0]
    jt, jm = jnp.asarray(targets), jnp.asarray(mask)
    want_f, g_pal = _jax(lambda *a: jax_fused_loss(*a, jt, jm, key, num_sampled, V, interpret=True), q, table, bias)
    want_x, g_xla = _jax(lambda *a: jax_sampled_loss(*a, jt, jm, key, num_sampled, V), q, table, bias)
    got_f, g_fused = _port(fused_sampled_softmax_loss, q, table, bias, targets, mask, neg, num_sampled, V)
    assert abs(got_f - want_f) <= REL_TOL * abs(want_f)
    for a, b, name in zip(g_fused, g_pal, ("dq", "dtable", "dbias")):
        _close(a, b, REL_TOL, name)
    got_x, g_plain = _port(sampled_softmax_loss, q, table, bias, targets, mask, neg, num_sampled, V)
    assert abs(got_x - want_x) <= REL_TOL * abs(want_x)
    for a, b, name in zip(g_plain, g_xla, ("dq", "dtable", "dbias")):
        _close(a, b, BF16_REL, name)


def test_kernel_widths_take_d512_and_refuse_others():
    """The wrappers' width dispatch (on CUDA tensors, before any launch): the
    kernels take D = 512, config #5's, and 768 and 1024; a width they are
    not built for is padded to the next one they are, up to 1024; past 1024
    (refused before the streamed kernels; the name keeps that) ``kernel_dim``
    pads to the next multiple of 256, and the list alone (``padded_dim``
    without ``chunked``) still refuses, naming the limit."""
    assert fused_sampled.KERNEL_DIMS == (64, 128, 256, 512, 768, 1024)
    assert padded_dim(512, fused_sampled.KERNEL_DIMS, "sampled_lse") == 512
    assert [padded_dim(d, fused_sampled.KERNEL_DIMS, "sampled_lse") for d in (1, 64, 96, 200, 384, 511, 513, 640,
                                                                               768, 769, 1024)] == \
        [64, 64, 128, 256, 512, 512, 768, 768, 768, 1024, 1024]
    assert [fused_sampled.kernel_dim(d) for d in (1, 384, 1024, 1025, 1100, 2048, 2049)] == \
        [64, 512, 1024, 1280, 1280, 2048, 2304]
    with pytest.raises(ValueError, match="D <= 1024.*D=1025"):
        padded_dim(1025, fused_sampled.KERNEL_DIMS, "sampled_lse")


@pytest.mark.parametrize("D", [64, 128, 256, 512])  # the widths the CUDA kernels take
def test_sampled_nll_rows_gradients_match_pallas_interpret(D):
    """All four cotangents of the custom VJP, s_pos's included, on a pool
    padded by neither side (S=200)."""
    rng = np.random.default_rng(3)
    N, S = 24, 200
    q = rng.normal(size=(N, D)).astype(np.float32)
    e_neg = (rng.normal(size=(S, D)) * 0.3).astype(np.float32)
    b_neg = (rng.normal(size=S) * 0.1 + 1.3).astype(np.float32)
    s_pos = rng.normal(size=N).astype(np.float32)
    targets = rng.integers(0, 40, N).astype(np.int32)
    ids = rng.integers(0, 40, S).astype(np.int32)
    w = rng.random(N).astype(np.float32)  # a cotangent that differs per row

    def jax_fn(q, e, b, s):
        return jnp.sum(jax_sampled_nll_rows(q, e, b, s, (jnp.asarray(targets), jnp.asarray(ids)), True) * w)

    want, g_pal = jax.value_and_grad(jax_fn, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (q, e_neg, b_neg, s_pos)))
    args = [torch.from_numpy(a).requires_grad_() for a in (q, e_neg, b_neg, s_pos)]
    got = (sampled_nll_rows(*args, torch.from_numpy(targets), torch.from_numpy(ids)) * torch.from_numpy(w)).sum()
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= REL_TOL * abs(float(want))
    for a, b, name in zip(args, g_pal, ("dq", "de_neg", "db_neg", "ds_pos")):
        _close(a.grad.numpy(), np.asarray(b), REL_TOL, name)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _ranges(n, splits, tile=64):
    """The CUDA backward's split rule for a forced count: the streamed rows'
    tiles cut into ranges of ceil(tiles / splits) tiles, every range
    non-empty (csrc/sampled.cu pass_splits)."""
    tiles = -(-n // tile)
    per = -(-tiles // min(splits, tiles))
    return [(t0 * tile, min(n, (t0 + per) * tile)) for t0 in range(0, tiles, per)]


def _b10_passes(q, e, b, ids, tgt, lse, g, dq_splits, de_splits, tile=64):
    """csrc/sampled.cu's backward written in plain torch: the dq pass (every
    row against the pool, the pool's tiles cut into dq_splits ranges, each a
    partial sum added tile by tile, the partials added in range order) and
    the dE/db pass (every pool row against the queries, cut into de_splits
    ranges the same way), gp recomputed in each, 0 on a hit, rounded to bf16
    for the products and summed unrounded into db."""
    qb, eb = _bf16(q), _bf16(e)

    def gp(r0, r1, c0, c1):
        z = qb[r0:r1] @ eb[c0:c1].T + b[c0:c1]
        out = torch.exp(z - lse[r0:r1, None]) * g[r0:r1, None]
        return torch.where(ids[None, c0:c1] == tgt[r0:r1, None], 0.0, out)

    N, S = q.shape[0], e.shape[0]
    parts = []
    for s0, s1 in _ranges(S, dq_splits, tile):
        acc = torch.zeros_like(q)
        for c0 in range(s0, s1, tile):
            acc += _bf16(gp(0, N, c0, min(s1, c0 + tile))) @ eb[c0:c0 + tile][: min(s1, c0 + tile) - c0]
        parts.append(acc)
    dq = sum(parts[1:], parts[0])
    de_parts, db_parts = [], []
    for n0, n1 in _ranges(N, de_splits, tile):
        acc, dacc = torch.zeros_like(e), torch.zeros(S)
        for r0 in range(n0, n1, tile):
            r1 = min(n1, r0 + tile)
            x = gp(r0, r1, 0, S)
            acc += _bf16(x).T @ qb[r0:r1]
            dacc += x.sum(dim=0)
        de_parts.append(acc)
        db_parts.append(dacc)
    return dq, sum(de_parts[1:], de_parts[0]), sum(db_parts[1:], db_parts[0])


@pytest.mark.parametrize("dq_splits, de_splits", [(1, 1), (2, 4), (3, 5)])
def test_b10_pass_structure_matches_pallas_vjp(dq_splits, de_splits):
    """The CUDA backward's two passes (pool ranges for dq, query ranges for
    dE and db, partials added in range order, hits masked) held against
    jax.vjp of poi_tpu's sampled_nll_rows in interpret mode at config #4's
    D = 256, on a pool (300) and a row count (330) that are no multiple of
    the 64-row tile and split counts that divide neither."""
    rng = np.random.default_rng(11)
    N, S, D = 330, 300, 256
    q = (rng.normal(size=(N, D)) * 0.3).astype(np.float32)
    e_neg = (rng.normal(size=(S, D)) * 0.3).astype(np.float32)
    b_neg = (rng.normal(size=S) * 0.1 + 1.3).astype(np.float32)
    s_pos = rng.normal(size=N).astype(np.float32)
    targets = rng.integers(0, 60, N).astype(np.int32)
    ids = rng.integers(0, 60, S).astype(np.int32)
    w = rng.random(N).astype(np.float32)
    assert (ids[None, :] == targets[:, None]).sum() > 100, "the case needs many hits"

    _, vjp = jax.vjp(lambda q, e, b: jax_sampled_nll_rows(q, e, b, jnp.asarray(s_pos),
                                                          (jnp.asarray(targets), jnp.asarray(ids)), True),
                     *map(jnp.asarray, (q, e_neg, b_neg)))
    want = vjp(jnp.asarray(w))
    t = [torch.from_numpy(a) for a in (q, e_neg, b_neg, ids, targets, s_pos, w)]
    lse_tot = torch.logaddexp(sampled_lse_reference(*t[:5]), t[5])
    got = _b10_passes(*t[:5], lse_tot, t[6], dq_splits, de_splits)
    for a, b, name in zip(got, want, ("dq", "de_neg", "db_neg")):
        _close(a.numpy(), np.asarray(b), REL_TOL, name)
    # And the plain version, which takes the whole [N, S] product at once:
    # fp32 summation order only.
    whole = sampled_bwd_reference(*t[:5], lse_tot, t[6])
    for a, b, name in zip(got, whole, ("dq", "de_neg", "db_neg")):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7, msg=name)


@pytest.mark.parametrize("fused", [True, False])
def test_gradient_reaches_only_the_pool_and_the_targets(fused):
    """dtable is zero outside pool ∪ targets, exactly (the set lazy Adam
    updates), and so is dbias."""
    q, table, bias, targets, mask, _, neg = _case(B=1, T=4, V=1000, S=128, seed=5)
    fn = fused_sampled_softmax_loss if fused else sampled_softmax_loss
    _, (_, dt, db) = _port(fn, q, table, bias, targets, mask, neg, 128, 1000)
    touched = set(neg.tolist()) | set(targets.reshape(-1).tolist())
    untouched = np.setdiff1d(np.arange(1000), sorted(touched))
    assert np.abs(dt[untouched]).max() == 0.0 and np.abs(db[untouched]).max() == 0.0
    assert np.abs(dt).sum(axis=1).astype(bool).sum() > 0


def test_padded_pool_entries_change_nothing():
    """Pool entries with a -1e30 bias (the TPU kernel's padding) leave the
    LSE unchanged and get exactly zero gradient."""
    rng = np.random.default_rng(8)
    q = torch.from_numpy(rng.normal(size=(10, 64)).astype(np.float32))
    e = torch.from_numpy(rng.normal(size=(30, 64)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=30).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 50, 30))
    tgt = torch.from_numpy(rng.integers(0, 50, 10))
    e_p = torch.cat([e, torch.ones(6, 64)])
    b_p = torch.cat([b, torch.full((6,), NEG)])
    ids_p = torch.cat([ids, torch.full((6,), -1)])
    lse = sampled_lse_reference(q, e, b, ids, tgt)
    torch.testing.assert_close(sampled_lse_reference(q, e_p, b_p, ids_p, tgt), lse, rtol=0, atol=0)
    g = torch.linspace(0.1, 1.0, 10)
    dq, de, db = sampled_bwd_reference(q, e_p, b_p, ids_p, tgt, lse + 0.5, g)
    assert (de[30:] == 0).all() and (db[30:] == 0).all()
    for a, w in zip((dq, de[:30], db[:30]), sampled_bwd_reference(q, e, b, ids, tgt, lse + 0.5, g)):
        torch.testing.assert_close(a, w, rtol=1e-6, atol=1e-7)  # the products' summation order only


def test_hit_columns_get_zero_gradient_and_wrappers_take_the_plain_versions_on_cpu():
    rng = np.random.default_rng(9)
    q = torch.from_numpy(rng.normal(size=(12, 64)).astype(np.float32))
    e = torch.from_numpy(rng.normal(size=(20, 64)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=20).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 100, 20))
    tgt = torch.full((12,), 7)
    ids[[2, 11]] = 7  # a hit for every row
    lse = sampled_lse(q, e, b, ids, tgt)
    assert torch.equal(lse, sampled_lse_reference(q, e, b, ids, tgt))
    g = torch.rand(12, generator=torch.Generator().manual_seed(0))
    got = sampled_bwd(q, e, b, ids, tgt, lse, g)
    for a, w in zip(got, sampled_bwd_reference(q, e, b, ids, tgt, lse, g)):
        assert torch.equal(a, w)
    assert (got[1][[2, 11]] == 0).all() and (got[2][[2, 11]] == 0).all()
    assert sampled_lse.launches == 0 and sampled_bwd.launches == 0  # CPU tensors launch nothing


@pytest.mark.parametrize("num_sampled, embed_dim, impl, fused", [
    (1024, 256, "auto", True),  # config #4
    (4096, 512, "auto", True),  # config #5
    (64, 256, "auto", False),  # S < 128
    (1024, 64, "auto", False),  # D % 128 != 0
    (64, 64, "fused", True),
    (1024, 256, "xla", False),
    (1024, None, "auto", True),
])
def test_build_loss_fn_dispatch_matches_the_tpu_package(num_sampled, embed_dim, impl, fused):
    fn = build_loss_fn(LossConfig(kind="sampled_softmax", num_sampled=num_sampled, impl=impl), 5000, embed_dim)
    assert fn.func is (fused_sampled_softmax_loss if fused else sampled_softmax_loss)
    assert fn.keywords == {"num_sampled": num_sampled, "num_pois": 5000}


def test_draw_sampled_negatives_is_keyed_by_its_generator():
    def draw(seed):
        return draw_sampled_negatives(torch.Generator().manual_seed(seed), 1024, 300, "cpu")

    a, b, c = draw(1), draw(1), draw(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (1024,) and a.dtype == torch.int64 and 0 <= int(a.min()) and int(a.max()) < 300


LOG2E = np.float32(1.4426950408889634)
LN2 = np.float32(0.6931471805599453)


def _b9_lse(q, e, b, ids, tgt, splits, tile=64):
    """csrc/sampled.cu's pool LSE written in plain torch: the pool's tiles
    cut into ``splits`` ranges (csrc/sampled.cu lse_splits, the same rule
    as _ranges), each range folded tile by tile into a running base-2 max
    (starting at -3e38, finite) and sum of every row, a logit t = z log2(e)
    with the bias scaled alike, a hit replaced by -1e30 in base 2; then the
    ranges' (max, sum) pairs merged in range order:
    lse = (M + log2(sum_s l_s 2^(m_s - M))) ln 2."""
    qb, eb = _bf16(q), _bf16(e)
    hit2 = torch.tensor(NEG, dtype=torch.float32) * LOG2E
    N, S = q.shape[0], e.shape[0]
    parts = []
    for s0, s1 in _ranges(S, splits, tile):
        m, l = torch.full((N,), -3.0e38), torch.zeros(N)
        for c0 in range(s0, s1, tile):
            c1 = min(s1, c0 + tile)
            t = (qb @ eb[c0:c1].T) * LOG2E + b[c0:c1] * LOG2E
            t = torch.where(ids[None, c0:c1] == tgt[:, None], hit2, t)
            mn = torch.maximum(m, t.max(dim=1).values)
            l = l * torch.exp2(m - mn) + torch.exp2(t - mn[:, None]).sum(dim=1)
            m = mn
        parts.append((m, l))
    M = parts[0][0]
    for m, _ in parts[1:]:
        M = torch.maximum(M, m)
    L = torch.zeros(N)
    for m, l in parts:
        L = L + l * torch.exp2(m - M)
    return (M + torch.log2(L)) * LN2


@pytest.mark.parametrize("splits", [1, 4, 5])
@pytest.mark.parametrize("hits", ["mixed", "all"])
def test_b9_range_structure_matches_pallas_forward(splits, hits):
    """The CUDA pool LSE's structure (64-row tiles folded in base 2, pool
    ranges, partial pairs merged in range order) held against poi_tpu's
    sampled_nll_rows forward in interpret mode and against
    sampled_lse_reference, at N = 330 and a pool of 200 entries padded to
    330 (bias -1e30, id -1): 6 tiles, which 4 and 5 ranges both cut into 3,
    the last wholly padding. "mixed": many accidental hits; "all": every pool
    entry is one id, the target of rows 0-9, whose lse is -1e30 and nll 0."""
    rng = np.random.default_rng(12)
    N, S_real, S, D = 330, 200, 330, 256
    q = (rng.normal(size=(N, D)) * 0.3).astype(np.float32)
    e_neg = (rng.normal(size=(S, D)) * 0.3).astype(np.float32)
    b_neg = (rng.normal(size=S) * 0.1 + 1.3).astype(np.float32)
    s_pos = rng.normal(size=N).astype(np.float32)
    targets = rng.integers(0, 60, N).astype(np.int32)
    ids = rng.integers(0, 60, S).astype(np.int32)
    if hits == "all":
        ids[:] = 7
        targets[:10] = 7
        targets[10:] = np.where(targets[10:] == 7, 8, targets[10:])
    b_neg[S_real:], ids[S_real:] = NEG, -1
    if hits == "mixed":
        assert (ids[None, :] == targets[:, None]).sum() > 100, "the case needs many hits"
    assert _ranges(S, splits)[-1][0] >= S_real or splits == 1, "a range of padding only"

    want_nll = np.asarray(jax_sampled_nll_rows(*map(jnp.asarray, (q, e_neg, b_neg, s_pos)),
                                               (jnp.asarray(targets), jnp.asarray(ids)), True))
    t = [torch.from_numpy(a) for a in (q, e_neg, b_neg, ids, targets)]
    lse = _b9_lse(*t, splits)
    assert torch.isfinite(lse).all()
    nll = torch.logaddexp(lse, torch.from_numpy(s_pos)) - torch.from_numpy(s_pos)
    _close(nll.numpy(), want_nll, REL_TOL, "nll")
    torch.testing.assert_close(lse, sampled_lse_reference(*t), rtol=0, atol=1e-4)
    if hits == "all":
        assert (lse[:10] == NEG).all() and (nll[:10] == 0).all() and (want_nll[:10] == 0).all()
