"""The port's attention tower (poi_tpu_torch.ops.attention,
models.attention) and dropout (models.base) held against the JAX package on
the same numpy inputs and the same parameters (carried across with
convert.params_from_jax)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poi_tpu.models import base as jax_base
from poi_tpu.ops.attention import multihead_attention as jax_mha
from poi_tpu.ops.attention import multihead_attention_last as jax_mha_last
from poi_tpu.ops.attention import window_mask as jax_window_mask
from poi_tpu.utils.config import ModelConfig as JaxModelConfig
from poi_tpu_torch.convert import flatten, params_from_jax
from poi_tpu_torch.data.pipeline import Batch
from poi_tpu_torch.models import base
from poi_tpu_torch.models.attention import AttentionModel, layer_norm
from poi_tpu_torch.ops.attention import multihead_attention, multihead_attention_last, window_mask
from poi_tpu_torch.utils.config import ModelConfig

torch.set_num_threads(1)

# fp32: the same arithmetic up to summation order.
F32_TOL = 1e-5
# bf16 against the same form (vanilla): the same rounding points; an fp32
# order difference can move a value across a bf16 boundary, 2^-8 relative.
BF16_TOL = 2 ** -8
# bf16 against blockwise, which rounds the unnormalised exp(s - m) to bf16
# before p·v and divides by the sum after, where the port (and vanilla)
# round the normalised softmax: the two differ at bf16 resolution in every
# p, ~1e-2 of the output's scale.
BLOCKWISE_BF16_TOL = 2e-2

DIMS = jax_base.DataDims(num_users=7, num_pois=50, num_time_buckets=12, num_geo_buckets=16,
                         num_tgap_buckets=4, num_dist_buckets=4)


def _rand_batch(rng, B, T, lens=None):
    lens = np.full(B, T) if lens is None else np.asarray(lens)
    return Batch(
        user=rng.integers(0, DIMS.num_users, B).astype(np.int32),
        poi_in=rng.integers(0, DIMS.num_pois, (B, T)).astype(np.int32),
        poi_tgt=rng.integers(0, DIMS.num_pois, (B, T)).astype(np.int32),
        mask=(np.arange(T)[None, :] < lens[:, None]).astype(np.float32),
        time_bucket=rng.integers(0, DIMS.num_time_buckets, (B, T)).astype(np.int32),
        geo_bucket=rng.integers(0, DIMS.num_geo_buckets, (B, T)).astype(np.int32),
        tgap_idx=rng.integers(0, 3, (B, T)).astype(np.int32),
        tgap_frac=rng.random((B, T)).astype(np.float32),
        dist_idx=rng.integers(0, 3, (B, T)).astype(np.int32),
        dist_frac=rng.random((B, T)).astype(np.float32),
    )


def _mha_params(rng, D):
    return {k: (rng.normal(size=(D, D)) / np.sqrt(D)).astype(np.float32) for k in ("wq", "wk", "wv", "wo")}


def _close(got, want, tol, name=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = np.abs(want).max() + 1e-12
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=0, err_msg=name)


def test_window_mask_matches_jax():
    for T, window in ((5, 3), (9, 2), (6, 10)):
        assert np.array_equal(window_mask(T, window).numpy(), np.asarray(jax_window_mask(T, T, window)))


@pytest.mark.parametrize("dtype, impl, tol", [
    ("float32", "vanilla", F32_TOL),
    ("float32", "blockwise", F32_TOL),
    ("bfloat16", "vanilla", BF16_TOL),
    ("bfloat16", "blockwise", BLOCKWISE_BF16_TOL),
])
def test_multihead_attention_matches_jax(dtype, impl, tol):
    """T=10 with blocks of 4: blockwise pads its last KV block."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 10, 16)).astype(np.float32)
    p = _mha_params(rng, 16)
    want = jax_mha(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, num_heads=2, window=5, impl=impl,
                   block_size=4, dtype=getattr(jnp, dtype))
    got = multihead_attention(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()}, 2, 5,
                              getattr(torch, dtype))
    assert got.dtype == torch.float32 and got.shape == (3, 10, 16)
    _close(got, want, tol, f"{dtype} {impl}")


@pytest.mark.parametrize("window, lens", [(4, [9, 1, 4, 7, 3]), (6, [2, 9, 1, 5, 6])])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_multihead_attention_last_matches_jax_and_the_full_path(window, lens, dtype):
    """At each row's last valid position, including prefixes shorter than
    the window (the positions before 0 are masked, not wrapped)."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(5, 9, 16)).astype(np.float32)
    p = _mha_params(rng, 16)
    last = np.asarray(lens) - 1
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    got = multihead_attention_last(torch.from_numpy(x), tp, 2, window, torch.from_numpy(last), getattr(torch, dtype))
    want = jax_mha_last(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, num_heads=2, window=window,
                        last=jnp.asarray(last), dtype=getattr(jnp, dtype))
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    _close(got, want, tol, "vs jax")
    full = multihead_attention(torch.from_numpy(x), tp, 2, window, getattr(torch, dtype))
    _close(got, full[torch.arange(5), torch.from_numpy(last)], tol, "vs the full path")


def _models(dtype, seed=3, **cfg_kw):
    cfg = ModelConfig(kind="attention", embed_dim=32, hidden_dim=32, attn_window=4, attn_heads=2,
                      compute_dtype=dtype, **cfg_kw)
    jm = jax_base.build_model(JaxModelConfig(**dataclasses.asdict(cfg)), DIMS)
    params = jm.init(jax.random.key(seed))
    tm = base.build_model(cfg, base.DataDims(**dataclasses.asdict(DIMS)))
    assert isinstance(tm, AttentionModel)
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jm, params, tm


@pytest.mark.parametrize("dtype, tol", [("float32", F32_TOL), ("bfloat16", BLOCKWISE_BF16_TOL)])
def test_attention_model_queries_match_jax(dtype, tol):
    """queries (every position) and queries_last, on ragged prefixes, from
    poi_tpu's params. poi_tpu runs its lax.scan GRU and blockwise attention,
    the port its GRU Function (the kernels' plain versions) and one
    attention form; bf16 differs as BLOCKWISE_BF16_TOL says."""
    jm, params, tm = _models(dtype)
    assert sorted(tm.state_dict()) == sorted(k.replace("/", ".") for k in flatten(params))
    lens = [12, 1, 5, 9]
    batch = _rand_batch(np.random.default_rng(4), 4, 12, lens)
    tb = base.batch_to(batch, "cpu")
    with torch.no_grad():
        got, got_last = tm.queries(tb), tm.queries_last(tb)
    want = np.asarray(jm.queries(params, batch))
    m = batch.mask.astype(bool)
    _close(got.numpy()[m], want[m], tol, "queries")
    _close(got_last, np.asarray(jm.queries_last(params, batch)), tol, "queries_last")
    _close(got_last, got.numpy()[np.arange(4), np.asarray(lens) - 1], F32_TOL if dtype == "float32" else BF16_TOL,
           "queries_last vs queries")


def test_layer_norm_matches_jax():
    from poi_tpu.models.attention import layer_norm as jax_layer_norm

    rng = np.random.default_rng(6)
    x = (rng.normal(size=(3, 5, 8)) * 4 + 2).astype(np.float32)
    p = {"scale": rng.normal(size=8).astype(np.float32), "bias": rng.normal(size=8).astype(np.float32)}
    got = layer_norm({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x))
    _close(got, jax_layer_norm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)), 1e-6)


def test_dropout_semantics():
    x = torch.randn(200, 300, generator=torch.Generator().manual_seed(0))
    assert base.dropout(x, 0.3, None) is x  # eval: no generator, the identity
    assert base.dropout(x, 0.0, torch.Generator()) is x
    y = base.dropout(x, 0.3, torch.Generator().manual_seed(5))
    dropped = y == 0
    assert abs(float(dropped.float().mean()) - 0.3) < 0.01  # 60,000 draws: std 0.002
    torch.testing.assert_close(y[~dropped], x[~dropped] / 0.7, rtol=0, atol=0)
    assert torch.equal(y, base.dropout(x, 0.3, torch.Generator().manual_seed(5)))  # keyed by the generator
    assert not torch.equal(y, base.dropout(x, 0.3, torch.Generator().manual_seed(6)))


def test_queries_drop_out_only_with_a_generator():
    _, _, tm = _models("float32", dropout=0.5)
    tb = base.batch_to(_rand_batch(np.random.default_rng(7), 3, 8), "cpu")
    with torch.no_grad():
        q0, q0b = tm.queries(tb), tm.queries(tb)
        q1 = tm.queries(tb, torch.Generator().manual_seed(1))
        q1b = tm.queries(tb, torch.Generator().manual_seed(1))
    assert torch.equal(q0, q0b) and torch.equal(q1, q1b) and not torch.equal(q0, q1)
    # The tower output is dropped last: about half its elements are zero.
    assert 0.4 < float((q1 == 0).float().mean()) < 0.6
    torch.testing.assert_close(tm.queries_last(tb), q0[:, -1], rtol=1e-5, atol=1e-6)
