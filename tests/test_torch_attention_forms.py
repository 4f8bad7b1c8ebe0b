"""The port's three local attention forms (poi_tpu_torch.ops.attention:
``vanilla_attention``, ``blockwise_attention``, ``banded_attention``), the
dispatch of ``multihead_attention`` and the attention tower's mapping of
``model.attn_impl`` and ``model.attn_block_size``, each held against
``poi_tpu``'s own function on the same seeded numpy inputs; and the port's
band-restricted blockwise form against its plain version, the reference's
unrestricted loop over every KV block (``blockwise_attention_reference``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import poi_tpu.models.attention as jax_tower_mod
import poi_tpu.ops.attention as jax_attn
import poi_tpu_torch.models.attention as tower_mod
import poi_tpu_torch.ops.attention as attn
from poi_tpu.models import base as jax_base
from poi_tpu.utils.config import ModelConfig as JaxModelConfig
from poi_tpu_torch.convert import params_from_jax
from poi_tpu_torch.data.pipeline import Batch
from poi_tpu_torch.models import base
from poi_tpu_torch.utils.config import ModelConfig

torch.set_num_threads(1)

F32_TOL = 1e-5  # fp32: the same arithmetic up to summation order
# bf16 against the same form: the same rounding points; an fp32 order
# difference can move a value across a bf16 boundary, 2^-8 relative.
BF16_TOL = 2 ** -8
# bf16 blockwise at config #4's shape (T = 128, D = 256, 4 heads, W = 16,
# one block of 128): 64-term sums whose fp32 order differs move a few of the
# unnormalised p across a bf16 boundary (measured 1.4e-4 to 4.9e-4).
C4_BF16_TOL = 1e-3

# name -> B, heads, T, Dh, window, block, kv_offset, Tk (None: T).
SHAPES = {
    "ragged": (3, 2, 10, 8, 5, 4, 0, None),  # T not a multiple of the block
    "w_past_block": (2, 2, 23, 8, 9, 4, 0, None),  # the window spans three KV blocks
    "w_past_t": (2, 2, 13, 8, 20, 4, 0, None),
    "kv_offset": (2, 2, 17, 8, 6, 4, -3, 20),  # keys start 3 before the queries
    "banded_rule": (1, 2, 300, 8, 128, 64, 0, None),  # W >= 128 and T >= 2W
}


def _qkv(shape, dtype, seed=0):
    B, H, T, Dh, _, _, _, Tk = shape
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(B, H, n, Dh)).astype(np.float32) for n in (T, Tk or T, Tk or T)]
    cot = rng.normal(size=(B, H, T, Dh)).astype(np.float32)
    return ([torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs],
            [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs], cot)


def _close(got, want, tol, name=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = np.abs(want).max() + 1e-12
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=0, err_msg=name)


def _form(name, shape):
    """(port, reference) callables of form ``name`` at ``shape``."""
    _, _, _, _, W, bs, off, _ = shape
    if name == "blockwise":
        return (lambda q, k, v: attn.blockwise_attention(q, k, v, W, bs, off),
                lambda q, k, v: jax_attn.blockwise_attention(q, k, v, W, bs, off))
    port, ref = getattr(attn, f"{name}_attention"), getattr(jax_attn, f"{name}_attention")
    return lambda q, k, v: port(q, k, v, W), lambda q, k, v: ref(q, k, v, W)


FORM_CASES = [(form, tag) for tag, s in SHAPES.items() for form in ("vanilla", "blockwise", "banded")
              if form == "blockwise" or (s[6] == 0 and s[7] is None)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form, tag", FORM_CASES)
def test_form_matches_reference(form, tag, dtype):
    """Each form against the reference's same form: fp32 within 1e-5, bf16
    within BF16_TOL (blockwise within 1e-5: its p·v sums bf16 products of
    the same unnormalised p, exact in fp32)."""
    shape = SHAPES[tag]
    (tq, tk, tv), (jq, jk, jv), _ = _qkv(shape, dtype)
    port, ref = _form(form, shape)
    got = port(tq, tk, tv)
    assert got.dtype == torch.float32 and got.shape == tq.shape
    tol = F32_TOL if dtype == "float32" or form == "blockwise" else BF16_TOL
    _close(got, ref(jq, jk, jv), tol, f"{form} {tag} {dtype}")


@pytest.mark.parametrize("form, tag", FORM_CASES)
def test_form_gradients_match_reference_vjp(form, tag):
    """fp32 gradients of q, k and v under a seeded cotangent against
    ``jax.vjp`` of the reference's form."""
    shape = SHAPES[tag]
    (tq, tk, tv), (jq, jk, jv), cot = _qkv(shape, "float32", seed=1)
    port, ref = _form(form, shape)
    ts = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    (port(*ts) * torch.from_numpy(cot)).sum().backward()
    _, vjp = jax.vjp(ref, jq, jk, jv)
    for name, t, g in zip("qkv", ts, vjp(jnp.asarray(cot))):
        _close(t.grad, g, F32_TOL, f"d{name} {form} {tag}")


@pytest.mark.parametrize("tag, T, W, bs", [("ragged", 300, 16, 128), ("long", 1000, 16, 128),
                                           ("w_past_block", 517, 200, 128), ("small_blocks", 64, 5, 16),
                                           ("w_past_t", 33, 40, 4), ("kv_offset", 40, 7, 6)])
def test_band_restricted_blockwise_equals_unrestricted_loop(tag, T, W, bs):
    """bf16 q, k, v: the port's form, which visits only the KV blocks that
    reach each query block's window, gives the unrestricted loop's bits: a
    skipped block is an exact no-op in the online update. (The products of
    bf16 operands are exact in fp32, so both batchings of the score product
    sum the same values.)"""
    off = -3 if tag == "kv_offset" else 0
    g = torch.Generator().manual_seed(T)
    q = torch.randn(2, 2, T, 8, generator=g).bfloat16()
    k, v = (torch.randn(2, 2, T - off, 8, generator=g).bfloat16() for _ in range(2))
    got = attn.blockwise_attention(q, k, v, W, bs, off)
    assert torch.equal(got, attn.blockwise_attention_reference(q, k, v, W, bs, off))


def _mha_inputs(B, T, D, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    p = {k: (rng.normal(size=(D, D)) / np.sqrt(D)).astype(np.float32) for k in ("wq", "wk", "wv", "wo")}
    return x, p


@pytest.mark.parametrize("dtype, tol", [("float32", F32_TOL), ("bfloat16", C4_BF16_TOL)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_config4_shape_blockwise_matches_reference(dtype, tol, seed):
    """multihead_attention(impl="blockwise") at config #4's shape (T = 128,
    D = 256, 4 heads, W = 16, block 128) against poi_tpu's."""
    x, p = _mha_inputs(2, 128, 256, seed)
    want = jax_attn.multihead_attention(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, num_heads=4,
                                        window=16, impl="blockwise", block_size=128, dtype=getattr(jnp, dtype))
    got = attn.multihead_attention(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()}, 4, 16,
                                   "blockwise", 128, getattr(torch, dtype))
    _close(got, want, tol, f"{dtype} seed {seed}")


def _spy(monkeypatch, module, names, seen):
    """Record which of ``module``'s forms ``names`` run, in order."""
    for name in names:
        fn = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, _fn=fn, _name=name, **kw: (seen.append(_name), _fn(*a, **kw))[1])


FORMS = ("vanilla_attention", "blockwise_attention", "banded_attention")


@pytest.mark.parametrize("impl, T, W, form", [
    ("vanilla", 40, 16, "vanilla_attention"),
    ("blockwise", 40, 16, "blockwise_attention"),
    ("banded", 40, 16, "banded_attention"),
    ("blockwise", 256, 128, "banded_attention"),  # window >= 128 and T >= 2W
    ("blockwise", 255, 128, "blockwise_attention"),  # T < 2W
    ("blockwise", 300, 127, "blockwise_attention"),  # window < 128
    ("vanilla", 256, 128, "vanilla_attention"),
])
def test_multihead_dispatch_matches_reference(monkeypatch, impl, T, W, form):
    """Both packages pick the same form for (impl, T, window), and the
    outputs in bf16 agree at that form's tolerance (block 32 for blockwise,
    so it runs several blocks)."""
    seen, jseen = [], []
    _spy(monkeypatch, attn, FORMS, seen)
    _spy(monkeypatch, jax_attn, FORMS, jseen)
    x, p = _mha_inputs(1, T, 16)
    got = attn.multihead_attention(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()}, 2, W, impl,
                                   32)
    want = jax_attn.multihead_attention(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, num_heads=2,
                                        window=W, impl=impl, block_size=32)
    assert seen == jseen == [form]
    _close(got, want, F32_TOL if form == "blockwise_attention" else BF16_TOL, f"{impl} T={T} W={W}")


@pytest.mark.parametrize("impl", ["ring", "ulysses", "flash"])
def test_multihead_refuses_an_unknown_impl(impl):
    x, p = _mha_inputs(1, 8, 16)
    with pytest.raises(ValueError) as want:
        jax_attn.multihead_attention(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, num_heads=2,
                                     window=4, impl=impl)
    with pytest.raises(ValueError) as got:
        attn.multihead_attention(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()}, 2, 4, impl)
    assert str(got.value) == str(want.value)


def test_window_mask_offsets_match_reference():
    for args in ((5, 7, 3, 0, 0), (6, 9, 4, 3, 0), (8, 8, 5, 2, -1), (4, 10, 20, 0, -6)):
        assert np.array_equal(attn.window_mask(*args).numpy(), np.asarray(jax_attn.window_mask(*args)))


DIMS = jax_base.DataDims(num_users=5, num_pois=40, num_time_buckets=6, num_geo_buckets=8, num_tgap_buckets=3,
                         num_dist_buckets=3)


def _batch(B, T, seed=0):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, T + 1, B)
    return Batch(
        user=rng.integers(0, DIMS.num_users, B).astype(np.int32),
        poi_in=rng.integers(0, DIMS.num_pois, (B, T)).astype(np.int32),
        poi_tgt=rng.integers(0, DIMS.num_pois, (B, T)).astype(np.int32),
        mask=(np.arange(T)[None, :] < lens[:, None]).astype(np.float32),
        time_bucket=rng.integers(0, DIMS.num_time_buckets, (B, T)).astype(np.int32),
        geo_bucket=rng.integers(0, DIMS.num_geo_buckets, (B, T)).astype(np.int32),
        tgap_idx=rng.integers(0, 2, (B, T)).astype(np.int32),
        tgap_frac=rng.random((B, T)).astype(np.float32),
        dist_idx=rng.integers(0, 2, (B, T)).astype(np.int32),
        dist_frac=rng.random((B, T)).astype(np.float32),
    )


@pytest.mark.parametrize("attn_impl, block, calls", [
    ("vanilla", 128, ("vanilla", 128)),
    ("blockwise", 128, ("blockwise", 128)),
    ("blockwise", 4, ("blockwise", 4)),
    ("banded", 4, ("blockwise", 4)),  # the tower maps banded to blockwise
    ("ring", 8, ("blockwise", 8)),  # SP modes without a mesh: blockwise
    ("ulysses", 8, ("blockwise", 8)),
])
def test_tower_maps_attn_impl_as_reference(monkeypatch, attn_impl, block, calls):
    """The attention tower hands ``multihead_attention`` the reference
    tower's (impl, block_size) for every ``model.attn_impl`` and
    ``model.attn_block_size``, and its queries in bf16 are poi_tpu's from
    the same parameters (BF16_TOL)."""
    cfg = ModelConfig(kind="attention", embed_dim=16, hidden_dim=16, attn_window=4, attn_heads=2,
                      attn_impl=attn_impl, attn_block_size=block)
    seen, jseen = [], []
    for mod, log in ((tower_mod, seen), (jax_tower_mod, jseen)):
        fn = mod.multihead_attention
        monkeypatch.setattr(mod, "multihead_attention", lambda *a, _fn=fn, _log=log, **kw: (
            _log.append((kw["impl"] if "impl" in kw else a[4], kw["block_size"] if "block_size" in kw else a[5])),
            _fn(*a, **kw))[1])
    jm = jax_base.build_model(JaxModelConfig(**dataclasses.asdict(cfg)), DIMS)
    params = jm.init(jax.random.key(0))
    tm = base.build_model(cfg, base.DataDims(**dataclasses.asdict(DIMS)), device="cpu")
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    batch = _batch(3, 10)
    with torch.no_grad():
        got = tm.queries(base.batch_to(batch, "cpu"))
    want = np.asarray(jm.queries(params, batch))
    assert seen == jseen == [calls]
    m = batch.mask.astype(bool)
    _close(got.numpy()[m], want[m], BF16_TOL, attn_impl)


def test_tower_attn_impl_and_block_size_change_what_it_computes():
    """As in poi_tpu, the tower's banded equals its blockwise bit for bit,
    vanilla and a smaller block give other bf16 values."""
    def queries(**kw):
        cfg = ModelConfig(kind="attention", embed_dim=16, hidden_dim=16, attn_window=4, attn_heads=2, **kw)
        tm = base.build_model(cfg, base.DataDims(**dataclasses.asdict(DIMS)), device="cpu",
                              generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            return tm.queries(base.batch_to(_batch(3, 12), "cpu"))

    blockwise = queries(attn_impl="blockwise", attn_block_size=4)
    assert torch.equal(blockwise, queries(attn_impl="banded", attn_block_size=4))
    assert not torch.equal(blockwise, queries(attn_impl="vanilla", attn_block_size=4))
    assert not torch.equal(blockwise, queries(attn_impl="blockwise", attn_block_size=3))
