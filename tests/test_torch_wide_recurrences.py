"""The LSTM and ST-RNN paths at the widths past the cluster kernels (the
LSTM past H = 512, the RNN past H = 640: the grid-resident kernels), held
against the JAX package on the same numpy inputs.

On the CPU the wrappers take the plain versions, which take any width; the
card runs the kernels and ``chip_smoke.py`` holds them against those plain
versions there. Here: the dispatch the card runs (``design``,
``grid_shape``, the limits), the plain forward and backward of both
recurrences just past the clusters' limits (ragged for the LSTM) and at
1024 against the Pallas kernels in interpret mode, and one ``Trainer`` step
of config #2 and of config #3 at H = 1024, D = 512 against ``poi_tpu``'s
(config #3 over a catalog large enough for the fused CE)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poi_tpu.models.base import DataDims as JaxDataDims
from poi_tpu.ops.fused_lstm import fused_lstm_scan as jax_fused_lstm_scan
from poi_tpu.ops.fused_rnn import fused_rnn_scan as jax_fused_rnn_scan
from poi_tpu.train.loop import Trainer as JaxTrainer
from poi_tpu.utils.config import Config as JaxConfig
from poi_tpu_torch.configs.presets import get_config
from poi_tpu_torch.convert import adam_state_from_jax, adam_state_to_numpy, flatten, params_to_numpy
from poi_tpu_torch.data.dataset import load_dataset
from poi_tpu_torch.data.pipeline import make_batch
from poi_tpu_torch.models.base import DataDims
from poi_tpu_torch.ops import fused_lstm, fused_rnn, grid
from poi_tpu_torch.ops.fused_lstm import lstm_bwd_reference, lstm_scan_reference
from poi_tpu_torch.ops.fused_rnn import rnn_bwd_reference, rnn_scan_reference
from poi_tpu_torch.train.losses import FUSED_CE_MIN_VOCAB
from poi_tpu_torch.train.loop import Trainer

torch.set_num_threads(1)

# The widest H each pair takes: csrc/lstm.cu's lstm_max_hidden() and
# csrc/rnn.cu's rnn_max_hidden(), which chip_smoke.py holds to the modules'
# MAX_HIDDEN on the card. The LSTM: at 1600 the forward's slice of two
# octets ([1600][72] bf16, 230,400 bytes) still fits a block's 232,448; at
# 1601 one octet a block would need 201 blocks. The RNN: at 3168 three
# octets a block ([3168][32], 202,752 bytes) on 132 blocks; at 3169 133.
LSTM_MAX_HIDDEN = 1600
RNN_MAX_HIDDEN = 3168
# tests/test_torch_lstm.py's and tests/test_torch_rnn.py's tolerances: the
# forward absolute (the LSTM's ATOL_WIDE, as at H = 256: two fp32 summation
# orders round some h across a bf16 boundary, damped by the gates; the
# RNN's ATOL), the backward relative to each output's largest element.
LSTM_ATOL = 1e-3
RNN_ATOL = 1e-5
REL_TOL = 1e-5


@pytest.mark.parametrize("mod, cluster_max, limit", [(fused_lstm, 512, LSTM_MAX_HIDDEN),
                                                      (fused_rnn, 640, RNN_MAX_HIDDEN)], ids=["lstm", "rnn"])
def test_design_picks_cluster_then_grid_and_refuses_past_the_limit(mod, cluster_max, limit):
    name = mod.__name__.rsplit("_", 1)[-1]
    assert mod.CLUSTER_MAX_HIDDEN == cluster_max and mod.MAX_HIDDEN == limit
    assert [mod.design(H) for H in (1, 20, 128, cluster_max - 1, cluster_max)] == ["cluster"] * 5
    assert [mod.design(H) for H in (cluster_max + 1, cluster_max + 8, 768, 1024, limit)] == ["grid"] * 5
    for H in (0, limit + 1, 8192):
        with pytest.raises(ValueError, match=rf"{name.upper()}: H={H} is not taken by the kernels: H <= {limit} "
                                              rf"\({name}_max_hidden\(\)\)"):
            mod.design(H)
    assert mod.grid_shape(1, limit + 1, False) is None
    assert mod.grid_shape(1, limit, False) and mod.grid_shape(1, limit, True)


@pytest.mark.parametrize("mod, B, H, bwd, want", [
    (fused_lstm, 64, 1024, False, (3, 43, 2, 32)),   # the wide LSTM path: 86 of 132 SMs
    (fused_lstm, 64, 1024, True, (3, 43, 2, 32)),
    (fused_lstm, 256, 1024, False, (3, 43, 3, 96)),  # recommend at batch 256
    (fused_lstm, 7, 520, False, (4, 17, 1, 16)),     # ragged just past 512: four octets a block
    (fused_lstm, 1, 1600, False, (2, 100, 1, 16)),   # the limit: two octets a block
    (fused_lstm, 1, 1600, True, (2, 100, 1, 16)),
    (fused_rnn, 64, 1024, False, (4, 32, 4, 16)),    # the wide ST-RNN path: 128 of 132 SMs
    (fused_rnn, 64, 1024, True, (4, 32, 4, 16)),
    (fused_rnn, 256, 1024, False, (4, 32, 4, 64)),
    (fused_rnn, 7, 648, True, (4, 21, 1, 16)),
    (fused_rnn, 1, 3168, False, (3, 132, 1, 16)),    # the limit: every SM, three octets a block
    (fused_rnn, 1, 3168, True, (4, 99, 1, 16)),
], ids=lambda v: getattr(v, "__name__", str(v)).rsplit(".", 1)[-1])
def test_grid_shape(mod, B, H, bwd, want):
    ocp, U, R, rows = got = mod.grid_shape(B, H, bwd)
    assert got == want
    assert U * R <= grid.SMS and R * rows >= B and (R - 1) * rows < B
    assert U * ocp >= -(-H // 8) and grid.slice_bytes(H, ocp, bwd, mod.GATES) <= grid.MAX_SMEM


def _mask(rng, B, T):
    lengths = rng.integers(2, T + 1, size=B)
    lengths[0] = T
    return (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)


def _mask_bh(mask, H):
    return jnp.broadcast_to(jnp.asarray(mask)[:, :, None], mask.shape + (H,))


def _close(got, want, tol, name):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = np.abs(want).max() + 1e-12
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=0, err_msg=name)


@pytest.mark.parametrize("H, T", [(520, 6), (1024, 4)])
def test_lstm_plain_versions_past_the_clusters_match_pallas_interpret(H, T):
    """``lstm_scan_reference`` and ``lstm_bwd_reference`` at a ragged width
    just past 512 and at 1024 against the reference's kernels in interpret
    mode and their ``jax.vjp``: hs at every step (both carry h through the
    padded ones), dxw, dwh; both carries exact through the padding and dxw
    exactly 0 there; the CPU wrappers are the plain versions."""
    rng = np.random.default_rng(H)
    B = 8
    xw = rng.normal(size=(B, T, 4 * H)).astype(np.float32)
    wh = (rng.normal(size=(H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    mask = _mask(rng, B, T)
    dhs = rng.normal(size=(B, T, H)).astype(np.float32)
    hs_j, vjp = jax.vjp(lambda a, w: jax_fused_lstm_scan(a, _mask_bh(mask, H), w, True), jnp.asarray(xw),
                        jnp.asarray(wh))
    dxw_j, dwh_j = vjp(jnp.asarray(dhs))
    m = torch.from_numpy(mask)
    wh16 = torch.from_numpy(wh).to(torch.bfloat16)
    hs, cs = lstm_scan_reference(torch.from_numpy(xw), m, wh16)
    np.testing.assert_allclose(hs.numpy(), np.asarray(hs_j), atol=LSTM_ATOL, rtol=0)
    for b in range(B):
        n = int(mask[b].sum())
        assert torch.equal(hs[b, n:], hs[b, n - 1].expand_as(hs[b, n:]))
        assert torch.equal(cs[b, n:], cs[b, n - 1].expand_as(cs[b, n:]))
    dxw, dwh = lstm_bwd_reference(torch.from_numpy(xw), m, wh16, hs, cs, torch.from_numpy(dhs))
    _close(dxw, dxw_j, REL_TOL, "dxw")
    _close(dwh, dwh_j, REL_TOL, "dwh")
    assert (dxw.numpy()[mask == 0] == 0).all()
    got = fused_lstm.fused_lstm_scan(torch.from_numpy(xw), m, wh16)
    assert torch.equal(got[0], hs) and torch.equal(got[1], cs)
    got = fused_lstm.fused_lstm_bwd(torch.from_numpy(xw), m, wh16, hs, cs, torch.from_numpy(dhs))
    assert torch.equal(got[0], dxw) and torch.equal(got[1], dwh)


@pytest.mark.parametrize("H, T", [(648, 6), (1024, 4)])
def test_rnn_plain_versions_past_the_clusters_match_pallas_interpret(H, T):
    """``rnn_scan_reference`` and ``rnn_bwd_reference`` just past 640 and at
    1024 against the reference's kernels in interpret mode and their
    ``jax.vjp``: hs at every step, dxin, dC; h exact through the padding and
    dxin exactly 0 there; the CPU wrappers are the plain versions."""
    rng = np.random.default_rng(H + 1)
    B = 8
    xin = (0.8 * rng.normal(size=(B, T, H))).astype(np.float32)
    c = (rng.normal(size=(H, H)) / np.sqrt(H)).astype(np.float32)
    mask = _mask(rng, B, T)
    dhs = rng.normal(size=(B, T, H)).astype(np.float32)
    hs_j, vjp = jax.vjp(lambda a, w: jax_fused_rnn_scan(a, _mask_bh(mask, H), w, True), jnp.asarray(xin),
                        jnp.asarray(c))
    dxin_j, dc_j = vjp(jnp.asarray(dhs))
    m = torch.from_numpy(mask)
    c16 = torch.from_numpy(c).to(torch.bfloat16)
    hs = rnn_scan_reference(torch.from_numpy(xin), m, c16)
    np.testing.assert_allclose(hs.numpy(), np.asarray(hs_j), atol=RNN_ATOL, rtol=0)
    for b in range(B):
        n = int(mask[b].sum())
        assert torch.equal(hs[b, n:], hs[b, n - 1].expand_as(hs[b, n:]))
    dxin, dc = rnn_bwd_reference(torch.from_numpy(xin), m, c16, hs, torch.from_numpy(dhs))
    _close(dxin, dxin_j, REL_TOL, "dxin")
    _close(dc, dc_j, REL_TOL, "dC")
    assert (dxin.numpy()[mask == 0] == 0).all()
    assert torch.equal(fused_rnn.fused_rnn_scan(torch.from_numpy(xin), m, c16), hs)
    got = fused_rnn.fused_rnn_bwd(torch.from_numpy(xin), m, c16, hs, torch.from_numpy(dhs))
    assert torch.equal(got[0], dxin) and torch.equal(got[1], dc)


# Configs #2 and #3 at the wide paths' widths, at test size: H = 1024 over
# D = 512 embeddings, batch 8, T = 6, fp32 as the packages' own step tests
# (tests/test_torch_train_lstm.py, test_torch_train_strnn.py) compare them;
# config #3 on its gowalla-shaped generator with 9,000 POIs drawn (8,432
# checked in), above FUSED_CE_MIN_VOCAB, so both packages take their fused
# CE, with dropout 0 (the packages draw masks from different generators).
WIDE = {"model.embed_dim": "512", "model.hidden_dim": "1024", "model.compute_dtype": "float32",
        "train.batch_size": "8", "train.warmup_steps": "0", "data.max_seq_len": "6"}
WIDE_CONFIGS = {
    "lstm_bpr_foursquare": {"data.num_users": "64", "data.num_pois": "512", "loss.num_negatives": "4"},
    "strnn_gowalla": {"data.num_pois": "9000", "data.num_users": "1000", "data.mean_checkins_per_user": "60",
                      "data.min_poi_checkins": "1", "model.dropout": "0.0"},
}
# The step tests' tolerances: the loss to 1e-5 relative, the Adam moments
# to 1e-5 of each tensor's largest, and the params to 1e-6 where the first
# moment is clear of the noise (above 5% of its tensor's largest), else
# within 2 lr (tests/test_torch_wide.py's rule: on Adam's first step an
# element moves by lr g / (|g| + eps), so a gradient near eps moves its
# update by up to lr on fp32 summation noise: 2.5e-6 on config #2 and
# 2.9e-4 on config #3's POI table here, where every clear element is within
# 1.2e-7).
STEP_LOSS_TOL = 1e-5
MOMENT_TOL = 1e-5


@pytest.mark.parametrize("config", list(WIDE_CONFIGS))
def test_wide_trainer_step_matches_jax(config):
    """One ``Trainer`` step of config #2 or #3 at H = 1024, D = 512 from the
    same params on the same host batch (config #2 also on the same BPR
    negatives, replayed from ``poi_tpu``'s draw) against ``poi_tpu``'s: the
    loss, the updated params and the Adam moments."""
    cfg = get_config(config).with_overrides({**WIDE, **WIDE_CONFIGS[config]})
    ds = load_dataset(cfg.data)
    assert ds.max_seq_len == 6 and cfg.model.hidden_dim == 1024
    if config == "strnn_gowalla":
        assert ds.num_pois >= FUSED_CE_MIN_VOCAB
    jt = JaxTrainer(JaxConfig.from_dict(cfg.to_dict()), JaxDataDims.from_dataset(ds))
    js = jt.init_state()
    tree = jax.tree.map(np.asarray, js.params)
    negatives = None
    if cfg.loss.kind == "bpr":
        shape = (cfg.train.batch_size, ds.max_seq_len, cfg.loss.num_negatives)
        neg = np.array(jax.random.randint(jax.random.fold_in(js.rng, 0), shape, 0, ds.num_pois))
        negatives = lambda step: torch.from_numpy(neg)  # noqa: E731
    tt = Trainer(cfg, DataDims.from_dataset(ds), device="cpu", negatives=negatives)
    batch = make_batch(ds.train, np.arange(cfg.train.batch_size))
    js2, jm = jt.step(js, batch)
    st, tm = tt.step(tt.init_state(tree), batch)
    assert st.step == 1
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= STEP_LOSS_TOL * float(jm["loss"])
    got, want = flatten(params_to_numpy(tt.model)), flatten(jax.tree.map(np.asarray, js2.params))
    assert got.keys() == want.keys()
    wh = [k for k in got if k.endswith("/wh") or k.endswith("/c")]
    assert wh and all(got[k].shape[0] == 1024 for k in wh), wh
    jadam, tadam = adam_state_to_numpy(adam_state_from_jax(js2.opt_state)), adam_state_to_numpy(st.opt_state)
    for which in ("mu", "nu"):
        tw = flatten(tadam[which])
        for name, w in flatten(jadam[which]).items():
            _close(tw[name], w, MOMENT_TOL, f"{which} {name}")
    lr = cfg.train.learning_rate
    mu = flatten(jadam["mu"])
    for name, w in want.items():
        diff = np.abs(got[name] - w)
        clear = np.abs(mu[name]) > 0.05 * np.abs(mu[name]).max()
        assert diff[clear].max(initial=0.0) <= 1e-6, name
        assert diff.max() <= 2 * lr + 1e-6, name
