"""The GRU path at the widths past the cluster kernels (H > 640, the
grid-resident kernels) and the full-catalog CE at D = 384 and 512, held
against the JAX package on the same numpy inputs.

On the CPU the wrappers take the plain versions, which take any width; the
card runs the kernels and ``chip_smoke.py`` holds them against those plain
versions there. Here: the dispatch the card runs (``fused_gru.design``,
``grid_shape``, the limit), the plain GRU forward and backward at H = 648
(ragged, just past the clusters' 640) and 1024 against the Pallas kernels in
interpret mode, and one ``Trainer`` step of GRU H = 1024, D = 512 over a
catalog large enough for the fused CE against ``poi_tpu``'s step."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poi_tpu.models.base import DataDims as JaxDataDims
from poi_tpu.ops.fused_gru import fused_gru_scan as jax_fused_gru_scan
from poi_tpu.train.loop import Trainer as JaxTrainer
from poi_tpu.utils.config import Config as JaxConfig
from poi_tpu_torch.configs.presets import get_config
from poi_tpu_torch.convert import adam_state_from_jax, adam_state_to_numpy, params_to_numpy
from poi_tpu_torch.data.dataset import load_dataset
from poi_tpu_torch.data.pipeline import make_batch
from poi_tpu_torch.models.base import DataDims
from poi_tpu_torch.ops import fused_gru
from poi_tpu_torch.ops.fused_gru import MASK_NEG, gru_bwd_reference, gru_scan_reference
from poi_tpu_torch.train.losses import FUSED_CE_MIN_VOCAB
from poi_tpu_torch.train.loop import Trainer

torch.set_num_threads(1)

# The widest H the pair takes: csrc/gru_fwd.cu's gru_max_hidden(), which
# chip_smoke.py holds to fused_gru.MAX_HIDDEN on the card. At 2064 the
# forward's slice of two octets ([2064][56] bf16, 231,168 bytes) still fits
# a block's 232,448; at 2065 one octet a block would need 259 blocks.
EXPECTED_MAX_HIDDEN = 2064
# The forward at the valid steps, absolute (tests/test_torch_gru.py's ATOL),
# and the backward relative to each output's largest element
# (tests/test_torch_gru_bwd.py's REL_TOL): the same formulas and rounding
# points on both sides, fp32 summation order and exp/tanh libraries apart.
ATOL = 1e-5
REL_TOL = 1e-5


def test_design_picks_cluster_to_640_grid_past_it_and_refuses_past_the_limit():
    assert fused_gru.CLUSTER_MAX_HIDDEN == 640 and fused_gru.MAX_HIDDEN == EXPECTED_MAX_HIDDEN
    assert [fused_gru.design(H) for H in (1, 64, 639, 640)] == ["cluster"] * 4
    assert [fused_gru.design(H) for H in (641, 648, 768, 1024, 2048, EXPECTED_MAX_HIDDEN)] == ["grid"] * 6
    for H in (0, EXPECTED_MAX_HIDDEN + 1, 4096):
        with pytest.raises(ValueError, match=rf"H={H} is not taken by the kernels: H <= {EXPECTED_MAX_HIDDEN} "
                                              rf"\(gru_max_hidden\(\)\)"):
            fused_gru.design(H)
    assert fused_gru.grid_shape(1, EXPECTED_MAX_HIDDEN + 1, False) is None


@pytest.mark.parametrize("B, H, bwd, want", [
    (512, 1024, False, (4, 32, 4, 128)),  # the wide path: 128 of 132 SMs, 4 row groups of 128 rows
    (512, 1024, True, (4, 32, 4, 128)),
    (7, 648, False, (4, 21, 1, 16)),      # one 16-row tile: one row group
    (5, 768, True, (4, 24, 1, 16)),
    (512, 768, False, (4, 24, 5, 112)),   # 5 groups of 7 tiles cover 32
    (1100, 700, True, (4, 22, 6, 192)),
    (3, 2048, False, (2, 128, 1, 16)),    # two octets a block fit, four do not
])
def test_grid_shape(B, H, bwd, want):
    ocp, U, R, rows = got = fused_gru.grid_shape(B, H, bwd)
    assert got == want
    assert U * R <= fused_gru.SMS and R * rows >= B and (R - 1) * rows < B
    assert U * ocp >= -(-H // 8) and fused_gru._slice_bytes(H, ocp, bwd) <= fused_gru.MAX_SMEM


def _case(B, T, H, seed):
    rng = np.random.default_rng(seed)
    xw = rng.normal(size=(B, T, 3 * H)).astype(np.float32)
    wh = (rng.normal(size=(H, 3 * H)) / np.sqrt(H)).astype(np.float32)
    lengths = rng.integers(2, T + 1, size=B)
    lengths[0] = T
    mask = np.arange(T)[None, :] < lengths[:, None]
    xw[:, :, :H] = np.where(mask[:, :, None], xw[:, :, :H], MASK_NEG)
    dhs = rng.normal(size=(B, T, H)).astype(np.float32)
    return xw, wh, mask, dhs


def _close(got, want, tol, name):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = np.abs(want).max() + 1e-12
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=0, err_msg=name)


@pytest.mark.parametrize("H, T", [(648, 6), (1024, 4)])
def test_gru_plain_versions_past_the_clusters_match_pallas_interpret(H, T):
    """``gru_scan_reference`` and ``gru_bwd_reference`` at a ragged width
    just past 640 and at 1024 against the reference's kernels in interpret
    mode and their ``jax.vjp``: hs at the valid steps, dxw, dwh; dxw exactly
    0 on padded steps; the CPU wrappers are the plain versions."""
    xw, wh, mask, dhs = _case(8, T, H, seed=H)
    hs_j, vjp = jax.vjp(lambda a, w: jax_fused_gru_scan(a, w, True), jnp.asarray(xw), jnp.asarray(wh))
    dxw_j, dwh_j = vjp(jnp.asarray(dhs))
    wh16 = torch.from_numpy(wh).to(torch.bfloat16)
    hs = gru_scan_reference(torch.from_numpy(xw), wh16)
    m = mask[:, :, None]
    np.testing.assert_allclose(hs.numpy() * m, np.asarray(hs_j) * m, atol=ATOL, rtol=0)
    dxw, dwh = gru_bwd_reference(torch.from_numpy(xw), wh16, hs, torch.from_numpy(dhs))
    _close(dxw, dxw_j, REL_TOL, "dxw")
    _close(dwh, dwh_j, REL_TOL, "dwh")
    assert (dxw.numpy()[~mask] == 0).all()
    np.testing.assert_array_equal(fused_gru.fused_gru_scan(torch.from_numpy(xw), wh16).numpy(), hs.numpy())


# The wide path's model at test size: GRU H = 1024 over D = 512 embeddings,
# batch 8, T = 6, bf16, on a synthetic catalog of 8,432 POIs (9,000 drawn),
# above FUSED_CE_MIN_VOCAB, so both packages take their fused CE.
WIDE_SETS = {"model.embed_dim": "512", "model.hidden_dim": "1024", "model.compute_dtype": "bfloat16",
             "train.batch_size": "8", "train.warmup_steps": "0", "data.num_pois": "9000", "data.num_users": "1000",
             "data.mean_checkins_per_user": "60", "data.max_seq_len": "6"}


def _leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(v, np.float32)) for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]]


def test_wide_trainer_step_matches_jax():
    """One ``Trainer`` step of the wide path's model from the same params on
    the same batch against ``poi_tpu``'s, at ``tests/test_torch_train.py``'s
    bf16 tolerances (``test_trainer_step_matches_jax``): the loss to 1e-6
    relative, the first Adam moment to 1% of each tensor's largest, and the
    params to 1e-6 where the moment is clear of the bf16 noise, else within
    2 lr. The reference's scan cell rounds the recurrent cotangent to bf16
    each step and the port's fused backward keeps it fp32, so the gradients
    differ at bf16 resolution: wh's first moment by 5.2e-3 of its largest
    here. The second moment is the gradient squared, its relative
    difference twice the first's (1.01e-2 for wh at H = 1024): it is held
    to 2%."""
    cfg = get_config("smoke").with_overrides(WIDE_SETS)
    ds = load_dataset(cfg.data)
    assert ds.num_pois >= FUSED_CE_MIN_VOCAB and ds.max_seq_len == 6
    jcfg = JaxConfig.from_dict(cfg.to_dict())
    assert dataclasses.asdict(jcfg.model)["hidden_dim"] == 1024
    jt = JaxTrainer(jcfg, JaxDataDims.from_dataset(ds))
    js = jt.init_state()
    tree = jax.tree.map(np.asarray, js.params)
    batch = make_batch(ds.train, np.arange(cfg.train.batch_size))
    js2, jm = jt.step(js, batch)

    tt = Trainer(cfg, DataDims.from_dataset(ds), device="cpu")
    st, tm = tt.step(tt.init_state(tree), batch)
    assert tt.model.tower.layers[0]["wh"].shape == (1024, 3072)
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-6 * float(jm["loss"])
    lr = cfg.train.learning_rate
    jadam = adam_state_to_numpy(adam_state_from_jax(js2.opt_state))
    tadam = adam_state_to_numpy(st.opt_state)
    for which, tol in (("mu", 1e-2), ("nu", 2e-2)):
        for (name, a), (_, b) in zip(_leaves(tadam[which]), _leaves(jadam[which])):
            assert np.abs(a - b).max() <= tol * (np.abs(b).max() + 1e-30), (which, name)
    for (name, a), (_, b), (_, mu) in zip(_leaves(params_to_numpy(tt.model)), _leaves(js2.params),
                                           _leaves(jadam["mu"])):
        diff = np.abs(a - b)
        clear = np.abs(mu) > 0.05 * np.abs(mu).max()
        assert diff[clear].max(initial=0.0) <= 1e-6, name
        assert diff.max() <= 2 * lr + 1e-6, name
