"""The losses past D = 512: B7/B8 and B9/B10 at D = 768 and 1024 on the
K-chunked kernels (``csrc/kchunk.cuh``), and the two models they let train at
D = H = 1024, held against the JAX package on the same numpy inputs.

On the CPU the wrappers take the plain versions, which take any width; the
card runs the kernels and ``chip_smoke.py`` holds them against those plain
versions there, and the Python mirrors of the kernels' block shapes against
the C side's. Here: the width dispatch (every D in 513..1024 to 768 or 1024,
1025 refused), the mirrors against a table, and one ``Trainer`` step at
D = H = 1024 of the smoke GRU model with the fused CE and of config #4's
attention model with sampled softmax, each against ``poi_tpu``'s step."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from poi_tpu.models.base import DataDims as JaxDataDims
from poi_tpu.train.loop import Trainer as JaxTrainer
from poi_tpu.utils.config import Config as JaxConfig
from poi_tpu_torch.configs.presets import get_config
from poi_tpu_torch.convert import (adam_state_from_jax, adam_state_to_numpy, flatten, params_to_numpy,
                                   sparse_adam_state_to_numpy)
from poi_tpu_torch.data.dataset import load_dataset
from poi_tpu_torch.data.pipeline import make_batch
from poi_tpu_torch.models.base import DataDims
from poi_tpu_torch.ops import fused_ce, fused_sampled
from poi_tpu_torch.ops.widths import padded_dim
from poi_tpu_torch.train.losses import FUSED_CE_MIN_VOCAB
from poi_tpu_torch.train.loop import Trainer

torch.set_num_threads(1)

PAIRS = {"ce": fused_ce.KERNEL_DIMS, "sampled": fused_sampled.KERNEL_DIMS}


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_padded_dim_past_512_pads_by_at_most_half_and_refuses_past_1024(pair):
    """Every D in 513..1024 runs at 768 or 1024, no more than 1.5x D; 1025
    is refused, naming the limit."""
    dims = PAIRS[pair]
    assert dims[-2:] == (768, 1024)
    got = {D: padded_dim(D, dims, pair) for D in range(513, 1025)}
    assert set(got.values()) == {768, 1024}
    assert all(D <= Dp <= 1.5 * D for D, Dp in got.items())
    assert all(Dp == (768 if D <= 768 else 1024) for D, Dp in got.items())
    with pytest.raises(ValueError, match=rf"{pair}: the kernels take D <= 1024 .*got D=1025"):
        padded_dim(1025, dims, pair)


# The kernels' block shapes by width (csrc/ce.cu ce_lse_plan, csrc/ce_bwd.cu
# ce_bwd_plan, csrc/sampled.cu sampled_plan; chip_smoke.py holds the Python
# mirrors to them on the card). Past 512 a streamed tile arrives in chunks of
# 256 columns; the ring takes as many 32 KB stages as fit 232,448 bytes
# beside 64 resident rows (and, in the backward, the hold's chunk); a B8 or
# B10 block sums one range of 256 output columns.
CE_LSE_PLANS = {32: (256, 4, 32), 128: (256, 4, 128), 192: (256, 4, 192), 256: (128, 4, 256), 384: (128, 2, 384),
                512: (64, 2, 512), 768: (64, 4, 256), 1024: (64, 3, 256)}
CE_BWD_PLANS = {32: (128, 4, 1, 32), 128: (128, 4, 1, 128), 192: (128, 4, 1, 192), 256: (128, 4, 1, 256),
                384: (64, 2, 2, 384), 512: (64, 2, 2, 512), 768: (64, 3, 3, 256), 1024: (64, 2, 4, 256)}
SAMPLED_PLANS = {64: (256, 4, 64, 128, 4, 1, 64), 128: (256, 4, 128, 128, 4, 1, 128),
                 256: (128, 4, 256, 128, 4, 1, 256), 512: (64, 2, 512, 64, 2, 2, 512),
                 768: (64, 3, 256, 64, 3, 3, 256), 1024: (64, 3, 256, 64, 2, 4, 256)}


@pytest.mark.parametrize("D", [32, 128, 192, 256, 384, 512, 600, 768, 1000, 1024])
def test_block_plans_match_the_table(D):
    """``lse_plan``, ``bwd_plan`` and ``fused_sampled.plan`` at each width,
    a width the kernels run padded (600, 1000) taking its padded width's
    plan."""
    Dc = padded_dim(D, fused_ce.KERNEL_DIMS, "ce")
    assert fused_ce.lse_plan(D) == CE_LSE_PLANS[Dc] and fused_ce.lse_plan(D)[0] == fused_ce.lse_rows(D)
    assert fused_ce.bwd_plan(D) == CE_BWD_PLANS[Dc]
    Ds = padded_dim(D, fused_sampled.KERNEL_DIMS, "sampled")
    assert fused_sampled.plan(D) == SAMPLED_PLANS[Ds]
    if Dc > 512:  # column ranges of 256 cover the width; the chunks tile it
        rows, stages, ranges, cols = fused_ce.bwd_plan(D)
        assert ranges * cols == Dc and Dc % fused_ce.lse_plan(D)[2] == 0 and 2 <= stages <= 4


def _leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(v, np.float32)) for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _moments_and_params_close(got_adam, want_adam, got_params, want_params, lr):
    """``tests/test_torch_wide.py``'s bounds: the first moment to 1% of each
    tensor's largest, the second to 2%, the params to 1e-6 where the moment
    is clear of the bf16 noise, else within 2 lr."""
    for which, tol in (("mu", 1e-2), ("nu", 2e-2)):
        for (name, a), (_, b) in zip(_leaves(got_adam[which]), _leaves(want_adam[which])):
            assert np.abs(a - b).max() <= tol * (np.abs(b).max() + 1e-30), (which, name)
    for (name, a), (_, b), (_, mu) in zip(_leaves(got_params), _leaves(want_params), _leaves(want_adam["mu"])):
        diff = np.abs(a - b)
        clear = np.abs(mu) > 0.05 * np.abs(mu).max()
        assert diff[clear].max(initial=0.0) <= 1e-6, name
        assert diff.max() <= 2 * lr + 1e-6, name


# The wider bench path's model at test size: GRU H = 1024 over D = 1024
# embeddings, batch 8, T = 6, bf16, on a synthetic catalog of 8,432 POIs
# (9,000 drawn), above FUSED_CE_MIN_VOCAB, so both packages take their fused
# CE (tests/test_torch_wide.py's model at D = 1024).
WIDER_SETS = {"model.embed_dim": "1024", "model.hidden_dim": "1024", "model.compute_dtype": "bfloat16",
              "train.batch_size": "8", "train.warmup_steps": "0", "data.num_pois": "9000", "data.num_users": "1000",
              "data.mean_checkins_per_user": "60", "data.max_seq_len": "6"}


def test_wider_gru_trainer_step_matches_jax():
    """One ``Trainer`` step of the GRU model at D = H = 1024 from the same
    params on the same batch against ``poi_tpu``'s, at
    ``test_wide_trainer_step_matches_jax``'s bounds: the loss to 1e-6
    relative, the moments and params as ``_moments_and_params_close``."""
    cfg = get_config("smoke").with_overrides(WIDER_SETS)
    ds = load_dataset(cfg.data)
    assert ds.num_pois >= FUSED_CE_MIN_VOCAB and ds.max_seq_len == 6
    jcfg = JaxConfig.from_dict(cfg.to_dict())
    assert dataclasses.asdict(jcfg.model)["embed_dim"] == 1024
    jt = JaxTrainer(jcfg, JaxDataDims.from_dataset(ds))
    js = jt.init_state()
    tree = jax.tree.map(np.asarray, js.params)
    batch = make_batch(ds.train, np.arange(cfg.train.batch_size))
    js2, jm = jt.step(js, batch)

    tt = Trainer(cfg, DataDims.from_dataset(ds), device="cpu")
    st, tm = tt.step(tt.init_state(tree), batch)
    assert tt.model.embed["poi"].shape[1] == 1024 and tt.model.tower.layers[0]["wh"].shape == (1024, 3072)
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-6 * float(jm["loss"])
    want_adam = adam_state_to_numpy(adam_state_from_jax(js2.opt_state))
    _moments_and_params_close(adam_state_to_numpy(st.opt_state), want_adam, params_to_numpy(tt.model), js2.params,
                              cfg.train.learning_rate)


# Config #4's model at D = H = 1024 at test size
# (tests/test_torch_train_attention.py's SMALL at these widths): a 410-POI synthetic catalog, T = 16, batch 16,
# S = 128 negatives, dropout 0, fp32, the port's fused sampled softmax (its
# kernels' plain versions here).
ATTN_SETS = {
    "data.dataset": "synthetic", "data.num_users": 64, "data.num_pois": 512, "data.mean_checkins_per_user": 30,
    "data.max_seq_len": 16, "data.min_user_checkins": 4, "data.min_poi_checkins": 1,
    "model.embed_dim": 1024, "model.hidden_dim": 1024, "model.attn_window": 4, "model.dropout": 0.0,
    "model.compute_dtype": "float32", "loss.num_sampled": 128, "loss.impl": "fused", "train.batch_size": 16,
    "train.warmup_steps": 0,
}


def test_wider_attention_trainer_step_matches_jax():
    """One step of config #4's model at D = H = 1024 with sampled softmax from
    the same params on the same batch against ``poi_tpu``'s, the port's pool
    replaying its draw through the ``negatives`` hook: the loss to 1e-6
    relative, lazy Adam's moments and the params at
    ``tests/test_torch_wide.py``'s bounds. The port's fused backward keeps dq
    and the table cotangent fp32 where poi_tpu's XLA autodiff rounds them
    to bf16 (``test_trainer_step_matches_jax`` of the attention suite)."""
    cfg = get_config("attention_gowalla").with_overrides({k: str(v) for k, v in ATTN_SETS.items()})
    ds = load_dataset(cfg.data)
    jt = JaxTrainer(JaxConfig.from_dict(cfg.to_dict()), JaxDataDims.from_dataset(ds))
    js = jt.init_state()
    tree = jax.tree.map(np.asarray, js.params)
    pool = np.array(jax.random.randint(jax.random.fold_in(js.rng, 0), (cfg.loss.num_sampled,), 0, ds.num_pois))
    tt = Trainer(cfg, DataDims.from_dataset(ds), device="cpu", negatives=lambda step: torch.from_numpy(pool))
    batch = make_batch(ds.train, np.arange(cfg.train.batch_size))
    js2, jm = jt.step(js, batch)
    st, tm = tt.step(tt.init_state(tree), batch)
    assert tt.model.embed["poi"].shape[1] == 1024 and st.step == 1
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-6 * float(jm["loss"])
    lazy = sparse_adam_state_to_numpy(st.opt_state)
    got = {"mu": lazy["m"], "nu": lazy["v"]}
    want = {"mu": js2.opt_state.m, "nu": js2.opt_state.v}
    assert set(flatten(got["mu"])) == set(flatten(jax.tree.map(np.asarray, want["mu"])))
    _moments_and_params_close(got, want, params_to_numpy(tt.model), js2.params, cfg.train.learning_rate)
