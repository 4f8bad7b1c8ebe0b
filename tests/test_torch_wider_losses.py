"""The losses past D = 512: B7/B8 and B9/B10 at D = 768 and 1024 on the
K-chunked kernels (``csrc/kchunk.cuh``), all four past 1024 on their
streamed kernels, and the models they let train, held against the JAX
package on the same numpy inputs.

On the CPU the wrappers take the plain versions, which take any width; the
card runs the kernels and ``chip_smoke.py`` holds them against those plain
versions there, and the Python mirrors of the kernels' block shapes against
the C side's. Here: the width dispatch (every D in 513..1024 to 768 or 1024;
past 1024 both pairs to the next multiple of 256), the mirrors against a
table, B9/B10's dispatch past 1024 against the reference's Pallas kernels,
one ``Trainer`` step at D = H = 1024 of the smoke GRU model with the fused
CE and of config #4's attention model with sampled softmax, and one
``Trainer`` step and one ``Recommender.recommend`` at D = H = 2048 of the
smoke GRU model (the widest bench path's model) and of config #4's (the
widest config #4 path's), each against ``poi_tpu``'s."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poi_tpu.eval.serve import Checkin as JaxCheckin
from poi_tpu.eval.serve import Recommender as JaxRecommender
from poi_tpu.models.base import DataDims as JaxDataDims
from poi_tpu.train.loop import Trainer as JaxTrainer
from poi_tpu.utils.config import Config as JaxConfig
from poi_tpu_torch.configs.presets import get_config
from poi_tpu_torch.convert import (adam_state_from_jax, adam_state_to_numpy, flatten, params_from_jax, params_to_numpy,
                                   sparse_adam_state_to_numpy)
from poi_tpu_torch.data.dataset import load_dataset
from poi_tpu_torch.data.pipeline import make_batch
from poi_tpu_torch.eval.serve import Checkin, Recommender
from poi_tpu_torch.models.base import DataDims, batch_to, build_model
from poi_tpu_torch.ops import fused_ce, fused_sampled
from poi_tpu_torch.ops.widths import padded_dim
from poi_tpu_torch.train.losses import FUSED_CE_MIN_VOCAB
from poi_tpu_torch.train.loop import Trainer
from poi_tpu_torch.train.state import ADAM_B1, ADAM_EPS
from test_torch_widths import _sampled_against_pallas

torch.set_num_threads(1)

PAIRS = {"ce": fused_ce.KERNEL_DIMS, "sampled": fused_sampled.KERNEL_DIMS}
# Each pair's dispatch: both take every multiple of 256 past 1024 (their
# streamed kernels: B7/B8 since they came, B9/B10 since theirs did), through
# their module's kernel_dim.
CHUNKED = {"ce": True, "sampled": True}
KERNEL_DIM = {"ce": fused_ce.kernel_dim, "sampled": fused_sampled.kernel_dim}


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_padded_dim_past_512_pads_by_at_most_half_and_refuses_past_1024(pair):
    """Every D in 513..1024 runs at 768 or 1024, no more than 1.5x D. Past
    1024 each pair (both refused there before their streamed kernels; the
    name keeps that limit) runs every D in 1025..4096 at the next multiple
    of 256, no more than 1.25x D, which its module's ``kernel_dim`` gives;
    ``padded_dim`` without ``chunked`` still refuses 1025, naming the
    limit."""
    dims = PAIRS[pair]
    assert dims[-2:] == (768, 1024)
    got = {D: padded_dim(D, dims, pair, chunked=CHUNKED[pair]) for D in range(513, 1025)}
    assert set(got.values()) == {768, 1024}
    assert all(D <= Dp <= 1.5 * D for D, Dp in got.items())
    assert all(Dp == (768 if D <= 768 else 1024) for D, Dp in got.items())
    assert all(KERNEL_DIM[pair](D) == Dp for D, Dp in got.items())
    assert CHUNKED[pair]
    past = {D: padded_dim(D, dims, pair, chunked=True) for D in range(1025, 4097)}
    assert all(Dp % 256 == 0 and D <= Dp <= 1.25 * D and Dp - D < 256 for D, Dp in past.items())
    assert past[1025] == 1280 and past[1100] == 1280 and past[2048] == 2048 and past[4096] == 4096
    assert all(past[D] == KERNEL_DIM[pair](D) == fused_ce.kernel_dim(D) for D in past)
    with pytest.raises(ValueError, match=rf"{pair}: the kernels take D <= 1024 .*got D=1025"):
        padded_dim(1025, dims, pair, chunked=False)


# The kernels' block shapes by width (csrc/ce.cu ce_lse_plan, csrc/ce_bwd.cu
# ce_bwd_plan, csrc/sampled.cu sampled_plan; chip_smoke.py holds the Python
# mirrors to them on the card). Past 512 a streamed tile arrives in chunks of
# 256 columns; the ring takes as many 32 KB stages as fit 232,448 bytes
# beside 64 resident rows (and, in the backward, the hold's chunk); a B8 or
# B10 block sums one range of 256 output columns. Past 1024 the resident
# rows' chunk rides each stage beside the tile's (64 KB): 3 stages, every
# width, for all four kernels.
CE_LSE_PLANS = {32: (256, 4, 32), 128: (256, 4, 128), 192: (256, 4, 192), 256: (128, 4, 256), 384: (128, 2, 384),
                512: (64, 2, 512), 768: (64, 4, 256), 1024: (64, 3, 256), 1280: (64, 3, 256), 2048: (64, 3, 256),
                4096: (64, 3, 256)}
CE_BWD_PLANS = {32: (128, 4, 1, 32), 128: (128, 4, 1, 128), 192: (128, 4, 1, 192), 256: (128, 4, 1, 256),
                384: (64, 2, 2, 384), 512: (64, 2, 2, 512), 768: (64, 3, 3, 256), 1024: (64, 2, 4, 256),
                1280: (64, 3, 5, 256), 2048: (64, 3, 8, 256), 4096: (64, 3, 16, 256)}
SAMPLED_PLANS = {64: (256, 4, 64, 128, 4, 1, 64), 128: (256, 4, 128, 128, 4, 1, 128),
                 256: (128, 4, 256, 128, 4, 1, 256), 512: (64, 2, 512, 64, 2, 2, 512),
                 768: (64, 3, 256, 64, 3, 3, 256), 1024: (64, 3, 256, 64, 2, 4, 256),
                 1280: (64, 3, 256, 64, 3, 5, 256), 2048: (64, 3, 256, 64, 3, 8, 256),
                 4096: (64, 3, 256, 64, 3, 16, 256)}


@pytest.mark.parametrize("D", [32, 128, 192, 256, 384, 512, 600, 768, 1000, 1024, 1280, 2048, 4096])
def test_block_plans_match_the_table(D):
    """``lse_plan``, ``bwd_plan`` and ``fused_sampled.plan`` at each width,
    a width the kernels run padded (600, 1000) taking its padded width's
    plan; past 1024 (where the sampled pair had none before its streamed
    kernels) both pairs' streamed plans."""
    Dc = fused_ce.kernel_dim(D)
    assert fused_ce.lse_plan(D) == CE_LSE_PLANS[Dc] and fused_ce.lse_plan(D)[0] == fused_ce.lse_rows(D)
    assert fused_ce.bwd_plan(D) == CE_BWD_PLANS[Dc]
    Ds = fused_sampled.kernel_dim(D)
    assert fused_sampled.plan(D) == SAMPLED_PLANS[Ds]
    if Dc > 512:  # column ranges of 256 cover the width; the chunks tile it
        rows, stages, ranges, cols = fused_ce.bwd_plan(D)
        assert ranges * cols == Dc and Dc % fused_ce.lse_plan(D)[2] == 0 and 2 <= stages <= 4
    if Ds > 512:
        _, fwd_stages, chunk, _, bwd_stages, ranges, cols = fused_sampled.plan(D)
        assert ranges * cols == Ds and Ds % chunk == 0 and 2 <= fwd_stages <= 4 and 2 <= bwd_stages <= 4


@pytest.mark.parametrize("D", [1100, 1280, 2048])
def test_sampled_past_1024_matches_pallas_interpret(D):
    """B9/B10's dispatch past 1024 (1100 runs at 1280 on the streamed
    kernels; 1280 and 2048 at themselves): the plain forward and backward at
    ``kernel_dim(D)`` on zero-padded operands, as the CUDA wrappers run
    them, and the CPU wrapper at D itself, against ``sampled_nll_rows`` of
    the reference at D in interpret mode, which checks no width
    (``tests/test_torch_widths.py``'s ``_sampled_against_pallas``: the loss
    and all four cotangents at ``REL_TOL``, accidental hits on most rows)."""
    Dp = fused_sampled.kernel_dim(D)
    assert Dp == {1100: 1280, 1280: 1280, 2048: 2048}[D]
    _sampled_against_pallas(D, Dp)


def _leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(v, np.float32)) for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _moments_and_params_close(got_adam, want_adam, got_params, want_params, lr, eps_regime: bool = False):
    """``tests/test_torch_wide.py``'s bounds: the first moment to 1% of each
    tensor's largest, the second to 2%, the params to 1e-6 where the moment
    is clear of the bf16 noise, else within 2 lr.

    ``eps_regime``: a first step whose gradients reach Adam's eps (config
    #4's attention projections wq and wk at D = 2048: |g| <= 9.5e-8, so its
    clear elements have |g| of a few eps). There the update lr g / (|g| +
    eps) moves with the gradient's size, not only its sign, and the clear
    elements' params are held to 1e-6 plus what the two packages' measured
    gradients allow: for g1, g2 of one sign, |u(g1) - u(g2)| <= lr eps |g1 -
    g2| / (min |g| + eps)^2, each g the first moment over 1 - b1 (a clear
    element whose two gradients differ in sign fails it)."""
    for which, tol in (("mu", 1e-2), ("nu", 2e-2)):
        for (name, a), (_, b) in zip(_leaves(got_adam[which]), _leaves(want_adam[which])):
            assert np.abs(a - b).max() <= tol * (np.abs(b).max() + 1e-30), (which, name)
    for (name, a), (_, b), (_, mu), (_, got_mu) in zip(_leaves(got_params), _leaves(want_params),
                                                       _leaves(want_adam["mu"]), _leaves(got_adam["mu"])):
        diff = np.abs(a - b)
        clear = np.abs(mu) > 0.05 * np.abs(mu).max()
        tol = np.full_like(diff, 1e-6)
        if eps_regime:
            g = np.minimum(np.abs(mu), np.abs(got_mu)) / (1 - ADAM_B1)
            tol += lr * ADAM_EPS * (np.abs(mu - got_mu) / (1 - ADAM_B1)) / (g + ADAM_EPS) ** 2
        assert (diff[clear] <= tol[clear]).all(), name
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
    _attention_step_matches_jax(ATTN_SETS, 1024)


def _attention_step_matches_jax(sets: dict, width: int, eps_regime: bool = False) -> None:
    """``test_wider_attention_trainer_step_matches_jax``'s step and bounds
    on config #4's model under ``sets`` (embeddings ``width`` wide;
    ``eps_regime`` as ``_moments_and_params_close``'s)."""
    cfg = get_config("attention_gowalla").with_overrides({k: str(v) for k, v in sets.items()})
    ds = load_dataset(cfg.data)
    jt = JaxTrainer(JaxConfig.from_dict(cfg.to_dict()), JaxDataDims.from_dataset(ds))
    js = jt.init_state()
    tree = jax.tree.map(np.asarray, js.params)
    pool = np.array(jax.random.randint(jax.random.fold_in(js.rng, 0), (cfg.loss.num_sampled,), 0, ds.num_pois))
    tt = Trainer(cfg, DataDims.from_dataset(ds), device="cpu", negatives=lambda step: torch.from_numpy(pool))
    batch = make_batch(ds.train, np.arange(cfg.train.batch_size))
    js2, jm = jt.step(js, batch)
    st, tm = tt.step(tt.init_state(tree), batch)
    assert tt.model.embed["poi"].shape[1] == width and st.step == 1
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-6 * float(jm["loss"])
    lazy = sparse_adam_state_to_numpy(st.opt_state)
    got = {"mu": lazy["m"], "nu": lazy["v"]}
    want = {"mu": js2.opt_state.m, "nu": js2.opt_state.v}
    assert set(flatten(got["mu"])) == set(flatten(jax.tree.map(np.asarray, want["mu"])))
    _moments_and_params_close(got, want, params_to_numpy(tt.model), js2.params, cfg.train.learning_rate, eps_regime)


# The widest bench path's model at test size: GRU H = 2048 over D = 2048
# embeddings (the widest GRU the port takes is 2,064), otherwise
# WIDER_SETS: batch 8, T = 6, bf16, 8,432 POIs, so both packages take their
# fused CE, the port's at D = 2048 on the streamed kernels on the card.
WIDEST_SETS = {**WIDER_SETS, "model.embed_dim": "2048", "model.hidden_dim": "2048"}
# Recommend: the query difference between the packages at D = 2048 (bf16
# operands, fp32 sums in other orders) under which two candidates may swap.
TIE_TOL = 1e-4


@pytest.fixture(scope="module")
def widest():
    """The model's config, data, ``poi_tpu`` trainer and init state, and the
    init params as numpy (the JAX step donates the state's buffers)."""
    cfg = get_config("smoke").with_overrides(WIDEST_SETS)
    ds = load_dataset(cfg.data)
    assert ds.num_pois >= FUSED_CE_MIN_VOCAB
    jt = JaxTrainer(JaxConfig.from_dict(cfg.to_dict()), JaxDataDims.from_dataset(ds))
    js = jt.init_state()
    return cfg, ds, jt, js, jax.tree.map(np.asarray, js.params)


def test_widest_gru_trainer_step_matches_jax(widest):
    """One ``Trainer`` step of the GRU model at D = H = 2048 from the same
    params on the same batch against ``poi_tpu``'s, at
    ``test_wider_gru_trainer_step_matches_jax``'s bounds."""
    cfg, ds, jt, js, tree = widest
    batch = make_batch(ds.train, np.arange(cfg.train.batch_size))
    js2, jm = jt.step(js, batch)

    tt = Trainer(cfg, DataDims.from_dataset(ds), device="cpu")
    st, tm = tt.step(tt.init_state(tree), batch)
    assert tt.model.embed["poi"].shape[1] == 2048 and tt.model.tower.layers[0]["wh"].shape == (2048, 6144)
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-6 * float(jm["loss"])
    want_adam = adam_state_to_numpy(adam_state_from_jax(js2.opt_state))
    _moments_and_params_close(adam_state_to_numpy(st.opt_state), want_adam, params_to_numpy(tt.model), js2.params,
                              cfg.train.learning_rate)


def test_widest_gru_recommend_matches_jax(widest):
    """``Recommender.recommend`` of the GRU model at D = H = 2048 (B11 past
    1024 on the card) against ``poi_tpu``'s with its top-k kernel in
    interpret mode, on the same params: the same ids but for near-ties, no
    visited POI."""
    cfg, ds, jt, _, tree = widest
    _recommend_matches_jax(cfg, ds, jt, tree)


def _recommend_matches_jax(cfg, ds, jt, tree) -> None:
    """``test_widest_gru_recommend_matches_jax``'s comparison on the model of
    ``cfg`` and ``poi_tpu``'s trainer ``jt``, from the init ``tree``: six
    test histories, k = 10, the visited excluded."""
    cfg = cfg.with_overrides({"eval.topk_impl": "pallas"})
    jcfg = JaxConfig.from_dict(cfg.to_dict())
    model = build_model(cfg.model, DataDims.from_dataset(ds), device="cpu")
    model.load_state_dict(params_from_jax(tree))
    ex = ds.test
    histories = []
    for i in np.linspace(0, len(ex) - 1, 6).astype(int):
        m = int(ex.mask[i].sum())
        histories.append([Checkin(poi=int(p), timestamp=float(tb) * 3600.0 + 1800.0)
                          for p, tb in zip(ex.poi_in[i, :m], ex.time_bucket[i, :m])])
    jhist = [[JaxCheckin(c.poi, c.timestamp) for c in h] for h in histories]
    want = JaxRecommender(jt.model, jax.tree.map(jnp.asarray, tree), jcfg, ds).recommend(jhist, k=10,
                                                                                          exclude_visited=True)
    rec = Recommender(model, cfg, ds)
    got = rec.recommend(histories, k=10, exclude_visited=True)
    assert got.shape == want.shape == (6, 10)
    assert (got >= 0).all() and (got < ds.num_pois).all()
    for row, hist in zip(got, histories):
        assert not set(row.tolist()) & {c.poi for c in hist} and len(set(row.tolist())) == 10
    with torch.inference_mode():
        q = model.queries_last(batch_to(rec._featurize(histories), "cpu")).double().numpy()
    table = model.embed["poi"].detach().to(torch.bfloat16).double().numpy()
    scores = torch.from_numpy(q).to(torch.bfloat16).double().numpy() @ table.T
    scores += model.embed["out_bias"].detach().double().numpy()
    rows = np.arange(len(got))[:, None]
    near = np.abs(scores[rows, got] - scores[rows, want]) < TIE_TOL
    assert ((got == want) | near).all(), (got, want)


# The widest config #4 path's model at test size: ATTN_SETS at D = H = 2048,
# B9/B10 past 1024 on their streamed kernels on the card.
WIDEST_ATTN_SETS = {**ATTN_SETS, "model.embed_dim": 2048, "model.hidden_dim": 2048}


def test_widest_attention_trainer_step_matches_jax():
    """One step of config #4's model at D = H = 2048 against ``poi_tpu``'s,
    at ``test_wider_attention_trainer_step_matches_jax``'s bounds, the
    params where the first step's gradients reach Adam's eps also by the
    update's size (``_moments_and_params_close``'s ``eps_regime``: the
    attention's wq and wk, whose clear elements moved 1.1e-6 apart, their
    first moments 3.5e-4 of the largest apart)."""
    _attention_step_matches_jax(WIDEST_ATTN_SETS, 2048, eps_regime=True)


def test_widest_attention_recommend_matches_jax():
    """``Recommender.recommend`` of config #4's model at D = H = 2048 against
    ``poi_tpu``'s with its top-k kernel in interpret mode, on the same
    params, as ``test_widest_gru_recommend_matches_jax``."""
    cfg = get_config("attention_gowalla").with_overrides({k: str(v) for k, v in WIDEST_ATTN_SETS.items()})
    ds = load_dataset(cfg.data)
    jt = JaxTrainer(JaxConfig.from_dict(cfg.to_dict()), JaxDataDims.from_dataset(ds))
    tree = jax.tree.map(np.asarray, jt.init_state().params)
    assert tree["embed"]["poi"].shape[1] == 2048
    _recommend_matches_jax(cfg, ds, jt, tree)
