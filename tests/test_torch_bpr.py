"""The port's BPR objective (poi_tpu_torch.train.losses: bpr_loss,
draw_bpr_negatives, the bpr branch of build_loss_fn, and the trainer's draw)
held against poi_tpu's bpr_loss on the same inputs and the same negatives.

poi_tpu's bpr_loss draws its negatives inside, with
jax.random.randint(rng, (B, T, N), 0, V); the test draws the same ids with
that key and hands them to the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poi_tpu.train.losses import bpr_loss as jax_bpr_loss
from poi_tpu.train.losses import draw_bpr_negatives as jax_draw_bpr_negatives
from poi_tpu_torch.configs.presets import get_config
from poi_tpu_torch.data.pipeline import Batch
from poi_tpu_torch.models.base import DataDims
from poi_tpu_torch.train import sparse_opt
from poi_tpu_torch.train.losses import bpr_loss, build_loss_fn, draw_bpr_negatives
from poi_tpu_torch.train.loop import NEGATIVES_STREAM, Trainer
from poi_tpu_torch.utils.config import LossConfig

torch.set_num_threads(1)

# Both sides compute the pairwise scores in fp32 (dot products of D terms) and
# log-sigmoid in fp32; they differ in summation order only: ~1e-7 relative.
LOSS_TOL = 1e-6
# Gradients relative to each tensor's largest element: the same fp32
# arithmetic, with the duplicate-id sums of the gathers' backward in another
# order.
GRAD_TOL = 1e-5


def _case(B=4, T=6, N=8, D=16, V=20, seed=0):
    """A small catalog so that negatives collide with the positive; a ragged
    mask."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, T, D)).astype(np.float32)
    table = (0.3 * rng.normal(size=(V, D))).astype(np.float32)
    bias = (0.1 * rng.normal(size=V)).astype(np.float32)
    targets = rng.integers(0, V, size=(B, T)).astype(np.int32)
    lengths = rng.integers(1, T + 1, size=B)
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    key = jax.random.key(seed + 11)
    neg = np.array(jax_draw_bpr_negatives(key, B, T, N, V))
    return q, table, bias, targets, mask, key, neg


@pytest.mark.parametrize("seed", [0, 1])
def test_bpr_loss_and_grads_match_jax_on_replayed_negatives(seed):
    q, table, bias, targets, mask, key, neg = _case(seed=seed)
    N, V = neg.shape[-1], table.shape[0]
    assert (neg == targets[..., None]).any(), "the case should hold collisions"

    def jloss(qq, tt, bb):
        return jax_bpr_loss(qq, tt, bb, jnp.asarray(targets), jnp.asarray(mask), key, N, V)

    want, (gq, gt, gb) = jax.value_and_grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(table),
                                                                       jnp.asarray(bias))
    qt, tt, bt = (torch.from_numpy(a).requires_grad_() for a in (q, table, bias))
    got = bpr_loss(qt, tt, bt, torch.from_numpy(targets).long(), torch.from_numpy(mask), torch.from_numpy(neg).long())
    assert abs(got.item() - float(want)) <= LOSS_TOL * abs(float(want))
    got.backward()
    for g, w, name in ((qt.grad, gq, "dq"), (tt.grad, gt, "dtable"), (bt.grad, gb, "dbias")):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy() / np.abs(w).max(), w / np.abs(w).max(), atol=GRAD_TOL, rtol=0,
                                   err_msg=name)


def test_bpr_mean_is_over_valid_pairs():
    """Pairs whose negative is the positive, and padded positions, are out of
    the mean: the loss equals the mean of -log σ over the remaining pairs."""
    q, table, bias, targets, mask, _, neg = _case(seed=2)
    args = [torch.from_numpy(a) for a in (q, table, bias)]
    t, m, n = torch.from_numpy(targets).long(), torch.from_numpy(mask), torch.from_numpy(neg).long()
    got = float(bpr_loss(*args, t, m, n))
    s_pos = (q * table[targets]).sum(-1) + bias[targets]
    s_neg = np.einsum("btd,btnd->btn", q, table[neg]) + bias[neg]
    ok = (neg != targets[..., None]) & (mask[..., None] > 0)
    want = np.log1p(np.exp(-(s_pos[..., None] - s_neg)))[ok].mean()
    assert got == pytest.approx(float(want), rel=1e-5)
    # A padded position's targets and negatives change nothing.
    b = int(np.flatnonzero(mask.sum(1) < mask.shape[1])[0])
    t2, n2 = t.clone(), n.clone()
    t2[b, -1], n2[b, -1] = 0, 1
    assert float(bpr_loss(*args, t2, m, n2)) == got


def test_build_loss_fn_takes_bpr():
    assert build_loss_fn(LossConfig(kind="bpr", num_negatives=32), 100) is bpr_loss


def test_trainer_draws_bpr_negatives_once_a_step_for_loss_and_lazy_adam():
    """[B, T, N] ids in [0, V) from the step's generator: the same step draws
    the same ids, another step others; the touched rows of lazy Adam (BPR
    with table_update=sparse is legal) hold every one of them."""
    cfg = get_config("lstm_bpr_foursquare").with_overrides({"loss.num_negatives": "5", "model.embed_dim": "8",
                                                              "model.hidden_dim": "8"})
    dims = DataDims(num_users=7, num_pois=50, num_time_buckets=4, num_geo_buckets=4, num_tgap_buckets=2,
                    num_dist_buckets=2)
    tt = Trainer(cfg, dims, device="cpu")
    batch = Batch(*(torch.zeros(3, 6, dtype=torch.long) for _ in range(10)))
    a, b, c = tt.draw_negatives(4, batch), tt.draw_negatives(4, batch), tt.draw_negatives(5, batch)
    assert a.shape == (3, 6, 5) and int(a.min()) >= 0 and int(a.max()) < 50
    assert torch.equal(a, b) and not torch.equal(a, c)
    want = draw_bpr_negatives(torch.Generator().manual_seed(0), 3, 6, 5, 50, "cpu")
    assert want.shape == a.shape and want.dtype == a.dtype
    sparse_cfg = cfg.with_overrides({"train.table_update": "sparse"})
    sparse_opt.validate_config(sparse_cfg)
    ids = sparse_opt.touched_ids(batch._replace(user=torch.zeros(3, dtype=torch.long)), a)
    assert set(a.reshape(-1).tolist()) <= set(ids["poi"].tolist())
    assert tt.generator(4, NEGATIVES_STREAM) is tt.generator(5, NEGATIVES_STREAM)  # one generator, re-keyed a step
