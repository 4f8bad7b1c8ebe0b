"""The GRU past the grid's H = 2064, on the streamed-weight kernels, held
against the JAX package on the same numpy inputs.

On the CPU the wrappers take the plain versions, which take any width; the
card runs the streamed kernels (``csrc/grid_stream.cuh``) and
``chip_smoke.py`` holds them against those plain versions there, and the
Python mirror of their grid (``fused_gru.stream_shape``) against the C
side's. Here: the padded weight the streamed kernels read, the plain GRU
forward and backward at H = 2070 (ragged, just past 2064) against the Pallas
kernels in interpret mode (the forward also one step at a time from one
bf16 carry), and one ``Trainer`` step of the bench workload's
model at H = 4096, D = 128 against ``poi_tpu``'s."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from poi_tpu.models.base import DataDims as JaxDataDims
from poi_tpu.ops.fused_gru import fused_gru_scan as jax_fused_gru_scan
from poi_tpu.parallel.mesh import make_mesh
from poi_tpu.train.loop import Trainer as JaxTrainer
from poi_tpu.utils.config import Config as JaxConfig
from poi_tpu_torch.configs.presets import get_config
from poi_tpu_torch.convert import adam_state_from_jax, adam_state_to_numpy, params_to_numpy
from poi_tpu_torch.data.dataset import load_dataset
from poi_tpu_torch.data.pipeline import make_batch
from poi_tpu_torch.models.base import DataDims
from poi_tpu_torch.ops import fused_gru
from poi_tpu_torch.ops.fused_gru import gru_bwd_reference, gru_scan_reference
from poi_tpu_torch.train.losses import FUSED_CE_MIN_VOCAB
from poi_tpu_torch.train.loop import Trainer
from test_torch_wide import ATOL, REL_TOL, _case, _close
from test_torch_wider_losses import WIDER_SETS, _moments_and_params_close

torch.set_num_threads(1)


def test_stream_weight_pads_each_gate_block_to_whole_octets():
    """At H % 8 != 0 the streamed kernels read wh with its z, r, n blocks
    Hp = 8 ceil(H / 8) apart, zeros between; at H % 8 == 0, wh itself."""
    H = 2070
    wh = torch.arange(H * 3 * H, dtype=torch.float32).reshape(H, 3 * H).to(torch.bfloat16)
    w = fused_gru.stream_weight(wh)
    Hp = 2072
    assert w.shape == (H, 3 * Hp) and w.is_contiguous()
    for q in range(3):
        assert torch.equal(w[:, q * Hp:q * Hp + H], wh[:, q * H:(q + 1) * H])
        assert not w[:, q * Hp + H:(q + 1) * Hp].any()
    wh8 = wh[:2048, :3 * 2048].contiguous()
    assert fused_gru.stream_weight(wh8) is wh8


def test_gru_plain_versions_past_the_grid_match_pallas_interpret():
    """``gru_scan_reference`` and ``gru_bwd_reference`` at H = 2070 (ragged,
    past the grid's 2064: the streamed design on the card) against the
    reference's kernels in interpret mode and their ``jax.vjp``, at
    ``test_gru_plain_versions_past_the_clusters_match_pallas_interpret``'s
    tolerances.

    The forward is held at each row's valid steps up to the first step whose
    carry rounds to another bf16 in the two chains (included): the two sum
    hw in other orders (2.5e-7 apart), and at this width an h within that of
    a bf16 rounding boundary turns up by step 1 (1 element of 16,560; 170 by
    step 5), after which a row's chains take different bf16 carries and part
    by up to 2.3e-4 by step 5. Rows are independent, so each is held until
    its own first such step. The backward takes the reference's hs in both
    packages (its ``vjp`` keeps its own forward's), so both differentiate one
    trajectory: dxw and dwh, dxw exactly 0 on padded steps. The CPU wrappers
    are the plain versions."""
    H, T = 2070, 6
    assert fused_gru.design(H) == "stream"
    xw, wh, mask, dhs = _case(8, T, H, seed=H)
    hs_j, vjp = jax.vjp(lambda a, w: jax_fused_gru_scan(a, w, True), jnp.asarray(xw), jnp.asarray(wh))
    dxw_j, dwh_j = vjp(jnp.asarray(dhs))
    hs_j = np.array(hs_j)
    wh16 = torch.from_numpy(wh).to(torch.bfloat16)
    hs = gru_scan_reference(torch.from_numpy(xw), wh16)
    carry = lambda h: torch.from_numpy(h).to(torch.bfloat16).float().numpy()  # noqa: E731
    parted = (carry(hs.numpy()) != carry(hs_j)).any(axis=2)  # [B, T]: the bf16 carries differ somewhere in the row
    first = np.where(parted.any(axis=1), parted.argmax(axis=1), T - 1)
    held = mask & (np.arange(T)[None, :] <= first[:, None])
    assert held[:, :2].sum() == mask[:, :2].sum() and held.sum() >= 0.5 * mask.sum()
    np.testing.assert_allclose(hs.numpy()[held], hs_j[held], atol=ATOL, rtol=0)
    hs_ref = torch.from_numpy(hs_j)
    dxw, dwh = gru_bwd_reference(torch.from_numpy(xw), wh16, hs_ref, torch.from_numpy(dhs))
    _close(dxw, dxw_j, REL_TOL, "dxw")
    _close(dwh, dwh_j, REL_TOL, "dwh")
    assert (dxw.numpy()[~mask] == 0).all()
    got = fused_gru.fused_gru_bwd(torch.from_numpy(xw), wh16, hs_ref, torch.from_numpy(dhs))
    assert torch.equal(got[0], dxw) and torch.equal(got[1], dwh)
    np.testing.assert_array_equal(fused_gru.fused_gru_scan(torch.from_numpy(xw), wh16).numpy(), hs.numpy())


def test_gru_plain_forward_past_the_grid_matches_pallas_step_by_step():
    """The plain forward at H = 2070 against the Pallas kernel in interpret
    mode one step at a time, every (b, t) past step 0 at ``ATOL``: both
    packages take step t from one bf16 carry, the plain chain's h(t - 1)
    rounded to bf16, so that no carry's rounding can part them (the test
    above holds each row only up to its first such parting).

    The Pallas kernel starts from h0 = 0, so each step runs as a sequence
    of two: the first sets the carry (z = sigmoid(100) = 1 exactly, n =
    tanh(atanh(c)), within a few fp32 ulps of the bf16 carry c, so that it
    rounds back to c, which is checked on both sides), the second is step
    t's own xw, padded steps included (the carry passes through)."""
    H, T, B = 2070, 6, 8
    xw, wh, mask, _ = _case(B, T, H, seed=H)
    wh16 = torch.from_numpy(wh).to(torch.bfloat16)
    to_bf16 = lambda h: torch.from_numpy(np.ascontiguousarray(h)).to(torch.bfloat16).float().numpy()  # noqa: E731
    c = to_bf16(gru_scan_reference(torch.from_numpy(xw), wh16).numpy()[:, :-1])  # [B, T - 1, H]
    first = np.zeros((B, T - 1, 3 * H), np.float32)
    first[..., :H] = 100.0
    first[..., 2 * H:] = np.arctanh(np.clip(c, -1 + 2.0 ** -30, 1 - 2.0 ** -30))
    pair = np.stack([first, xw[:, 1:]], axis=2).reshape(B * (T - 1), 2, 3 * H)
    got_j = np.array(jax_fused_gru_scan(jnp.asarray(pair), jnp.asarray(wh), True))
    got = gru_scan_reference(torch.from_numpy(pair), wh16).numpy()
    carry = c.reshape(B * (T - 1), H)
    assert np.array_equal(to_bf16(got[:, 0]), carry) and np.array_equal(to_bf16(got_j[:, 0]), carry)
    np.testing.assert_allclose(got[:, 1], got_j[:, 1], atol=ATOL, rtol=0)
    assert mask[:, 1:].sum() > 0.5 * mask[:, 1:].size


# The bench workload's model at H = 4096 (the widest-H bench path's) at test
# size: GRU H = 4096 over its own D = 128 embeddings, so the hidden-to-
# embedding projection runs, otherwise WIDER_SETS: batch 8, T = 6, bf16,
# 8,432 POIs, so both packages take their fused CE; every step a log step,
# so that both report the grad norm. poi_tpu's step runs on one of the 8 fake
# CPU devices: replicated over all 8, its state at H = 4096 held ~10 GB.
WIDEST_H_SETS = {**WIDER_SETS, "model.embed_dim": "128", "model.hidden_dim": "4096", "train.log_every": "1"}


def test_widest_h_trainer_step_matches_jax():
    """One ``Trainer`` step of the GRU model at H = 4096, D = 128 from the
    same params on the same batch against ``poi_tpu``'s: the loss to 1e-6
    relative (1.1e-7 here), the grad norm to 1e-4 relative (the trajectory
    tests' bound, tests/test_torch_train.py; 1.6e-6 here), and the Adam
    moments and the params at ``test_wider_gru_trainer_step_matches_jax``'s
    bounds. The reference's scan cell rounds the recurrent cotangent to bf16
    each step and the port's fused backward keeps it fp32, so single
    gradients differ at bf16 resolution (tests/test_torch_wide.py); the grad
    norm sums over every element."""
    cfg = get_config("smoke").with_overrides(WIDEST_H_SETS)
    ds = load_dataset(cfg.data)
    assert ds.num_pois >= FUSED_CE_MIN_VOCAB and ds.max_seq_len == 6
    jt = JaxTrainer(JaxConfig.from_dict(cfg.to_dict()), JaxDataDims.from_dataset(ds),
                    mesh=make_mesh(data=1, model=1, devices=np.array(jax.devices()[:1])))
    js = jt.init_state()
    tree = jax.tree.map(np.asarray, js.params)
    batch = make_batch(ds.train, np.arange(cfg.train.batch_size))
    js2, jm = jt.step(js, batch)

    tt = Trainer(cfg, DataDims.from_dataset(ds), device="cpu")
    st, tm = tt.step(tt.init_state(tree), batch)
    assert tt.model.tower.layers[0]["wh"].shape == (4096, 3 * 4096) and tt.model.embed["poi"].shape[1] == 128
    assert fused_gru.design(4096) == "stream"
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-6 * float(jm["loss"])
    assert float(jm["grad_norm"]) > 0
    assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= 1e-4 * float(jm["grad_norm"])
    want_adam = adam_state_to_numpy(adam_state_from_jax(js2.opt_state))
    _moments_and_params_close(adam_state_to_numpy(st.opt_state), want_adam, params_to_numpy(tt.model), js2.params,
                              cfg.train.learning_rate)
