"""The LSTM past the grid's H = 1600 and the RNN past 3168, on the
streamed-weight kernels, held against the JAX package on the same numpy
inputs.

On the CPU the wrappers take the plain versions, which take any width; the
card runs the streamed kernels (``csrc/grid_stream.cuh``, ``lstm.cu``,
``rnn.cu``) and ``chip_smoke.py`` holds them against those plain versions
there, and the Python mirrors of their grids (``stream_shape``) against the
C side's. Here: the padded weights the streamed kernels read, the streamed
grid, the same for the three recurrences, the plain LSTM and RNN
forward and backward just past their grids (ragged) against the Pallas
kernels in interpret mode, the LSTM's plain versions summed in fp64 for fp64
inputs, and one ``Trainer`` step of config #2 and of config #3 at H = 4096,
D = 128 against ``poi_tpu``'s."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poi_tpu.ops import fused_lstm as jax_lstm
from poi_tpu.ops import fused_rnn as jax_rnn
from poi_tpu.parallel.mesh import make_mesh
from poi_tpu_torch import _build
from poi_tpu_torch.ops import fused_gru, fused_lstm, fused_rnn, grid
from poi_tpu_torch.ops.fused_lstm import lstm_bwd_reference, lstm_scan_reference
from poi_tpu_torch.ops.fused_rnn import rnn_bwd_reference, rnn_scan_reference
from poi_tpu_torch.scripts import stream_rules
from test_torch_wide_recurrences import (LSTM_ATOL, REL_TOL, RNN_ATOL, WIDE, WIDE_CONFIGS, _close, _mask, _mask_bh,
                                         wide_step_matches_jax)

torch.set_num_threads(1)


@pytest.mark.parametrize("mod, H", [(fused_lstm, 1602), (fused_rnn, 3170)], ids=["lstm", "rnn"])
def test_stream_weight_pads_each_gate_block_to_whole_octets(mod, H):
    """At H % 8 != 0 the streamed kernels read the weight with its gate
    blocks (the LSTM's i, f, g, o; the RNN's one) Hp = 8 ceil(H / 8) apart,
    zeros between; at H % 8 == 0, the weight itself."""
    G = mod.GATES
    w = torch.arange(H * G * H, dtype=torch.float32).reshape(H, G * H).to(torch.bfloat16)
    got = mod.stream_weight(w)
    Hp = -(-H // 8) * 8
    assert got.shape == (H, G * Hp) and got.is_contiguous()
    for q in range(G):
        assert torch.equal(got[:, q * Hp:q * Hp + H], w[:, q * H:(q + 1) * H])
        assert not got[:, q * Hp + H:(q + 1) * Hp].any()
    w8 = w[:H - H % 8, :G * (H - H % 8)].contiguous()
    assert mod.stream_weight(w8) is w8


# The streamed grid (ocp, U, Uc, R, rows, mt), the same for the three
# recurrences' gate counts: the LSTM's at config #2's widest-H shapes (train
# at B = 64, serving at 1 and 256), ragged just past its grid and at H =
# 8192, the RNN's at config #3's, at serving batch 1 and just past its grid,
# and the GRU's at the widest-H bench path's (the values of
# tests/test_torch_wide.py's test_stream_shape). The LSTM's pass of 128 rows
# at 8-octet slices holds 4 x 2 x 4 x 4 = 128 fp32 accumulators a thread,
# and is taken all the same (grid_stream.cuh says why).
@pytest.mark.parametrize("mod, B, H, bwd, want", [
    (fused_lstm, 64, 4096, False, (4, 128, 128, 1, 64, 2)),   # config #2 at H = 4096: one pass of 64 rows
    (fused_lstm, 64, 4096, True, (8, 64, 64, 2, 32, 1)),      # its carry: two row groups of 32
    (fused_lstm, 1, 4096, False, (4, 128, 128, 1, 16, 1)),    # serving at batch 1
    (fused_lstm, 256, 4096, False, (8, 64, 64, 2, 128, 4)),   # serving at batch 256: one pass of 128
    (fused_lstm, 24, 1601, True, (8, 26, 26, 2, 16, 1)),      # ragged, just past the grid
    (fused_lstm, 8, 8192, False, (4, 256, 132, 1, 16, 1)),    # 256 slices on 132 blocks
    (fused_rnn, 64, 4096, False, (4, 128, 128, 1, 64, 2)),    # config #3 at H = 4096
    (fused_rnn, 64, 4096, True, (8, 64, 64, 2, 32, 1)),
    (fused_rnn, 1, 4096, True, (8, 64, 64, 1, 16, 1)),        # serving at batch 1 (the carry's grid)
    (fused_rnn, 24, 3169, False, (4, 100, 100, 1, 32, 1)),    # ragged, just past the grid
    (fused_rnn, 256, 4096, False, (8, 64, 64, 2, 128, 4)),    # serving at batch 256: one pass of 128
    (fused_gru, 512, 4096, False, (8, 64, 64, 2, 256, 4)),    # the GRU's, as before
    (fused_gru, 512, 4096, True, (16, 32, 32, 4, 128, 2)),
], ids=lambda v: getattr(v, "__name__", str(v)).rsplit(".", 1)[-1])
def test_stream_shape_is_the_same_for_every_gate_count(mod, B, H, bwd, want):
    got = mod.stream_shape(B, H, bwd)
    assert got == want == grid.stream_shape(B, H, bwd)
    assert all(m.stream_shape(B, H, bwd) == want for m in (fused_gru, fused_lstm, fused_rnn))
    ocp, U, Uc, R, rows, mt = got
    assert Uc * R <= grid.SMS and R * rows >= B and (R - 1) * rows < max(B, 1) and U * ocp >= -(-H // 8)
    assert rows <= 32 * mt or rows > (64 if bwd else 128)  # one pass where the group's rows fit one


def test_stream_rules_script_finds_each_rule_and_needs_a_card():
    """``scripts/stream_rules.py`` times each of grid_stream.cuh's two
    measured rules against a build with the rule's one line replaced: each
    line is there exactly once and its alternative is not, and every case
    names a recurrence the script drives. Without a card it exits 2 before
    building anything."""
    text = (_build.CSRC / "grid_stream.cuh").read_text()
    assert set(stream_rules.VARIANTS) == set(stream_rules.CASES)
    for rule, other in stream_rules.VARIANTS.values():
        assert text.count(rule) == 1 and other not in text
    assert all(kind in stream_rules.GATES for cases in stream_rules.CASES.values() for kind, *_ in cases)
    assert stream_rules.main([]) == 2

def _held(hs, hs_j, mask):
    """Each row's valid steps up to the first step whose bf16 carry parts in
    the two chains (included): the two sum the recurrent product in other
    orders, and past the grids' widths an h within that of a bf16 rounding
    boundary turns up, after which a row's chains take different bf16
    carries (tests/test_torch_gru_stream.py's rule; at the RNN's H = 3170
    here one row's carries part at step 0). Rows are independent, so each is
    held until its own first such step, and at least half the valid steps
    are held."""
    T = mask.shape[1]
    carry = lambda h: torch.from_numpy(np.ascontiguousarray(h)).to(torch.bfloat16).float().numpy()  # noqa: E731
    parted = (carry(hs) != carry(hs_j)).any(axis=2)
    first = np.where(parted.any(axis=1), parted.argmax(axis=1), T - 1)
    held = (mask > 0) & (np.arange(T)[None, :] <= first[:, None])
    assert held[:, 0].all() and held.sum() >= 0.5 * (mask > 0).sum()
    return held


def test_lstm_plain_versions_past_the_grid_match_pallas_interpret():
    """``lstm_scan_reference`` and ``lstm_bwd_reference`` at H = 1602
    (ragged, past the grid's 1600: the streamed design on the card) against
    the reference's kernels in interpret mode and their ``jax.vjp``, at
    ``LSTM_ATOL`` and ``REL_TOL``: hs and cs at each row's valid steps up to
    its first parted bf16 carry (``_held``), both carries exact through the
    padding. The backward takes the reference's hs and cs (its ``vjp``
    keeps its own forward's), so both differentiate one trajectory: dxw,
    dwh, dxw exactly 0 on padded steps. The CPU wrappers are the plain
    versions."""
    H, T, B = 1602, 4, 8
    assert fused_lstm.design(H) == "stream"
    rng = np.random.default_rng(H)
    xw = rng.normal(size=(B, T, 4 * H)).astype(np.float32)
    wh = (rng.normal(size=(H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    mask = _mask(rng, B, T)
    dhs = rng.normal(size=(B, T, H)).astype(np.float32)
    mask_bh = _mask_bh(mask, H)
    _, res = jax_lstm._fwd(jnp.asarray(xw), mask_bh, jnp.asarray(wh), True, None)
    hs_j, cs_j = (np.swapaxes(np.array(a), 0, 1) for a in res[3:5])
    _, vjp = jax.vjp(lambda a, w: jax_lstm.fused_lstm_scan(a, mask_bh, w, True), jnp.asarray(xw), jnp.asarray(wh))
    dxw_j, dwh_j = vjp(jnp.asarray(dhs))
    m = torch.from_numpy(mask)
    wh16 = torch.from_numpy(wh).to(torch.bfloat16)
    hs, cs = lstm_scan_reference(torch.from_numpy(xw), m, wh16)
    held = _held(hs.numpy(), hs_j, mask)
    np.testing.assert_allclose(hs.numpy()[held], hs_j[held], atol=LSTM_ATOL, rtol=0)
    np.testing.assert_allclose(cs.numpy()[held], cs_j[held], atol=LSTM_ATOL, rtol=0)
    for b in range(B):
        n = int(mask[b].sum())
        assert torch.equal(hs[b, n:], hs[b, n - 1].expand_as(hs[b, n:]))
        assert torch.equal(cs[b, n:], cs[b, n - 1].expand_as(cs[b, n:]))
    hs_r, cs_r = torch.from_numpy(hs_j), torch.from_numpy(cs_j)
    dxw, dwh = lstm_bwd_reference(torch.from_numpy(xw), m, wh16, hs_r, cs_r, torch.from_numpy(dhs))
    _close(dxw, dxw_j, REL_TOL, "dxw")
    _close(dwh, dwh_j, REL_TOL, "dwh")
    assert (dxw.numpy()[mask == 0] == 0).all()
    got = fused_lstm.fused_lstm_scan(torch.from_numpy(xw), m, wh16)
    assert torch.equal(got[0], hs) and torch.equal(got[1], cs)
    got = fused_lstm.fused_lstm_bwd(torch.from_numpy(xw), m, wh16, hs_r, cs_r, torch.from_numpy(dhs))
    assert torch.equal(got[0], dxw) and torch.equal(got[1], dwh)


def test_rnn_plain_versions_past_the_grid_match_pallas_interpret():
    """``rnn_scan_reference`` and ``rnn_bwd_reference`` at H = 3170 (ragged,
    past the grid's 3168) against the reference's kernels in interpret mode
    and their ``jax.vjp``, at ``RNN_ATOL`` and ``REL_TOL``: hs at each row's
    valid steps up to its first parted bf16 carry (``_held``), h exact
    through the padding; the backward on the reference's hs: dxin, dC, dxin
    exactly 0 on padded steps. The CPU wrappers are the plain versions."""
    H, T, B = 3170, 4, 8
    assert fused_rnn.design(H) == "stream"
    rng = np.random.default_rng(H + 1)
    xin = (0.8 * rng.normal(size=(B, T, H))).astype(np.float32)
    c = (rng.normal(size=(H, H)) / np.sqrt(H)).astype(np.float32)
    mask = _mask(rng, B, T)
    dhs = rng.normal(size=(B, T, H)).astype(np.float32)
    mask_bh = _mask_bh(mask, H)
    hs_j, vjp = jax.vjp(lambda a, w: jax_rnn.fused_rnn_scan(a, mask_bh, w, True), jnp.asarray(xin), jnp.asarray(c))
    dxin_j, dc_j = vjp(jnp.asarray(dhs))
    hs_j = np.array(hs_j)
    m = torch.from_numpy(mask)
    c16 = torch.from_numpy(c).to(torch.bfloat16)
    hs = rnn_scan_reference(torch.from_numpy(xin), m, c16)
    held = _held(hs.numpy(), hs_j, mask)
    np.testing.assert_allclose(hs.numpy()[held], hs_j[held], atol=RNN_ATOL, rtol=0)
    for b in range(B):
        n = int(mask[b].sum())
        assert torch.equal(hs[b, n:], hs[b, n - 1].expand_as(hs[b, n:]))
    hs_r = torch.from_numpy(hs_j)
    dxin, dc = rnn_bwd_reference(torch.from_numpy(xin), m, c16, hs_r, torch.from_numpy(dhs))
    _close(dxin, dxin_j, REL_TOL, "dxin")
    _close(dc, dc_j, REL_TOL, "dC")
    assert (dxin.numpy()[mask == 0] == 0).all()
    assert torch.equal(fused_rnn.fused_rnn_scan(torch.from_numpy(xin), m, c16), hs)
    got = fused_rnn.fused_rnn_bwd(torch.from_numpy(xin), m, c16, hs_r, torch.from_numpy(dhs))
    assert torch.equal(got[0], dxin) and torch.equal(got[1], dc)


@pytest.mark.parametrize("H", [96, 1602])
def test_lstm_plain_versions_sum_in_fp64_for_fp64_inputs(H):
    """The card's held checks measure B3/B4 and their fp32 plain versions
    against the same plain versions summed in fp64 (an fp64 ``xw``; h still
    rounded to ``wh``'s bf16 before the product), as
    ``test_rnn_plain_versions_sum_in_fp64_for_fp64_inputs`` does for the
    RNN: they return fp64; the fp32 backward is within ``REL_TOL`` of them,
    and the forward within ``LSTM_ATOL`` (an fp32 sum that lands across a
    bf16 rounding boundary of h moves later steps)."""
    rng = np.random.default_rng(H)
    B, T = 4, 5
    xw = torch.from_numpy(rng.normal(size=(B, T, 4 * H)).astype(np.float32))
    wh = torch.from_numpy((rng.normal(size=(H, 4 * H)) / np.sqrt(H)).astype(np.float32)).to(torch.bfloat16)
    mask = torch.from_numpy(_mask(rng, B, T))
    dhs = torch.from_numpy(rng.normal(size=(B, T, H)).astype(np.float32))
    (hs32, cs32), (hs64, cs64) = lstm_scan_reference(xw, mask, wh), lstm_scan_reference(xw.double(), mask, wh)
    assert hs32.dtype == cs32.dtype == torch.float32 and hs64.dtype == cs64.dtype == torch.float64
    assert float((hs32.double() - hs64).abs().max()) < LSTM_ATOL
    assert float((cs32.double() - cs64).abs().max()) < LSTM_ATOL
    (dx32, dw32), (dx64, dw64) = (lstm_bwd_reference(xw, mask, wh, hs32, cs32, dhs),
                                  lstm_bwd_reference(xw.double(), mask, wh, hs32, cs32, dhs))
    assert dx64.dtype == dw64.dtype == torch.float64
    _close(dx32, dx64.numpy(), REL_TOL, "dxw")
    _close(dw32, dw64.numpy(), REL_TOL, "dwh")


# Configs #2 and #3 at the widest-H paths' width (H = 4096 over their own D
# = 128, so the hidden-to-embedding projection runs) on WIDE_CONFIGS' small
# data, otherwise WIDE (batch 8, T = 6, fp32). poi_tpu's step runs on one of
# the 8 fake CPU devices, as tests/test_torch_gru_stream.py's at 4096.
WIDEST_H = {**WIDE, "model.embed_dim": "128", "model.hidden_dim": "4096"}


@pytest.mark.parametrize("config", list(WIDE_CONFIGS))
def test_widest_h_trainer_step_matches_jax(config):
    """One ``Trainer`` step of config #2 or #3 at H = 4096, D = 128 against
    ``poi_tpu``'s at ``test_wide_trainer_step_matches_jax``'s bounds: the
    loss, the Adam moments and the params; the recurrence the streamed
    design on the card."""
    assert fused_lstm.design(4096) == fused_rnn.design(4096) == "stream"
    wide_step_matches_jax(config, WIDEST_H, 4096, mesh=make_mesh(data=1, model=1, devices=np.array(jax.devices()[:1])))
