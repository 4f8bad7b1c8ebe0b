"""The port's GRU recurrence (poi_tpu_torch.ops.fused_gru, models.gru) held
against the JAX package on the same numpy inputs.

The JAX side runs the Pallas kernel in interpret mode, as
tests/test_fused_gru.py runs it; the port's CPU path is the kernel's plain
PyTorch version (the CUDA kernel itself is compared with it on the card by
chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poi_tpu.models.gru import gru_layer as jax_gru_layer
from poi_tpu.ops.fused_gru import MASK_NEG as JAX_MASK_NEG
from poi_tpu.ops.fused_gru import fused_gru_scan as jax_fused_gru_scan
from poi_tpu_torch.models.gru import gru_layer
from poi_tpu_torch.ops.fused_gru import MASK_NEG, fused_gru_scan, gru_scan_reference

torch.set_num_threads(1)

# Both sides round h and wh to bf16 and sum exact products in fp32, in
# different orders, and take sigmoid/tanh from different libraries: on these
# seeds they agree to ~1e-7. 1e-5 leaves room for that drift over T steps;
# a wrong gate order, bias placement or update rule moves h by ~1e-1.
ATOL = 1e-5


def _case(B, T, D, H, seed):
    rng = np.random.default_rng(seed)
    p = {
        "wx": (rng.normal(size=(D, 3 * H)) / np.sqrt(D)).astype(np.float32),
        "wh": (rng.normal(size=(H, 3 * H)) / np.sqrt(H)).astype(np.float32),
        "b": (0.1 * rng.normal(size=3 * H)).astype(np.float32),
    }
    x = (0.5 * rng.normal(size=(B, T, D))).astype(np.float32)
    lengths = rng.integers(1, T + 1, size=B)
    lengths[0] = T  # one full row
    mask = np.arange(T)[None, :] < lengths[:, None]
    return p, x, mask


def _folded_xw(p, x, mask):
    H = p["wh"].shape[0]
    xw = (x @ p["wx"] + p["b"]).astype(np.float32)
    xw[:, :, :H] = np.where(mask[:, :, None], xw[:, :, :H], MASK_NEG)
    return xw


def test_mask_neg_matches_jax():
    assert MASK_NEG == JAX_MASK_NEG


@pytest.mark.parametrize("H", [16, 64, 20])  # 20: no multiple of 8, as the CUDA kernel's ragged last octet
def test_gru_scan_reference_matches_pallas_interpret(H):
    p, x, mask = _case(B=8, T=12, D=16, H=H, seed=H)
    xw = _folded_xw(p, x, mask)
    want = np.asarray(jax_fused_gru_scan(jnp.asarray(xw), jnp.asarray(p["wh"]), True))
    wh16 = torch.from_numpy(p["wh"]).to(torch.bfloat16)
    got = gru_scan_reference(torch.from_numpy(xw), wh16).numpy()
    m = mask[:, :, None]
    np.testing.assert_allclose(got * m, want * m, atol=ATOL, rtol=0)
    # The wrapper takes the plain version for CPU tensors.
    np.testing.assert_array_equal(fused_gru_scan(torch.from_numpy(xw), wh16).numpy(), got)


@pytest.mark.parametrize("cell_impl", ["scan", "auto"])
def test_gru_layer_matches_jax_scan(cell_impl):
    """Hoisted bf16 projection + recurrence, port vs JAX's lax.scan cell."""
    p, x, mask = _case(B=8, T=12, D=16, H=32, seed=5)
    want = np.asarray(
        jax_gru_layer({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jnp.asarray(mask),
                      jnp.bfloat16, cell_impl="scan")
    )
    got = gru_layer({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
                    torch.from_numpy(mask.astype(np.float32)), torch.bfloat16, cell_impl=cell_impl).numpy()
    m = mask[:, :, None]
    np.testing.assert_allclose(got * m, want * m, atol=ATOL, rtol=0)


def test_gru_layer_float32_matches_jax_scan():
    """compute_dtype=float32: no bf16 rounding anywhere, so the two agree to
    fp32 summation order."""
    p, x, mask = _case(B=4, T=10, D=16, H=16, seed=9)
    want = np.asarray(
        jax_gru_layer({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jnp.asarray(mask),
                      jnp.float32, cell_impl="scan")
    )
    got = gru_layer({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
                    torch.from_numpy(mask.astype(np.float32)), torch.float32, cell_impl="scan").numpy()
    m = mask[:, :, None]
    np.testing.assert_allclose(got * m, want * m, atol=1e-5, rtol=0)


def test_padded_steps_carry_through():
    """With the mask folded into z, a fully masked tail leaves h unchanged,
    bit for bit, in the port and in the JAX kernel."""
    p, x, _ = _case(B=8, T=12, D=16, H=16, seed=3)
    T = x.shape[1]
    mask = np.zeros((8, T), bool)
    mask[:, : T // 2] = True
    xw = _folded_xw(p, x, mask)
    got = fused_gru_scan(torch.from_numpy(xw), torch.from_numpy(p["wh"]).to(torch.bfloat16)).numpy()
    want = np.asarray(jax_fused_gru_scan(jnp.asarray(xw), jnp.asarray(p["wh"]), True))
    for hs in (got, want):
        for t in range(T // 2, T):
            np.testing.assert_array_equal(hs[:, t], hs[:, T // 2 - 1])


def test_gru_layer_rejects_unknown_cell_impl():
    p, x, mask = _case(B=2, T=3, D=4, H=4, seed=0)
    with pytest.raises(ValueError, match="cell_impl"):
        gru_layer({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x), None,
                  torch.bfloat16, cell_impl="cudnn")


def test_fused_gru_scan_rejects_bad_shapes():
    with pytest.raises(ValueError, match="3H"):
        fused_gru_scan(torch.zeros(2, 3, 12), torch.zeros(4, 8, dtype=torch.bfloat16))
