"""ST-RNN tower (config #3), counterpart of ``poi_tpu/models/strnn.py``:

    h_t = tanh( T(dt_t) @ S(dd_t) @ x_t  +  C @ h_{t-1}  + b )

``T(dt)`` and ``S(dd)`` are D×D matrices interpolated linearly between
learned bucket-endpoint matrices by the time gap and the distance since the
previous check-in; the loader precomputes each step's (lower bucket,
fraction) pair (``data/dataset.py:bucketize_interp``). As in the JAX package
every endpoint matrix is applied to the inputs in one product over the whole
batch and the two relevant results are interpolated, all outside the
recurrence, which is then the plain RNN of ``ops/fused_rnn.py``.

Params under ``tower.layer.{t_tab [Kt+1, D, D], s_tab [Kd+1, D, D],
w_in [D, H], c [H, H], b [H]}``.
"""

from __future__ import annotations

import torch
from torch import nn

from poi_tpu_torch.models import base
from poi_tpu_torch.models.gru import CELL_IMPLS
from poi_tpu_torch.ops.fused_rnn import fused_rnn, rnn_scan_reference


def apply_interpolated(tables: torch.Tensor, x: torch.Tensor, idx: torch.Tensor, frac: torch.Tensor,
                       dtype: torch.dtype) -> torch.Tensor:
    """y[b, t] = lerp(tables[idx], tables[idx + 1], frac) @ x[b, t].

    tables [K+1, D, D] endpoint matrices (applied as x @ Mᵀ), x [B, T, D],
    idx [B, T] in [0, K-1], frac [B, T] in [0, 1]. One product applies every
    endpoint ([B, T, K+1, D], operands rounded to ``dtype``, fp32 sums); then
    a gather of ``idx`` and ``idx + 1`` along K and the lerp.
    """
    all_applied = torch.einsum("btd,ked->btke", x.to(dtype).float(), tables.to(dtype).float())
    B, T, _, E = all_applied.shape
    at = idx.long()[:, :, None, None].expand(B, T, 1, E)
    lo = torch.gather(all_applied, 2, at)[:, :, 0]
    hi = torch.gather(all_applied, 2, at + 1)[:, :, 0]
    w = frac.float()[:, :, None]
    return (1.0 - w) * lo + w * hi


def init_strnn_layer(gen: torch.Generator, d: int, h: int, k_time: int, k_dist: int) -> dict[str, torch.Tensor]:
    # Endpoint matrices near the identity, so early training behaves like a vanilla RNN.
    eye = torch.eye(d)
    return {
        "t_tab": eye[None] + 0.02 * torch.randn(k_time + 1, d, d, generator=gen),
        "s_tab": eye[None] + 0.02 * torch.randn(k_dist + 1, d, d, generator=gen),
        "w_in": (1.0 / d) ** 0.5 * torch.randn(d, h, generator=gen),
        "c": (1.0 / h) ** 0.5 * torch.randn(h, h, generator=gen),
        "b": torch.zeros(h),
    }


class STRNNTower(nn.Module):
    """One ST-RNN layer; params under ``layer.{t_tab, s_tab, w_in, c, b}``."""

    def __init__(self, cfg, dims, gen: torch.Generator, device=None):
        super().__init__()
        if cfg.cell_impl not in CELL_IMPLS:
            raise ValueError(f"unknown cell_impl {cfg.cell_impl!r}: have {CELL_IMPLS}")
        self.cfg = cfg
        self.layer = base.params(init_strnn_layer(gen, cfg.embed_dim, cfg.hidden_dim, dims.num_tgap_buckets,
                                                  dims.num_dist_buckets), device)

    def forward(self, x: torch.Tensor, batch) -> torch.Tensor:
        """[B, T, D] → [B, T, H]. ``cell_impl`` ``auto`` (with bf16) and
        ``pallas`` run the recurrence through ``fused_rnn``; ``scan`` (or
        ``auto`` with fp32) runs the plain forward under autograd."""
        p, cfg = self.layer, self.cfg
        dtype = base.compute_dtype(cfg)
        # The spatial transition, then the temporal one, both hoisted.
        sx = apply_interpolated(p["s_tab"], x, batch.dist_idx, batch.dist_frac, dtype)
        tsx = apply_interpolated(p["t_tab"], sx, batch.tgap_idx, batch.tgap_frac, dtype)
        xin = base.matmul_fp32(tsx, p["w_in"], dtype) + p["b"]  # [B, T, H] fp32
        c = p["c"].to(dtype)
        if cfg.cell_impl == "pallas" or (cfg.cell_impl == "auto" and dtype == torch.bfloat16):
            return fused_rnn(xin, batch.mask, c)
        return rnn_scan_reference(xin, batch.mask, c)


class STRNNModel(base.SequenceModel):
    """ST-RNN tower; 128-d, 8 time-gap and 8 distance buckets in config #3."""

    def build_tower(self, gen: torch.Generator, device) -> nn.Module:
        return STRNNTower(self.cfg, self.dims, gen, device)
