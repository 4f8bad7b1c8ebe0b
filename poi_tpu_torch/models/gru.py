"""GRU next-POI tower (config #1), counterpart of ``poi_tpu/models/gru.py``.

Layout kept from the JAX package (``torch.nn.GRU`` differs on every point,
so it does not hold these params): ``wx [D, 3H]``, ``wh [H, 3H]``, one bias
``b [3H]`` on the input side, gate columns ordered z | r | n, and the update
``h' = (1 - z)·h + z·n`` with ``n = tanh(xn + r·(h @ wh_n))``.
"""

from __future__ import annotations

import torch
from torch import nn

from poi_tpu_torch.models import base
from poi_tpu_torch.ops.fused_gru import MASK_NEG, fused_gru, gru_scan_reference

CELL_IMPLS = ("auto", "pallas", "scan")


def init_gru_layer(gen: torch.Generator, d_in: int, d_h: int) -> dict[str, torch.Tensor]:
    return {
        "wx": (1.0 / d_in) ** 0.5 * torch.randn(d_in, 3 * d_h, generator=gen),
        "wh": (1.0 / d_h) ** 0.5 * torch.randn(d_h, 3 * d_h, generator=gen),
        "b": torch.zeros(3 * d_h),
    }


def gru_layer(p, x: torch.Tensor, mask: torch.Tensor | None, dtype: torch.dtype, cell_impl: str = "auto") -> torch.Tensor:
    """[B, T, D] → [B, T, H].

    ``cell_impl`` ``auto`` (with bf16) and ``pallas`` run the recurrence
    through ``fused_gru``: the CUDA kernels forward and backward on a CUDA
    tensor, their plain versions on a CPU tensor. ``scan`` (or ``auto`` with
    fp32) runs the plain forward under autograd, the oracle.
    """
    if cell_impl not in CELL_IMPLS:
        raise ValueError(f"unknown cell_impl {cell_impl!r}: have {CELL_IMPLS}")
    H = p["wh"].shape[0]
    # Hoisted input projection: one large product for all timesteps.
    xw = base.matmul_fp32(x, p["wx"], dtype) + p["b"]  # [B, T, 3H] fp32
    wh = p["wh"].to(dtype)
    # Fold the padding mask into the update gate: z == 0 on padded steps
    # makes the carry pass through exactly.
    if mask is not None:
        xz = torch.where(mask[:, :, None] > 0, xw[:, :, :H], MASK_NEG)
        xw = torch.cat([xz, xw[:, :, H:]], dim=2)
    if cell_impl == "pallas" or (cell_impl == "auto" and dtype == torch.bfloat16):
        return fused_gru(xw, wh)
    return gru_scan_reference(xw, wh)


class GRUTower(nn.Module):
    """Stacked GRU layers; params under ``layers.<i>.{wx, wh, b}``."""

    def __init__(self, cfg, gen: torch.Generator, device=None):
        super().__init__()
        self.cfg = cfg
        layers = []
        d_in = cfg.embed_dim
        for _ in range(cfg.num_layers):
            layers.append(base.params(init_gru_layer(gen, d_in, cfg.hidden_dim), device))
            d_in = cfg.hidden_dim
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor, batch) -> torch.Tensor:
        dtype = base.compute_dtype(self.cfg)
        h = x
        for p in self.layers:
            h = gru_layer(p, h, batch.mask, dtype, cell_impl=self.cfg.cell_impl)
        return h


class GRUModel(base.SequenceModel):
    """Plain GRU tower; 64-d in config #1."""

    def build_tower(self, gen: torch.Generator, device) -> nn.Module:
        return GRUTower(self.cfg, gen, device)
