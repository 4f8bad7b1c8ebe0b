"""LSTM tower with the user embedding, paired with BPR in config #2;
counterpart of ``poi_tpu/models/lstm.py``.

Layout kept from the JAX package: ``wx [D, 4H]``, ``wh [H, 4H]``, one bias
``b [4H]`` on the input side (the forget block starting at 1.0), gate columns
ordered i | f | g | o, params under ``tower.layers.<i>.{wx, wh, b}``. The user
vector is added to the scoring query by ``base.add_user_query``.
"""

from __future__ import annotations

import torch
from torch import nn

from poi_tpu_torch.models import base
from poi_tpu_torch.models.gru import CELL_IMPLS
from poi_tpu_torch.ops.fused_lstm import fused_lstm, lstm_scan_reference


def init_lstm_layer(gen: torch.Generator, d_in: int, d_h: int) -> dict[str, torch.Tensor]:
    b = torch.zeros(4 * d_h)
    b[d_h:2 * d_h] = 1.0  # forget-gate bias starts at 1.0
    return {
        "wx": (1.0 / d_in) ** 0.5 * torch.randn(d_in, 4 * d_h, generator=gen),
        "wh": (1.0 / d_h) ** 0.5 * torch.randn(d_h, 4 * d_h, generator=gen),
        "b": b,
    }


def lstm_layer(p, x: torch.Tensor, mask: torch.Tensor, dtype: torch.dtype, cell_impl: str = "auto") -> torch.Tensor:
    """[B, T, D] → [B, T, H].

    ``cell_impl`` ``auto`` (with bf16) and ``pallas`` run the recurrence
    through ``fused_lstm``: the CUDA kernels forward and backward on a CUDA
    tensor, their plain versions on a CPU tensor. ``scan`` (or ``auto`` with
    fp32) runs the plain forward under autograd, the oracle.
    """
    if cell_impl not in CELL_IMPLS:
        raise ValueError(f"unknown cell_impl {cell_impl!r}: have {CELL_IMPLS}")
    # Hoisted input projection: one large product for all timesteps.
    xw = base.matmul_fp32(x, p["wx"], dtype) + p["b"]  # [B, T, 4H] fp32
    wh = p["wh"].to(dtype)
    if cell_impl == "pallas" or (cell_impl == "auto" and dtype == torch.bfloat16):
        return fused_lstm(xw, mask, wh)
    return lstm_scan_reference(xw, mask, wh)[0]


class LSTMTower(nn.Module):
    """Stacked LSTM layers; params under ``layers.<i>.{wx, wh, b}``."""

    def __init__(self, cfg, gen: torch.Generator, device=None):
        super().__init__()
        self.cfg = cfg
        layers = []
        d_in = cfg.embed_dim
        for _ in range(cfg.num_layers):
            layers.append(base.params(init_lstm_layer(gen, d_in, cfg.hidden_dim), device))
            d_in = cfg.hidden_dim
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor, batch) -> torch.Tensor:
        dtype = base.compute_dtype(self.cfg)
        h = x
        for p in self.layers:
            h = lstm_layer(p, h, batch.mask, dtype, cell_impl=self.cfg.cell_impl)
        return h


class LSTMModel(base.SequenceModel):
    """LSTM tower; 128-d with the user embedding in config #2."""

    def build_tower(self, gen: torch.Generator, device) -> nn.Module:
        return LSTMTower(self.cfg, gen, device)
