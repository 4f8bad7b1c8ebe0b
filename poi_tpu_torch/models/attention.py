"""GRU + windowed causal attention tower (config #4), counterpart of
``poi_tpu/models/attention.py``: embeddings → GRU layer → MHA over the last
``attn_window`` positions + residual → LayerNorm.

Parameters keep the JAX package's names: ``tower.gru.{wx, wh, b}``,
``tower.mha.{wq, wk, wv, wo}`` ([H, H] each) and ``tower.ln.{scale, bias}``.
"""

from __future__ import annotations

import torch
from torch import nn

from poi_tpu_torch.models import base
from poi_tpu_torch.models.gru import gru_layer, init_gru_layer
from poi_tpu_torch.ops.attention import multihead_attention, multihead_attention_last

LN_EPS = 1e-6


def init_mha(gen: torch.Generator, d: int) -> dict[str, torch.Tensor]:
    s = (1.0 / d) ** 0.5
    return {name: s * torch.randn(d, d, generator=gen) for name in ("wq", "wk", "wv", "wo")}


def layer_norm(p, x: torch.Tensor) -> torch.Tensor:
    """fp32 LayerNorm over the last axis, eps 1e-6, population variance."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(dim=-1, keepdim=True)
    return p["scale"] * (x32 - mu) * torch.rsqrt(var + LN_EPS) + p["bias"]


class AttentionTower(nn.Module):
    # Injected by the Trainer when model.attn_impl is ring or ulysses on a
    # mesh whose model axis is > 1 (parallel.sp_attention.make_sp_attention):
    # mha(h, self.mha) in place of the local attention of the training path.
    sp_mha = None

    def __init__(self, cfg, gen: torch.Generator, device=None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_dim
        self.gru = base.params(init_gru_layer(gen, cfg.embed_dim, h), device)
        self.mha = base.params(init_mha(gen, h), device)
        self.ln = base.params({"scale": torch.ones(h), "bias": torch.zeros(h)}, device)

    def _gru(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return gru_layer(self.gru, x, mask, base.compute_dtype(self.cfg), cell_impl=self.cfg.cell_impl)

    def forward(self, x: torch.Tensor, batch) -> torch.Tensor:
        """[B, T, D] → [B, T, H] at every position."""
        cfg = self.cfg
        h = self._gru(x, batch.mask)
        if self.sp_mha is not None:
            o = self.sp_mha(h, self.mha)
        else:
            o = multihead_attention(h, self.mha, cfg.attn_heads, cfg.attn_window, base.compute_dtype(cfg))
        return layer_norm(self.ln, h + o)

    def last(self, x: torch.Tensor, batch, last: torch.Tensor) -> torch.Tensor:
        """[B, H] at position ``last`` of each row: the GRU runs over all T,
        the attention and LayerNorm only at that position. A single query
        needs no sequence split, so this path ignores ``sp_mha``."""
        cfg = self.cfg
        h = self._gru(x, batch.mask)
        o = multihead_attention_last(h, self.mha, cfg.attn_heads, cfg.attn_window, last, base.compute_dtype(cfg))
        h_last = h[torch.arange(h.shape[0], device=h.device), last]
        return layer_norm(self.ln, h_last + o)


class AttentionModel(base.SequenceModel):
    """Config #4's tower: 256-d GRU + 4-head attention over a 16-step window."""

    def build_tower(self, gen: torch.Generator, device) -> nn.Module:
        return AttentionTower(self.cfg, gen, device)

    def tower_last(self, x: torch.Tensor, batch, last: torch.Tensor) -> torch.Tensor:
        return self.tower.last(x, batch, last)
