"""The widths the CUDA kernels are built for, and the zero columns that take
any narrower ``D`` to one of them.

A wrapper pads its inputs' last dimension with zero columns to
``padded_dim(D, its kernels' widths)``. Zero columns add nothing to a row
product ``q · eᵀ``, and the gradient columns past ``D`` are dropped, so the
result is the function at ``D``. Pure Python, so the CPU tests hold the
dispatch the card runs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def padded_dim(D: int, widths: tuple[int, ...], name: str) -> int:
    """The smallest of ``widths`` (ascending) at least ``D``; raises past
    the last, naming it."""
    for k in widths:
        if D <= k:
            return k
    raise ValueError(f"{name}: the kernels take D <= {widths[-1]} (padded with zero columns to the next width "
                     f"they are built for), got D={D}")


def pad_cols(x: torch.Tensor, width: int) -> torch.Tensor:
    """``x [R, D]`` with zero columns up to ``width``."""
    return x if x.shape[1] == width else F.pad(x, (0, width - x.shape[1]))
