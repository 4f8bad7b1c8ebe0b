"""The widths the CUDA kernels are built for, the zero columns that take any
narrower ``D`` to one of them, and the shared-memory rule of the loss
kernels' K-chunked streams past ``D = 512`` (``csrc/kchunk.cuh``).

A wrapper pads its inputs' last dimension with zero columns to
``padded_dim(D, its kernels' widths)``. Zero columns add nothing to a row
product ``q · eᵀ``, and the gradient columns past ``D`` are dropped, so the
result is the function at ``D``. Past the last width, the kernels that
stream every operand in K-chunks (B7, B8, B9, B10, B11) take any multiple of
``KCHUNK``: ``padded_dim(..., chunked=True)`` pads to the next one
(``chunked_dim``, at most 1.25× past 1024); without ``chunked`` it raises.
Pure Python, so the CPU tests hold the dispatch the card runs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def chunked_dim(D: int) -> int:
    """The width past the last built one: ``D`` padded to the next multiple
    of ``KCHUNK``."""
    return -(-D // KCHUNK) * KCHUNK


def padded_dim(D: int, widths: tuple[int, ...], name: str, chunked: bool = False) -> int:
    """The smallest of ``widths`` (ascending) at least ``D``; past the last,
    ``chunked_dim(D)`` when ``chunked`` (the kernels take every multiple of
    ``KCHUNK`` there), else raises, naming the last."""
    for k in widths:
        if D <= k:
            return k
    if chunked:
        return chunked_dim(D)
    raise ValueError(f"{name}: the kernels take D <= {widths[-1]} (padded with zero columns to the next width "
                     f"they are built for), got D={D}")


def pad_cols(x: torch.Tensor, width: int) -> torch.Tensor:
    """``x [R, D]`` with zero columns up to ``width``."""
    return x if x.shape[1] == width else F.pad(x, (0, width - x.shape[1]))


# csrc/kchunk.cuh: the loss kernels past D = 512 stream a 64-row tile as
# K-chunks of KCHUNK columns (32 KB) through a ring of 2 to 4 stages, as many
# as fit the shared memory a block may opt into on an H100; past D = 1024
# (B7-B10; B11 in csrc/topk.cu) every multiple of KCHUNK.
KCHUNK = 256
KCHUNK_ROWS = 64
SMEM_OPT_IN = 232448


def kchunk_stages(fixed: int, per_stage: int) -> int:
    """``kc_stages``: the most stages, 4 down to 2, of ``per_stage`` bytes
    beside ``fixed`` bytes and the 1,024 that align the base."""
    st = 4
    while st > 2 and 1024 + fixed + st * per_stage > SMEM_OPT_IN:
        st -= 1
    return st


def kchunk_fwd_stages(D: int, vecs: int) -> int:
    """The forward's ring (``KcFwd``): 64 resident rows and a barrier fixed;
    a stage is a chunk, ``vecs`` vectors of 64 4-byte values and two
    barriers."""
    return kchunk_stages(KCHUNK_ROWS * D * 2 + 8, KCHUNK_ROWS * KCHUNK * 2 + vecs * KCHUNK_ROWS * 4 + 16)


def kchunk_bwd_stages(D: int, vecs: int) -> int:
    """The backward's ring (``KcBwd``): 64 resident rows, the hold (a chunk
    and the tile's ``vecs`` vectors) and three barriers fixed; a stage is a
    chunk and two barriers."""
    return kchunk_stages(KCHUNK_ROWS * D * 2 + KCHUNK_ROWS * KCHUNK * 2 + vecs * KCHUNK_ROWS * 4 + 24,
                         KCHUNK_ROWS * KCHUNK * 2 + 16)


def kchunk_stream_fwd_stages(vecs: int) -> int:
    """The forward's ring past D = 1024 (``KcsFwd``), the resident rows
    streamed too: nothing fixed; a stage is their chunk and the tile's,
    ``vecs`` vectors and two barriers."""
    return kchunk_stages(0, 2 * KCHUNK_ROWS * KCHUNK * 2 + vecs * KCHUNK_ROWS * 4 + 16)


def kchunk_stream_bwd_stages(vecs: int) -> int:
    """The backward's ring past D = 1024 (``KcsBwd``): the hold (a chunk and
    the tile's ``vecs`` vectors) and two barriers fixed; a stage is the
    resident rows' chunk, the tile's and two barriers."""
    return kchunk_stages(KCHUNK_ROWS * KCHUNK * 2 + vecs * KCHUNK_ROWS * 4 + 16, 2 * KCHUNK_ROWS * KCHUNK * 2 + 16)
