"""The grids the recurrences' serial kernels run on past the clusters
(``csrc/grid_carry.cuh``, ``csrc/grid_stream.cuh``), mirrored in Python so
that the wrappers' dispatch and buffers, and the CPU tests, hold them
without the card.

Past the widths a cluster holds, a kernel runs on R row groups x U unit
slices, one block an SM: block (r, u) keeps the slice of the recurrent
weight for its unit octets in shared memory (``grid_shape``). Past the
widths whose slices fit, the streamed kernels read the weight from device
memory every step through a ring of k-chunks (``stream_shape``). ``G`` is
the weight's gate blocks: 3 for the GRU (``fused_gru``), 4 for the LSTM
(``fused_lstm``), 1 for the RNN (``fused_rnn``).
"""

from __future__ import annotations

import torch

# A block's shared memory at most, the card's SMs, and a block's unit octets
# at most (kMaxSmem, kSms, kTaskOct).
MAX_SMEM = 232448
SMS = 132
TASK_OCT = 4


def slice_bytes(H: int, ocp: int, bwd: bool, G: int) -> int:
    """Shared memory of a block's slice of the weight at ``ocp`` unit octets
    (``grid_slice_bytes``): the forward's G gate columns of the octets for
    every k, ``[Hk][8 G ocp + 8]``; the backward carry's rows of the octets'
    units, ``[8 ocp][Kp + 8]`` (``Kp`` = G H rounded up to 16); bf16."""
    if bwd:
        return 8 * ocp * ((G * H + 15) // 16 * 16 + 8) * 2
    return (H + 15) // 16 * 16 * (8 * G * ocp + 8) * 2


def grid_shape(B: int, H: int, bwd: bool, G: int) -> tuple[int, int, int, int] | None:
    """The grid of the grid-resident kernel for ``B`` rows of width ``H``
    (the forward's, or with ``bwd`` the backward carry's), as
    ``grid_shape`` in ``csrc/grid_carry.cuh`` picks it: ``(ocp, U, R,
    rows)``, the most octets a block (up to 4) whose slice fits, the unit
    slices that takes, as many row groups as the other SMs hold (no more
    than the batch has 16-row tiles), and the rows a group. ``None`` where
    no grid takes ``H``."""
    if H <= 0:
        return None
    fit = [c for c in range(1, TASK_OCT + 1) if slice_bytes(H, c, bwd, G) <= MAX_SMEM]
    if not fit:
        return None
    ocp = fit[-1]
    U = (-(-H // 8) + ocp - 1) // ocp
    if U > SMS:
        return None
    tiles = -(-B // 16) if B > 0 else 1
    rmax = SMS // U
    per = -(-tiles // rmax)
    return ocp, U, -(-tiles // per), 16 * per


def max_hidden(cluster_max: int, G: int) -> int:
    """The widest H a pair of kernels takes, every narrower one with it: the
    cluster kernels up to ``cluster_max``, the grid-resident ones in both
    directions past it."""
    H = cluster_max
    while grid_shape(1, H + 1, False, G) and grid_shape(1, H + 1, True, G):
        H += 1
    return H


def stream_shape(B: int, H: int, bwd: bool) -> tuple[int, int, int, int, int, int] | None:
    """The grid of the streamed kernel for ``B`` rows of width ``H`` (the
    forward's, or with ``bwd`` the carry's), the same for every gate count,
    as ``stream_shape`` in ``csrc/grid_stream.cuh`` picks it: ``(ocp, U,
    Uc, R, rows, mt)``, octets a unit slice, unit slices, blocks a row group (``min(U, 132)``:
    a block takes slices ``c, c + Uc, ...``), row groups (as many as the
    other SMs hold, no more than the batch has 16-row tiles), rows a group,
    and ``mt`` (a block's rows go in passes of ``32 mt``). The forward takes
    slices of 4 octets where a group's rows take one pass of at most 128,
    else 8; the carry 8 where they take one pass of at most 64, else 16
    (the header says why). ``None`` at H <= 0."""
    if H <= 0:
        return None
    O, tiles = -(-H // 8), (-(-B // 16) if B > 0 else 1)
    for c in (8, 16) if bwd else (4, 8):
        U = -(-O // c)
        Uc = min(U, SMS)
        per = -(-tiles // max(1, min(SMS // Uc, tiles)))
        R, rows = -(-tiles // per), 16 * per
        if rows <= (64 if bwd else 128):
            break
    mt = 1 if rows <= 32 else 2 if bwd or rows <= 64 else 4
    return c, U, Uc, R, rows, mt


def stream_weight(w: torch.Tensor, G: int) -> torch.Tensor:
    """A recurrent weight ``[H, G H]`` as the streamed kernels read it: its
    ``G`` gate blocks ``Hp`` = 8 ceil(H / 8) apart, ``[H, G Hp]`` with zero
    columns past H in each block, so that each unit octet of a row is 16
    aligned bytes; the weight itself where H % 8 == 0."""
    H = w.shape[0]
    if H % 8 == 0:
        return w
    return torch.nn.functional.pad(w.view(H, G, H), (0, -H % 8)).reshape(H, -1)


def design(H: int, cluster_max: int, limit: int, refusal: str) -> str:
    """Which kernels run width ``H``: ``"cluster"`` up to ``cluster_max``,
    ``"grid"`` past it up to ``limit``, and ``"stream"`` past it; H <= 0
    raises ``ValueError(refusal)``."""
    if H <= 0:
        raise ValueError(refusal)
    return "cluster" if H <= cluster_max else "grid" if H <= limit else "stream"
