"""The grid the recurrences' grid-resident serial kernels run on
(``csrc/grid_carry.cuh``), mirrored in Python so that the wrappers' dispatch
and buffers, and the CPU tests, hold it without the card.

Past the widths a cluster holds, a kernel runs on R row groups x U unit
slices, one block an SM: block (r, u) keeps the slice of the recurrent
weight for its unit octets in shared memory. ``G`` is the weight's gate
blocks: 3 for the GRU (``fused_gru``), 4 for the LSTM (``fused_lstm``), 1
for the RNN (``fused_rnn``).
"""

from __future__ import annotations

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


def design(H: int, cluster_max: int, limit: int, refusal: str) -> str:
    """Which kernels run width ``H``: ``"cluster"`` up to ``cluster_max``,
    ``"grid"`` past it up to ``limit``; past it (or at H <= 0) raises
    ``ValueError(refusal)``."""
    if 0 < H <= cluster_max:
        return "cluster"
    if cluster_max < H <= limit:
        return "grid"
    raise ValueError(refusal)
