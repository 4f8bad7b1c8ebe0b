"""Vanilla-RNN recurrence of the ST-RNN tower: the CUDA kernels of
``csrc/rnn.cu`` (forward and BPTT), their plain PyTorch versions, and the
autograd ``Function`` that ties them together.

Counterpart of ``poi_tpu/ops/fused_rnn.py``. Contract, the TPU kernels':

- ``xin [B, T, H]`` fp32: the pre-projected inputs, bias included (the
  ST-RNN's transitions are applied outside, ``models/strnn.py``).
- ``mask [B, T]``: 1 on a valid step, 0 on a padded one;
  ``h = m·tanh(xin[t] + bf16(h) @ C) + (1 - m)·h`` with fp32 sums, h0 = 0, so
  a padded step passes the carry through exactly. (The TPU kernels take the
  mask broadcast to [B, T, H]; the function is the same.)
- ``C [H, H]`` bf16. Returns ``hs [B, T, H]`` fp32.
- backward: ``dpre = dh·m·(1 - h_raw²)`` with h_raw recomputed from
  ``hs[t-1]``, ``dxin = dpre`` (exactly 0 on padded steps),
  ``dh = dh·(1 - m) + dpre @ Cᵀ`` in fp32, and ``dC = Σ h_prevᵀ · dpre`` in
  fp32.

Up to ``CLUSTER_MAX_HIDDEN`` (640) both directions run a group of batch
rows on a cluster of blocks, each block a slice of the hidden units, each
warp its octet's columns of ``C`` (forward) or ``Cᵀ`` (backward) in
registers, exchanging the group's step with every block of the cluster by
``st.async`` on mbarriers: 8 rows a group where the 8-row groups' clusters
all fit on the card at once, else 16. The forward streams ``xin`` and the
mask in by TMA and takes ``tanh`` from ``ex2.approx``; the backward
recomputes every step's ``h_raw`` at once on the tensor cores, runs the
serial carry (``dpre @ Cᵀ`` with the fp32 ``dpre`` split into three exact
bf16 products) and forms ``dC`` in fp32 on the CUDA cores. Past 640 a warp's
fragments (40 k-steps) no longer fit its registers, and both serial kernels
run on the whole card (``grid_shape``): R row groups x U unit slices, one
block an SM, each block's slice of ``C`` in its shared memory, the operand a
step needs exchanged through an L2-resident buffer behind a step barrier of
the row group (``rnn_fwd_grid``, ``rnn_bwd_grid``), up to ``MAX_HIDDEN``
(3168), the C side's ``rnn_max_hidden()``. Past it no slice of ``C`` fits a
block (33.6 MB at H = 4096), and the serial kernels read it from L2 or
device memory every step through a ring of k-chunks in shared memory, on
the same grid of row groups (``stream_shape``; ``rnn_fwd_stream``,
``rnn_bwd_stream``, whose ``dC`` sums its rows in runs). So the pair takes
any H >= 1; ``design`` is the dispatch, in Python so that the CPU tests
hold it.
"""

from __future__ import annotations

import torch

from poi_tpu_torch import _build
from poi_tpu_torch.models.base import remat_step
from poi_tpu_torch.ops import grid

# The widest H the cluster kernels take (rnn_fwd_cluster_size and
# rnn_bwd_cluster_size are 0 past it: chip_smoke.py checks both sides).
CLUSTER_MAX_HIDDEN = 640
GATES = 1  # C is one block
# The widest H of the grid-resident kernels (``rnn_max_hidden()`` in
# csrc/rnn.cu); the streamed kernels take every H past it.
MAX_HIDDEN = grid.max_hidden(CLUSTER_MAX_HIDDEN, GATES)
TAKES_H = (f"H >= 1: on a cluster of 1 to 16 blocks a group of 8 or 16 batch rows up to H = {CLUSTER_MAX_HIDDEN}, "
           f"on a grid of row groups x unit slices, one block an SM, each block's slice of C in shared memory up to "
           f"H = {MAX_HIDDEN} (rnn_max_hidden()), and past it on that grid with C streamed every step")


def grid_shape(B: int, H: int, bwd: bool) -> tuple[int, int, int, int] | None:
    """The grid of the grid-resident kernel for ``B`` rows of width ``H``
    (the forward's, or with ``bwd`` the backward carry's), as
    ``rnn_grid_shape`` picks it: ``(ocp, U, R, rows)`` (``grid.grid_shape``
    with one gate block). ``None`` where no grid takes ``H``."""
    return grid.grid_shape(B, H, bwd, GATES)


def stream_shape(B: int, H: int, bwd: bool) -> tuple[int, int, int, int, int, int] | None:
    """The grid of the streamed kernel for ``B`` rows of width ``H`` (the
    forward's, or with ``bwd`` the carry's), as ``rnn_stream_shape`` picks
    it: ``(ocp, U, Uc, R, rows, mt)`` (``grid.stream_shape``)."""
    return grid.stream_shape(B, H, bwd)


def stream_weight(c: torch.Tensor) -> torch.Tensor:
    """``C`` as the streamed kernels read it: its columns padded to ``Hp`` =
    8 ceil(H / 8), ``[H, Hp]`` (``grid.stream_weight``)."""
    return grid.stream_weight(c, GATES)


def design(H: int) -> str:
    """Which kernels run width ``H``: ``"cluster"`` up to 640, ``"grid"``
    past it up to ``MAX_HIDDEN`` (3168), ``"stream"`` past that; raises at
    H <= 0."""
    return grid.design(H, CLUSTER_MAX_HIDDEN, MAX_HIDDEN, f"RNN: H={H} is not taken by the kernels: {TAKES_H}")


def _sum_dtype(xin: torch.Tensor) -> torch.dtype:
    return torch.float64 if xin.dtype == torch.float64 else torch.float32


def rnn_scan_reference(xin: torch.Tensor, mask: torch.Tensor, c: torch.Tensor, remat: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel: a Python loop over T.

    ``h`` is rounded to ``c``'s dtype before the recurrent product, which sums
    in fp32: with bf16 ``c`` that is the kernel's arithmetic, with fp32 ``c``
    the JAX scan cell's at ``compute_dtype="float32"``. An fp64 ``xin`` sums
    in fp64 (a reference for both fp32 orders). ``remat`` checkpoints each
    step (``models.base.remat_step``).
    """
    B, T, H = xin.shape
    dt = _sum_dtype(xin)
    xin, mask = xin.to(dt), mask.to(dt)
    w = c.to(dt)

    def step(h, x_t, m_t):
        h_raw = torch.tanh(x_t + h.to(c.dtype).to(dt) @ w)
        m = m_t[:, None]
        return m * h_raw + (1.0 - m) * h

    step = remat_step(step, remat)
    h = xin.new_zeros(B, H)
    hs = []
    for t in range(T):
        h = step(h, xin[:, t], mask[:, t])
        hs.append(h)
    return torch.stack(hs, dim=1) if hs else xin.new_zeros(B, 0, H)


def _check(name: str, xin, mask, c) -> None:
    if xin.dim() != 3 or c.shape != (xin.shape[2], xin.shape[2]) or mask.shape != xin.shape[:2]:
        raise ValueError(f"{name}: need xin [B,T,H], mask [B,T] and C [H,H], got {tuple(xin.shape)}, "
                         f"{tuple(mask.shape)}, {tuple(c.shape)}")


def _check_cuda(name: str, tensors, H: int) -> str:
    """The design that runs width ``H`` on the tensors' CUDA device; raises
    where they are not on one, or past ``MAX_HIDDEN``."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: tensors on {sorted({str(t.device) for t in tensors})}; need one CUDA device")
    return design(H)


def fused_rnn_scan(xin: torch.Tensor, mask: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """[B, T, H] inputs + [B, T] mask + [H, H] weights → hs [B, T, H].

    A CPU tensor takes the plain version. A CUDA tensor launches the kernel
    or raises; ``fused_rnn_scan.launches`` counts the launches.
    """
    _check("fused_rnn_scan", xin, mask, c)
    if all(t.device.type == "cpu" for t in (xin, mask, c)):
        return rnn_scan_reference(xin, mask, c)
    B, T, H = xin.shape
    kind = _check_cuda("fused_rnn_scan", (xin, mask, c), H)
    if xin.dtype != torch.float32 or mask.dtype != torch.float32 or c.dtype != torch.bfloat16:
        raise TypeError(f"fused_rnn_scan: need xin and mask float32, C bfloat16; got {xin.dtype}, {mask.dtype}, "
                        f"{c.dtype}")
    lib = _build.library()
    xin, mask, c = xin.contiguous(), mask.contiguous(), c.contiguous()
    dev = xin.device
    hs = torch.empty(B, T, H, dtype=torch.float32, device=dev)
    w = stream_weight(c) if kind == "stream" else c
    args = (xin.data_ptr(), mask.data_ptr(), w.data_ptr(), hs.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    if kind in ("grid", "stream"):
        R, rows = stream_shape(B, H, False)[3:5] if kind == "stream" else grid_shape(B, H, False)[2:]
        # bf16(h) by step parity, zero past B and H; the row groups' step counters.
        hbuf = torch.zeros(2, R * rows, (H + 15) // 16 * 16, dtype=torch.bfloat16, device=dev)
        ctr = torch.zeros(R * 32, dtype=torch.int32, device=dev)
        entry = lib.rnn_fwd_stream if kind == "stream" else lib.rnn_fwd_grid
        rc = entry(*args, hbuf.data_ptr(), ctr.data_ptr(), B, T, H, dev.index, stream)
    else:
        # Cluster and rows 0: the kernel's own pick.
        rc = lib.rnn_fwd(*args, B, T, H, 0, 0, dev.index, stream)
    _build.check(rc, "rnn_fwd launch")
    fused_rnn_scan.launches += 1
    return hs


fused_rnn_scan.launches = 0


def rnn_bwd_reference(xin, mask, c, hs, dhs):
    """Plain PyTorch version of the backward kernel: an explicit reverse-time
    loop in fp32 with the TPU kernel's formulas (``fused_rnn.py:_bwd_kernel``).
    Returns ``(dxin [B, T, H], dC [H, H])`` fp32 (fp64 for an fp64 ``xin``,
    as ``rnn_scan_reference``)."""
    B, T, H = xin.shape
    dt = _sum_dtype(xin)
    xin, mask, hs, dhs = xin.to(dt), mask.to(dt), hs.to(dt), dhs.to(dt)
    w = c.to(dt)
    zero = xin.new_zeros(B, H)
    dh = zero
    dxin = torch.empty_like(xin)
    dc = xin.new_zeros(H, H)
    for t in range(T - 1, -1, -1):
        h_prev = hs[:, t - 1] if t > 0 else zero
        m = mask[:, t, None]
        h_raw = torch.tanh(xin[:, t] + h_prev.to(c.dtype).to(dt) @ w)
        dh = dh + dhs[:, t]
        dpre = dh * m * (1.0 - h_raw * h_raw)
        dxin[:, t] = dpre
        dh = dh * (1.0 - m) + dpre @ w.T
        dc += h_prev.T @ dpre
    return dxin, dc


def fused_rnn_bwd(xin, mask, c, hs, dhs):
    """BPTT of ``fused_rnn_scan``: ``(dxin [B, T, H], dC [H, H])`` fp32.

    A CPU tensor takes the plain version. A CUDA tensor launches the kernels
    of ``csrc/rnn.cu`` or raises; ``fused_rnn_bwd.launches`` counts the
    launches.
    """
    _check("fused_rnn_bwd", xin, mask, c)
    B, T, H = xin.shape
    if hs.shape != (B, T, H) or dhs.shape != (B, T, H):
        raise ValueError(f"fused_rnn_bwd: need hs and dhs [B,T,H]; got {tuple(hs.shape)}, {tuple(dhs.shape)}")
    tensors = (xin, mask, c, hs, dhs)
    if all(t.device.type == "cpu" for t in tensors):
        return rnn_bwd_reference(*tensors)
    kind = _check_cuda("fused_rnn_bwd", tensors, H)
    if c.dtype != torch.bfloat16 or any(t.dtype != torch.float32 for t in (xin, mask, hs, dhs)):
        raise TypeError(f"fused_rnn_bwd: need C bfloat16 and the rest float32; got {[t.dtype for t in tensors]}")
    lib = _build.library()
    dev = xin.device
    dxin = torch.empty(B, T, H, dtype=torch.float32, device=dev)
    dc = torch.empty(H, H, dtype=torch.float32, device=dev)
    if B == 0 or T == 0:
        return dxin, dc.zero_()
    xin, mask, c, hs, dhs = (t.contiguous() for t in tensors)
    partial = torch.empty(lib.rnn_bwd_splits(B, T, H), H, H, dtype=torch.float32, device=dev)
    args = (xin.data_ptr(), mask.data_ptr(), c.data_ptr(), hs.data_ptr(), dhs.data_ptr(), dxin.data_ptr(),
            partial.data_ptr(), dc.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    if kind in ("grid", "stream"):
        R, rows = stream_shape(B, H, True)[3:5] if kind == "stream" else grid_shape(B, H, True)[2:]
        # The three bf16 terms of dpre by step parity, zero past B and H (the streamed carry's columns to 8
        # ceil(H / 8)); the row groups' step counters; the carry dh of each (row, unit).
        cols = -(-H // 8) * 8 if kind == "stream" else (H + 15) // 16 * 16
        dt = torch.zeros(2, 3, R * rows, cols, dtype=torch.bfloat16, device=dev)
        ctr = torch.zeros(R * 32, dtype=torch.int32, device=dev)
        carry = torch.empty(B, H, dtype=torch.float32, device=dev)
        bufs = (dt.data_ptr(), ctr.data_ptr(), carry.data_ptr(), B, T, H, dev.index, stream)
        if kind == "stream":
            rc = lib.rnn_bwd_stream(*args, stream_weight(c).data_ptr(), *bufs)
        else:
            rc = lib.rnn_bwd_grid(*args, *bufs)
    else:
        # Cluster 0: the carry's own pick.
        rc = lib.rnn_bwd(*args, B, T, H, 0, dev.index, stream)
    _build.check(rc, "rnn_bwd launch")
    fused_rnn_bwd.launches += 1
    return dxin, dc


fused_rnn_bwd.launches = 0


class FusedRNN(torch.autograd.Function):
    """``fused_rnn_scan`` with its BPTT as the backward, the counterpart of
    the TPU package's ``jax.custom_vjp``. The recurrence runs on ``bf16(C)``
    whatever ``C``'s dtype, and ``dC`` comes back in ``C``'s dtype; the mask
    gets no gradient. On CPU tensors both directions run the plain versions;
    on CUDA tensors, the kernels."""

    @staticmethod
    def forward(ctx, xin: torch.Tensor, mask: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        c16 = c.detach().to(torch.bfloat16)
        m = mask.detach().float().contiguous()
        hs = fused_rnn_scan(xin.detach().float().contiguous(), m, c16)
        ctx.save_for_backward(xin, m, c16, hs)
        ctx.c_dtype = c.dtype
        return hs

    @staticmethod
    def backward(ctx, dhs: torch.Tensor):
        xin, m, c16, hs = ctx.saved_tensors
        dxin, dc = fused_rnn_bwd(xin.detach().float(), m, c16, hs, dhs.float().contiguous())
        return dxin.to(xin.dtype), None, dc.to(ctx.c_dtype)


def fused_rnn(xin: torch.Tensor, mask: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Differentiable [B, T, H] inputs + [B, T] mask + [H, H] → hs [B, T, H]."""
    return FusedRNN.apply(xin, mask, c)
