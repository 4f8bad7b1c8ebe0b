"""GRU recurrence: the CUDA kernels ``csrc/gru_fwd.cu`` (forward) and
``csrc/gru_bwd.cu`` (BPTT), their plain PyTorch versions, and the autograd
``Function`` that ties them together.

Counterpart of ``poi_tpu/ops/fused_gru.py``. Contract, the same as the TPU
kernels':

- ``xw [B, T, 3H]`` fp32: the hoisted input projection plus bias, gate blocks
  ordered z | r | n, with the padding mask already folded into the z block as
  ``MASK_NEG`` (``models/gru.py``). On a padded step ``sigmoid(z) == 0``
  exactly, so the carry passes through unchanged.
- ``wh [H, 3H]`` bf16, h0 = 0.
- per step ``hw = bf16(h) @ wh`` with fp32 accumulation, then
  ``z = σ(xz + hz)``, ``r = σ(xr + hr)``, ``n = tanh(xn + r·hn)``,
  ``h = (1 - z)·h + z·n``.
- returns ``hs [B, T, H]`` fp32.
- backward: the gates are recomputed from ``hs``; every cotangent stays
  fp32 (``dh @ whᵀ`` with wh widened from bf16), and ``dwh`` sums
  ``h_prevᵀ · dhw`` over batch and time in fp32.

Up to ``CLUSTER_MAX_HIDDEN`` (640) both kernels run groups of 16 batch rows
(8 on the backward's clusters of 16) on a cluster of 1 to 16 blocks, wh's
columns split across the cluster and kept in shared memory, and do each
step's product on the tensor cores. The forward runs ``bf16(h) @ wh`` a step
for the group (``gru_fwd_cluster_size``). The backward recomputes every
step's gates at once, then runs the serial carry, ``dh @ whᵀ`` with the fp32
cotangent split into three exact bf16 products (``gru_bwd_cluster_size``).
Past 640 no cluster holds wh, and the serial kernels run on the whole card
(``grid_shape``): R row groups x U unit slices, one block an SM, each
block's slice of wh in its shared memory, the operand a step needs
exchanged through an L2-resident buffer behind a step barrier of the row
group (``gru_fwd_grid``, ``gru_bwd_grid``). The pair takes any H up to
``MAX_HIDDEN``, the C side's ``gru_max_hidden()``; ``design`` is the
dispatch, in Python so that the CPU tests hold it.
"""

from __future__ import annotations

import torch

from poi_tpu_torch import _build
from poi_tpu_torch.ops import grid

MASK_NEG = -1e9
# The widest H the cluster kernels take (gru_fwd_cluster_size and
# gru_bwd_cluster_size are 0 past it: chip_smoke.py checks both sides).
CLUSTER_MAX_HIDDEN = 640
GATES = 3  # the z, r and n blocks of wh
# The grid-resident kernels' limits (csrc/grid_carry.cuh): a block's shared
# memory, and the card's SMs.
MAX_SMEM, SMS = grid.MAX_SMEM, grid.SMS


def _slice_bytes(H: int, ocp: int, bwd: bool) -> int:
    """Shared memory of a block's slice of wh at ``ocp`` unit octets
    (``grid.slice_bytes`` with three gate blocks): the forward's z, r, n
    columns of the octets for every k, ``[Hk][24 ocp + 8]``; the backward
    carry's rows of the octets' units, ``[8 ocp][Kp + 8]`` (``Kp`` = 3H
    rounded up to 16); bf16."""
    return grid.slice_bytes(H, ocp, bwd, GATES)


def grid_shape(B: int, H: int, bwd: bool) -> tuple[int, int, int, int] | None:
    """The grid of the grid-resident kernel for ``B`` rows of width ``H``
    (the forward's, or with ``bwd`` the backward carry's), as
    ``gru_grid_shape`` picks it: ``(ocp, U, R, rows)`` (``grid.grid_shape``
    with three gate blocks). ``None`` where no grid takes ``H``."""
    return grid.grid_shape(B, H, bwd, GATES)


# The widest H the pair takes (``gru_max_hidden()`` in csrc/gru_fwd.cu).
MAX_HIDDEN = grid.max_hidden(CLUSTER_MAX_HIDDEN, GATES)
TAKES_H = (f"H <= {MAX_HIDDEN} (gru_max_hidden()): on a cluster of 1, 2, 4, 8 or 16 blocks a group of batch "
           f"rows up to H = {CLUSTER_MAX_HIDDEN}, on a grid of row groups x unit slices, one block an SM, past it")


def design(H: int) -> str:
    """Which kernels run width ``H``: ``"cluster"`` up to 640, ``"grid"``
    past it; raises past ``MAX_HIDDEN``, naming it."""
    return grid.design(H, CLUSTER_MAX_HIDDEN, MAX_HIDDEN, f"GRU: H={H} is not taken by the kernels: {TAKES_H}")


def gru_scan_reference(xw: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: a Python loop over T.

    ``h`` is rounded to ``wh``'s dtype before the recurrent product, which
    sums in fp32: with bf16 ``wh`` that is the kernel's arithmetic, with fp32
    ``wh`` the JAX scan cell's at ``compute_dtype="float32"``.
    """
    B, T, H3 = xw.shape
    H = H3 // 3
    xw = xw.float()
    w = wh.float()
    h = xw.new_zeros(B, H)
    hs = []
    for t in range(T):
        hw = h.to(wh.dtype).float() @ w
        x_t = xw[:, t]
        z = torch.sigmoid(x_t[:, :H] + hw[:, :H])
        r = torch.sigmoid(x_t[:, H:2 * H] + hw[:, H:2 * H])
        n = torch.tanh(x_t[:, 2 * H:] + r * hw[:, 2 * H:])
        h = (1.0 - z) * h + z * n
        hs.append(h)
    return torch.stack(hs, dim=1) if hs else xw.new_zeros(B, 0, H)


def fused_gru_scan(xw: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    """[B, T, 3H] folded gate inputs + [H, 3H] recurrent weights → [B, T, H].

    A CPU tensor takes the plain version. A CUDA tensor launches the kernel
    or raises; ``fused_gru_scan.launches`` counts the launches.
    """
    if xw.dim() != 3 or wh.dim() != 2 or xw.shape[2] != wh.shape[1] or wh.shape[1] != 3 * wh.shape[0]:
        raise ValueError(f"fused_gru_scan: need xw [B,T,3H] and wh [H,3H], got {tuple(xw.shape)}, {tuple(wh.shape)}")
    if xw.device.type == "cpu" and wh.device.type == "cpu":
        return gru_scan_reference(xw, wh)
    if xw.device.type != "cuda" or wh.device != xw.device:
        raise ValueError(f"fused_gru_scan: xw on {xw.device}, wh on {wh.device}; need both on one CUDA device")
    if xw.dtype != torch.float32 or wh.dtype != torch.bfloat16:
        raise TypeError(f"fused_gru_scan: need xw float32 and wh bfloat16, got {xw.dtype}, {wh.dtype}")
    B, T, H3 = xw.shape
    H = H3 // 3
    grid = design(H) == "grid"
    lib = _build.library()
    xw = xw.contiguous()
    wh = wh.contiguous()
    dev = xw.device
    hs = torch.empty(B, T, H, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if grid:
        _, _, R, rows = grid_shape(B, H, False)
        # bf16(h) by step parity, zero past B and H; the row groups' step counters.
        hbuf = torch.zeros(2, R * rows, (H + 15) // 16 * 16, dtype=torch.bfloat16, device=dev)
        ctr = torch.zeros(R * 32, dtype=torch.int32, device=dev)
        rc = lib.gru_fwd_grid(xw.data_ptr(), wh.data_ptr(), hs.data_ptr(), hbuf.data_ptr(), ctr.data_ptr(), B, T, H,
                              dev.index, stream)
    else:
        rc = lib.gru_fwd(xw.data_ptr(), wh.data_ptr(), hs.data_ptr(), B, T, H, 0, dev.index, stream)
    _build.check(rc, "gru_fwd launch")
    fused_gru_scan.launches += 1
    return hs


fused_gru_scan.launches = 0


def gru_bwd_reference(xw: torch.Tensor, wh: torch.Tensor, hs: torch.Tensor, dhs: torch.Tensor):
    """Plain PyTorch version of the backward kernel: an explicit reverse-time
    loop in fp32 with the TPU kernel's formulas (``fused_gru.py:_bwd_kernel``).

    The gates are recomputed with ``h_prev`` rounded to ``wh``'s dtype, as in
    ``gru_scan_reference``. Returns ``(dxw [B, T, 3H], dwh [H, 3H])``, both
    fp32.
    """
    B, T, H3 = xw.shape
    H = H3 // 3
    xw, hs, dhs = xw.float(), hs.float(), dhs.float()
    w = wh.float()
    dh = xw.new_zeros(B, H)
    dxw = torch.empty_like(xw)
    dwh = xw.new_zeros(H, H3)
    for t in range(T - 1, -1, -1):
        h_prev = hs[:, t - 1] if t > 0 else xw.new_zeros(B, H)
        hw = h_prev.to(wh.dtype).float() @ w
        x_t = xw[:, t]
        z = torch.sigmoid(x_t[:, :H] + hw[:, :H])
        r = torch.sigmoid(x_t[:, H:2 * H] + hw[:, H:2 * H])
        hn = hw[:, 2 * H:]
        n = torch.tanh(x_t[:, 2 * H:] + r * hn)
        dh = dh + dhs[:, t]
        dn = dh * z * (1.0 - n * n)
        da = dh * (n - h_prev) * z * (1.0 - z)
        dr_pre = dn * hn * r * (1.0 - r)
        dhn = dn * r
        dxw[:, t] = torch.cat([da, dr_pre, dn], dim=1)
        dhw = torch.cat([da, dr_pre, dhn], dim=1)
        dh = dh * (1.0 - z) + dhw @ w.T
        dwh += h_prev.T @ dhw
    return dxw, dwh


def fused_gru_bwd(xw: torch.Tensor, wh: torch.Tensor, hs: torch.Tensor, dhs: torch.Tensor):
    """BPTT of ``fused_gru_scan``: ``(dxw [B, T, 3H], dwh [H, 3H])`` fp32.

    A CPU tensor takes the plain version. A CUDA tensor launches the kernels
    of ``csrc/gru_bwd.cu`` or raises; ``fused_gru_bwd.launches`` counts the
    launches.
    """
    B, T, H3 = xw.shape
    H = wh.shape[0]
    if wh.shape != (H, 3 * H) or H3 != 3 * H or hs.shape != (B, T, H) or dhs.shape != (B, T, H):
        raise ValueError(f"fused_gru_bwd: need xw [B,T,3H], wh [H,3H], hs and dhs [B,T,H]; got "
                         f"{tuple(xw.shape)}, {tuple(wh.shape)}, {tuple(hs.shape)}, {tuple(dhs.shape)}")
    tensors = (xw, wh, hs, dhs)
    if all(t.device.type == "cpu" for t in tensors):
        return gru_bwd_reference(xw, wh, hs, dhs)
    if xw.device.type != "cuda" or any(t.device != xw.device for t in tensors):
        raise ValueError(f"fused_gru_bwd: tensors on {sorted({str(t.device) for t in tensors})}; need one CUDA device")
    if wh.dtype != torch.bfloat16 or any(t.dtype != torch.float32 for t in (xw, hs, dhs)):
        raise TypeError(f"fused_gru_bwd: need wh bfloat16 and xw, hs, dhs float32; got "
                        f"{[t.dtype for t in tensors]}")
    grid = design(H) == "grid"
    lib = _build.library()
    dev = xw.device
    dxw = torch.empty(B, T, H3, dtype=torch.float32, device=dev)
    dwh = torch.empty(H, H3, dtype=torch.float32, device=dev)
    if B == 0 or T == 0:
        return dxw, dwh.zero_()
    xw, wh, hs, dhs = (t.contiguous() for t in tensors)
    dhw = torch.empty(B, T, H3, dtype=torch.float32, device=dev)  # scratch: the recurrent cotangent per step
    partial = torch.empty(lib.gru_bwd_splits(B, T, H), H, H3, dtype=torch.float32, device=dev)
    args = (xw.data_ptr(), wh.data_ptr(), hs.data_ptr(), dhs.data_ptr(), dxw.data_ptr(), dhw.data_ptr(),
            partial.data_ptr(), dwh.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    if grid:
        _, _, R, rows = grid_shape(B, H, True)
        # The three bf16 terms of dhw by step parity, zero past B and 3H; the row groups' step counters.
        dt = torch.zeros(2, 3, R * rows, (3 * H + 15) // 16 * 16, dtype=torch.bfloat16, device=dev)
        ctr = torch.zeros(R * 32, dtype=torch.int32, device=dev)
        rc = lib.gru_bwd_grid(*args, dt.data_ptr(), ctr.data_ptr(), B, T, H, dev.index, stream)
    else:
        rc = lib.gru_bwd(*args, B, T, H, dev.index, stream)
    _build.check(rc, "gru_bwd launch")
    fused_gru_bwd.launches += 1
    return dxw, dwh


fused_gru_bwd.launches = 0


class FusedGRU(torch.autograd.Function):
    """``fused_gru_scan`` with its BPTT as the backward, the counterpart of
    the TPU package's ``jax.custom_vjp``.

    The recurrence runs on ``bf16(wh)`` whatever ``wh``'s dtype, as the TPU
    kernel does, and ``dwh`` comes back in ``wh``'s dtype. On CPU tensors
    both directions run the plain versions; on CUDA tensors, the kernels.
    """

    @staticmethod
    def forward(ctx, xw: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
        wh16 = wh.detach().to(torch.bfloat16)
        hs = fused_gru_scan(xw.detach().float().contiguous(), wh16)
        ctx.save_for_backward(xw, wh16, hs)
        ctx.wh_dtype = wh.dtype
        return hs

    @staticmethod
    def backward(ctx, dhs: torch.Tensor):
        xw, wh16, hs = ctx.saved_tensors
        dxw, dwh = fused_gru_bwd(xw.detach().float(), wh16, hs, dhs.float().contiguous())
        return dxw.to(xw.dtype), dwh.to(ctx.wh_dtype)


def fused_gru(xw: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    """Differentiable [B, T, 3H] folded gate inputs + [H, 3H] → [B, T, H]."""
    return FusedGRU.apply(xw, wh)
