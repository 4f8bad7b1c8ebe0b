"""LSTM recurrence: the CUDA kernels of ``csrc/lstm.cu`` (forward and BPTT),
their plain PyTorch versions, and the autograd ``Function`` that ties them
together.

Counterpart of ``poi_tpu/ops/fused_lstm.py``. Contract, the TPU kernels':

- ``xw [B, T, 4H]`` fp32: the hoisted input projection plus bias, gate
  blocks ordered i | f | g | o.
- ``mask [B, T]``: 1 on a valid step, 0 on a padded one. An LSTM has no single
  gate that freezes both carries, so the mask is an operand and blends them:
  ``c = m·c_raw + (1 - m)·c``, ``h = m·h_raw + (1 - m)·h``; a padded step
  passes both through exactly. (The TPU kernels take it broadcast to
  [B, T, H] for their lane layout; the function is the same.)
- ``wh [H, 4H]`` bf16, h0 = c0 = 0; per step ``pre = xw[t] + bf16(h) @ wh``
  with fp32 sums.
- returns ``hs`` and ``cs [B, T, H]`` fp32: padded steps hold the carries.
- backward: the gates are recomputed from ``hs[t-1]`` and ``cs[t-1]``; every
  cotangent stays fp32 (``dxw @ whᵀ`` with wh widened from bf16), ``dxw`` is
  exactly 0 on padded steps, and ``dwh`` sums ``h_prevᵀ · dxw`` over batch
  and time in fp32.

Up to ``CLUSTER_MAX_HIDDEN`` (512) the forward runs groups of 16 batch rows
on a cluster of 1 to 16 blocks, each block holding the i, f, g and o columns
of its units of bf16 ``wh``: every step is a tensor-core tile product, and
both carries stay in registers. The backward recomputes every step's gates
at once on the tensor cores, then runs the serial carry, ``dxw @ whᵀ`` with
the fp32 cotangent split into three exact bf16 products, on such clusters
too. Past 512 no cluster holds wh (2.1 MB at H = 512, 8.4 MB at 1024), and
both serial kernels run on the whole card (``grid_shape``): R row groups x U
unit slices, one block an SM, each block's slice of wh in its shared memory,
the operand a step needs exchanged through an L2-resident buffer behind a
step barrier of the row group (``lstm_fwd_grid``, ``lstm_bwd_grid``). The
pair takes any H up to ``MAX_HIDDEN`` (1600), the C side's
``lstm_max_hidden()``; ``design`` is the dispatch, in Python so that the CPU
tests hold it.
"""

from __future__ import annotations

import torch

from poi_tpu_torch import _build
from poi_tpu_torch.ops import grid

# The widest H the cluster kernels take (lstm_fwd_cluster_size is 0 past it:
# chip_smoke.py checks both sides).
CLUSTER_MAX_HIDDEN = 512
GATES = 4  # the i, f, g and o blocks of wh
# The widest H the pair takes (``lstm_max_hidden()`` in csrc/lstm.cu).
MAX_HIDDEN = grid.max_hidden(CLUSTER_MAX_HIDDEN, GATES)
TAKES_H = (f"H <= {MAX_HIDDEN} (lstm_max_hidden()): on a cluster of 1 to 16 blocks a group of 16 batch rows up to "
           f"H = {CLUSTER_MAX_HIDDEN}, on a grid of row groups x unit slices, one block an SM, past it")


def grid_shape(B: int, H: int, bwd: bool) -> tuple[int, int, int, int] | None:
    """The grid of the grid-resident kernel for ``B`` rows of width ``H``
    (the forward's, or with ``bwd`` the backward carry's), as
    ``lstm_grid_shape`` picks it: ``(ocp, U, R, rows)`` (``grid.grid_shape``
    with four gate blocks). ``None`` where no grid takes ``H``."""
    return grid.grid_shape(B, H, bwd, GATES)


def design(H: int) -> str:
    """Which kernels run width ``H``: ``"cluster"`` up to 512, ``"grid"``
    past it; raises past ``MAX_HIDDEN``, naming it."""
    return grid.design(H, CLUSTER_MAX_HIDDEN, MAX_HIDDEN, f"LSTM: H={H} is not taken by the kernels: {TAKES_H}")


def _blend(m: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """``m·new + (1 - m)·old`` with ``m`` [B] in {0, 1}: exactly one of them."""
    m = m[:, None]
    return m * new + (1.0 - m) * old


def _gates(pre: torch.Tensor, H: int):
    return (torch.sigmoid(pre[:, :H]), torch.sigmoid(pre[:, H:2 * H]), torch.tanh(pre[:, 2 * H:3 * H]),
            torch.sigmoid(pre[:, 3 * H:]))


def lstm_scan_reference(xw: torch.Tensor, mask: torch.Tensor, wh: torch.Tensor):
    """Plain PyTorch version of the forward kernel: a Python loop over T.

    ``h`` is rounded to ``wh``'s dtype before the recurrent product, which
    sums in fp32: with bf16 ``wh`` that is the kernel's arithmetic, with fp32
    ``wh`` the JAX scan cell's at ``compute_dtype="float32"``. Returns
    ``(hs, cs)`` [B, T, H] fp32.
    """
    B, T, H4 = xw.shape
    H = H4 // 4
    xw, mask = xw.float(), mask.float()
    w = wh.float()
    h = xw.new_zeros(B, H)
    c = xw.new_zeros(B, H)
    hs, cs = [], []
    for t in range(T):
        i, f, g, o = _gates(xw[:, t] + h.to(wh.dtype).float() @ w, H)
        c_raw = f * c + i * g
        h_raw = o * torch.tanh(c_raw)
        c = _blend(mask[:, t], c_raw, c)
        h = _blend(mask[:, t], h_raw, h)
        hs.append(h)
        cs.append(c)
    if not hs:
        return xw.new_zeros(B, 0, H), xw.new_zeros(B, 0, H)
    return torch.stack(hs, dim=1), torch.stack(cs, dim=1)


def _check_fwd(xw, mask, wh):
    if xw.dim() != 3 or wh.dim() != 2 or xw.shape[2] != wh.shape[1] or wh.shape[1] != 4 * wh.shape[0] \
            or mask.shape != xw.shape[:2]:
        raise ValueError(f"fused_lstm: need xw [B,T,4H], mask [B,T] and wh [H,4H], got {tuple(xw.shape)}, "
                         f"{tuple(mask.shape)}, {tuple(wh.shape)}")


def _check_cuda(name: str, tensors, H: int) -> str:
    """The design that runs width ``H`` on the tensors' CUDA device; raises
    where they are not on one, or past ``MAX_HIDDEN``."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: tensors on {sorted({str(t.device) for t in tensors})}; need one CUDA device")
    return design(H)


def fused_lstm_scan(xw: torch.Tensor, mask: torch.Tensor, wh: torch.Tensor):
    """[B, T, 4H] gate inputs + [B, T] mask + [H, 4H] weights → ``(hs, cs)``.

    A CPU tensor takes the plain version. A CUDA tensor launches the kernel
    or raises; ``fused_lstm_scan.launches`` counts the launches.
    """
    _check_fwd(xw, mask, wh)
    if all(t.device.type == "cpu" for t in (xw, mask, wh)):
        return lstm_scan_reference(xw, mask, wh)
    B, T, H4 = xw.shape
    H = H4 // 4
    on_grid = _check_cuda("fused_lstm_scan", (xw, mask, wh), H) == "grid"
    if xw.dtype != torch.float32 or mask.dtype != torch.float32 or wh.dtype != torch.bfloat16:
        raise TypeError(f"fused_lstm_scan: need xw and mask float32, wh bfloat16; got {xw.dtype}, {mask.dtype}, "
                        f"{wh.dtype}")
    lib = _build.library()
    xw, mask, wh = xw.contiguous(), mask.contiguous(), wh.contiguous()
    dev = xw.device
    hs = torch.empty(B, T, H, dtype=torch.float32, device=dev)
    cs = torch.empty_like(hs)
    args = (xw.data_ptr(), mask.data_ptr(), wh.data_ptr(), hs.data_ptr(), cs.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    if on_grid:
        _, _, R, rows = grid_shape(B, H, False)
        # bf16(h) by step parity, zero past B and H; the row groups' step counters.
        hbuf = torch.zeros(2, R * rows, (H + 15) // 16 * 16, dtype=torch.bfloat16, device=dev)
        ctr = torch.zeros(R * 32, dtype=torch.int32, device=dev)
        rc = lib.lstm_fwd_grid(*args, hbuf.data_ptr(), ctr.data_ptr(), B, T, H, dev.index, stream)
    else:
        rc = lib.lstm_fwd(*args, B, T, H, 0, dev.index, stream)
    _build.check(rc, "lstm_fwd launch")
    fused_lstm_scan.launches += 1
    return hs, cs


fused_lstm_scan.launches = 0


def lstm_bwd_reference(xw, mask, wh, hs, cs, dhs):
    """Plain PyTorch version of the backward kernel: an explicit reverse-time
    loop in fp32 with the TPU kernel's formulas (``fused_lstm.py:_bwd_kernel``).

    The gates are recomputed with ``h_prev`` rounded to ``wh``'s dtype, as in
    ``lstm_scan_reference``. Returns ``(dxw [B, T, 4H], dwh [H, 4H])`` fp32.
    """
    B, T, H4 = xw.shape
    H = H4 // 4
    xw, mask, hs, cs, dhs = xw.float(), mask.float(), hs.float(), cs.float(), dhs.float()
    w = wh.float()
    zero = xw.new_zeros(B, H)
    dh, dc = zero, zero
    dxw = torch.empty_like(xw)
    dwh = xw.new_zeros(H, H4)
    for t in range(T - 1, -1, -1):
        h_prev = hs[:, t - 1] if t > 0 else zero
        c_prev = cs[:, t - 1] if t > 0 else zero
        m = mask[:, t, None]
        i, f, g, o = _gates(xw[:, t] + h_prev.to(wh.dtype).float() @ w, H)
        tc = torch.tanh(f * c_prev + i * g)
        dh = dh + dhs[:, t]
        dh_raw = dh * m
        dc_raw = dc * m + dh_raw * o * (1.0 - tc * tc)
        d = torch.cat([dc_raw * g * i * (1.0 - i), dc_raw * c_prev * f * (1.0 - f), dc_raw * i * (1.0 - g * g),
                       dh_raw * tc * o * (1.0 - o)], dim=1)
        dxw[:, t] = d
        dh = dh * (1.0 - m) + d @ w.T
        dc = dc * (1.0 - m) + dc_raw * f
        dwh += h_prev.T @ d
    return dxw, dwh


def fused_lstm_bwd(xw, mask, wh, hs, cs, dhs):
    """BPTT of ``fused_lstm_scan``: ``(dxw [B, T, 4H], dwh [H, 4H])`` fp32.

    A CPU tensor takes the plain version. A CUDA tensor launches the kernels
    of ``csrc/lstm.cu`` or raises; ``fused_lstm_bwd.launches`` counts the
    launches.
    """
    _check_fwd(xw, mask, wh)
    B, T, H4 = xw.shape
    H = H4 // 4
    if hs.shape != (B, T, H) or cs.shape != (B, T, H) or dhs.shape != (B, T, H):
        raise ValueError(f"fused_lstm_bwd: need hs, cs and dhs [B,T,H]; got {tuple(hs.shape)}, {tuple(cs.shape)}, "
                         f"{tuple(dhs.shape)}")
    tensors = (xw, mask, wh, hs, cs, dhs)
    if all(t.device.type == "cpu" for t in tensors):
        return lstm_bwd_reference(*tensors)
    on_grid = _check_cuda("fused_lstm_bwd", tensors, H) == "grid"
    if wh.dtype != torch.bfloat16 or any(t.dtype != torch.float32 for t in (xw, mask, hs, cs, dhs)):
        raise TypeError(f"fused_lstm_bwd: need wh bfloat16 and the rest float32; got {[t.dtype for t in tensors]}")
    lib = _build.library()
    dev = xw.device
    dxw = torch.empty(B, T, H4, dtype=torch.float32, device=dev)
    dwh = torch.empty(H, H4, dtype=torch.float32, device=dev)
    if B == 0 or T == 0:
        return dxw, dwh.zero_()
    xw, mask, wh, hs, cs, dhs = (t.contiguous() for t in tensors)
    coef = torch.empty(B, T, 2 * H, dtype=torch.float32, device=dev)  # scratch: two of the gates' coefficients
    partial = torch.empty(lib.lstm_bwd_splits(B, T, H), H, H4, dtype=torch.float32, device=dev)
    args = (xw.data_ptr(), mask.data_ptr(), wh.data_ptr(), hs.data_ptr(), cs.data_ptr(), dhs.data_ptr(),
            dxw.data_ptr(), coef.data_ptr(), partial.data_ptr(), dwh.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    if on_grid:
        _, _, R, rows = grid_shape(B, H, True)
        # The three bf16 terms of dxw[t] by step parity, zero past B and 4H; the row groups' step counters; the
        # carries dh and dc of each (row, unit).
        dt = torch.zeros(2, 3, R * rows, (4 * H + 15) // 16 * 16, dtype=torch.bfloat16, device=dev)
        ctr = torch.zeros(R * 32, dtype=torch.int32, device=dev)
        carry = torch.empty(2, B, H, dtype=torch.float32, device=dev)
        rc = lib.lstm_bwd_grid(*args, dt.data_ptr(), ctr.data_ptr(), carry.data_ptr(), B, T, H, dev.index, stream)
    else:
        rc = lib.lstm_bwd(*args, B, T, H, dev.index, stream)
    _build.check(rc, "lstm_bwd launch")
    fused_lstm_bwd.launches += 1
    return dxw, dwh


fused_lstm_bwd.launches = 0


class FusedLSTM(torch.autograd.Function):
    """``fused_lstm_scan`` with its BPTT as the backward, the counterpart of
    the TPU package's ``jax.custom_vjp``; it saves ``hs`` and ``cs``, as the
    TPU's ``_fwd`` keeps both as residuals.

    The recurrence runs on ``bf16(wh)`` whatever ``wh``'s dtype, as the TPU
    kernel does, and ``dwh`` comes back in ``wh``'s dtype. The mask gets no
    gradient. On CPU tensors both directions run the plain versions; on CUDA
    tensors, the kernels.
    """

    @staticmethod
    def forward(ctx, xw: torch.Tensor, mask: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
        wh16 = wh.detach().to(torch.bfloat16)
        m = mask.detach().float().contiguous()
        hs, cs = fused_lstm_scan(xw.detach().float().contiguous(), m, wh16)
        ctx.save_for_backward(xw, m, wh16, hs, cs)
        ctx.wh_dtype = wh.dtype
        return hs

    @staticmethod
    def backward(ctx, dhs: torch.Tensor):
        xw, m, wh16, hs, cs = ctx.saved_tensors
        dxw, dwh = fused_lstm_bwd(xw.detach().float(), m, wh16, hs, cs, dhs.float().contiguous())
        return dxw.to(xw.dtype), None, dwh.to(ctx.wh_dtype)


def fused_lstm(xw: torch.Tensor, mask: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    """Differentiable [B, T, 4H] gate inputs + [B, T] mask + [H, 4H] → hs [B, T, H]."""
    return FusedLSTM.apply(xw, mask, wh)
