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

The forward runs groups of 16 batch rows on a cluster of 1 to 16 blocks,
each block holding the i, f, g and o columns of its units of bf16 ``wh``:
every step is a tensor-core tile product, and both carries stay in
registers. The backward recomputes every step's gates at once on the tensor
cores, then runs the serial carry, ``dxw @ whᵀ`` with the fp32 cotangent
split into three exact bf16 products, on such clusters too. The pair takes
any H up to ``csrc/lstm.cu``'s ``lstm_max_hidden()`` (512), where both
directions still fit a cluster's blocks.
"""

from __future__ import annotations

import torch

from poi_tpu_torch import _build


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


def _check_cuda(name: str, tensors, lib_max_hidden, H: int) -> None:
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: tensors on {sorted({str(t.device) for t in tensors})}; need one CUDA device")
    max_h = lib_max_hidden()
    if H > max_h:
        raise ValueError(f"{name}: H={H} is not taken by the kernels: past it, a cluster's blocks cannot hold "
                         f"their columns of bf16 wh beside the forward's and the backward's buffers, so H <= {max_h}")


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
    lib = _build.library()
    _check_cuda("fused_lstm_scan", (xw, mask, wh), lib.lstm_max_hidden, H)
    if xw.dtype != torch.float32 or mask.dtype != torch.float32 or wh.dtype != torch.bfloat16:
        raise TypeError(f"fused_lstm_scan: need xw and mask float32, wh bfloat16; got {xw.dtype}, {mask.dtype}, "
                        f"{wh.dtype}")
    xw, mask, wh = xw.contiguous(), mask.contiguous(), wh.contiguous()
    hs = torch.empty(B, T, H, dtype=torch.float32, device=xw.device)
    cs = torch.empty_like(hs)
    rc = lib.lstm_fwd(xw.data_ptr(), mask.data_ptr(), wh.data_ptr(), hs.data_ptr(), cs.data_ptr(), B, T, H, 0,
                      xw.device.index, torch.cuda.current_stream(xw.device).cuda_stream)
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
    lib = _build.library()
    _check_cuda("fused_lstm_bwd", tensors, lib.lstm_max_hidden, H)
    if wh.dtype != torch.bfloat16 or any(t.dtype != torch.float32 for t in (xw, mask, hs, cs, dhs)):
        raise TypeError(f"fused_lstm_bwd: need wh bfloat16 and the rest float32; got {[t.dtype for t in tensors]}")
    dev = xw.device
    dxw = torch.empty(B, T, H4, dtype=torch.float32, device=dev)
    dwh = torch.empty(H, H4, dtype=torch.float32, device=dev)
    if B == 0 or T == 0:
        return dxw, dwh.zero_()
    xw, mask, wh, hs, cs, dhs = (t.contiguous() for t in tensors)
    coef = torch.empty(B, T, 2 * H, dtype=torch.float32, device=dev)  # scratch: two of the gates' coefficients
    partial = torch.empty(lib.lstm_bwd_splits(B, T, H), H, H4, dtype=torch.float32, device=dev)
    rc = lib.lstm_bwd(xw.data_ptr(), mask.data_ptr(), wh.data_ptr(), hs.data_ptr(), cs.data_ptr(), dhs.data_ptr(),
                      dxw.data_ptr(), coef.data_ptr(), partial.data_ptr(), dwh.data_ptr(), B, T, H, dev.index,
                      torch.cuda.current_stream(dev).cuda_stream)
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
