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

The forward keeps bf16 ``C`` (2·H² bytes) in one block's shared memory, so
the pair takes H up to ``csrc/rnn.cu``'s ``rnn_max_hidden()`` (339). The
backward recomputes every step's ``h_raw`` at once on the tensor cores, runs
the serial carry (``dpre @ Cᵀ`` with the fp32 ``dpre`` split into three exact
bf16 products) on a cluster of blocks a group of 8 rows (16 where the
8-row groups' clusters would not all fit on the card at once), and forms
``dC`` in fp32 on the CUDA cores.
"""

from __future__ import annotations

import torch

from poi_tpu_torch import _build


def rnn_scan_reference(xin: torch.Tensor, mask: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel: a Python loop over T.

    ``h`` is rounded to ``c``'s dtype before the recurrent product, which sums
    in fp32: with bf16 ``c`` that is the kernel's arithmetic, with fp32 ``c``
    the JAX scan cell's at ``compute_dtype="float32"``.
    """
    B, T, H = xin.shape
    xin, mask = xin.float(), mask.float()
    w = c.float()
    h = xin.new_zeros(B, H)
    hs = []
    for t in range(T):
        h_raw = torch.tanh(xin[:, t] + h.to(c.dtype).float() @ w)
        m = mask[:, t, None]
        h = m * h_raw + (1.0 - m) * h
        hs.append(h)
    return torch.stack(hs, dim=1) if hs else xin.new_zeros(B, 0, H)


def _check(name: str, xin, mask, c) -> None:
    if xin.dim() != 3 or c.shape != (xin.shape[2], xin.shape[2]) or mask.shape != xin.shape[:2]:
        raise ValueError(f"{name}: need xin [B,T,H], mask [B,T] and C [H,H], got {tuple(xin.shape)}, "
                         f"{tuple(mask.shape)}, {tuple(c.shape)}")


def _check_cuda(name: str, tensors, lib, H: int) -> None:
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: tensors on {sorted({str(t.device) for t in tensors})}; need one CUDA device")
    max_h = lib.rnn_max_hidden()
    if H > max_h:
        raise ValueError(f"{name}: H={H} is not taken by the kernels: the forward holds bf16 C (2*H*H bytes) in "
                         f"one block's shared memory, so H <= {max_h}")


def fused_rnn_scan(xin: torch.Tensor, mask: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """[B, T, H] inputs + [B, T] mask + [H, H] weights → hs [B, T, H].

    A CPU tensor takes the plain version. A CUDA tensor launches the kernel
    or raises; ``fused_rnn_scan.launches`` counts the launches.
    """
    _check("fused_rnn_scan", xin, mask, c)
    if all(t.device.type == "cpu" for t in (xin, mask, c)):
        return rnn_scan_reference(xin, mask, c)
    B, T, H = xin.shape
    lib = _build.library()
    _check_cuda("fused_rnn_scan", (xin, mask, c), lib, H)
    if xin.dtype != torch.float32 or mask.dtype != torch.float32 or c.dtype != torch.bfloat16:
        raise TypeError(f"fused_rnn_scan: need xin and mask float32, C bfloat16; got {xin.dtype}, {mask.dtype}, "
                        f"{c.dtype}")
    xin, mask, c = xin.contiguous(), mask.contiguous(), c.contiguous()
    hs = torch.empty(B, T, H, dtype=torch.float32, device=xin.device)
    rc = lib.rnn_fwd(xin.data_ptr(), mask.data_ptr(), c.data_ptr(), hs.data_ptr(), B, T, H, xin.device.index,
                     torch.cuda.current_stream(xin.device).cuda_stream)
    _build.check(rc, "rnn_fwd launch")
    fused_rnn_scan.launches += 1
    return hs


fused_rnn_scan.launches = 0


def rnn_bwd_reference(xin, mask, c, hs, dhs):
    """Plain PyTorch version of the backward kernel: an explicit reverse-time
    loop in fp32 with the TPU kernel's formulas (``fused_rnn.py:_bwd_kernel``).
    Returns ``(dxin [B, T, H], dC [H, H])`` fp32."""
    B, T, H = xin.shape
    xin, mask, hs, dhs = xin.float(), mask.float(), hs.float(), dhs.float()
    w = c.float()
    zero = xin.new_zeros(B, H)
    dh = zero
    dxin = torch.empty_like(xin)
    dc = xin.new_zeros(H, H)
    for t in range(T - 1, -1, -1):
        h_prev = hs[:, t - 1] if t > 0 else zero
        m = mask[:, t, None]
        h_raw = torch.tanh(xin[:, t] + h_prev.to(c.dtype).float() @ w)
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
    lib = _build.library()
    _check_cuda("fused_rnn_bwd", tensors, lib, H)
    if c.dtype != torch.bfloat16 or any(t.dtype != torch.float32 for t in (xin, mask, hs, dhs)):
        raise TypeError(f"fused_rnn_bwd: need C bfloat16 and the rest float32; got {[t.dtype for t in tensors]}")
    dev = xin.device
    dxin = torch.empty(B, T, H, dtype=torch.float32, device=dev)
    dc = torch.empty(H, H, dtype=torch.float32, device=dev)
    if B == 0 or T == 0:
        return dxin, dc.zero_()
    xin, mask, c, hs, dhs = (t.contiguous() for t in tensors)
    partial = torch.empty(lib.rnn_bwd_splits(B, T, H), H, H, dtype=torch.float32, device=dev)
    # Cluster 0: the carry's own pick.
    rc = lib.rnn_bwd(xin.data_ptr(), mask.data_ptr(), c.data_ptr(), hs.data_ptr(), dhs.data_ptr(), dxin.data_ptr(),
                     partial.data_ptr(), dc.data_ptr(), B, T, H, 0, dev.index,
                     torch.cuda.current_stream(dev).cuda_stream)
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
