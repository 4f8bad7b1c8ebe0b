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

The kernels keep bf16 ``wh`` in shared memory. The forward holds it in one
block up to H = 196, and above that splits its columns across a cluster of 2,
4 or 8 blocks (H = 256 for config #4, 512 for config #5). The backward
recomputes every step's gates at once on the tensor cores, then runs the
serial carry, ``dh @ whᵀ`` with the fp32 cotangent split into three exact
bf16 products, for groups of 16 batch rows with wh's columns split across a
cluster of 1 to 16 blocks (``gru_bwd_cluster_size``); it takes any H up to
640.
"""

from __future__ import annotations

import torch

from poi_tpu_torch import _build

MASK_NEG = -1e9
TAKES_H = "H <= 196 in one block, or H <= 544 split evenly across a cluster of 2, 4 or 8 blocks"
BWD_TAKES_H = "H <= 640, on a cluster of 1, 2, 4, 8 or 16 blocks a group of batch rows"


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
    lib = _build.library()
    if lib.gru_fwd_cluster_size(H) == 0:
        raise ValueError(f"fused_gru_scan: H={H} is not taken by the kernels: {TAKES_H}")
    xw = xw.contiguous()
    wh = wh.contiguous()
    hs = torch.empty(B, T, H, dtype=torch.float32, device=xw.device)
    stream = torch.cuda.current_stream(xw.device).cuda_stream
    rc = lib.gru_fwd(xw.data_ptr(), wh.data_ptr(), hs.data_ptr(), B, T, H, xw.device.index, stream)
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
    lib = _build.library()
    if lib.gru_bwd_cluster_size(B, H) == 0:
        raise ValueError(f"fused_gru_bwd: H={H} is not taken by the kernels: {BWD_TAKES_H}")
    dev = xw.device
    dxw = torch.empty(B, T, H3, dtype=torch.float32, device=dev)
    dwh = torch.empty(H, H3, dtype=torch.float32, device=dev)
    if B == 0 or T == 0:
        return dxw, dwh.zero_()
    xw, wh, hs, dhs = (t.contiguous() for t in tensors)
    dhw = torch.empty(B, T, H3, dtype=torch.float32, device=dev)  # scratch: the recurrent cotangent per step
    partial = torch.empty(lib.gru_bwd_splits(B, T, H), H, H3, dtype=torch.float32, device=dev)
    rc = lib.gru_bwd(xw.data_ptr(), wh.data_ptr(), hs.data_ptr(), dhs.data_ptr(), dxw.data_ptr(), dhw.data_ptr(),
                     partial.data_ptr(), dwh.data_ptr(), B, T, H, dev.index,
                     torch.cuda.current_stream(dev).cuda_stream)
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
