"""GRU forward recurrence: the CUDA kernel ``csrc/gru_fwd.cu`` and its plain
PyTorch version.

Counterpart of ``poi_tpu/ops/fused_gru.py`` (forward only). Contract, the
same as the TPU kernel's:

- ``xw [B, T, 3H]`` fp32: the hoisted input projection plus bias, gate blocks
  ordered z | r | n, with the padding mask already folded into the z block as
  ``MASK_NEG`` (``models/gru.py``). On a padded step ``sigmoid(z) == 0``
  exactly, so the carry passes through unchanged.
- ``wh [H, 3H]`` bf16, h0 = 0.
- per step ``hw = bf16(h) @ wh`` with fp32 accumulation, then
  ``z = σ(xz + hz)``, ``r = σ(xr + hr)``, ``n = tanh(xn + r·hn)``,
  ``h = (1 - z)·h + z·n``.
- returns ``hs [B, T, H]`` fp32.
"""

from __future__ import annotations

import torch

from poi_tpu_torch import _build

MASK_NEG = -1e9
MAX_SMEM_BYTES = 232_448  # the most shared memory one Hopper block may use


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
    smem = lib.gru_fwd_smem_bytes(H)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"fused_gru_scan: H={H} needs {smem} bytes of shared memory for bf16 wh, more than the "
            f"{MAX_SMEM_BYTES} a Hopper block has (H <= 196 fits); splitting wh across a cluster is not built yet"
        )
    xw = xw.contiguous()
    wh = wh.contiguous()
    hs = torch.empty(B, T, H, dtype=torch.float32, device=xw.device)
    stream = torch.cuda.current_stream(xw.device).cuda_stream
    rc = lib.gru_fwd(xw.data_ptr(), wh.data_ptr(), hs.data_ptr(), B, T, H, xw.device.index, stream)
    _build.check(rc, "gru_fwd launch")
    fused_gru_scan.launches += 1
    return hs


fused_gru_scan.launches = 0
