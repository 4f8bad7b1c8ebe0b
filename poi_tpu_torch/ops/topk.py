"""Full-catalog score + top-k: the CUDA kernel ``csrc/topk.cu`` and its plain
PyTorch version.

Counterpart of ``poi_tpu/ops/topk.py``. Contract, the same as the TPU
kernel's: queries ``q [B, D]`` and the table ``[V, D]`` are rounded to bf16,
scores accumulate in fp32 and add the fp32 bias, ``k <= 128``. Returns
``vals [B, k]`` fp32 descending and ``ids [B, k]`` int32. Ties go to the
lower id, as the TPU kernel's first-column pick and strict ``>`` across
tiles order them. The CUDA kernel takes any V and any D: up to 1024 padded
with zero columns to a multiple of 8, past it to a multiple of 256, whose
rows it streams in K-chunks (``widths.padded_dim``); ``pad_table_for_topk``
is kept because the eval and serving code fix their id space with it.
"""

from __future__ import annotations

import ctypes

import torch

from poi_tpu_torch import _build
from poi_tpu_torch.ops.widths import pad_cols, padded_dim

NEG = -1e30
MAX_K = 128  # the TPU kernel's lane-aligned scratch width; k <= MAX_K
# The kernel reads rows as 16-byte vectors: it takes every multiple of 8 up
# to 1024 whole, and every multiple of 256 past it in K-chunks.
KERNEL_DIMS = tuple(range(8, 1025, 8))


def kernel_dim(D: int) -> int:
    """The width the kernel runs ``D`` at: the next multiple of 8 up to
    1024, of 256 past it."""
    return padded_dim(D, KERNEL_DIMS, "fused_topk", chunked=True)


def pad_table_for_topk(table: torch.Tensor, bias: torch.Tensor, tile_v: int = 2048):
    """Pad (table, bias) rows to a multiple of tile_v; padded rows carry a
    -1e30 bias and so never enter a top-k over real rows."""
    v = table.shape[0]
    v_pad = -(-v // tile_v) * tile_v
    if v_pad == v:
        return table, bias
    table = torch.cat([table, table.new_zeros(v_pad - v, table.shape[1])])
    bias = torch.cat([bias, bias.new_full((v_pad - v,), NEG)])
    return table, bias


def topk_reference(q: torch.Tensor, table: torch.Tensor, bias: torch.Tensor, k: int):
    """Plain PyTorch version of the kernel: fp32 scores of the bf16-rounded
    operands (exact products, fp32 sums), then a stable descending sort,
    which puts the lower id first among equal scores (``torch.topk`` does
    not promise that order)."""
    scores = q.to(torch.bfloat16).float() @ table.to(torch.bfloat16).float().T + bias.float()
    vals, ids = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k].contiguous(), ids[:, :k].to(torch.int32).contiguous()


def fused_topk(q: torch.Tensor, table: torch.Tensor, bias: torch.Tensor, k: int):
    """(vals [B, k] fp32 descending, ids [B, k] int32) of q·tableᵀ + bias.

    CPU tensors take the plain version. CUDA tensors launch the kernel or
    raise; ``fused_topk.launches`` counts the launches.
    """
    if k > MAX_K:
        raise ValueError(f"k={k} > {MAX_K} not supported")
    if q.dim() != 2 or table.dim() != 2 or bias.dim() != 1:
        raise ValueError(f"fused_topk: need q [B,D], table [V,D], bias [V]; got {q.shape}, {table.shape}, {bias.shape}")
    B, D = q.shape
    V = table.shape[0]
    if table.shape[1] != D or bias.shape[0] != V:
        raise ValueError(f"fused_topk: shapes disagree: q {tuple(q.shape)}, table {tuple(table.shape)}, bias {tuple(bias.shape)}")
    if not 1 <= k <= V:
        raise ValueError(f"fused_topk: need 1 <= k <= V={V}, got k={k}")
    devices = {q.device, table.device, bias.device}
    if devices == {torch.device("cpu")}:
        return topk_reference(q, table, bias, k)
    if len(devices) != 1 or q.device.type != "cuda":
        raise ValueError(f"fused_topk: tensors on {sorted(map(str, devices))}; need all on one CUDA device")
    if bias.dtype != torch.float32:
        raise TypeError(f"fused_topk: bias must be float32, got {bias.dtype}")
    if B > 65535:
        raise ValueError(f"fused_topk: B={B} query rows exceed the kernel's grid limit of 65535")
    D = kernel_dim(D)
    q16 = pad_cols(q.to(torch.bfloat16), D).contiguous()
    t16 = pad_cols(table.to(torch.bfloat16), D).contiguous()
    bias = bias.contiguous()
    if t16.data_ptr() % 16:
        raise ValueError("fused_topk: the bf16 table must start on a 16-byte boundary")
    lib = _build.library()
    slice_len = ctypes.c_int(0)
    slices = lib.topk_plan(V, k, B, D, ctypes.byref(slice_len))
    dev = q.device
    vals = torch.empty(B, k, dtype=torch.float32, device=dev)
    ids = torch.empty(B, k, dtype=torch.int32, device=dev)
    # Pass 1's candidates [B, slices, k]; with one slice it writes vals/ids.
    cand_v = torch.empty(B, slices, k, dtype=torch.float32, device=dev) if slices > 1 else vals
    cand_i = torch.empty(B, slices, k, dtype=torch.int32, device=dev) if slices > 1 else ids
    rc = lib.topk_fwd(
        q16.data_ptr(), t16.data_ptr(), bias.data_ptr(), cand_v.data_ptr(), cand_i.data_ptr(),
        vals.data_ptr(), ids.data_ptr(), B, V, D, k, slices, slice_len.value, dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(rc, "topk_fwd launch")
    fused_topk.launches += 1
    return vals, ids


fused_topk.launches = 0


def sharded_topk(q: torch.Tensor, table_local: torch.Tensor, bias_local: torch.Tensor, k: int, mesh,
                 select=fused_topk):
    """Top-k over a vocab-sharded catalog, ``make_sharded_topk``: ``select``
    (``fused_topk``, B11, or ``topk_reference``) takes each shard's local
    top-k of its rows, the ids are offset to the shard's rows of the
    (per-shard padded) catalog, and the k·M candidates are all-gathered over
    ``model`` in shard order. The final k keep, among equal values, the
    earlier candidate (the lower shard, then that shard's order), as
    ``lax.top_k`` over the gathered row does: a stable descending sort.
    ``q [b, D]`` are this data shard's rows. Returns (vals [b, k] fp32, ids
    [b, k] int64)."""
    from poi_tpu_torch.parallel import collectives as cc
    from poi_tpu_torch.parallel.mesh import MODEL_AXIS

    vals, ids = select(q, table_local, bias_local, k)
    ids = ids.long() + cc.axis_index(mesh, MODEL_AXIS) * table_local.shape[0]
    vals_all = cc.all_gather(vals, mesh, MODEL_AXIS, dim=1)
    ids_all = cc.all_gather(ids, mesh, MODEL_AXIS, dim=1)
    v, pos = torch.sort(vals_all, dim=1, descending=True, stable=True)
    return v[:, :k].contiguous(), ids_all.gather(1, pos[:, :k])
