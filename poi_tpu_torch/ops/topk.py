"""Full-catalog score + top-k: the CUDA kernels ``csrc/topk_wg.cu`` (wgmma)
and ``csrc/topk.cu`` (the mma.sync design), the plan that picks between
them, and their plain PyTorch version.

Counterpart of ``poi_tpu/ops/topk.py``. Contract, the same as the TPU
kernel's: queries ``q [B, D]`` and the table ``[V, D]`` are rounded to bf16,
scores accumulate in fp32 and add the fp32 bias, ``k <= 128``. Returns
``vals [B, k]`` fp32 descending and ``ids [B, k]`` int32. Ties go to the
lower id, as the TPU kernel's first-column pick and strict ``>`` across
tiles order them. The kernels take any V and any D: up to 1024 padded with
zero columns to a multiple of 8, past it to a multiple of 256
(``widths.padded_dim``); ``pad_table_for_topk`` is kept because the eval and
serving code fix their id space with it. ``topk_plan`` is the launch plan,
a pure function the CPU tests hold; the C entry points only check it.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

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


# The launch plan: which design takes a call and how it cuts the work. The C
# entry points (csrc/topk.cu topk_fwd, csrc/topk_wg.cu topk_wg) only check
# what they are given; the numbers below mirror their constants.
SMS = 132  # H100 SXM
SMEM_OPT_IN = 232448  # the dynamic shared memory a block may opt into
# The mma.sync design (topk_slice_kernel, then topk_merge_kernel): D <= 128, a
# block of 64 query rows and 64-row tiles, at most 64 slices a row group (32
# at k > 32: its merge warp walks every slice's list), each at least 4 tiles.
SLICE_MAX_D = 128
SLICE_ROWS = SLICE_TILE = 64
SLICE_MAX_SLICES = 64
SLICE_MIN_TILES = 4
# The wgmma design (topk_wg_kernel, then topk_wg_merge_kernel): 64-row
# tiles, 64 query rows a consumer warpgroup (8 held where B <= 8), 64
# survivors a row between merges, a ring of 4 to 8 stages of 1, 2 or 4 boxes
# of 64 columns, each slice at least 2 tiles.
WG_TILE = 64
WG_SURV = 64
WG_MIN_STAGES = 4
WG_MAX_STAGES = 8
WG_MIN_TILES = 2


def list_len(k: int) -> int:
    """A row's sorted list in the kernels: k rounded up to 32 or 128."""
    return 32 if k <= 32 else 128


def wg_smem(qrows: int, D: int, unit_boxes: int, stages: int, resident: bool, surv_rows: int = 0) -> int:
    """``wg_smem_bytes`` of csrc/topk_wg.cu: the base's alignment, the
    ``qrows`` resident query rows, the ring (a stage: the unit's table boxes
    and, when the rows stream, theirs), the stages' bias, ``surv_rows`` rows'
    survivor buffers and the barriers."""
    boxes = -(-D // 64)
    stage = unit_boxes * (WG_TILE * 128 + (0 if resident else qrows * 128))
    return (1024 + (qrows * boxes * 128 if resident else 0) + stages * stage + stages * WG_TILE * 4
            + surv_rows * WG_SURV * 8 + (2 * stages + 1) * 8)


@dataclass(frozen=True)
class TopkPlan:
    """How one call runs. ``design``: "wg" (wgmma fed by TMA, csrc/topk_wg.cu)
    or "slice" (the mma.sync design, csrc/topk.cu). ``slices``: catalog
    slices a row group, one block each; ``slice_len``: a "slice" slice's rows
    (whole tiles; the last ends at V), 0 for "wg", whose slice s takes tiles
    [s T / S, (s + 1) T / S). ``rows``: query rows a block; ``tile``: table
    rows a tile. "wg" only: ``qrows`` query rows held (``rows``, or 8 at B
    <= 8: the products' A operand reads those 8 for each group of 8 rows),
    ``stages`` of ``unit_boxes`` boxes of 64 columns, the query rows
    ``resident`` or streamed with each unit, the rows' survivor buffers in
    smem (``surv_rows`` = qrows) or in device memory (0), ``smem`` bytes a
    block."""

    design: str
    slices: int
    slice_len: int
    rows: int
    tile: int
    qrows: int = 0
    stages: int = 0
    unit_boxes: int = 0
    resident: bool = False
    surv_rows: int = 0
    smem: int = 0

    def groups(self, B: int) -> int:
        return -(-B // self.rows)

    def scratch(self, B: int, k: int) -> tuple[int, int, int] | None:
        """The shape of pass 1's candidates (values and ids each), or None
        where pass 1 writes the result (one "slice" slice)."""
        if self.design == "wg":
            return (B, self.slices, list_len(k))
        return (B, self.slices, k) if self.slices > 1 else None

    def survivors(self, B: int) -> int:
        """The pairs of pass 1's survivor buffers in device memory ("wg",
        where they are not in smem): WG_SURV a row of every block."""
        if self.design != "wg" or self.surv_rows:
            return 0
        return self.groups(B) * self.slices * self.rows * WG_SURV

    def ranges(self, V: int) -> list[tuple[int, int]]:
        """The catalog rows [start, end) of each slice."""
        if self.design == "wg":
            T = -(-V // self.tile)
            return [(s * T // self.slices * self.tile, min(V, (s + 1) * T // self.slices * self.tile))
                    for s in range(self.slices)]
        return [(s * self.slice_len, min(V, (s + 1) * self.slice_len)) for s in range(self.slices)]

    def kernels(self) -> tuple[str, ...]:
        """The kernels one call launches, by name."""
        if self.design == "wg":
            return ("topk_wg_kernel", "topk_wg_merge_kernel")
        return ("topk_slice_kernel", "topk_merge_kernel") if self.slices > 1 else ("topk_slice_kernel",)


def _slice_plan(B: int, V: int, D: int, k: int) -> TopkPlan:
    """The mma.sync design's plan: as many slices as it takes for (row groups x slices) to
    reach the SM count, each at least SLICE_MIN_TILES tiles, at most
    SLICE_MAX_SLICES (half at k > 32)."""
    rows, tile = SLICE_ROWS, SLICE_TILE
    groups = -(-B // rows) if B > 0 else 1
    tiles = -(-V // tile)
    most = SLICE_MAX_SLICES if list_len(k) == 32 else SLICE_MAX_SLICES // 2
    cap = min(max(tiles // SLICE_MIN_TILES, 1), most)
    want = min(max(-(-SMS // groups), 1), cap)
    slice_len = tile * -(-tiles // want)
    return TopkPlan("slice", -(-V // slice_len), slice_len, rows, tile)


def _wg_plan(B: int, V: int, D: int, k: int) -> TopkPlan:
    """The wgmma design's plan: 128 query rows a block (two consumer
    warpgroups) past B = 64, else 64, of which 8 are held at B <= 8. The
    query rows resident where they fit beside WG_MIN_STAGES stages, else
    streamed with each unit; the rows' survivor buffers in smem where they fit
    too, else in device memory; the widest unit (4, 2 or 1 boxes) that gives
    WG_MIN_STAGES stages, and as many stages as fit, up to WG_MAX_STAGES. At
    k <= 32 a unit is at least 2 boxes (1 at D <= 64), even if the survivors
    then go to device memory: merges are rare there, and the deeper ring
    wins; past k = 32 merges are frequent, and the survivors keep smem (both
    measured on the H100 at config #5's width, PERF.md). As many slices as fill
    the SMs in one wave (row groups x slices <= SMS), each at least
    WG_MIN_TILES tiles."""
    rows = 128 if B > 64 else 64
    qrows = 8 if B <= 8 else rows
    boxes = -(-D // 64)
    least = 1 if list_len(k) == 128 else min(2, boxes)

    def stages(unit_boxes, resident, surv_rows):
        fit = [st for st in range(WG_MIN_STAGES, WG_MAX_STAGES + 1)
               if wg_smem(qrows, D, unit_boxes, st, resident, surv_rows) <= SMEM_OPT_IN]
        return max(fit, default=0)

    # The last candidate, streamed rows and survivors in device memory on one-box
    # stages, fits at any D (at most 100,424 bytes at 4 stages).
    unit_boxes, resident, surv_rows, n_stages = next(
        (u, res, sr, stages(u, res, sr)) for res in (True, False) for sr in (qrows, 0)
        for u in dict.fromkeys(min(n, boxes) for n in (4, 2, 1) if min(n, boxes) >= least or (not res and not sr))
        if stages(u, res, sr))
    groups = -(-B // rows) if B > 0 else 1
    tiles = -(-V // WG_TILE)
    slices = max(1, min(SMS // groups, tiles // WG_MIN_TILES))
    return TopkPlan("wg", slices, 0, rows, WG_TILE, qrows, n_stages, unit_boxes, resident, surv_rows,
                    wg_smem(qrows, D, unit_boxes, n_stages, resident, surv_rows))


@functools.cache
def topk_plan(B: int, V: int, D: int, k: int, design: str | None = None) -> TopkPlan:
    """The launch of ``fused_topk`` for B query rows, V catalog rows, kernel
    width D (``kernel_dim``) and k. ``design`` names one to hold the two
    against each other on the card; ``fused_topk`` passes None, the rule
    (measured on the H100 at every B11 shape of PERF.md, both designs on the
    same inputs): the wgmma design from D = 128, and from D = 64 at B <= 8;
    the mma.sync design for the rest (config #1's serving at batch 256, 0.079
    against 0.110 ms device, and every D < 64). A score's bits do not
    depend on the design, so the rule may depend on B: a mesh shard and its
    catalog agree whichever design takes each."""
    if design is None:
        design = "wg" if D >= 128 or (D >= 64 and B <= 8) else "slice"
    if design == "wg":
        if D < 64:
            raise ValueError(f"topk_plan: the wgmma design takes D >= 64, got {D}")
        return _wg_plan(B, V, D, k)
    if design == "slice":
        if D > SLICE_MAX_D:
            raise ValueError(f"topk_plan: the mma.sync design takes D <= {SLICE_MAX_D}, got {D}")
        return _slice_plan(B, V, D, k)
    raise ValueError(f"topk_plan: unknown design {design!r}")


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

    CPU tensors take the plain version. CUDA tensors launch the design that
    ``topk_plan`` picks or raise; ``fused_topk.launches`` counts the launches.
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
    return launch_topk(q, table, bias, k, topk_plan(B, V, kernel_dim(D), k))


def launch_topk(q: torch.Tensor, table: torch.Tensor, bias: torch.Tensor, k: int, plan: TopkPlan):
    """``fused_topk``'s launch on CUDA tensors with the given plan (the
    wrapper's own, or, to hold one design against the other on the card,
    ``topk_plan``'s with ``design`` named). Counts in ``fused_topk.launches``."""
    devices = {q.device, table.device, bias.device}
    if len(devices) != 1 or q.device.type != "cuda":
        raise ValueError(f"fused_topk: tensors on {sorted(map(str, devices))}; need all on one CUDA device")
    if bias.dtype != torch.float32:
        raise TypeError(f"fused_topk: bias must be float32, got {bias.dtype}")
    B, V = q.shape[0], table.shape[0]
    if B > 65535:
        raise ValueError(f"fused_topk: B={B} query rows exceed the kernel's grid limit of 65535")
    D = kernel_dim(q.shape[1])
    q16 = pad_cols(q.to(torch.bfloat16), D).contiguous()
    t16 = pad_cols(table.to(torch.bfloat16), D).contiguous()
    bias = bias.contiguous()
    if t16.data_ptr() % 16 or q16.data_ptr() % 16:
        raise ValueError("fused_topk: the bf16 queries and table must start on a 16-byte boundary")
    lib = _build.library()
    dev = q.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    vals = torch.empty(B, k, dtype=torch.float32, device=dev)
    ids = torch.empty(B, k, dtype=torch.int32, device=dev)
    shape = plan.scratch(B, k)
    cand_v = torch.empty(shape, dtype=torch.float32, device=dev) if shape else vals
    cand_i = torch.empty(shape, dtype=torch.int32, device=dev) if shape else ids
    if plan.design == "wg":
        n = plan.survivors(B)
        surv_v = torch.empty(n, dtype=torch.float32, device=dev) if n else vals
        surv_i = torch.empty(n, dtype=torch.int32, device=dev) if n else ids
        rc = lib.topk_wg(
            q16.data_ptr(), t16.data_ptr(), bias.data_ptr(), cand_v.data_ptr(), cand_i.data_ptr(), surv_v.data_ptr(),
            surv_i.data_ptr(), vals.data_ptr(), ids.data_ptr(), B, V, D, k, plan.slices, plan.rows, plan.qrows,
            plan.unit_boxes, plan.stages, int(plan.resident), plan.surv_rows, dev.index, stream,
        )
    else:
        rc = lib.topk_fwd(
            q16.data_ptr(), t16.data_ptr(), bias.data_ptr(), cand_v.data_ptr(), cand_i.data_ptr(),
            vals.data_ptr(), ids.data_ptr(), B, V, D, k, plan.slices, plan.slice_len, dev.index, stream,
        )
    _build.check(rc, f"topk ({plan.design}) launch")
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
