"""Full-catalog softmax cross-entropy that never stores the [N, V] logits:
the CUDA kernels of ``csrc/ce.cu`` (forward) and ``csrc/ce_bwd.cu``
(backward), their plain PyTorch versions, and the autograd ``Function``
around them.

Counterpart of the Pallas path of ``poi_tpu/ops/fused_ce.py``
(``fused_ce_rows_pallas`` / ``fused_ce_loss_pallas``). Contract, the same as
the TPU kernels':

- logits ``q · tableᵀ + bias`` from bf16-rounded ``q [N, D]`` and
  ``table [V, D]`` with fp32 sums and the fp32 ``bias [V]`` (-1e30 on padded
  catalog rows, which then get exactly zero gradient);
- forward (``ce_lse``): ``lse [N]`` (where the row blocks do not fill the
  card, the catalog is split into ranges whose partial (max, sum) pairs a
  merge combines in order: ``lse_merge_reference``); the target logit is gathered outside the
  kernel in plain fp32 from the unrounded ``q`` and ``table``, and
  ``nll = lse - target logit``;
- backward (``ce_bwd``): ``gp = exp(logit - lse) · g`` in fp32, rounded to
  bf16 for the two products ``dq = gp · table`` and ``dtable = gpᵀ · q``;
  ``dbias = colsum(gp)`` from the unrounded ``gp``. The one-hot target terms
  are subtracted outside the kernels in plain torch.

Widths: the kernels are built for ``KERNEL_DIMS``; the wrappers pad any
``D <= MAX_DIM`` with zero columns to the next of them (``widths.padded_dim``).
Zero columns add nothing to ``q · tableᵀ``, and the padded columns of
``dq`` and ``dtable`` are dropped, so the result is the function at ``D``;
``D > MAX_DIM`` raises, naming the limit. No width pads by more than 1.5×
past 128. The forward runs 128 rows a block at ``D = 256`` and 384, 64 from
512 (``lse_rows``); at 384 and 512 the backward's blocks each sum half of
the output columns, both halves recomputing the logits. At 768 and 1024
both stream the catalog in K-chunks of 256 columns (``csrc/kchunk.cuh``),
and the backward's blocks each sum one range of 256 output columns, every
range recomputing the logits. ``lse_plan`` and ``bwd_plan`` give each
width's block shape, as ``ce_lse_plan`` and ``ce_bwd_plan`` in the C
sources do.

``ce_lse_variant`` holds the forward's tuning variants, the counterparts of
``scripts/sweep_ce_fwd.py``'s kernels (``exp2``, ``nomax``), on ``ce_lse``'s
own kernel; ``scripts/sweep_ce_fwd.py`` of this package times them. The TPU
sweep's row block (``rb``) maps to the kernel's consumer warpgroups, 64 rows
each (``ROWS``); its catalog chunk (``cv``) has no counterpart, as the
streamed tile is fixed at 64 rows by the ``wgmma``'s N. Nothing on the train
or serve path calls them.
"""

from __future__ import annotations

import torch

from poi_tpu_torch import _build
from poi_tpu_torch.ops.widths import KCHUNK, kchunk_bwd_stages, kchunk_fwd_stages, pad_cols, padded_dim

# Catalog columns per chunk of the plain versions: [N, 4096] fp32 logits at a
# time (512 MiB at N = 32,768), so they run at the full training shape.
REFERENCE_CHUNK = 4096
LOG2E = 1.4426950408889634
# The forward's variants, in the C entry's numbering, and its rows per block
# (2 or 4 consumer warpgroups; ce_lse takes 256).
VARIANTS = ("base", "exp2", "nomax")
ROWS = (128, 256)
# The widths the kernels are built for (``ce_supports_dim`` in csrc/ce.cu
# says the same; B12's variants take the first three).
KERNEL_DIMS = (32, 64, 128, 192, 256, 384, 512, 768, 1024)
MAX_DIM = KERNEL_DIMS[-1]


def lse_rows(D: int) -> int:
    """The query rows a block of ``ce_lse`` at width ``D`` (``lse_rows_for``
    in csrc/ce.cu): 128 where it runs at 256 or 384 columns, 64 from 512,
    else 256."""
    return {256: 128, 384: 128, 512: 64, 768: 64, 1024: 64}.get(padded_dim(D, KERNEL_DIMS, "ce_lse"), 256)


def lse_plan(D: int) -> tuple[int, int, int]:
    """``ce_lse``'s block at width ``D`` (run at ``padded_dim(D)``), as
    ``ce_lse_plan`` in csrc/ce.cu gives it: (query rows a block, ring
    stages, columns a streamed chunk). Up to 512 a tile arrives whole, on 4
    stages (2 from 384); past it in chunks of 256 (``csrc/kchunk.cuh``)."""
    Dp = padded_dim(D, KERNEL_DIMS, "ce_lse")
    if Dp > 512:
        return lse_rows(Dp), kchunk_fwd_stages(Dp, 1), KCHUNK
    return lse_rows(Dp), 2 if Dp >= 384 else 4, Dp


def bwd_plan(D: int) -> tuple[int, int, int, int]:
    """``ce_bwd``'s blocks at width ``D`` (run at ``padded_dim(D)``), as
    ``ce_bwd_plan`` in csrc/ce_bwd.cu gives them: (resident rows a block,
    ring stages, output column ranges, columns a streamed chunk). Up to 256
    two warpgroups sum every column; at 384 and 512 one, over half the
    columns; past 512 one, over 256 columns, the tile in chunks of 256."""
    Dp = padded_dim(D, KERNEL_DIMS, "ce_bwd")
    if Dp > 512:
        return 64, kchunk_bwd_stages(Dp, 2), Dp // KCHUNK, KCHUNK
    return (64, 2, 2, Dp) if Dp >= 384 else (128, 4, 1, Dp)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def ce_lse_reference(q: torch.Tensor, table: torch.Tensor, bias: torch.Tensor,
                     chunk: int = REFERENCE_CHUNK) -> torch.Tensor:
    """Plain PyTorch version of ``ce_lse``: [N] fp32 log-sum-exp over the
    catalog, an online max and sum over catalog chunks."""
    qb = _bf16(q)
    m = qb.new_full((q.shape[0],), float("-inf"))
    s = qb.new_zeros(q.shape[0])
    for v0 in range(0, table.shape[0], chunk):
        logits = qb @ _bf16(table[v0:v0 + chunk]).T + bias[v0:v0 + chunk].float()
        m_new = torch.maximum(m, logits.max(dim=1).values)
        s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(dim=1)
        m = m_new
    return m + torch.log(s)


def lse_partials_reference(q: torch.Tensor, table: torch.Tensor, bias: torch.Tensor, bounds,
                           variant: str = "base") -> tuple:
    """The partials a split launch of ``variant`` writes, in plain PyTorch:
    for each catalog range ``[v0, v1)`` of ``bounds``, each row's max logit
    ``m`` and ``l = sum exp(logit - m)`` over the range. Returns ``(m, l)``,
    each ``[S, N]`` fp32, in the variant's units: natural for ``base`` (the
    kernel keeps them in base 2); base 2 for ``exp2``, whose logits are
    ``bf16(q · log2(e)) · table + bias · log2(e)``, with ``2^`` for ``exp``;
    ``m = 0`` for ``nomax``, which keeps no max."""
    scale = LOG2E if variant == "exp2" else 1.0
    q, bias = _bf16(q.float() * scale), bias.float() * scale
    ms, ls = [], []
    for v0, v1 in bounds:
        logits = q @ _bf16(table[v0:v1]).T + bias[v0:v1]
        m = logits.new_zeros(q.shape[0]) if variant == "nomax" else logits.max(dim=1).values
        ms.append(m)
        ls.append((torch.exp2 if variant == "exp2" else torch.exp)(logits - m[:, None]).sum(dim=1))
    return torch.stack(ms), torch.stack(ls)


def lse_merge_reference(m: torch.Tensor, l: torch.Tensor, variant: str = "base") -> torch.Tensor:
    """Plain PyTorch version of the forward's merge (``lse_merge`` in
    ``csrc/ce.cu``): ``[S, N]`` partial maxima and sums of S catalog ranges
    (``lse_partials_reference``'s) combined in range order,
    ``M + log(sum_s l_s exp(m_s - M))`` with ``M = max_s m_s``; ``exp2`` in
    base 2 and divided by log2(e) at the end; ``nomax``'s maxima are 0, so
    its merge is ``log(sum_s l_s)``. Used by nothing on the train or serve
    path."""
    M = m.max(dim=0).values
    L = torch.zeros_like(M)
    for s in range(m.shape[0]):
        L = L + l[s] * (torch.exp2 if variant == "exp2" else torch.exp)(m[s] - M)
    return (M + torch.log2(L)) / LOG2E if variant == "exp2" else M + torch.log(L)


def ce_lse_exp2_reference(q: torch.Tensor, table: torch.Tensor, bias: torch.Tensor,
                          chunk: int = REFERENCE_CHUNK) -> torch.Tensor:
    """Plain PyTorch version of the ``exp2`` variant: ``q`` is scaled by
    log2(e) in fp32 and then rounded to bf16, the bias scaled in fp32, so
    the logits are in base 2; an online max and sum of ``2^x`` over catalog
    chunks, and ``lse = (log2(l) + m) / log2(e)``. It differs from the exact
    LSE by the rounding of ``q · log2(e)``."""
    q2 = _bf16(q.float() * LOG2E)
    m = q2.new_full((q.shape[0],), float("-inf"))
    s = q2.new_zeros(q.shape[0])
    for v0 in range(0, table.shape[0], chunk):
        logits = q2 @ _bf16(table[v0:v0 + chunk]).T + bias[v0:v0 + chunk].float() * LOG2E
        m_new = torch.maximum(m, logits.max(dim=1).values)
        s = s * torch.exp2(m - m_new) + torch.exp2(logits - m_new[:, None]).sum(dim=1)
        m = m_new
    return (torch.log2(s) + m) / LOG2E


def ce_lse_nomax_reference(q: torch.Tensor, table: torch.Tensor, bias: torch.Tensor,
                           chunk: int = REFERENCE_CHUNK) -> torch.Tensor:
    """Plain PyTorch version of the ``nomax`` variant: ``log`` of the plain
    sum of ``exp(logit)`` over catalog chunks, no running max. Unsafe: a
    logit past about 88 overflows fp32 to inf."""
    qb = _bf16(q)
    s = qb.new_zeros(q.shape[0])
    for v0 in range(0, table.shape[0], chunk):
        s = s + torch.exp(qb @ _bf16(table[v0:v0 + chunk]).T + bias[v0:v0 + chunk].float()).sum(dim=1)
    return torch.log(s)


VARIANT_REFERENCES = {"base": ce_lse_reference, "exp2": ce_lse_exp2_reference, "nomax": ce_lse_nomax_reference}


def ce_bwd_reference(q: torch.Tensor, table: torch.Tensor, bias: torch.Tensor, lse: torch.Tensor, g: torch.Tensor,
                     chunk: int = REFERENCE_CHUNK):
    """Plain PyTorch version of ``ce_bwd``: ``(dq [N, D], dtable [V, D],
    dbias [V])`` fp32, without the one-hot target terms; the same rounding
    points as the kernels."""
    qb = _bf16(q)
    lse, g = lse.float(), g.float()
    dq = qb.new_zeros(q.shape)
    dtable = qb.new_zeros(table.shape)
    dbias = qb.new_zeros(table.shape[0])
    for v0 in range(0, table.shape[0], chunk):
        tb = _bf16(table[v0:v0 + chunk])
        logits = qb @ tb.T + bias[v0:v0 + chunk].float()
        gp = torch.exp(logits - lse[:, None]) * g[:, None]
        gpb = _bf16(gp)
        dq += gpb @ tb
        dtable[v0:v0 + chunk] = gpb.T @ qb
        dbias[v0:v0 + chunk] = gp.sum(dim=0)
    return dq, dtable, dbias


def _check(name: str, tensors: dict[str, torch.Tensor]) -> bool:
    """True when every tensor lies on the CPU (the plain versions run); False
    when all lie on one CUDA device and the kernel may launch; raises
    otherwise."""
    devices = {t.device for t in tensors.values()}
    if devices == {torch.device("cpu")}:
        return True
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{name}: tensors on {sorted(map(str, devices))}; need all on one CUDA device")
    padded_dim(tensors["q"].shape[1], KERNEL_DIMS, name)
    return False


def _lse_launch(wrapper, name: str, q: torch.Tensor, table: torch.Tensor, bias: torch.Tensor, variant: str,
                rows: int) -> torch.Tensor:
    """Launches ``csrc/ce.cu``'s kernel (and, where it splits the catalog,
    its merge) for ``variant`` at ``rows`` query rows a block on CUDA
    tensors, or raises through ``_build.check``; counts the launch on
    ``wrapper.launches``."""
    N, D = q.shape[0], padded_dim(q.shape[1], KERNEL_DIMS, name)
    V = table.shape[0]
    if D > 128 and (variant, rows) != ("base", lse_rows(D)):
        raise ValueError(f"{name}: at D={q.shape[1]} the kernel runs only the base variant at "
                         f"{lse_rows(D)} rows a block; the variants take D <= 128")
    lse = torch.empty(N, dtype=torch.float32, device=q.device)
    if N == 0:
        return lse
    if variant == "exp2":  # base 2: q scaled before its bf16 rounding
        q, bias = q.float() * LOG2E, bias.float() * LOG2E
    q16 = pad_cols(q.to(torch.bfloat16), D).contiguous()
    t16 = pad_cols(table.to(torch.bfloat16), D).contiguous()
    b32 = bias.float().contiguous()
    dev = q.device
    lib = _build.library()
    # fp32 partial (max, sum) pairs of the catalog ranges, where the row blocks split it to fill the card.
    scratch = torch.empty(max(1, lib.ce_lse_scratch(N, V, D, rows)), dtype=torch.float32, device=dev)
    rc = lib.ce_lse_variant(q16.data_ptr(), t16.data_ptr(), b32.data_ptr(), lse.data_ptr(), scratch.data_ptr(), N, V,
                            D, VARIANTS.index(variant), rows, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, f"{name} launch")
    wrapper.launches += 1
    return lse


def _check_shapes(name: str, q: torch.Tensor, table: torch.Tensor, bias: torch.Tensor) -> None:
    V = table.shape[0]
    if q.dim() != 2 or table.shape[1] != q.shape[1] or bias.shape != (V,) or V == 0:
        raise ValueError(f"{name}: need q [N,D], table [V,D], bias [V], V > 0; got "
                         f"{tuple(q.shape)}, {tuple(table.shape)}, {tuple(bias.shape)}")


def ce_lse(q: torch.Tensor, table: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """[N] fp32 log-sum-exp of ``q · tableᵀ + bias`` over the catalog.

    CPU tensors take the plain version. CUDA tensors launch the kernel at
    ``lse_rows(D)`` rows a block (and, where it splits the catalog, its
    merge), ``D`` padded to ``padded_dim(D)``, or raise; ``ce_lse.launches``
    counts the calls that launched them.
    """
    _check_shapes("ce_lse", q, table, bias)
    if _check("ce_lse", {"q": q, "table": table, "bias": bias}):
        return ce_lse_reference(q, table, bias)
    return _lse_launch(ce_lse, "ce_lse", q, table, bias, "base", lse_rows(q.shape[1]))


ce_lse.launches = 0


def ce_lse_variant(q: torch.Tensor, table: torch.Tensor, bias: torch.Tensor, variant: str = "base",
                   rows: int = 256) -> torch.Tensor:
    """[N] fp32 log-sum-exp of ``q · tableᵀ + bias`` through one of the
    forward's tuning variants (``VARIANTS``) with ``rows`` query rows a block
    (``ROWS``), on ``ce_lse``'s kernel: ``base`` at 256 rows is ``ce_lse``
    itself. ``exp2`` scales ``q`` (in fp32, before its bf16 rounding) and
    ``bias`` by log2(e) here, so its result carries the rounding of
    ``q · log2(e)``. ``nomax`` keeps no running max and is UNSAFE: a logit
    past about 88 overflows the fp32 sum to inf.

    CPU tensors take the variant's plain version (``VARIANT_REFERENCES``).
    CUDA tensors launch the kernel (and, where it splits the catalog, its
    merge) or raise; ``ce_lse_variant.launches`` counts the calls that
    launched them.
    """
    if variant not in VARIANTS or rows not in ROWS:
        raise ValueError(f"ce_lse_variant: variant in {VARIANTS} and rows in {ROWS}, got {variant!r}, {rows}")
    _check_shapes("ce_lse_variant", q, table, bias)
    if _check("ce_lse_variant", {"q": q, "table": table, "bias": bias}):
        return VARIANT_REFERENCES[variant](q, table, bias)
    return _lse_launch(ce_lse_variant, f"ce_lse_variant({variant}, rows={rows})", q, table, bias, variant, rows)


ce_lse_variant.launches = 0


def ce_bwd(q: torch.Tensor, table: torch.Tensor, bias: torch.Tensor, lse: torch.Tensor, g: torch.Tensor):
    """``(dq [N, D], dtable [V, D], dbias [V])`` fp32 of ``sum_n g[n] · lse[n]``
    (the softmax part of the CE gradient, without the one-hot terms).

    CPU tensors take the plain version. CUDA tensors launch the kernels (the
    dq pass and the dtable pass of ``csrc/ce_bwd.cu``, and the reduction of
    split partials where a pass splits) at ``padded_dim(D)`` columns, the
    padded ones dropped from ``dq`` and ``dtable``, or raise;
    ``ce_bwd.launches`` counts the calls that launched them.
    """
    N, D = q.shape
    V = table.shape[0]
    if table.shape[1] != D or bias.shape != (V,) or lse.shape != (N,) or g.shape != (N,) or V == 0:
        raise ValueError(f"ce_bwd: need q [N,D], table [V,D], bias [V], lse and g [N], V > 0; got "
                         f"{tuple(q.shape)}, {tuple(table.shape)}, {tuple(bias.shape)}, "
                         f"{tuple(lse.shape)}, {tuple(g.shape)}")
    if _check("ce_bwd", {"q": q, "table": table, "bias": bias, "lse": lse, "g": g}):
        return ce_bwd_reference(q, table, bias, lse, g)
    dev = q.device
    Dp = padded_dim(D, KERNEL_DIMS, "ce_bwd")
    dq = torch.empty(N, Dp, dtype=torch.float32, device=dev)
    dtable = torch.empty(V, Dp, dtype=torch.float32, device=dev)
    dbias = torch.empty(V, dtype=torch.float32, device=dev)
    if N == 0:
        return dq[:, :D], dtable[:, :D].zero_(), dbias.zero_()
    q16 = pad_cols(q.to(torch.bfloat16), Dp).contiguous()
    t16 = pad_cols(table.to(torch.bfloat16), Dp).contiguous()
    b32, l32, g32 = (x.float().contiguous() for x in (bias, lse, g))
    lib = _build.library()
    # fp32 partials of a pass that splits its streamed rows to fill the card.
    scratch = torch.empty(max(1, lib.ce_bwd_scratch(N, V, Dp)), dtype=torch.float32, device=dev)
    rc = lib.ce_bwd(q16.data_ptr(), t16.data_ptr(), b32.data_ptr(), l32.data_ptr(), g32.data_ptr(), dq.data_ptr(),
                    dtable.data_ptr(), dbias.data_ptr(), scratch.data_ptr(), N, V, Dp, dev.index,
                    torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "ce_bwd launch")
    ce_bwd.launches += 1
    return dq[:, :D], dtable[:, :D], dbias


ce_bwd.launches = 0


class FusedCERows(torch.autograd.Function):
    """Per-row NLL of ``targets`` under softmax(q · tableᵀ + bias); the
    counterpart of ``fused_ce_rows_pallas``'s custom VJP."""

    @staticmethod
    def forward(ctx, q, table, bias, targets):
        q, table, bias = q.detach(), table.detach(), bias.detach()
        lse = ce_lse(q, table, bias)
        tgt = (q.float() * table[targets].float()).sum(dim=1) + bias[targets].float()
        ctx.save_for_backward(q, table, bias, targets, lse)
        return lse - tgt

    @staticmethod
    def backward(ctx, g):
        q, table, bias, targets, lse = ctx.saved_tensors
        g = g.float().contiguous()
        dq, dtable, dbias = ce_bwd(q, table, bias, lse, g)
        dq -= g[:, None] * table[targets].float()
        dtable.index_add_(0, targets, -g[:, None] * q.float())
        dbias.index_add_(0, targets, -g)
        return dq, dtable, dbias, None


def fused_ce_rows(q, table, bias, targets) -> torch.Tensor:
    """[N] fp32 per-row NLL; differentiable in ``q``, ``table`` and ``bias``."""
    return FusedCERows.apply(q, table, bias, targets)


def fused_ce_loss(q, table, bias, targets, mask, mean=None) -> torch.Tensor:
    """Masked-mean fused CE over [B, T, D] queries, the counterpart of
    ``fused_ce_loss_pallas``."""
    B, T, D = q.shape
    nll = fused_ce_rows(q.reshape(B * T, D), table, bias, targets.reshape(-1))
    if mean is not None:  # another reduction than this batch's masked mean
        return mean(nll, mask.reshape(-1))
    m = mask.reshape(-1).float()
    return (nll * m).sum() / m.sum().clamp_min(1.0)
