"""Full-catalog softmax cross-entropy that never stores the [N, V] logits:
the CUDA kernels of ``csrc/ce.cu``, their plain PyTorch versions, and the
autograd ``Function`` around them.

Counterpart of the Pallas path of ``poi_tpu/ops/fused_ce.py``
(``fused_ce_rows_pallas`` / ``fused_ce_loss_pallas``). Contract, the same as
the TPU kernels':

- logits ``q · tableᵀ + bias`` from bf16-rounded ``q [N, D]`` and
  ``table [V, D]`` with fp32 sums and the fp32 ``bias [V]`` (-1e30 on padded
  catalog rows, which then get exactly zero gradient);
- forward (``ce_lse``): ``lse [N]``; the target logit is gathered outside the
  kernel in plain fp32 from the unrounded ``q`` and ``table``, and
  ``nll = lse - target logit``;
- backward (``ce_bwd``): ``gp = exp(logit - lse) · g`` in fp32, rounded to
  bf16 for the two products ``dq = gp · table`` and ``dtable = gpᵀ · q``;
  ``dbias = colsum(gp)`` from the unrounded ``gp``. The one-hot target terms
  are subtracted outside the kernels in plain torch.
"""

from __future__ import annotations

import torch

from poi_tpu_torch import _build

# Catalog columns per chunk of the plain versions: [N, 4096] fp32 logits at a
# time (512 MiB at N = 32,768), so they run at the full training shape.
REFERENCE_CHUNK = 4096


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
    lib = _build.library()
    D = tensors["q"].shape[1]
    if not lib.ce_supports_dim(D):
        raise ValueError(f"{name}: the kernels are built for D in (32, 64, 128), got D={D}")
    return False


def ce_lse(q: torch.Tensor, table: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """[N] fp32 log-sum-exp of ``q · tableᵀ + bias`` over the catalog.

    CPU tensors take the plain version. CUDA tensors launch the kernel or
    raise; ``ce_lse.launches`` counts the launches.
    """
    N, D = q.shape
    V = table.shape[0]
    if table.shape[1] != D or bias.shape != (V,) or V == 0:
        raise ValueError(f"ce_lse: need q [N,D], table [V,D], bias [V], V > 0; got "
                         f"{tuple(q.shape)}, {tuple(table.shape)}, {tuple(bias.shape)}")
    if _check("ce_lse", {"q": q, "table": table, "bias": bias}):
        return ce_lse_reference(q, table, bias)
    lse = torch.empty(N, dtype=torch.float32, device=q.device)
    if N == 0:
        return lse
    q16 = q.to(torch.bfloat16).contiguous()
    t16 = table.to(torch.bfloat16).contiguous()
    b32 = bias.float().contiguous()
    dev = q.device
    rc = _build.library().ce_lse(q16.data_ptr(), t16.data_ptr(), b32.data_ptr(), lse.data_ptr(), N, V, D, dev.index,
                                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "ce_lse launch")
    ce_lse.launches += 1
    return lse


ce_lse.launches = 0


def ce_bwd(q: torch.Tensor, table: torch.Tensor, bias: torch.Tensor, lse: torch.Tensor, g: torch.Tensor):
    """``(dq [N, D], dtable [V, D], dbias [V])`` fp32 of ``sum_n g[n] · lse[n]``
    (the softmax part of the CE gradient, without the one-hot terms).

    CPU tensors take the plain version. CUDA tensors launch the two kernels
    (``ce_bwd_dq``, ``ce_bwd_dtable``) or raise; ``ce_bwd.launches`` counts
    the calls that launched them.
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
    dq = torch.empty(N, D, dtype=torch.float32, device=dev)
    dtable = torch.empty(V, D, dtype=torch.float32, device=dev)
    dbias = torch.empty(V, dtype=torch.float32, device=dev)
    if N == 0:
        return dq, dtable.zero_(), dbias.zero_()
    q16 = q.to(torch.bfloat16).contiguous()
    t16 = table.to(torch.bfloat16).contiguous()
    b32, l32, g32 = (x.float().contiguous() for x in (bias, lse, g))
    rc = _build.library().ce_bwd(q16.data_ptr(), t16.data_ptr(), b32.data_ptr(), l32.data_ptr(), g32.data_ptr(),
                                 dq.data_ptr(), dtable.data_ptr(), dbias.data_ptr(), N, V, D, dev.index,
                                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "ce_bwd launch")
    ce_bwd.launches += 1
    return dq, dtable, dbias


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


def fused_ce_loss(q, table, bias, targets, mask) -> torch.Tensor:
    """Masked-mean fused CE over [B, T, D] queries, the counterpart of
    ``fused_ce_loss_pallas``."""
    B, T, D = q.shape
    nll = fused_ce_rows(q.reshape(B * T, D), table, bias, targets.reshape(-1))
    m = mask.reshape(-1).float()
    return (nll * m).sum() / m.sum().clamp_min(1.0)
