"""Sampled softmax over one negative pool shared by every row, without
storing the [N, S] logits: the CUDA kernels of ``csrc/sampled.cu``, their
plain PyTorch versions, and the autograd ``Function`` around them.

Counterpart of ``poi_tpu/ops/fused_sampled.py``. Contract, the same as the
TPU kernels':

- negative logits ``z = q · e_negᵀ + b_neg`` from bf16-rounded ``q [N, D]``
  and ``e_neg [S, D]`` with fp32 sums; ``b_neg [S]`` carries the logQ
  correction; ``z = -1e30`` where a pool id equals the row's target (an
  accidental hit);
- forward (``sampled_lse``): ``lse_neg [N]``; outside the kernel, in plain
  fp32, ``lse_tot = logaddexp(lse_neg, s_pos)`` and ``nll = lse_tot - s_pos``;
- backward (``sampled_bwd``): ``gp = exp(z - lse_tot) · g`` in fp32, rounded
  to bf16 for ``dq = gp · e_neg`` and ``de_neg = gpᵀ · q``;
  ``db_neg = colsum(gp)`` from the unrounded ``gp``. The positive column's
  gradient ``ds_pos = g · (exp(s_pos - lse_tot) - 1)`` stays outside.

The kernels are built for ``KERNEL_DIMS``; on CUDA tensors the wrappers pad
any ``D <= 1024`` with zero columns to the next of them (``widths.padded_dim``:
config #5's 384-wide variants run at 512) and drop the padded columns of
``dq`` and ``de_neg``. Zero columns add nothing to ``q · e_negᵀ``. At 768
and 1024 both kernels stream the pool in K-chunks of 256 columns
(``csrc/kchunk.cuh``); ``plan`` gives each width's block shape, as
``sampled_plan`` in ``csrc/sampled.cu`` does.
"""

from __future__ import annotations

import numpy as np
import torch

from poi_tpu_torch import _build
from poi_tpu_torch.models.base import gather_rows
from poi_tpu_torch.ops.widths import KCHUNK, kchunk_bwd_stages, kchunk_fwd_stages, pad_cols, padded_dim

NEG = -1e30


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def log_q(num_sampled: int, num_pois: int) -> float:
    """The logQ correction log(S/V) of uniform sampling with replacement,
    taken in float32 as the TPU package takes it."""
    return float(np.log(np.float32(num_sampled / num_pois)))


def sampled_logits_reference(q, e_neg, b_neg, neg_ids, targets) -> torch.Tensor:
    """[N, S] fp32 masked negative logits."""
    z = _bf16(q) @ _bf16(e_neg).T + b_neg.float()
    return torch.where(neg_ids[None, :] == targets[:, None], NEG, z)


def sampled_lse_reference(q, e_neg, b_neg, neg_ids, targets) -> torch.Tensor:
    """Plain PyTorch version of ``sampled_lse``: [N] fp32."""
    return torch.logsumexp(sampled_logits_reference(q, e_neg, b_neg, neg_ids, targets), dim=1)


def sampled_bwd_reference(q, e_neg, b_neg, neg_ids, targets, lse_tot, g):
    """Plain PyTorch version of ``sampled_bwd``: ``(dq [N, D], de_neg [S, D],
    db_neg [S])`` fp32, with the kernels' rounding points."""
    z = sampled_logits_reference(q, e_neg, b_neg, neg_ids, targets)
    gp = torch.exp(z - lse_tot.float()[:, None]) * g.float()[:, None]
    gpb = _bf16(gp)
    return gpb @ _bf16(e_neg), gpb.T @ _bf16(q), gp.sum(dim=0)


# The widths the kernels are built for (``sampled_supports_dim`` in
# ``csrc/sampled.cu`` says the same).
KERNEL_DIMS = (64, 128, 256, 512, 768, 1024)


def plan(D: int) -> tuple[int, ...]:
    """The kernels' blocks at width ``D`` (run at ``padded_dim(D)``), as
    ``sampled_plan`` in ``csrc/sampled.cu`` gives them: B9's (query rows a
    block, ring stages, columns a streamed chunk), then B10's (resident rows
    a block, the dE pass's ring stages, output column ranges, columns a
    chunk). Up to 512 a tile arrives whole; past it in chunks of 256, and a
    B10 block sums one range of 256 output columns."""
    Dp = padded_dim(D, KERNEL_DIMS, "sampled_lse")
    if Dp > 512:
        return 64, kchunk_fwd_stages(Dp, 2), KCHUNK, 64, kchunk_bwd_stages(Dp, 3), Dp // KCHUNK, KCHUNK
    if Dp == 512:
        return 64, 2, 512, 64, 2, 2, 512
    return 128 if Dp == 256 else 256, 4, Dp, 128, 4, 1, Dp


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


def _shapes(name, q, e_neg, b_neg, neg_ids, targets, *rows):
    N, D = q.shape
    S = e_neg.shape[0]
    if (e_neg.shape != (S, D) or b_neg.shape != (S,) or neg_ids.shape != (S,) or targets.shape != (N,) or S == 0
            or any(r.shape != (N,) for r in rows)):
        raise ValueError(f"{name}: need q [N,D], e_neg [S,D], b_neg, neg_ids [S], targets and row values [N], S > 0; "
                         f"got {[tuple(t.shape) for t in (q, e_neg, b_neg, neg_ids, targets, *rows)]}")
    return N, S, D


def _kernel_args(q, e_neg, b_neg, neg_ids, targets, width: int | None = None):
    """The kernels' inputs in their dtypes, contiguous; ``q`` and ``e_neg``
    padded with zero columns to ``width`` where it is given."""
    width = width or q.shape[1]
    return (pad_cols(q.to(torch.bfloat16), width).contiguous(), pad_cols(e_neg.to(torch.bfloat16), width).contiguous(),
            b_neg.float().contiguous(), neg_ids.to(torch.int32).contiguous(), targets.to(torch.int32).contiguous())


def bwd_kernel_args(q, e_neg, b_neg, neg_ids, targets, lse_tot, g, width: int | None = None):
    """The backward kernels' inputs in their dtypes, contiguous: q, e_neg,
    b_neg, neg_ids, targets, lse_tot, g (q and e_neg padded to ``width``)."""
    return (_kernel_args(q, e_neg, b_neg, neg_ids, targets, width)
            + (lse_tot.float().contiguous(), g.float().contiguous()))


def sampled_lse(q, e_neg, b_neg, neg_ids, targets) -> torch.Tensor:
    """[N] fp32 log-sum-exp of each row's masked negative logits (-1e30 for a
    row whose every pool entry is a hit).

    CPU tensors take the plain version. CUDA tensors launch the kernel (and
    the ordered merge of its pool ranges' partials where it splits) or
    raise; ``sampled_lse.launches`` counts the calls that launched it.
    """
    N, S, D = _shapes("sampled_lse", q, e_neg, b_neg, neg_ids, targets)
    if _check("sampled_lse", {"q": q, "e_neg": e_neg, "b_neg": b_neg, "neg_ids": neg_ids, "targets": targets}):
        return sampled_lse_reference(q, e_neg, b_neg, neg_ids, targets)
    dev = q.device
    lse = torch.empty(N, dtype=torch.float32, device=dev)
    if N == 0:
        return lse
    lib = _build.library()
    D = padded_dim(D, KERNEL_DIMS, "sampled_lse")
    args = _kernel_args(q, e_neg, b_neg, neg_ids, targets, D)
    # Scratch for the pool ranges' partial sums; 0: the split rule.
    scratch = torch.empty(max(1, lib.sampled_lse_scratch(N, S, D, 0)), dtype=torch.float32, device=dev)
    rc = lib.sampled_lse(*(a.data_ptr() for a in args), lse.data_ptr(), scratch.data_ptr(), N, S, D, 0, dev.index,
                         torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "sampled_lse launch")
    sampled_lse.launches += 1
    return lse


sampled_lse.launches = 0


def sampled_bwd(q, e_neg, b_neg, neg_ids, targets, lse_tot, g):
    """``(dq [N, D], de_neg [S, D], db_neg [S])`` fp32 of ``sum_n g[n] ·
    lse_tot[n]`` through the negative columns.

    CPU tensors take the plain version. CUDA tensors launch the kernels (the
    dq pass and the dE/db pass, each with the ordered sum of its split
    partials where it splits) or raise; ``sampled_bwd.launches`` counts the
    calls that launched them.
    """
    N, S, D = _shapes("sampled_bwd", q, e_neg, b_neg, neg_ids, targets, lse_tot, g)
    if _check("sampled_bwd", {"q": q, "e_neg": e_neg, "b_neg": b_neg, "neg_ids": neg_ids, "targets": targets,
                              "lse_tot": lse_tot, "g": g}):
        return sampled_bwd_reference(q, e_neg, b_neg, neg_ids, targets, lse_tot, g)
    dev = q.device
    Dp = padded_dim(D, KERNEL_DIMS, "sampled_bwd")
    dq = torch.empty(N, Dp, dtype=torch.float32, device=dev)
    de = torch.empty(S, Dp, dtype=torch.float32, device=dev)
    db = torch.empty(S, dtype=torch.float32, device=dev)
    if N == 0:
        return dq[:, :D], de[:, :D].zero_(), db.zero_()
    lib = _build.library()
    args = bwd_kernel_args(q, e_neg, b_neg, neg_ids, targets, lse_tot, g, Dp)
    # Scratch for the passes' split partials; (0, 0): each pass's own split rule.
    scratch = torch.empty(max(1, lib.sampled_bwd_scratch(N, S, Dp, 0, 0)), dtype=torch.float32, device=dev)
    rc = lib.sampled_bwd(*(a.data_ptr() for a in args), dq.data_ptr(), de.data_ptr(), db.data_ptr(),
                         scratch.data_ptr(), N, S, Dp, 0, 0, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "sampled_bwd launch")
    sampled_bwd.launches += 1
    return dq[:, :D], de[:, :D], db


sampled_bwd.launches = 0


class SampledNLL(torch.autograd.Function):
    """Per-row sampled-softmax NLL, the counterpart of ``sampled_nll_rows``'s
    custom VJP: differentiable in ``q``, ``e_neg``, ``b_neg`` and ``s_pos``;
    the ids only mask hits."""

    @staticmethod
    def forward(ctx, q, e_neg, b_neg, s_pos, targets, neg_ids):
        q, e_neg, b_neg, s_pos = q.detach(), e_neg.detach(), b_neg.detach(), s_pos.detach().float()
        if q.is_cuda:
            # The kernels' bf16/int32 arguments, made once for both directions.
            q, e_neg, b_neg, neg_ids, targets = _kernel_args(q, e_neg, b_neg, neg_ids, targets)
        lse_tot = torch.logaddexp(sampled_lse(q, e_neg, b_neg, neg_ids, targets), s_pos)
        ctx.save_for_backward(q, e_neg, b_neg, s_pos, targets, neg_ids, lse_tot)
        return lse_tot - s_pos

    @staticmethod
    def backward(ctx, g):
        q, e_neg, b_neg, s_pos, targets, neg_ids, lse_tot = ctx.saved_tensors
        g = g.float().contiguous()
        dq, de, db = sampled_bwd(q, e_neg, b_neg, neg_ids, targets, lse_tot, g)
        ds_pos = g * (torch.exp(s_pos - lse_tot) - 1.0)
        return dq, de, db, ds_pos, None, None


def sampled_nll_rows(q, e_neg, b_neg, s_pos, targets, neg_ids) -> torch.Tensor:
    """[N] fp32 ``logaddexp(LSE(masked s_neg), s_pos) - s_pos``."""
    return SampledNLL.apply(q, e_neg, b_neg, s_pos, targets, neg_ids)


def fused_sampled_softmax_loss(q, table, bias, targets, mask, neg, num_sampled: int, num_pois: int,
                               mean=None) -> torch.Tensor:
    """Masked-mean sampled softmax over [B, T, D] queries with the pool
    ``neg [S]``, the counterpart of ``fused_sampled_softmax_loss``. The
    table and bias rows (the targets', then the pool's) are gathered in
    plain torch, one lookup a tensor, so their gradients scatter back
    through autograd."""
    B, T, D = q.shape
    q2 = q.reshape(B * T, D)
    t1 = targets.reshape(-1)
    rows, brows = gather_rows(table, bias, torch.cat([t1, neg]))
    s_pos = (q2.float() * rows[:B * T].float()).sum(dim=1) + brows[:B * T]
    nll = sampled_nll_rows(q2, rows[B * T:], brows[B * T:] - log_q(num_sampled, num_pois), s_pos, t1, neg)
    if mean is not None:  # another reduction than this batch's masked mean
        return mean(nll, mask.reshape(-1))
    m = mask.reshape(-1).float()
    return (nll * m).sum() / m.sum().clamp_min(1.0)
