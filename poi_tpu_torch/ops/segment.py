"""Sums of rows by id with static shapes and a fixed summation order: the
deduplication of lazy Adam's touched ids (``train/sparse_opt.py``) and the
backward of every embedding lookup (``models/base.py``'s ``lookup``).

The reference computes both in XLA (``jnp.sort``, ``jax.ops.segment_sum``,
``.at[].add``). Plain torch here, built to give the same bits on every run:
``index_add_`` and the card's ``F.embedding`` backward sum duplicate ids
with fp32 atomics, whose order, and so whose bits, change from run to run.
No ``torch.unique``: its output size depends on the data, so the host would
wait for the card.
"""

from __future__ import annotations

import math

import torch


def _segments(s: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Of sorted ids ``s``: where each id's run starts, and each position's
    segment index (the rank of its id among the unique ids)."""
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    return first, torch.cumsum(first, 0) - 1


def _compact(s: torch.Tensor, seg: torch.Tensor, oob: int) -> torch.Tensor:
    """The unique ids of sorted ``s`` first (ascending), then the distinct
    sentinels ``oob + j``."""
    pad = oob + torch.arange(s.shape[0], device=s.device, dtype=s.dtype)
    # The positions of a segment write the same id: any order gives these bits.
    return pad.scatter(0, seg, s)


def _segment_sum(x: torch.Tensor, first: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """[len(x), ...] sums of the rows of ``x`` by their sorted segment index
    ``seg`` (``first``: where a segment starts; empty segments 0), in a
    fixed order: a segment's rows in runs, cut where it crosses a multiple
    of ``c = ceil(sqrt(len(x)))`` rows, each run summed in row order, then
    the runs in order. ``torch.segment_reduce`` sums a segment serially, one
    thread a column, so one id that holds half a batch (the padded
    positions' id 0) kept the card on one segment for a millisecond; here
    neither level sums more than ~c rows serially."""
    m = x.shape[0]
    c = math.isqrt(max(m - 1, 0)) + 1
    run_first = first | (torch.arange(m, device=x.device) % c == 0)
    run = torch.cumsum(run_first, 0) - 1
    # Level 1: [m, ...] run sums in run order (the empty runs' rows 0).
    runs = torch.segment_reduce(x, "sum", lengths=_counts(run, m), axis=0, unsafe=True)
    # Level 2: a segment's runs; the lengths cover the runs, the zero rows after them are not read.
    return torch.segment_reduce(runs, "sum", lengths=_counts(seg, m, run_first), axis=0, unsafe=True)


def _counts(index: torch.Tensor, n: int, weight: torch.Tensor | None = None) -> torch.Tensor:
    """[n] int64 counts of ``index`` (of its positions where ``weight``)."""
    ones = torch.ones_like(index) if weight is None else weight.to(index.dtype)
    return torch.zeros(n, dtype=torch.int64, device=index.device).scatter_add_(0, index, ones)


def dedup_ids(ids: torch.Tensor, oob: int) -> torch.Tensor:
    """Strictly sorted unique ids, then distinct out-of-bounds sentinels
    (``oob + j``), as long as ``ids``."""
    s = torch.sort(ids.reshape(-1)).values
    return _compact(s, _segments(s)[1], oob)


def dedup_sum(ids: torch.Tensor, g: torch.Tensor, oob: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dedup_ids(ids, oob), per-unique-id summed rows of g)``: one row per
    id occurrence in, one summed row per unique id out (the rows past the
    unique count are 0), summed in occurrence order."""
    s, order = torch.sort(ids.reshape(-1), stable=True)
    first, seg = _segments(s)
    rows = g.reshape(s.shape[0], *g.shape[ids.dim():])[order]
    return _compact(s, seg, oob), _segment_sum(rows, first, seg)


def scatter_sum(ids: torch.Tensor, g: torch.Tensor, num_rows: int) -> torch.Tensor:
    """The [num_rows, ...] table whose row i sums the rows of ``g`` at the
    positions where ``ids == i`` (``zeros.index_add_(0, ids, g)``), summed
    by ``dedup_sum`` in a fixed order. Each unique id and each sentinel is
    written once, into a table with a row for every sentinel, whose first
    ``num_rows`` rows are returned. ``F.embedding``'s CUDA backward gave
    other bits on a second call (32,768 ids into a 168-row table, H100), and
    ``index_put_(accumulate=True)`` sums one id's rows serially (18 ms a
    step of the bench workload, whose padded positions share id 0)."""
    uids, sums = dedup_sum(ids, g, num_rows)
    out = torch.zeros((num_rows + uids.shape[0],) + tuple(sums.shape[1:]), dtype=sums.dtype, device=sums.device)
    return out.index_put_((uids,), sums)[:num_rows]
