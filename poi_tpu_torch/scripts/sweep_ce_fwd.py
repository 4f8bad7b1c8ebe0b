"""Sweep of the CE forward (B12): the variants of ``ops.fused_ce.ce_lse_variant``
against rows a block, the counterpart of ``scripts/sweep_ce_fwd.py``.

    python -m poi_tpu_torch.scripts.sweep_ce_fwd [--n 16384 --v 44170 --d 128] [--device cuda]

  base   ce_lse's fold: an online max and sum in base 2 (one FMA a logit
         scales it to base 2 with its bias, then ex2)
  exp2   q and bias pre-scaled by log2(e): an add in place of the FMA
  nomax  UNSAFE (no running max: fp32 overflows past logits of ~88): what the
         running max costs the fold

each on ``ce_lse``'s kernel (``csrc/ce.cu`` ``ce_lse_wg_kernel``) at 128 and
256 query rows a block, 2 or 4 consumer warpgroups: the TPU sweep's row
block (``rb``) maps to the warpgroups, and its catalog chunk (``cv``) has no
counterpart, the streamed tile being 64 rows in every cell (the ``wgmma``'s
N). base at 256 rows is ``ce_lse`` itself. Per cell: the time (CUDA events,
median), the rate over the catalog product's 2·N·V·D FLOPs, and the largest
difference from the variant's own plain version. Beside them, ``ce_lse`` (the
train path's call) on the same inputs. Inputs as the JAX script's: q ~ N(0,
1), table ~ 0.05·N(0, 1), zero bias.
"""

from __future__ import annotations

import argparse
import sys

import torch

from poi_tpu_torch.ops import fused_ce
from poi_tpu_torch.scripts._timing import add_device_arg, setup, sync, time_ms

N, V, D = 16384, 44170, 128
ITERS = 20
# nomax's sum overflows fp32 once one exp(logit) does: logits above ln(2^128).
NOMAX_SAFE_LOGIT = 88.0


def inputs(n: int, v: int, d: int, dev) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(q, table, bias) as the JAX script draws them, from seed 0."""
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(n, d, generator=gen, device=dev)
    table = 0.05 * torch.randn(v, d, generator=gen, device=dev)
    return q, table, torch.zeros(v, device=dev)


def sweep(q, table, bias) -> dict[str, dict]:
    """Each instantiation ``"variant/rows"``: its output ``lse``, its
    ``max_abs_err`` from its variant's plain version, its median ``ms``, and
    the ``launches`` of its timed calls (the count is set to 0 just before
    them, so the comparison's launch is not counted)."""
    cells = {}
    for variant in fused_ce.VARIANTS:
        want = fused_ce.VARIANT_REFERENCES[variant](q, table, bias)
        for rows in fused_ce.ROWS:
            got = fused_ce.ce_lse_variant(q, table, bias, variant, rows)
            sync(q.device)
            fused_ce.ce_lse_variant.launches = 0
            ms = time_ms(lambda: fused_ce.ce_lse_variant(q, table, bias, variant, rows), ITERS, dev=q.device)
            cells[f"{variant}/{rows}"] = {"lse": got, "max_abs_err": float((got - want).abs().max()), "ms": ms,
                                          "launches": fused_ce.ce_lse_variant.launches}
    return cells


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m poi_tpu_torch.scripts.sweep_ce_fwd", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--n", type=int, default=N, help="query rows")
    p.add_argument("--v", type=int, default=V, help="catalog rows")
    p.add_argument("--d", type=int, default=D, help="width (32, 64 or 128)")
    add_device_arg(p)
    args = p.parse_args(argv)
    dev = setup(args.device)
    q, table, bias = inputs(args.n, args.v, args.d, dev)
    flop = 2 * args.n * args.v * args.d
    print(f"N={args.n} V={args.v} D={args.d}: {flop / 1e9:.1f} GFLOP of catalog product a call", flush=True)
    top = float(fused_ce.ce_lse_reference(q, table, bias).max())  # >= every logit
    print(f"largest lse {top:.3f}: every logit is below it, so nomax "
          f"{'is safe on these inputs' if top < NOMAX_SAFE_LOGIT else 'OVERFLOWS on these inputs'} "
          f"(unsafe past logits of ~{NOMAX_SAFE_LOGIT:.0f})", flush=True)

    cells = sweep(q, table, bias)
    for name, c in cells.items():
        variant, rows = name.split("/")
        print(f"{variant:5s} rows={int(rows):3d}: {c['ms']:8.4f} ms {flop / c['ms'] / 1e9:7.1f} TFLOP/s  "
              f"max |kernel - plain| {c['max_abs_err']:.2e}  launches {c['launches']}", flush=True)
    want = fused_ce.ce_lse_reference(q, table, bias)
    err = float((fused_ce.ce_lse(q, table, bias) - want).abs().max())
    ms = time_ms(lambda: fused_ce.ce_lse(q, table, bias), ITERS, dev=q.device)
    print(f"ce_lse (the train path's kernel): {ms:8.4f} ms {flop / ms / 1e9:7.1f} TFLOP/s  "
          f"max |kernel - plain| {err:.2e}", flush=True)
    print(f"ce_lse_variant launches: {sum(c['launches'] for c in cells.values())} (the timed runs'; the "
          f"comparisons' not counted)")
    best = min(cells, key=lambda k: cells[k]["ms"])
    variant, rows = best.split("/")
    ms = cells[best]["ms"]
    print(f"\nbest: {variant} rows={rows}: {ms:.4f} ms ({flop / ms / 1e9:.1f} TFLOP/s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
