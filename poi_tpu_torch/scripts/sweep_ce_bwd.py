"""Timing of the CE backward (B8), the counterpart of ``scripts/sweep_ce_bwd.py``.

    python -m poi_tpu_torch.scripts.sweep_ce_bwd [--n 16384 --v 44170 --d 128] [--device cuda]

``ops.fused_ce.ce_bwd`` launches two passes of ``csrc/ce_bwd.cu``'s
``ce_bwd_pass``: the dq pass (blocks of 128 query rows over the catalog) and
the dtable pass (blocks of 128 catalog rows over the queries), and, where a
pass splits its streamed rows to fill the card, ``sum_splits``. Together
they are timed with CUDA events; apart, by their device time in
``torch.profiler`` over the same launches. The rates are given under two
counts of the work: the JAX script's three catalog products (the TPU kernel
keeps dq resident and recomputes the logits once) and the port's own four
(each pass recomputes the logits). B8 has one tile shape (128 resident rows,
64-row streamed tiles), so unlike the TPU sweep there is no tile axis.
Inputs as the JAX script's: q ~ N(0, 1), table ~ 0.05·N(0, 1), zero bias,
lse = 5, g = 1/N.
"""

from __future__ import annotations

import argparse
import sys

import torch

from poi_tpu_torch.ops.fused_ce import ce_bwd, ce_bwd_reference
from poi_tpu_torch.scripts._timing import add_device_arg, kernel_ms, setup, sync, time_ms

# The profiler's kernel names (substrings) of the two passes and the reduction.
KERNELS = {"dq pass": ", false>", "dtable pass": ", true>", "sum_splits": "sum_splits"}
ITERS = 20


def pass_ms(fn, n: int) -> dict[str, float]:
    """Device ms a call of each of ``KERNELS`` takes (those that ran), from
    the profiler over ``n`` calls of ``fn`` (``_timing.kernel_ms``, which
    checks that the record holds both passes and every launch)."""
    out = {}
    for key, ms in kernel_ms(fn, n, expect=("ce_bwd_pass<", ", false>", ", true>")).items():
        for name, part in KERNELS.items():
            if part in key and ("ce_bwd_pass<" in key or name == "sum_splits"):
                out[name] = out.get(name, 0.0) + ms
    return out


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m poi_tpu_torch.scripts.sweep_ce_bwd", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--n", type=int, default=16384, help="query rows")
    p.add_argument("--v", type=int, default=44170, help="catalog rows")
    p.add_argument("--d", type=int, default=128, help="width (32, 64 or 128)")
    add_device_arg(p)
    args = p.parse_args(argv)
    dev = setup(args.device)
    N, V, D = args.n, args.v, args.d
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(N, D, generator=gen, device=dev)
    table = 0.05 * torch.randn(V, D, generator=gen, device=dev)
    bias = torch.zeros(V, device=dev)
    lse = torch.full((N,), 5.0, device=dev)
    g = torch.full((N,), 1.0 / N, device=dev)
    product = 2 * N * V * D
    print(f"N={N} V={V} D={D}: one catalog product is {product / 1e9:.1f} GFLOP; the backward counts 3 (the JAX "
          f"script's, sweep_ce_bwd.py:45) or 4 (the port's two passes, csrc/ce_bwd.cu)", flush=True)
    print("B8 has one tile shape (128 resident rows, 64-row streamed tiles): no tile axis to sweep", flush=True)

    got = ce_bwd(q, table, bias, lse, g)
    sync(dev)
    want = ce_bwd_reference(q, table, bias, lse, g)
    errs = [float((a - b).abs().max() / b.abs().max().clamp_min(1e-30)) for a, b in zip(got, want)]
    print(f"rel err against the plain version: dq {errs[0]:.2e}, dtable {errs[1]:.2e}, dbias {errs[2]:.2e}")
    ms = time_ms(lambda: ce_bwd(q, table, bias, lse, g), ITERS, dev=dev)
    print(f"ce_bwd (dq + dtable): {ms:8.4f} ms  {3 * product / ms / 1e9:7.1f} TFLOP/s (3 products)  "
          f"{4 * product / ms / 1e9:7.1f} TFLOP/s (4 products)", flush=True)
    if dev.type != "cuda":
        print("dq pass, dtable pass apart: not measured (no device profile on the cpu)")
        return 0
    parts = pass_ms(lambda: ce_bwd(q, table, bias, lse, g), ITERS)
    for name in ("dq pass", "dtable pass"):
        t = parts[name]
        # Each pass: the logits' product and one gradient product.
        print(f"{name:11s}: {t:8.4f} ms  {2 * product / t / 1e9:7.1f} TFLOP/s (2 products; device time, "
              f"torch.profiler)", flush=True)
    if "sum_splits" in parts:
        print(f"sum_splits : {parts['sum_splits']:8.4f} ms  (the split partials' reduction)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
