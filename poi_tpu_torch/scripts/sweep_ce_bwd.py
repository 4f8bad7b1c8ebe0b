"""Timing of the CE backward (B8), the counterpart of ``scripts/sweep_ce_bwd.py``.

    python -m poi_tpu_torch.scripts.sweep_ce_bwd [--n 16384 --v 44170 --d 128] [--device cuda]

``ops.fused_ce.ce_bwd`` launches two kernels, ``ce_bwd_dq`` (row blocks over
the catalog) and ``ce_bwd_dtable`` (catalog blocks over the rows). Together
they are timed with CUDA events; apart, by their device time in
``torch.profiler`` over the same launches. The rates are given under two
counts of the work: the JAX script's three catalog products (the TPU kernel
keeps dq resident and recomputes the logits once) and the port's own four
(each kernel recomputes the logits: ``csrc/ce.cu``). B8 has one tile shape
(64-row blocks, 64-row streamed tiles), so unlike the TPU sweep there is no
tile axis. Inputs as the JAX script's: q ~ N(0, 1), table ~ 0.05·N(0, 1),
zero bias, lse = 5, g = 1/N.
"""

from __future__ import annotations

import argparse
import sys

import torch

from poi_tpu_torch.ops.fused_ce import ce_bwd, ce_bwd_reference
from poi_tpu_torch.scripts._timing import add_device_arg, setup, sync, time_ms

KERNELS = ("ce_bwd_dq_kernel", "ce_bwd_dtable_kernel")
ITERS = 20


def kernel_ms(fn, n: int) -> dict[str, float]:
    """Device ms a call of each of ``KERNELS`` takes, from the profiler over
    ``n`` calls of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        for name in KERNELS:
            if name in e.key:
                out[name] = out.get(name, 0.0) + e.self_device_time_total / 1e3 / n
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
          f"script's, sweep_ce_bwd.py:45) or 4 (the port's two kernels, csrc/ce.cu)", flush=True)
    print("B8 has one tile shape (64-row blocks, 64-row streamed tiles): no tile axis to sweep", flush=True)

    got = ce_bwd(q, table, bias, lse, g)
    sync(dev)
    want = ce_bwd_reference(q, table, bias, lse, g)
    errs = [float((a - b).abs().max() / b.abs().max().clamp_min(1e-30)) for a, b in zip(got, want)]
    print(f"rel err against the plain version: dq {errs[0]:.2e}, dtable {errs[1]:.2e}, dbias {errs[2]:.2e}")
    ms = time_ms(lambda: ce_bwd(q, table, bias, lse, g), ITERS, dev=dev)
    print(f"ce_bwd (dq + dtable): {ms:8.4f} ms  {3 * product / ms / 1e9:7.1f} TFLOP/s (3 products)  "
          f"{4 * product / ms / 1e9:7.1f} TFLOP/s (4 products)", flush=True)
    if dev.type != "cuda":
        print("ce_bwd_dq, ce_bwd_dtable apart: not measured (no device profile on the cpu)")
        return 0
    parts = kernel_ms(lambda: ce_bwd(q, table, bias, lse, g), ITERS)
    for name in KERNELS:
        t = parts.get(name)
        if t is None:
            raise SystemExit(f"the profiler recorded no {name}: {sorted(parts)}")
        # Each pass: the logits' product and one gradient product.
        print(f"{name.removesuffix('_kernel'):13s}: {t:8.4f} ms  {2 * product / t / 1e9:7.1f} TFLOP/s (2 products; "
              f"device time, torch.profiler)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
