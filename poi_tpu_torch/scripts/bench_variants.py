"""The bench workload's step over batch size and steps a call, the
counterpart of ``scripts/bench_variants.py``: how far larger batches and
longer device-sampled chunks amortise the host's dispatch, and the
whole-step MFU at each point.

    python -m poi_tpu_torch.scripts.bench_variants [repeats] [--device cuda]

The workload is ``bench.py``'s (``_timing.BENCH_OVERRIDES``: GRU 128-d,
T=64, bf16, full-catalog CE over 44,170 POIs) on device-sampled batches, at
batch 256, 512 and 1024 x ``steps_per_call`` 10, 20 and 40. Each point is
``profile_step.sampled_ms``: a warm-up chunk, then the best of ``repeats``
(default 4) windows of ``max(40, 2 spc)`` steps in chunks of ``spc``, each
fenced by reading its last loss (host clock). A row a point: seq/s, ms a
step, the analytic GFLOP a step (``_timing.step_flops``, ``bench.py``'s
count) and the whole-step MFU against the H100's dense bf16 peak
(``_timing.H100_BF16_PEAK``, 989 TFLOP/s). The tower's products run in
fp32 today (``models/base.py`` ``matmul_fp32``), so this MFU reads an
fp32-and-bf16 step against a bf16 peak, as the reference reads its own
against the v5e's. On the CPU (the kernels' plain versions) no MFU is
given.
"""

from __future__ import annotations

import argparse
import sys

import torch

from poi_tpu_torch.scripts._timing import BENCH_OVERRIDES, H100_BF16_PEAK, add_device_arg, setup, step_flops
from poi_tpu_torch.scripts.profile_step import sampled_ms

OVERRIDES = {**BENCH_OVERRIDES, "data.sampler": "device"}
BATCHES = (256, 512, 1024)
SPCS = (10, 20, 40)
MIN_STEPS = 40  # a window is max(MIN_STEPS, 2 spc) steps


def row(dev: torch.device, B: int, ms: float, flops: float) -> str:
    """seq/s, ms a step, MFU (on the card) and GFLOP a step of one point."""
    mfu = (f"whole-step MFU {flops / (ms / 1e3) / H100_BF16_PEAK:.2%} of {H100_BF16_PEAK / 1e12:.0f} TFLOP/s"
           if dev.type == "cuda" else "MFU not measured (cpu)")
    return f"{B / ms * 1e3:11,.1f} seq/s ({ms:8.3f} ms/step, {mfu}, analytic {flops / 1e9:.1f} GFLOP/step)"


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m poi_tpu_torch.scripts.bench_variants", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("repeats", nargs="?", type=int, default=4, help="timed windows a point (the best is kept)")
    add_device_arg(p)
    args = p.parse_args(argv)
    dev = setup(args.device)

    from poi_tpu_torch.configs.presets import get_config
    from poi_tpu_torch.data.dataset import load_dataset
    from poi_tpu_torch.train.loop import make_trainer

    cfg0 = get_config("smoke").with_overrides(OVERRIDES)
    ds = load_dataset(cfg0.data)
    print(f"dataset: {ds.num_users} users {ds.num_pois} pois; best of {args.repeats} windows a point", flush=True)
    for bs in BATCHES:
        cfg = cfg0.with_overrides({"train.batch_size": str(bs)})
        trainer = make_trainer(cfg, ds, dev)
        flops = step_flops(cfg, trainer.dims)
        for spc in SPCS:
            steps = max(MIN_STEPS, 2 * spc)
            ms = sampled_ms(trainer, spc, steps // spc, args.repeats)
            print(f"batch={bs:5d} spc={spc:3d}: {row(dev, bs, ms, flops)}", flush=True)
        del trainer
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
