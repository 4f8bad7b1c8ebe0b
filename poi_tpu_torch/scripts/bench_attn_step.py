"""Whole-step MFU of config #4's attention workload, the counterpart of
``scripts/bench_attn_step.py``.

    python -m poi_tpu_torch.scripts.bench_attn_step [--device cuda]
    ATTN_BENCH_MODES=sparse python -m poi_tpu_torch.scripts.bench_attn_step

``attention_gowalla`` (GRU 256-d + 4-head windowed attention, T=128,
sampled softmax over 1,024 negatives, 36,969 POIs) with no val split,
device-sampled batches in chunks of 10 steps, no warm-up and dropout 0 (the
serving compute path), at batch 64 and 256 x ``train.table_update`` in
``ATTN_BENCH_MODES`` (a comma list of ``sparse`` and ``dense``, default
both). At this table size ``sparse`` is the masked-dense lazy Adam
(below ``sparse_opt.DENSE_LAZY_MAX_BYTES``). Each point is
``profile_step.sampled_ms``: a warm-up chunk, then the best of 4 windows of
40 steps, each fenced by reading its last loss (host clock). A row a point:
seq/s, ms a step, the whole-step MFU against the H100's dense bf16 peak
(989 TFLOP/s) and the analytic GFLOP a step (``_timing.step_flops``,
``bench.py``'s count). The tower's products run in fp32 today
(``models/base.py`` ``matmul_fp32``), so this MFU reads an fp32-and-bf16
step against a bf16 peak, as the reference reads its own against the
v5e's. On the CPU no MFU is given.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from poi_tpu_torch.scripts._timing import add_device_arg, setup, step_flops
from poi_tpu_torch.scripts.bench_variants import row
from poi_tpu_torch.scripts.profile_step import sampled_ms

OVERRIDES = {
    "data.val_fraction": "0",  # throughput only; no val machinery
    "data.sampler": "device",
    "train.steps_per_call": "10",
    "train.warmup_steps": "0",
    "model.dropout": "0",
}
BATCHES = (64, 256)
STEPS, REPEATS = 40, 4


def modes() -> list[str]:
    """``ATTN_BENCH_MODES`` as a list; anything but sparse and dense exits."""
    got = [m.strip() for m in os.environ.get("ATTN_BENCH_MODES", "sparse,dense").split(",") if m.strip()]
    bad = set(got) - {"sparse", "dense"}
    if bad or not got:
        raise SystemExit(f"ATTN_BENCH_MODES must be a comma list of sparse|dense, got {bad or 'nothing'}")
    return got


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m poi_tpu_torch.scripts.bench_attn_step", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_device_arg(p)
    args = p.parse_args(argv)
    updates = modes()
    dev = setup(args.device)

    from poi_tpu_torch.configs.presets import get_config
    from poi_tpu_torch.data.dataset import load_dataset
    from poi_tpu_torch.train.loop import make_trainer

    base = get_config("attention_gowalla").with_overrides(OVERRIDES)
    ds = load_dataset(base.data)
    print(f"dataset: {ds.num_users} users {ds.num_pois} pois", flush=True)
    spc = base.train.steps_per_call
    for bs in BATCHES:
        for tu in updates:
            cfg = base.with_overrides({"train.batch_size": str(bs), "train.table_update": tu})
            trainer = make_trainer(cfg, ds, dev)
            ms = sampled_ms(trainer, spc, STEPS // spc, REPEATS)
            print(f"attention batch={bs:4d} ({tu:6s}): {row(dev, bs, ms, step_flops(cfg, trainer.dims))}", flush=True)
            del trainer
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
