"""The whole train step of the bench workload, config #4 and config #5 on
device-sampled batches: ms a step and seq/s.

    python -m poi_tpu_torch.scripts.step_time [bench attention_gowalla multihost_1m] [--device cuda]

Each configuration as ``chip_smoke.py`` trains it (``CONFIGS``): the bench
workload (``bench.py``'s, batch 512), ``attention_gowalla`` at its full
width, and ``multihost_1m`` on one device (``mesh.model=1``, the
rows-gradient step at V = 903,889). ``profile_step.sampled_ms``: a warm-up
chunk, then the best of ``TRIALS`` ``CHUNK``-step ``step_sampled`` chunks,
each fenced by reading its last loss (host clock). It uses nothing newer
than the trainer, the presets and those helpers, so the same file times
another checkout's package: ``PYTHONPATH=<checkout> python
poi_tpu_torch/scripts/step_time.py``.
"""

from __future__ import annotations

import argparse
import sys

import torch

from poi_tpu_torch.scripts._timing import BENCH_OVERRIDES, add_device_arg, setup
from poi_tpu_torch.scripts.profile_step import sampled_ms

CONFIGS = {
    "bench": ("smoke", {**BENCH_OVERRIDES, "train.batch_size": "512"}),
    "attention_gowalla": ("attention_gowalla", {}),
    "multihost_1m": ("multihost_1m", {"mesh.model": "1", "mesh.embedding_mode": "psum",
                                      "data.min_poi_checkins": "1", "data.val_fraction": "0.05"}),
}
CHUNK, TRIALS = 20, 3


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m poi_tpu_torch.scripts.step_time", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("configs", nargs="*", help=f"of {list(CONFIGS)} (default: all)")
    add_device_arg(p)
    args = p.parse_args(argv)
    if set(args.configs) - set(CONFIGS):
        p.error(f"unknown configs {sorted(set(args.configs) - set(CONFIGS))}: have {list(CONFIGS)}")
    dev = setup(args.device)

    import poi_tpu_torch
    from poi_tpu_torch.configs.presets import get_config
    from poi_tpu_torch.data.dataset import load_dataset
    from poi_tpu_torch.train.loop import make_trainer

    print(f"package: {poi_tpu_torch.__file__}", flush=True)
    for name in args.configs or CONFIGS:
        preset, sets = CONFIGS[name]
        cfg = get_config(preset).with_overrides({**sets, "data.sampler": "device"})
        trainer = make_trainer(cfg, load_dataset(cfg.data), dev)
        ms = sampled_ms(trainer, CHUNK, 1, TRIALS)
        B = cfg.train.batch_size
        print(f"{name}: {ms:.3f} ms a step, {B / ms * 1e3:,.0f} seq/s at batch {B}", flush=True)
        del trainer
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
