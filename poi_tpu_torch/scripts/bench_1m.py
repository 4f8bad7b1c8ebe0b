"""Config #5 at catalog scale on one card, the counterpart of
``scripts/bench_1m.py``.

    python -m poi_tpu_torch.scripts.bench_1m [--table-update dense|sparse|both] [--skip-topk] [--device cuda]

1. Fused top-k (B11) at V = 1,000,000, D = 512, B = 512, k = 10 against
   ``torch.topk`` over the materialised [B, V] logits, CUDA events around
   each call (the median of ``ITERS``), and the queries a second that gives.
2. Training seq/s: ``multihost_1m`` on one device (``mesh.model=1``) with the
   JAX script's overrides (20,000 users, device-sampled batches in chunks of
   ``CHUNK`` steps, no warmup) and the model's catalog forced to
   ``FORCE_V`` rows whatever the corpus holds, as the JAX script forces it:
   every cost that scales with V (the tables, the negatives' id space, the
   optimizer's table traffic) runs at full scale while the batch ids stay
   the corpus'. ``profile_step.sampled_ms``: the best of ``TRIALS`` runs of
   ``CHUNKS`` chunks on the host clock, fenced by reading the last loss,
   after a warm-up chunk. ``--table-update`` picks the
   optimizer (the preset's ``sparse``: the rows-gradient step with lazy
   Adam; ``dense``: Adam over every row; ``both``).
3. ``torch.cuda.max_memory_allocated`` over each training run.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import torch

from poi_tpu_torch.scripts._timing import add_device_arg, setup, time_ms
from poi_tpu_torch.scripts.profile_step import sampled_ms

FORCE_V = 1_000_000
TOPK_SHAPE = (512, 1_000_000, 512, 10)  # (B, V, D, k)
OVERRIDES = {"mesh.model": "1", "mesh.embedding_mode": "psum", "data.num_users": "20000",
             "data.mean_checkins_per_user": "50", "data.sampler": "device", "train.warmup_steps": "0"}
CHUNK, CHUNKS, TRIALS = 10, 3, 3
ITERS = 20  # timed top-k calls


def topk_times(B: int, V: int, D: int, k: int, dev) -> dict:
    """ms of the fused top-k and of torch.topk over the logits, on the same
    random operands (the bias of the catalog's pad rows -1e30, as served)."""
    from poi_tpu_torch.ops.topk import fused_topk, pad_table_for_topk

    gen = torch.Generator(device=dev).manual_seed(0)
    table = torch.randn(V, D, generator=gen, device=dev).to(torch.bfloat16)
    bias = torch.randn(V, generator=gen, device=dev)
    table, bias = pad_table_for_topk(table, bias)
    q = torch.randn(B, D, generator=gen, device=dev) * D ** -0.5

    def library():
        logits = q.to(torch.bfloat16).float() @ table.float().T + bias
        return torch.topk(logits, k, dim=1)

    return {"fused_ms": time_ms(lambda: fused_topk(q, table, bias, k), ITERS, dev=dev),
            "library_ms": time_ms(library, max(3, ITERS // 4), dev=dev), "V_padded": table.shape[0]}


def train_rate(cfg, ds, dev) -> tuple[float, int]:
    """(seq/s, peak bytes) of device-sampled training at ``FORCE_V`` rows."""
    from poi_tpu_torch.data.device_sampler import DeviceSampler
    from poi_tpu_torch.models.base import DataDims
    from poi_tpu_torch.train.loop import Trainer

    dims = dataclasses.replace(DataDims.from_dataset(ds), num_pois=FORCE_V, num_pois_padded=0)
    sampler = DeviceSampler(ds.train, cfg.train.batch_size, cfg.train.seed, dev)
    trainer = Trainer(cfg, dims, device=dev, sampler=sampler)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    ms = sampled_ms(trainer, CHUNK, CHUNKS, TRIALS)
    return cfg.train.batch_size / ms * 1e3, torch.cuda.max_memory_allocated(dev) if cuda else 0


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m poi_tpu_torch.scripts.bench_1m", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--table-update", choices=("dense", "sparse", "both"), default="sparse")
    p.add_argument("--skip-topk", action="store_true")
    p.add_argument("--batch", type=int, default=512)
    add_device_arg(p)
    args = p.parse_args(argv)
    dev = setup(args.device)

    from poi_tpu_torch.configs.presets import get_config
    from poi_tpu_torch.data.dataset import load_dataset

    if not args.skip_topk:
        B, V, D, k = TOPK_SHAPE
        t = topk_times(B, V, D, k, dev)
        print(f"fused top-k @ V={V:,} (padded {t['V_padded']:,}) D={D} B={B} k={k}: {B / t['fused_ms'] * 1e3:,.0f} "
              f"qps ({t['fused_ms']:.4f} ms a batch; torch.topk over the logits {t['library_ms']:.4f} ms -> "
              f"{t['library_ms'] / t['fused_ms']:.2f}x)", flush=True)
    cfg = get_config("multihost_1m").with_overrides({**OVERRIDES, "train.batch_size": str(args.batch),
                                                    "train.steps_per_call": str(CHUNK)})
    ds = load_dataset(cfg.data)
    print(f"dataset: {ds.num_users} users {ds.num_pois} POIs {len(ds.train)} train windows; model dims V={FORCE_V:,} "
          f"D={cfg.model.embed_dim} B={cfg.train.batch_size} S={cfg.loss.num_sampled}", flush=True)
    for update in ("dense", "sparse") if args.table_update == "both" else (args.table_update,):
        rate, peak = train_rate(cfg.with_overrides({"train.table_update": update}), ds, dev)
        mem = f"; peak {peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated)" if dev.type == "cuda" else ""
        print(f"config #5 one-card training ({update}): {rate:,.1f} seq/s{mem}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
