"""Serving benchmark: ``Recommender.recommend`` latency and requests/s, the
counterpart of ``scripts/bench_serve.py``.

    python -m poi_tpu_torch.scripts.bench_serve [--num-pois 100000 --dim 256] [--device cuda]

The whole online path: featurize raw histories on the host, the recurrence
and the fused top-k over the catalog on the card, the visited filter on the
host. An untrained GRU (``smoke`` with the bench workload's data shape, at
``--dim`` wide) over a catalog of about ``--num-pois`` POIs: serving cost
depends on the shapes only. Request batches of 1, 8, 64 and 256 random
20-check-in histories, each timed ``REPS`` times on the host clock (the
call ends in a device-to-host copy): p50, p99 and requests/s at p50; then
the marginal cost of a request between the two largest batches, where the
fixed cost of a call cancels.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from poi_tpu_torch.scripts._timing import BENCH_OVERRIDES, add_device_arg, setup

BATCHES = (1, 8, 64, 256)
REPS = 30  # timed calls a batch


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m poi_tpu_torch.scripts.bench_serve", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--num-pois", type=int, default=100_000, help="POIs the synthetic corpus draws from")
    p.add_argument("--dim", type=int, default=256, help="embedding and hidden width")
    add_device_arg(p)
    args = p.parse_args(argv)
    dev = setup(args.device)

    from poi_tpu_torch.configs.presets import get_config
    from poi_tpu_torch.data.dataset import load_dataset
    from poi_tpu_torch.eval.serve import Checkin, Recommender
    from poi_tpu_torch.models.base import DataDims, build_model

    cfg = get_config("smoke").with_overrides({
        **BENCH_OVERRIDES, "data.num_pois": str(args.num_pois),
        "model.embed_dim": str(args.dim), "model.hidden_dim": str(args.dim), "eval.topk_impl": "pallas"})
    ds = load_dataset(cfg.data)
    model = build_model(cfg.model, DataDims.from_dataset(ds), device=dev,
                        generator=torch.Generator().manual_seed(cfg.train.seed))
    rec = Recommender(model, cfg, ds)
    print(f"catalog V={ds.num_pois} D={args.dim} k=10 (untrained params: serving cost depends on the shapes only)",
          flush=True)

    rng = np.random.default_rng(0)

    def make_requests(n, hist_len=20):
        out = []
        for _ in range(n):
            pois = rng.integers(0, ds.num_pois, size=hist_len)
            t0 = 1.3e9 + float(rng.integers(0, 86400 * 30))
            out.append([Checkin(int(poi), t0 + 3600.0 * i) for i, poi in enumerate(pois)])
        return out

    rows = []
    for bs in BATCHES:
        reqs = make_requests(bs)
        rec.recommend(reqs, k=10)  # warm: allocator, cuBLAS handles
        lat = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            ids = rec.recommend(reqs, k=10)
            lat.append(time.perf_counter() - t0)
        assert ids.shape == (bs, 10), ids.shape
        lat.sort()
        p50, p99 = lat[len(lat) // 2], lat[min(len(lat) - 1, int(len(lat) * 0.99))]
        rows.append((bs, p50))
        print(f"batch={bs:4d}: p50 {p50 * 1e3:8.3f} ms  p99 {p99 * 1e3:8.3f} ms  {bs / p50:10,.0f} req/s (at p50)",
              flush=True)
    (b1, t1), (b2, t2) = rows[-2], rows[-1]
    slope_us = (t2 - t1) / (b2 - b1) * 1e6
    rate = f"{1e6 / slope_us:,.0f} req/s sustained" if slope_us > 0 else "no positive slope"
    print(f"marginal cost {slope_us:.1f} us/request between batch {b1} and {b2} -> {rate} (fixed cost of a call "
          f"excluded)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
