"""The eval and serving query path: full-T ``queries`` then the last
position, against ``queries_last``; the counterpart of
``scripts/bench_eval_path.py``.

    python -m poi_tpu_torch.scripts.bench_eval_path [--device cuda]

``queries`` runs the tower, the projection and the user add at every
position and keeps each row's last valid one; ``queries_last`` computes
them at that position only (``models.base.SequenceModel``). Both are timed
on the first eval batch of ``ds.test`` at config #4 (batch 256) and at
config #5 (batch 512, ``data.num_users=20000``, the catalog forced to
1,000,000 POIs as the reference forces it) under ``torch.no_grad``, with
random weights from the seed, by CUDA events around each call (the median
of ``ITERS``; ``_timing.time_ms``), not the reference's slope of minima,
which existed for the remote TPU. It also prints the largest difference
between the two paths' queries.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import torch

from poi_tpu_torch.scripts._timing import add_device_arg, setup, time_ms

# (preset, overrides, eval batch, catalog forced to this many POIs or None)
CASES = (
    ("attention_gowalla", {"data.val_fraction": "0", "model.dropout": "0"}, 256, None),
    ("multihost_1m", {"mesh.model": "1", "mesh.embedding_mode": "psum", "data.num_users": "20000"}, 512, 1_000_000),
)
ITERS = 20


def bench(preset: str, overrides: dict, batch_size: int, force_v: int | None, dev: torch.device) -> None:
    from poi_tpu_torch.configs.presets import get_config
    from poi_tpu_torch.data.dataset import load_dataset
    from poi_tpu_torch.data.pipeline import eval_batches
    from poi_tpu_torch.models import base as model_base

    cfg = get_config(preset).with_overrides(overrides)
    ds = load_dataset(cfg.data)
    dims = model_base.DataDims.from_dataset(ds)
    if force_v is not None:
        dims = dataclasses.replace(dims, num_pois=force_v, num_pois_padded=0)
    model = model_base.build_model(cfg.model, dims, device=dev, generator=torch.Generator().manual_seed(0))
    batch = model_base.batch_to(next(iter(eval_batches(ds.test, batch_size)))[0], dev)
    rows = torch.arange(batch.poi_in.shape[0], device=dev)

    def old_path():  # every position, then the last valid one
        q = model.queries(batch)
        return q[rows, (batch.mask.to(torch.int32).sum(dim=1) - 1).clamp_min(0)]

    with torch.no_grad():
        diff = float((old_path() - model.queries_last(batch)).abs().max())
        t_old = time_ms(old_path, ITERS, dev=dev)
        t_new = time_ms(lambda: model.queries_last(batch), ITERS, dev=dev)
    B, T = batch.poi_in.shape
    print(f"{preset:18s} B={B} T={T} D={cfg.model.embed_dim} V={dims.num_pois}: full-T path {t_old:8.4f} ms -> "
          f"last-position {t_new:8.4f} ms ({t_old / max(t_new, 1e-9):.2f}x); max |diff| {diff:.2e}", flush=True)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m poi_tpu_torch.scripts.bench_eval_path", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_device_arg(p)
    dev = setup(p.parse_args(argv).device)
    for preset, overrides, batch_size, force_v in CASES:
        bench(preset, overrides, batch_size, force_v, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
