"""Config #4's train step split into regions, the counterpart of
``scripts/profile_attn.py`` (``profile_step`` covers the bench workload).

    python -m poi_tpu_torch.scripts.profile_attn [--batch 256] [--device cuda]

``attention_gowalla`` (GRU 256-d, windowed attention, sampled softmax over
1,024 negatives, lazy Adam on the tables) with the JAX script's overrides: no
val split, no warmup, no dropout. Regions as ``profile_step``'s, each timed
alone with CUDA events: embed lookup fwd+bwd, tower fwd, tower fwd+bwd, loss
fwd+bwd with q fixed, full loss fwd+bwd, the optimizer update (lazy Adam
over the step's touched rows).
"""

from __future__ import annotations

import argparse
import sys

from poi_tpu_torch.scripts._timing import add_device_arg, setup, time_ms
from poi_tpu_torch.scripts.profile_step import first_batch, print_regions, regions

ITERS = 20  # timed calls a region
# The JAX script's overrides of the preset.
OVERRIDES = {"data.val_fraction": "0", "train.warmup_steps": "0", "model.dropout": "0"}

# profile_step's regions that the JAX script times here, under its names.
REGIONS = {"embed lookup fwd+bwd": "embed lookup fwd+bwd", "tower fwd": "tower fwd", "tower fwd+bwd": "tower fwd+bwd",
           "CE fwd+bwd (fixed q)": "loss fwd+bwd (fixed q)", "full loss fwd+bwd": "full loss fwd+bwd",
           "optimizer update": "optimizer update"}


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m poi_tpu_torch.scripts.profile_attn", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, default=256)
    add_device_arg(p)
    args = p.parse_args(argv)
    dev = setup(args.device)

    from poi_tpu_torch.configs.presets import get_config
    from poi_tpu_torch.data.dataset import load_dataset
    from poi_tpu_torch.train.loop import make_trainer

    cfg = get_config("attention_gowalla").with_overrides({**OVERRIDES, "train.batch_size": str(args.batch)})
    ds = load_dataset(cfg.data)
    trainer = make_trainer(cfg, ds, dev)
    batch = first_batch(cfg, ds, dev)
    B, T = batch.poi_in.shape
    m = cfg.model
    print(f"batch={B} T={T} V={trainer.dims.num_pois_padded} D={m.embed_dim} W={m.attn_window} heads={m.attn_heads} "
          f"sampled={cfg.loss.num_sampled} cell={m.cell_impl} table_update={cfg.train.table_update}; each region "
          f"timed alone ({'CUDA events' if dev.type == 'cuda' else 'host clock'}, median of {ITERS})", flush=True)
    fns = regions(trainer, batch)
    print_regions({label: time_ms(fns[name], ITERS, dev=dev) for name, label in REGIONS.items()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
