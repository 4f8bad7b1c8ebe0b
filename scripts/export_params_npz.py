"""Export a poi_tpu checkpoint's parameters to the .npz the PyTorch port reads.

    python scripts/export_params_npz.py --config gru_foursquare_nyc \
        --checkpoint-dir DIR --out params.npz [--step N] [--set k=v ...] [--platform cpu]

Restores like ``python -m poi_tpu recommend`` does: the latest step, overlaid
with the best-on-val-selected params under ``DIR/selected`` when the run saved
them, or exactly ``--step N``. The tree is written with ``/``-joined keys
(``poi_tpu_torch.convert.save_npz``); serve it with
``python -m poi_tpu_torch serve --config ... --params params.npz``.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def export(cfg, out: str, step: int | None = None) -> None:
    import jax
    import numpy as np

    from poi_tpu.cli import _restore_for_inference
    from poi_tpu_torch.convert import save_npz

    _, _, state = _restore_for_inference(cfg, step=step)
    save_npz(out, jax.tree.map(np.asarray, jax.device_get(state.params)))


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="export_params_npz")
    parser.add_argument("--config", required=True)
    parser.add_argument("--checkpoint-dir", default=None)
    parser.add_argument("--step", type=int, default=None)
    parser.add_argument("--set", nargs="*", default=[])
    parser.add_argument("--out", required=True)
    parser.add_argument("--platform", default=None, help="force jax platform (e.g. cpu)")
    args = parser.parse_args(argv)

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from poi_tpu.configs.presets import get_config
    from poi_tpu.utils.config import parse_set_flags

    cfg = get_config(args.config).with_overrides(parse_set_flags(args.set))
    if args.checkpoint_dir:
        cfg = cfg.with_overrides({"checkpoint.directory": args.checkpoint_dir})
    export(cfg, args.out, step=args.step)
    print(args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
