"""Short-probe tuning sweep of config #3 (ST-RNN), the counterpart of
``scripts/tune_strnn.py``.

    python -m poi_tpu_torch.scripts.tune_strnn [steps] [--device cuda]

Trains ``strnn_gowalla`` with ``data.val_fraction=0.1`` for ``steps``
steps (1,500 by default) once a probe, the reference's probes (the preset;
no user embedding; no dropout; dropout 0.3; 256-d, whose full CE runs B7/B8
at D = 256; lr 3e-3), each from the preset's seed, and scores the
VALIDATION split beside the popularity floor, so a knob's choice never
touches test. One ``PROBE`` line a probe, the reference's.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from poi_tpu_torch.scripts._timing import add_device_arg, setup

# Every probe's base: the preset with a val split to score on.
BASE = {"data.val_fraction": "0.1"}
# Preset base = user embedding on + dropout 0.5.
PROBES = {
    "base": {},
    "no_user": {"model.use_user_embedding": "false"},
    "no_drop": {"model.dropout": "0.0"},
    "drop03": {"model.dropout": "0.3"},
    "h256": {"model.embed_dim": "256", "model.hidden_dim": "256"},
    "lr3e3": {"train.learning_rate": "0.003"},
}


def run_probes(preset: str, probes: dict, steps: int, dev: torch.device, base: dict = BASE) -> None:
    """Each probe of ``probes`` on ``preset`` + ``base`` (its dataset) for
    ``steps`` steps, scored on val; prints a PROBE line each."""
    from poi_tpu_torch.configs.presets import get_config
    from poi_tpu_torch.data.dataset import load_dataset
    from poi_tpu_torch.eval.evaluate import evaluate, popularity_baseline
    from poi_tpu_torch.train.loop import train

    base = get_config(preset).with_overrides(base)
    ds = load_dataset(base.data)
    pop = None
    for name, over in probes.items():
        cfg = base.with_overrides({**over, "train.num_steps": str(steps)})
        t0 = time.time()
        trainer, state, history = train(cfg, ds, device=dev)
        m = evaluate(trainer.model, ds, cfg, split="val", mesh=trainer.mesh)
        if pop is None:
            pop = popularity_baseline(ds, cfg.eval.recall_ks, split="val")
        dt = time.time() - t0
        print(
            f"PROBE {name:>12}: loss={history[-1]['loss']:.3f} "
            f"VAL r@1={m['recall@1']:.4f} r@5={m['recall@5']:.4f} r@10={m['recall@10']:.4f} "
            f"ndcg={m['ndcg@10']:.4f} | pop r@10={pop['recall@10']:.4f} "
            f"{'BEATS POP' if m['recall@10'] > pop['recall@10'] else 'below'} ({dt:.0f}s)",
            flush=True,
        )


def parse(prog: str, doc: str, default_steps: int, argv: list[str] | None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog=prog, description=doc, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("steps", nargs="?", type=int, default=default_steps, help="train steps a probe")
    add_device_arg(p)
    return p.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    args = parse("python -m poi_tpu_torch.scripts.tune_strnn", __doc__, 1500, argv)
    run_probes("strnn_gowalla", PROBES, args.steps, setup(args.device), BASE)
    return 0


if __name__ == "__main__":
    sys.exit(main())
