"""Quality run of a named config, the counterpart of ``scripts/quality_runs.py``.

    python -m poi_tpu_torch.scripts.quality_runs <preset> [k=v ...] [--device cuda]

e.g.  python -m poi_tpu_torch.scripts.quality_runs lstm_bpr_foursquare
      python -m poi_tpu_torch.scripts.quality_runs gru_foursquare_nyc train.num_steps=300

Trains the preset for its step budget (or the ``train.num_steps`` given),
selecting the best parameters on the val split every ``eval_every`` steps
when the preset has one, evaluates the selected parameters on test once, and
prints the ``ROW`` line of the JAX script: the metrics, the popularity
floor, the median window's seq/s.

Under a launcher (``python -m torch.distributed.run --nproc-per-node N -m
poi_tpu_torch.scripts.quality_runs multihost_1m ...``) each rank runs on
the config's ``(mesh.data, mesh.model)`` mesh, as the ``train`` verb does:
the selection and the test evaluation run on the mesh, every rank gets the
same metrics, and only rank 0 prints. A process group made before ``main``
is kept (gloo ranks sharing one card make their own). With the a2a lookup
rank 0 also prints the share of input ids it dropped.
"""

from __future__ import annotations

import argparse
import logging
import statistics
import sys
import time

import torch
import torch.distributed as dist

from poi_tpu_torch.scripts._timing import add_device_arg, setup


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m poi_tpu_torch.scripts.quality_runs", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("preset")
    p.add_argument("overrides", nargs="*", help="dotted overrides key=value")
    add_device_arg(p)
    args = p.parse_args(argv)
    dev = setup(args.device)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")

    from poi_tpu_torch.parallel.mesh import join_launch

    made = not dist.is_initialized()
    dev = join_launch(dev)
    try:
        return run(args.preset, args.overrides, dev)
    finally:
        # Before the interpreter exits (cli.main's reason); a group the caller made is the caller's.
        if made and dist.is_initialized():
            dist.destroy_process_group()


def run(preset: str, sets: list[str], dev: torch.device) -> int:
    from poi_tpu_torch.configs.presets import get_config
    from poi_tpu_torch.data.dataset import load_dataset
    from poi_tpu_torch.eval.evaluate import evaluate, popularity_baseline
    from poi_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS
    from poi_tpu_torch.train.loop import make_trainer, train
    from poi_tpu_torch.train.selection import BestOnVal
    from poi_tpu_torch.utils.config import parse_set_flags

    lead = not dist.is_initialized() or dist.get_rank() == 0
    say = print if lead else lambda *a, **k: None
    overrides = parse_set_flags(sets)
    cfg = get_config(preset).with_overrides(overrides)
    say(f"config: {preset} + {overrides} ({cfg.train.num_steps} steps)", flush=True)
    ds = load_dataset(cfg.data)
    say(f"dataset: {ds.num_users} users {ds.num_pois} pois {len(ds.train)} train / {len(ds.test)} test"
        + (f" / {len(ds.val)} val" if ds.val is not None else ""), flush=True)

    trainer = make_trainer(cfg, ds, dev)
    mesh = trainer.mesh
    tracker = BestOnVal(trainer, ds, cfg) if ds.val is not None else None
    t0 = time.time()
    trainer, state, history = train(cfg, ds, trainer=trainer, callbacks=[tracker] if tracker else None, device=dev)
    dt = time.time() - t0
    sel = ""
    if tracker is not None and tracker.best_step >= 0:
        with torch.no_grad():
            for k, v in tracker.best_params(state.params).items():
                state.params[k].copy_(v)
        sel = f" [selected step {tracker.best_step} val {tracker.metric}={tracker.best_score:.4f}]"
    m = evaluate(trainer.model, ds, cfg, mesh=mesh)
    pop = popularity_baseline(ds, cfg.eval.recall_ks)
    dropped = [h["a2a_overflow"] for h in history if "a2a_overflow" in h]
    if dropped:
        say(f"a2a lookup at mesh.a2a_capacity_factor={cfg.mesh.a2a_capacity_factor}: dropped a share "
            f"{statistics.mean(dropped):.6f} of the input ids a step (mean of {len(dropped)} log steps; min "
            f"{min(dropped):.6f}, max {max(dropped):.6f})", flush=True)
    # Steady state: the median window's seq/s (the first window holds the warm-up).
    sps = sorted(h["seqs_per_sec"] for h in history[1:] or history)
    sps = sps[len(sps) // 2]
    verdict = (f"BEATS POP {m['recall@10'] / max(pop['recall@10'], 1e-9):.2f}x" if m["recall@10"] > pop["recall@10"]
               else "BELOW FLOOR")
    say(
        f"ROW {preset}: steps={cfg.train.num_steps} loss={history[-1]['loss']:.3f} "
        f"r@1={m['recall@1']:.4f} r@5={m['recall@5']:.4f} r@10={m['recall@10']:.4f} "
        f"ndcg@10={m['ndcg@10']:.4f}{sel} | pop r@1={pop['recall@1']:.4f} "
        f"r@5={pop['recall@5']:.4f} r@10={pop['recall@10']:.4f} "
        f"ndcg={pop['ndcg@10']:.4f} | {sps:,.0f} seq/s (median window) "
        f"batch={cfg.train.batch_size} wall={dt:.0f}s device={dev.type} "
        f"mesh={mesh.shape[DATA_AXIS]}x{mesh.shape[MODEL_AXIS]} {verdict}",
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
