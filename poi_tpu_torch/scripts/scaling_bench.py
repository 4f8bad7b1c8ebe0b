"""Weak-scaling harness, the counterpart of ``scripts/scaling_bench.py``:
seq/s of the train step at 1 and N ranks with the per-rank batch fixed.

    python -m torch.distributed.run --nproc-per-node N -m poi_tpu_torch.scripts.scaling_bench
        --config multihost_1m --per-host-batch 256 --steps 100 --out scaling.json
    python -m poi_tpu_torch.scripts.scaling_bench --local-processes 2 --config smoke   # the rig

Every rank trains ``--steps`` steps of the config's host-loader path (its
data rank's share of a global batch of ``per-host-batch x N``, through
``Trainer.step`` or ``step_chunk`` at ``train.steps_per_call``) after
``--warmup`` steps, ``--repeats`` times, and keeps its best seq/s; the
clock stops after reading the last loss, which waits for the device. Rank 0
appends one row to ``--out`` (replacing the row of the same N and config)
and prints the efficiency table against the N = 1 row (run N = 1 first).

Under ``torch.distributed.run`` the ranks are its (NCCL on cards, a card a
rank). ``--local-processes N`` starts N gloo ranks on this machine
(``parallel.launch.spawn``); with ``--device cuda`` they all share the one
card, so that table prices the rig (gloo's host copies, ranks taking turns
on one card), not scaling, and the script says so.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

from poi_tpu_torch.scripts._timing import add_device_arg, setup


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m poi_tpu_torch.scripts.scaling_bench", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default="smoke")
    p.add_argument("--set", nargs="*", default=[], help="dotted overrides key=value")
    p.add_argument("--per-host-batch", type=int, default=None,
                   help="per-rank batch (global = N * this); default: the config's batch_size")
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--warmup", type=int, default=10)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--out", default=None, help="JSON results file (rows appended by rank 0)")
    p.add_argument("--local-processes", type=int, default=0,
                   help="the rig: N gloo ranks on this machine (sharing the one card with --device cuda)")
    add_device_arg(p)
    return p.parse_args(argv)


def rank_main(config: str, sets: list[str], per_host_batch: int | None, steps: int, warmup: int, repeats: int,
              out: str | None, device: str, rig: bool) -> dict:
    """One rank's run; rank 0 records the row and prints the table."""
    import torch
    import torch.distributed as dist

    from poi_tpu_torch.configs.presets import get_config
    from poi_tpu_torch.data.dataset import load_dataset
    from poi_tpu_torch.data.pipeline import make_train_loader
    from poi_tpu_torch.models.base import DataDims
    from poi_tpu_torch.parallel.mesh import DATA_AXIS, init_distributed, launched, rank_device
    from poi_tpu_torch.train.loop import Trainer
    from poi_tpu_torch.utils.config import parse_set_flags

    if launched() and not dist.is_initialized():
        init_distributed("gloo" if rig or torch.device(device).type == "cpu" else "nccl")
    n = dist.get_world_size() if dist.is_initialized() else 1
    dev = rank_device(device)
    cfg = get_config(config).with_overrides(parse_set_flags(sets))
    per_host = per_host_batch or cfg.train.batch_size
    cfg = cfg.with_overrides({"train.batch_size": str(per_host * n), "train.warmup_steps": "0"})
    ds = load_dataset(cfg.data)
    trainer = Trainer(cfg, DataDims.from_dataset(ds), device=dev)
    mesh = trainer.mesh
    state = trainer.init_state()
    loader = make_train_loader(ds.train, batch_size=per_host, seed=0, host_id=mesh.index[DATA_AXIS],
                               num_hosts=mesh.shape[DATA_AXIS], backend=cfg.data.loader_backend)
    spc = max(1, cfg.train.steps_per_call)
    steps = max(spc, steps - steps % spc)

    def run(k: int) -> float:
        nonlocal state
        for _ in range(k // spc):
            if spc > 1:
                state, m = trainer.step_chunk(state, [next(loader) for _ in range(spc)])
                loss = m["loss"][-1]
            else:
                state, m = trainer.step(state, next(loader))
                loss = m["loss"]
        return float(loss)  # waits for every step above

    run(max(warmup, spc))
    best = 0.0
    for _ in range(repeats):
        t0 = time.perf_counter()
        run(steps)
        best = max(best, steps * cfg.train.batch_size / (time.perf_counter() - t0))
    loader.close()
    row = {"processes": n, "devices": n, "global_batch": cfg.train.batch_size, "global_seqs_per_sec": round(best, 1),
           "per_process_seqs_per_sec": round(best / n, 1), "config": config, "steps": steps,
           "device": str(dev.type), "rig": rig}
    if not dist.is_initialized() or dist.get_rank() == 0:
        _record(out, row)
        print("SCALING " + json.dumps(row), flush=True)
        if rig and dev.type == "cuda":
            print("note: these ranks share one card over gloo; the table prices the rig (host copies, ranks taking "
                  "turns on the card), not scaling", flush=True)
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    return row


def _record(out: str | None, row: dict) -> None:
    if not out:
        return
    path = Path(out)
    rows = json.loads(path.read_text()) if path.exists() else []
    rows = [r for r in rows if r["processes"] != row["processes"] or r["config"] != row["config"]]
    rows.append(row)
    rows.sort(key=lambda r: (r["config"], r["processes"]))
    path.write_text(json.dumps(rows, indent=2))
    base = next((r for r in rows if r["config"] == row["config"] and r["processes"] == 1), None)
    print(f"{'N':>3} {'global seq/s':>14} {'per-proc':>10} {'efficiency':>10}")
    for r in (r for r in rows if r["config"] == row["config"]):
        eff = "-" if base is None else f"{r['per_process_seqs_per_sec'] / base['per_process_seqs_per_sec']:.1%}"
        print(f"{r['processes']:>3} {r['global_seqs_per_sec']:>14} {r['per_process_seqs_per_sec']:>10} {eff:>10}")


def main(argv=None) -> int:
    args = parse_args(argv)
    setup(args.device)
    kw = {"config": args.config, "sets": args.set, "per_host_batch": args.per_host_batch, "steps": args.steps,
          "warmup": args.warmup, "repeats": args.repeats,
          "out": os.path.abspath(args.out) if args.out else None, "device": args.device}
    if args.local_processes:
        from poi_tpu_torch.parallel.launch import spawn

        spawn("poi_tpu_torch.scripts.scaling_bench:rank_main", args.local_processes, {**kw, "rig": True},
              timeout=900)
    else:
        rank_main(**kw, rig=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
