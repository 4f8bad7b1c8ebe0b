"""Device memory budget of a named config's training, the counterpart of
``scripts/mem_budget.py``.

    python -m poi_tpu_torch.scripts.mem_budget [config] [--set k=v ...] [--force-v V] [--device cuda]

1. **Exact accounting** from the trainer's tensors: the bytes of the
   parameters and of the optimizer state (Adam's moments, or lazy Adam's
   where ``train.table_update=sparse``), split into catalog tables (first
   dimension the padded catalog) and dense; the gradients' bytes.
2. **One real step**: ``torch.cuda.max_memory_allocated`` around one
   ``Trainer.step`` on a host-loader batch, or one ``step_sampled`` chunk of
   ``train.steps_per_call`` steps with ``data.sampler=device``, after
   ``reset_peak_memory_stats``: the counterpart of XLA's
   ``memory_analysis()`` of the compiled step.
3. ``torch.cuda.memory_stats()`` after that step.

``--budget-gib`` defaults to the card's memory. ``--force-v`` sizes the
model's catalog at V rows whatever the corpus holds (``bench_1m``'s
dimensions). Config #5 (``multihost_1m --set mesh.model=1
mesh.embedding_mode=psum data.min_poi_checkins=1``: a tied 903,889 x 512
table) takes the rows-gradient step: no dense table gradient, [N, D + 1]
gradient rows (N = 2 B T + S) instead, and lazy Adam by gather/scatter.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import torch

from poi_tpu_torch.scripts._timing import add_device_arg, setup


def tensors(tree):
    """The tensors of a nest of dicts (an optimizer state's host ints are
    not device memory)."""
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tensors(v)


def split_bytes(tree, vp: int) -> tuple[int, int]:
    """(bytes of the tensors whose first dimension is the padded catalog,
    bytes of the rest)."""
    table = dense = 0
    for t in tensors(tree):
        b = t.numel() * t.element_size()
        if t.dim() >= 1 and t.shape[0] == vp:
            table += b
        else:
            dense += b
    return table, dense


def accounting(trainer, state) -> dict[str, int]:
    """Exact bytes of the parameters and optimizer state, tables and dense."""
    vp = trainer.dims.num_pois_padded
    pt, pd = split_bytes(state.params, vp)
    ot, od = split_bytes(state.opt_state, vp)
    return {"params_tables": pt, "params_dense": pd, "opt_tables": ot, "opt_dense": od}


def gib(n: float) -> str:
    return f"{n / 2**30:8.3f} GiB ({int(n):,} B)"


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m poi_tpu_torch.scripts.mem_budget", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("config", nargs="?", default="attention_gowalla")
    p.add_argument("--set", nargs="*", default=[])
    p.add_argument("--force-v", type=int, default=0,
                   help="size the model's catalog at V rows, independent of the corpus' visited set")
    p.add_argument("--budget-gib", type=float, default=None,
                   help="memory to report headroom against (default: the card's total)")
    add_device_arg(p)
    args = p.parse_args(argv)
    dev = setup(args.device)

    from poi_tpu_torch.configs.presets import get_config
    from poi_tpu_torch.data.dataset import load_dataset
    from poi_tpu_torch.data.device_sampler import DeviceSampler
    from poi_tpu_torch.data.pipeline import make_train_loader
    from poi_tpu_torch.models.base import DataDims, batch_to
    from poi_tpu_torch.train.loop import Trainer
    from poi_tpu_torch.utils.config import parse_set_flags

    cfg = get_config(args.config).with_overrides(parse_set_flags(args.set))
    ds = load_dataset(cfg.data)
    dims = DataDims.from_dataset(ds)
    if args.force_v:
        dims = dataclasses.replace(dims, num_pois=args.force_v, num_pois_padded=0)
    sampler = DeviceSampler(ds.train, cfg.train.batch_size, cfg.train.seed, dev) \
        if cfg.data.sampler == "device" else None
    trainer = Trainer(cfg, dims, device=dev, sampler=sampler)
    state = trainer.init_state()

    # ---- 1. exact accounting ------------------------------------------------
    acc = accounting(trainer, state)
    B, T = cfg.train.batch_size, cfg.data.max_seq_len
    from poi_tpu_torch.train import sparse_opt

    big = trainer.dims.num_pois_padded * cfg.model.embed_dim * 4 > sparse_opt.DENSE_LAZY_MAX_BYTES
    lazy = ""
    if trainer.rows_mode:
        lazy = " (rows-gradient step, gather/scatter lazy Adam)"
    elif cfg.train.table_update == "sparse":
        lazy = f" ({'gather/scatter' if big else 'masked-dense'} lazy Adam)"
    print(f"config {cfg.name}: V={trainer.dims.num_pois:,} (padded {trainer.dims.num_pois_padded:,}) "
          f"D={cfg.model.embed_dim} B={B} T={T} S={cfg.loss.num_sampled} loss={cfg.loss.kind} "
          f"table_update={cfg.train.table_update}{lazy} sampler={cfg.data.sampler}", flush=True)
    print("-- exact accounting (the trainer's tensors) --")
    print(f"  params      tables {gib(acc['params_tables'])}   dense {gib(acc['params_dense'])}")
    print(f"  opt state   tables {gib(acc['opt_tables'])}   dense {gib(acc['opt_dense'])}   "
          f"({cfg.train.optimizer}; its step count is a host int)")
    if trainer.rows_mode:
        n = 2 * B * T + cfg.loss.num_sampled
        print(f"  table grad  {gib(n * (cfg.model.embed_dim + 1) * 4)}  ([{n:,}, D + 1] rows: no dense cotangent)")
    else:
        print(f"  table grad  {gib(acc['params_tables'])}  (dense cotangent)")
    print(f"  dense grad  {gib(acc['params_dense'])}")
    print(f"  resident state (params + optimizer state): {gib(sum(acc.values()))}", flush=True)

    # ---- 2. one real step ---------------------------------------------------
    spc = max(1, cfg.train.steps_per_call)
    what = f"one step_sampled chunk of {spc} steps" if sampler is not None else "one Trainer.step on a host batch"
    if sampler is None:
        loader = make_train_loader(ds.train, batch_size=B, seed=0, backend=cfg.data.loader_backend)
        try:
            batch = batch_to(next(loader), dev)
        finally:
            loader.close()
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    if sampler is not None:
        state, m = trainer.step_sampled(state, spc)
        loss = float(m["loss"][-1])
    else:
        state, m = trainer.step(state, batch)
        loss = float(m["loss"])
    print(f"-- {what} (loss {loss:.4f}) --")
    if not cuda:
        print("  not measured: the CUDA memory counters need a card (cpu run)")
        return 0
    peak = torch.cuda.max_memory_allocated(dev)
    budget = (args.budget_gib * 2**30 if args.budget_gib is not None
              else torch.cuda.get_device_properties(dev).total_memory)
    print(f"  allocated before the step {gib(base)}  (state{' + the device-resident corpus' if sampler else ''})")
    print(f"  peak during the step      {gib(peak)}  (torch.cuda.max_memory_allocated)")
    print(f"  step's own peak           {gib(peak - base)}  (activations, gradients, workspace)")
    print(f"  headroom vs {budget / 2**30:.2f} GiB: {gib(budget - peak)}")

    # ---- 3. the allocator's counters ------------------------------------------
    stats = torch.cuda.memory_stats(dev)
    print("-- torch.cuda.memory_stats --")
    for k in ("allocated_bytes.all.current", "allocated_bytes.all.peak", "reserved_bytes.all.current",
              "reserved_bytes.all.peak"):
        print(f"  {k}: {gib(stats.get(k, 0))}")
    for k in ("num_alloc_retries", "num_ooms"):
        print(f"  {k}: {stats.get(k, 0)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
