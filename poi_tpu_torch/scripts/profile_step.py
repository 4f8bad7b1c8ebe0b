"""The bench workload's train step split into regions, the counterpart of
``scripts/profile_step.py``.

    python -m poi_tpu_torch.scripts.profile_step [--batch 256] [--device cuda]

The workload is ``bench.py``'s (the smoke preset with its overrides: GRU
128-d, T=64, bf16, full-catalog CE over 44,170 POIs). Each region is timed
on one batch with CUDA events around the region alone (the median of
``ITERS``), so there is no harness body to subtract: embed lookup
fwd+bwd, tower fwd, tower fwd+bwd, CE fwd and fwd+bwd with q fixed, the full
loss fwd+bwd, the optimizer update, the two global norms. Then the whole
``Trainer.step`` on host-loader batches and a 10-step ``step_sampled`` chunk
on device-sampled ones, on the host clock fenced by reading the last loss.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from poi_tpu_torch.scripts._timing import BENCH_OVERRIDES, add_device_arg, setup, time_ms

ITERS = 20  # timed calls a region
STEPS, TRIALS = 30, 3  # Trainer.step: the best of TRIALS runs of STEPS steps


def regions(trainer, batch) -> dict:
    """The step's regions as closures over one device ``batch``. The
    optimizer runs on copies of the parameters (its gradients are the
    parameters, as in the JAX script), so the trainer's stay as they were."""
    from poi_tpu_torch.models.base import input_embeddings, output_table
    from poi_tpu_torch.train.sparse_opt import touched_ids
    from poi_tpu_torch.train.state import global_norm

    model, cfg = trainer.model, trainer.cfg
    params = dict(model.named_parameters())
    neg = trainer.draw_negatives(0, batch)
    extra = () if neg is None else (neg,)
    table, bias = output_table(model.embed, cfg.model)
    with torch.no_grad():
        q0 = model.queries(batch)
    q_fixed = q0.clone().requires_grad_()

    def clear():
        for p in (*params.values(), q_fixed):
            p.grad = None

    def loss_on(q):
        return trainer.loss_fn(q, table, bias, batch.poi_tgt, batch.mask, *extra)

    def backward(t):
        clear()
        t.float().sum().backward() if t.dim() else t.backward()

    def no_grad(fn):
        def run():
            with torch.no_grad():
                fn()
        return run

    copies = {k: v.detach().clone() for k, v in params.items()}
    grads = {k: v.detach().clone() for k, v in params.items()}
    opt_state = trainer.optimizer.init(copies)
    if trainer.sparse:
        ids = touched_ids(batch, neg)
        opt = lambda: trainer.optimizer.update(grads, opt_state, copies, ids)  # noqa: E731
    else:
        opt = lambda: trainer.optimizer.update(grads, opt_state, copies)  # noqa: E731
    return {
        "embed lookup fwd+bwd": lambda: backward(input_embeddings(model.embed, batch, cfg.model)),
        "tower fwd": no_grad(lambda: model.queries(batch)),
        "tower fwd+bwd": lambda: backward(model.queries(batch)),
        "CE fwd (fixed q)": no_grad(lambda: loss_on(q0)),
        "CE fwd+bwd (fixed q)": lambda: backward(loss_on(q_fixed)),
        "full loss fwd+bwd": lambda: backward(trainer.loss(batch, neg)),
        "optimizer update": opt,
        "global norms x2": no_grad(lambda: (global_norm(params.values()), global_norm(params.values()))),
    }


def print_regions(rows: dict[str, float]) -> None:
    for name, ms in rows.items():
        print(f"  {name:24s}: {ms:8.3f} ms", flush=True)


def first_batch(cfg, ds, dev):
    from poi_tpu_torch.data.pipeline import make_train_loader
    from poi_tpu_torch.models.base import batch_to

    loader = make_train_loader(ds.train, batch_size=cfg.train.batch_size, seed=0, backend=cfg.data.loader_backend)
    try:
        return batch_to(next(loader), dev)
    finally:
        loader.close()


def step_ms(trainer, cfg, ds, steps: int, trials: int) -> float:
    """Best ms a ``Trainer.step`` on host-loader batches, over ``trials``
    runs of ``steps`` steps, each fenced by reading its last loss."""
    from poi_tpu_torch.data.pipeline import make_train_loader

    loader = make_train_loader(ds.train, batch_size=cfg.train.batch_size, seed=0, backend=cfg.data.loader_backend)
    try:
        state = trainer.init_state()
        for _ in range(min(steps, 5)):
            state, m = trainer.step(state, next(loader))
        float(m["loss"])
        best = float("inf")
        for _ in range(trials):
            t0 = time.perf_counter()
            for _ in range(steps):
                state, m = trainer.step(state, next(loader))
            float(m["loss"])
            best = min(best, (time.perf_counter() - t0) * 1e3 / steps)
        return best
    finally:
        loader.close()


def sampled_ms(trainer, chunk: int, chunks: int, trials: int) -> float:
    """Best ms a step of ``step_sampled`` chunks of ``chunk`` steps, over
    ``trials`` runs of ``chunks`` chunks, fenced by reading the last loss."""
    state = trainer.init_state()
    state, m = trainer.step_sampled(state, chunk)
    float(m["loss"][-1])
    best = float("inf")
    for _ in range(trials):
        t0 = time.perf_counter()
        for _ in range(chunks):
            state, m = trainer.step_sampled(state, chunk)
        float(m["loss"][-1])
        best = min(best, (time.perf_counter() - t0) * 1e3 / (chunk * chunks))
    return best


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m poi_tpu_torch.scripts.profile_step", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, default=256)
    add_device_arg(p)
    args = p.parse_args(argv)
    dev = setup(args.device)

    from poi_tpu_torch.configs.presets import get_config
    from poi_tpu_torch.data.dataset import load_dataset
    from poi_tpu_torch.train.loop import make_trainer

    cfg = get_config("smoke").with_overrides({**BENCH_OVERRIDES, "train.batch_size": str(args.batch)})
    ds = load_dataset(cfg.data)
    trainer = make_trainer(cfg, ds, dev)
    batch = first_batch(cfg, ds, dev)
    B, T = batch.poi_in.shape
    V, D = trainer.dims.num_pois_padded, cfg.model.embed_dim
    product = 2 * B * T * D * V
    print(f"batch={B} T={T} V={V} D={D}  (CE fwd product {product / 1e9:.0f} GFLOP); each region timed alone "
          f"({'CUDA events' if dev.type == 'cuda' else 'host clock'}, median of {ITERS}): no harness body "
          f"to subtract", flush=True)
    rows = {name: time_ms(fn, ITERS, dev=dev) for name, fn in regions(trainer, batch).items()}
    print_regions(rows)
    t_f, t_fb = rows["CE fwd (fixed q)"], rows["CE fwd+bwd (fixed q)"]
    print(f"  CE fwd eff : {product / t_f / 1e9:7.1f} TFLOP/s (1 catalog product)")
    print(f"  CE bwd eff : {3 * product / (t_fb - t_f) / 1e9:7.1f} TFLOP/s (3 products, the JAX script's count), "
          f"{4 * product / (t_fb - t_f) / 1e9:7.1f} TFLOP/s (4, the port's two recomputing kernels)", flush=True)
    ms = step_ms(trainer, cfg, ds, STEPS, TRIALS)
    print(f"  full step          : {ms:8.3f} ms  ({B / ms * 1e3:,.0f} seq/s; Trainer.step on host-loader batches, "
          f"host clock)", flush=True)
    sampled = make_trainer(cfg.with_overrides({"data.sampler": "device"}), ds, dev)
    ms = sampled_ms(sampled, 10, max(1, STEPS // 10), TRIALS + 1)
    print(f"  sampled 10-step    : {ms:8.3f} ms/step  ({B / ms * 1e3:,.0f} seq/s; step_sampled chunks of 10, host "
          f"clock)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
