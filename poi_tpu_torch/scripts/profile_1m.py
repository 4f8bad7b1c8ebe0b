"""Config #5's train step split into regions at catalog scale, the
counterpart of ``scripts/profile_1m.py``; and the lazy-Adam update's two
forms at config #4's and config #5's tables.

    python -m poi_tpu_torch.scripts.profile_1m [--batch 512] [--device cuda]

``multihost_1m`` on one device with the JAX script's overrides (20,000 users,
device-sampled batches, no warmup), the model's catalog forced to
``FORCE_V`` rows as ``bench_1m`` forces it. Each region is one call on one
batch, timed by the device time ``torch.profiler`` records for its kernels
(``_timing.kernel_ms``, the mean of ``ITERS`` calls; the host clock on the
CPU): embed lookup fwd+bwd, tower fwd, tower fwd+bwd, attention + LayerNorm
fwd+bwd on fixed hidden states, the full gradient of the rows-gradient step
("full grads (rows)") against the dense-gradient one ("full grads (dense
path)"), the dense table gradient of a gather alone, the sampled loss with q
fixed, and the optimizer: dense Adam over every row and lazy Adam
(``table_update=sparse``) on the step's touched ids.

Then ``crossover``: lazy Adam on one table alone, at config #4's (36,969 x
256) and config #5's (903,889 x 512) shapes with 2 B T + S touched ids
drawn uniformly, forced through the masked-dense form and the gather/scatter
form in turn (``DENSE_LAZY_MAX_BYTES`` set for each): the measurement a
later change of the threshold would rest on.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import torch

from poi_tpu_torch.scripts._timing import add_device_arg, kernel_ms, setup, time_ms

FORCE_V = 1_000_000
OVERRIDES = {"mesh.model": "1", "mesh.embedding_mode": "psum", "data.num_users": "20000",
             "data.sampler": "device", "train.warmup_steps": "0"}
ITERS = 10
# (name, V, D, touched ids = 2 B T + S): config #4 (B 64, T 128, S 1,024) and config #5 (B 512, T 64, S 4,096).
CROSSOVER = (("config #4", 36_969, 256, 2 * 64 * 128 + 1024), ("config #5", 903_889, 512, 2 * 512 * 64 + 4096))


def region_ms(fn, dev) -> float:
    """Device ms of one call of ``fn`` on the card; host ms on the CPU."""
    if dev.type == "cuda":
        return sum(kernel_ms(fn, ITERS).values())
    return time_ms(fn, ITERS, warmup=1, dev=dev)


def regions(trainer, batch) -> dict:
    """The step's regions as closures over one device ``batch``. The
    optimizers run on copies of the parameters, their gradients the
    parameters' one real step's."""
    from poi_tpu_torch.models.attention import layer_norm
    from poi_tpu_torch.models.base import input_embeddings, output_table
    from poi_tpu_torch.train import sparse_opt
    from poi_tpu_torch.train.state import make_optimizer

    model, cfg = trainer.model, trainer.cfg
    params = dict(model.named_parameters())
    neg = trainer.draw_negatives(0, batch)
    table, bias = output_table(model.embed, cfg.model)
    with torch.no_grad():
        q_fixed = model.queries(batch).requires_grad_()  # [B, T, D]: the hidden states' shape too
    h_fixed = q_fixed.detach().clone().requires_grad_()

    def clear():
        for p in (*params.values(), q_fixed, h_fixed):
            p.grad = None

    def backward(t):
        clear()
        t.float().sum().backward() if t.dim() else t.backward()

    def mha_ln():
        backward(layer_norm(model.tower.ln, h_fixed + model.tower.attention(h_fixed)))

    def no_grad(fn):
        def run():
            with torch.no_grad():
                fn()
        return run

    def full_rows():
        backward(trainer._rows_loss(batch, neg, None)[0])

    def dense_scatter():
        rows = trainer.model.embed["poi"].index_select(0, sparse_opt.touched_ids(batch, neg)["poi"])
        backward(rows)

    # One step's gradients (the dense path's), then the optimizers on copies.
    backward(trainer.loss(batch, neg))
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().clone() for k, p in params.items()}
    clear()
    copies = {k: v.detach().clone() for k, v in params.items()}
    dense_opt = make_optimizer(cfg.train)
    lazy_opt = sparse_opt.SparseTableOptimizer(cfg.with_overrides({"train.table_update": "sparse"}))
    ids = sparse_opt.touched_ids(batch, neg)
    states = {}

    def opt(kind):
        def run():
            if kind not in states:  # one optimizer state held at a time: each is 2x the params
                states.clear()
                states[kind] = (dense_opt if kind == "dense" else lazy_opt).init(copies)
            if kind == "dense":
                dense_opt.update(grads, states[kind], copies)
            else:
                lazy_opt.update(grads, states[kind], copies, ids)
        return run

    return {
        "embed lookup fwd+bwd": lambda: backward(input_embeddings(model.embed, batch, cfg.model)),
        "tower fwd": no_grad(lambda: model.queries(batch)),
        "tower fwd+bwd": lambda: backward(model.queries(batch)),
        "mha+ln fwd+bwd (fixed h)": mha_ln,
        "full grads (rows)": full_rows,
        "full grads (dense path)": lambda: backward(trainer.loss(batch, neg)),
        "dense-grad scatter alone": dense_scatter,
        "loss fwd+bwd (fixed q)": lambda: backward(trainer.loss_fn(q_fixed, table, bias, batch.poi_tgt, batch.mask,
                                                                   neg)),
        "optimizer DENSE adam": opt("dense"),
        "optimizer SPARSE adam": opt("sparse"),
    }


def crossover(dev) -> dict:
    """ms of one lazy-Adam update of a lone [V, D] table on each path."""
    from poi_tpu_torch.configs.presets import get_config
    from poi_tpu_torch.train import sparse_opt

    cfg = get_config("multihost_1m")
    gen = torch.Generator(device=dev).manual_seed(0)
    saved = sparse_opt.DENSE_LAZY_MAX_BYTES
    out = {}
    try:
        for name, V, D, n in CROSSOVER:
            p = {"embed.poi": torch.randn(V, D, generator=gen, device=dev) * 0.02}
            ids = {"poi": torch.randint(0, V, (n,), generator=gen, device=dev)}
            g = torch.zeros(V, D, device=dev).index_fill_(0, ids["poi"], 1e-3)
            opt = sparse_opt.SparseTableOptimizer(cfg)
            state = opt.init(p)
            for path, threshold in (("masked-dense", 2**62), ("gather/scatter", 0)):
                sparse_opt.DENSE_LAZY_MAX_BYTES = threshold
                out[(name, path)] = region_ms(lambda: opt.update({"embed.poi": g}, state, p, ids), dev)
            del p, g, state
    finally:
        sparse_opt.DENSE_LAZY_MAX_BYTES = saved
    return out


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m poi_tpu_torch.scripts.profile_1m", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, default=512)
    add_device_arg(p)
    args = p.parse_args(argv)
    dev = setup(args.device)

    from poi_tpu_torch.configs.presets import get_config
    from poi_tpu_torch.data.dataset import load_dataset
    from poi_tpu_torch.data.device_sampler import DeviceSampler
    from poi_tpu_torch.models.base import DataDims
    from poi_tpu_torch.train.loop import Trainer

    cfg = get_config("multihost_1m").with_overrides({**OVERRIDES, "train.batch_size": str(args.batch)})
    ds = load_dataset(cfg.data)
    dims = dataclasses.replace(DataDims.from_dataset(ds), num_pois=FORCE_V, num_pois_padded=0)
    sampler = DeviceSampler(ds.train, cfg.train.batch_size, cfg.train.seed, dev)
    trainer = Trainer(cfg, dims, device=dev, sampler=sampler)
    trainer.init_state()
    batch = sampler.sample(0)
    B, T = batch.poi_in.shape
    how = "device time, torch.profiler" if dev.type == "cuda" else "host clock"
    print(f"batch={B} T={T} V={dims.num_pois_padded:,} D={cfg.model.embed_dim} sampled={cfg.loss.num_sampled} "
          f"heads={cfg.model.attn_heads} touched_ids={2 * B * T + cfg.loss.num_sampled:,} rows_mode="
          f"{trainer.rows_mode}; each region one call ({how}, mean of {ITERS})", flush=True)
    for name, fn in regions(trainer, batch).items():
        print(f"  {name:26s}: {region_ms(fn, dev):8.3f} ms", flush=True)
    del trainer, sampler, batch
    print("lazy Adam on one table, each form forced:", flush=True)
    for (name, path), ms in crossover(dev).items():
        print(f"  {name} {path:14s}: {ms:8.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
