"""The host loader's ``train()`` under each way of feeding it batches, in
turns: what a prefetcher's worker costs the thread that launches the step,
on a configuration bound by that thread (config #4).

    python -m poi_tpu_torch.scripts.host_feed [--config attention_gowalla] [--spc 1]
        [--steps 100] [--warmup 10] [--rounds 3] [--set k=v ...] [--device cuda]

The feeds (``FEEDS``): where a batch is assembled, and which thread queues
its copy to the device, and how. ``train()`` runs ``sync`` at ``--spc 1``
and ``prefetch`` above it; the others are put in place around it.

    sync       the loader's own thread assembles; the launching thread copies
               each batch (chunk) synchronously (``batch_to``)
    inline     the loader's own thread assembles; the launching thread queues
               the next batch's (chunk's) pinned copy one ahead
               (``Trainer.put_chunk``, no worker)
    prefetch   a ``DevicePrefetcher`` worker assembles and queues the pinned
               copy, 3 batches or 2 chunks ahead; the loader runs no thread
    prefetch2  that worker and the loader's own thread both

One line a run (seq/s, ms a step, and the ms a step spent producing the
feed's items on whichever thread produces them), then each feed's median.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from contextlib import contextmanager

from poi_tpu_torch.scripts._timing import add_device_arg, setup

FEEDS = ("sync", "inline", "prefetch", "prefetch2")


class _Inline:
    """``DevicePrefetcher``'s interface without a thread: ``produce`` runs
    on the caller's thread, ``depth - 1`` items ahead."""

    def __init__(self, produce, depth: int = 2):
        self._produce = produce
        self._ahead = [produce() for _ in range(depth - 1)]

    def __iter__(self):
        return self

    def __next__(self):
        self._ahead.append(self._produce())
        return self._ahead.pop(0)

    def close(self) -> None:
        self._ahead.clear()


class _Fed:
    """A loader whose single batches come through a feed made by
    ``make_feed(produce)`` at the first ``next()`` (after ``train()`` has
    positioned the loader), each made ready on the caller's thread."""

    def __init__(self, loader, trainer, make_feed):
        self._loader, self._trainer, self._make_feed, self._feed = loader, trainer, make_feed, None

    def __next__(self):
        from poi_tpu_torch.models.base import InFlight

        if self._feed is None:
            self._feed = self._make_feed(lambda: self._trainer.put_chunk([next(self._loader)]))
        item = next(self._feed)
        return (item.ready() if isinstance(item, InFlight) else item)[0]

    def close(self) -> None:
        if self._feed is not None:
            self._feed.close()
        self._loader.close()

    def __getattr__(self, name):
        return getattr(self._loader, name)


@contextmanager
def feeding(feed: str, spc: int, trainer, busy: list):
    """``train()`` fed as ``feed`` says while inside; the seconds each item
    of the feed took to produce are appended to ``busy``."""
    from poi_tpu_torch.data import pipeline
    from poi_tpu_torch.models.base import batch_to
    from poi_tpu_torch.train import loop

    make_loader, prefetcher = loop.make_train_loader, loop.DevicePrefetcher

    def timed(produce):
        def run():
            t0 = time.perf_counter()
            item = produce()
            busy.append(time.perf_counter() - t0)
            return item
        return run

    def feed_of(produce, depth):
        if feed in ("prefetch", "prefetch2"):
            return pipeline.DevicePrefetcher(timed(produce), depth)
        return _Inline(timed(produce), 1 if feed == "sync" else 2)

    own_thread = 0 if feed == "prefetch" else 2
    if spc == 1:
        def loader(*a, **k):
            inner = make_loader(*a, **{**k, "prefetch": own_thread})
            return inner if feed == "sync" else _Fed(inner, trainer, lambda produce: feed_of(produce, 3))
        loop.make_train_loader = loader
        if feed == "sync":  # train()'s own: each step's next() and copy, timed
            trainer.step = _timed_step(trainer, busy)
    else:
        loop.make_train_loader = lambda *a, **k: make_loader(*a, **{**k, "prefetch": own_thread})
        loop.DevicePrefetcher = feed_of
        if feed == "sync":
            trainer.put_chunk = lambda bs: [batch_to(b, trainer.device) for b in bs]
    try:
        yield
    finally:
        loop.make_train_loader, loop.DevicePrefetcher = make_loader, prefetcher
        trainer.__dict__.pop("put_chunk", None)
        trainer.__dict__.pop("step", None)


def _timed_step(trainer, busy: list):
    """``trainer.step`` with its copy of a host batch timed into ``busy``."""
    import numpy as np

    from poi_tpu_torch.models.base import batch_to

    step = trainer.step

    def run(state, batch):
        if isinstance(batch.poi_in, np.ndarray):
            t0 = time.perf_counter()
            batch = batch_to(batch, trainer.device)
            busy.append(time.perf_counter() - t0)
        return step(state, batch)
    return run


def run(cfg, ds, feed: str, steps: int, warmup: int, dev) -> dict:
    """One warmed run of ``feed``: seq/s, ms a step, producing ms a step."""
    import torch

    from poi_tpu_torch.train.loop import make_trainer, train

    trainer = make_trainer(cfg, ds, dev)
    busy: list = []
    with feeding(feed, cfg.train.steps_per_call, trainer, busy):
        _, state, _ = train(cfg, ds, num_steps=warmup, trainer=trainer, state=trainer.init_state())
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        busy.clear()
        t0 = time.perf_counter()
        train(cfg, ds, num_steps=steps, trainer=trainer, state=state)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        step_ms = (time.perf_counter() - t0) * 1e3 / steps
    return {"seq_per_s": cfg.train.batch_size / step_ms * 1e3, "step_ms": step_ms,
            "produce_ms": sum(busy) * 1e3 / steps}


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m poi_tpu_torch.scripts.host_feed", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default="attention_gowalla")
    p.add_argument("--spc", type=int, default=1, help="train.steps_per_call")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--warmup", type=int, default=10)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE")
    add_device_arg(p)
    args = p.parse_args(argv)
    dev = setup(args.device)

    from poi_tpu_torch.configs.presets import get_config
    from poi_tpu_torch.data.dataset import load_dataset

    cfg = get_config(args.config).with_overrides(
        {**dict(kv.split("=", 1) for kv in args.set), "train.steps_per_call": str(args.spc)})
    if cfg.data.sampler != "host":
        raise SystemExit(f"--config {args.config}: data.sampler={cfg.data.sampler!r}; this times the host loader")
    ds = load_dataset(cfg.data)
    runs: dict[str, list[dict]] = {f: [] for f in FEEDS}
    for r in range(args.rounds):
        for feed in FEEDS:
            t = run(cfg, ds, feed, args.steps, args.warmup, dev)
            runs[feed].append(t)
            print(f"round {r + 1} {feed:9s} spc={args.spc}: {t['seq_per_s']:.1f} seq/s, {t['step_ms']:.3f} ms a step, "
                  f"producing {t['produce_ms']:.3f} ms a step", flush=True)
    for feed in FEEDS:
        med = {k: statistics.median(t[k] for t in runs[feed]) for k in runs[feed][0]}
        print(f"median {feed:9s} spc={args.spc}: {med['seq_per_s']:.1f} seq/s, {med['step_ms']:.3f} ms a step, "
              f"producing {med['produce_ms']:.3f} ms a step ({args.rounds} runs of {args.steps} steps after "
              f"{args.warmup}, {args.config}, log_every {cfg.train.log_every})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
