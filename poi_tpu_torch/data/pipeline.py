"""Sharded, prefetched batch pipeline.

Replaces the reference's NumPy minibatch loop (SURVEY.md §2.1 R2/R9) with a
grain-style loader: deterministic per-epoch shuffling, per-host sharding (each
JAX process sees a disjoint slice of the example set), fixed static batch
shapes (drop-remainder), and a background prefetch thread that overlaps host
batch assembly with device compute.

The loader is checkpointable: ``state()`` / ``restore()`` capture (epoch,
position) so training resumes mid-epoch after preemption (SURVEY.md §5
"Checkpoint/resume" — loader state is part of the checkpoint).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, NamedTuple

import numpy as np

from poi_tpu_torch.data.dataset import Examples


class Batch(NamedTuple):
    """One device-ready batch. All arrays have static shapes."""

    user: np.ndarray  # [B]
    poi_in: np.ndarray  # [B, T]
    poi_tgt: np.ndarray  # [B, T]
    mask: np.ndarray  # [B, T] float32 (1.0 at valid target positions)
    time_bucket: np.ndarray  # [B, T]
    geo_bucket: np.ndarray  # [B, T]
    tgap_idx: np.ndarray  # [B, T]
    tgap_frac: np.ndarray  # [B, T]
    dist_idx: np.ndarray  # [B, T]
    dist_frac: np.ndarray  # [B, T]


def make_batch(ex: Examples, idx: np.ndarray) -> Batch:
    return Batch(
        user=ex.user[idx],
        poi_in=ex.poi_in[idx],
        poi_tgt=ex.poi_tgt[idx],
        mask=ex.mask[idx].astype(np.float32),
        time_bucket=ex.time_bucket[idx],
        geo_bucket=ex.geo_bucket[idx],
        tgap_idx=ex.tgap_idx[idx],
        tgap_frac=ex.tgap_frac[idx],
        dist_idx=ex.dist_idx[idx],
        dist_frac=ex.dist_frac[idx],
    )


class TrainLoader:
    """Infinite shuffled loader over training examples.

    ``batch_size`` here is the PER-HOST batch (global batch // process_count);
    the caller shards it further over local devices via NamedSharding.
    """

    def __init__(
        self,
        examples: Examples,
        batch_size: int,
        seed: int = 0,
        host_id: int = 0,
        num_hosts: int = 1,
        prefetch: int = 2,
    ):
        if len(examples) == 0:
            raise ValueError("empty example set")
        self._ex = examples
        self._bs = batch_size
        self._seed = seed
        self._host = host_id
        self._nhosts = num_hosts
        self._epoch = 0
        self._pos = 0  # batch index within the epoch
        self._perm: np.ndarray | None = None
        self._queue: queue.Queue | None = None
        self._thread: threading.Thread | None = None
        self._prefetch = prefetch
        self._stop = threading.Event()

    # ------------------------------------------------------------ epoch mgmt
    def _epoch_perm(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng((self._seed, epoch))
        perm = rng.permutation(len(self._ex))
        # Per-host shard: contiguous stripe of the shuffled order.
        shard = perm[self._host :: self._nhosts]
        n_batches = len(shard) // self._bs
        if n_batches == 0:
            # Fewer examples than a batch: sample with replacement (tiny data).
            shard = rng.choice(shard, size=self._bs, replace=True)
            n_batches = 1
        return shard[: n_batches * self._bs].reshape(n_batches, self._bs)

    def _next_indices(self) -> np.ndarray:
        if self._perm is None:
            self._perm = self._epoch_perm(self._epoch)
        if self._pos >= len(self._perm):
            self._epoch += 1
            self._pos = 0
            self._perm = self._epoch_perm(self._epoch)
        idx = self._perm[self._pos]
        self._pos += 1
        return idx

    # ------------------------------------------------------------- iteration
    def __iter__(self) -> Iterator[Batch]:
        return self

    def __next__(self) -> Batch:
        if not self._prefetch:  # no thread: the caller's (a DevicePrefetcher's worker) assembles
            return make_batch(self._ex, self._next_indices())
        if self._queue is None:
            self._start_prefetch()
        return self._queue.get()

    def _start_prefetch(self) -> None:
        self._queue = queue.Queue(maxsize=self._prefetch)

        def worker() -> None:
            while not self._stop.is_set():
                batch = make_batch(self._ex, self._next_indices())
                while not self._stop.is_set():
                    try:
                        self._queue.put(batch, timeout=0.2)
                        break
                    except queue.Full:
                        continue

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._stop.set()

    def batches_per_epoch(self) -> int:
        n_shard = len(range(self._host, len(self._ex), self._nhosts))
        return max(1, n_shard // self._bs)

    def seek(self, global_batches: int) -> None:
        """Position the loader as if ``global_batches`` had been consumed —
        the deterministic equivalent of replaying from step 0, used when
        resuming from a checkpointed step count."""
        n = self.batches_per_epoch()
        self._epoch = global_batches // n
        self._pos = global_batches % n
        self._perm = None

    # ------------------------------------------------------------ checkpoint
    def state(self) -> dict:
        # NOTE: prefetched-but-unconsumed batches are replayed after restore;
        # that is the standard at-least-once semantic for loader checkpoints.
        return {"epoch": self._epoch, "pos": self._pos, "seed": self._seed}

    def state_at(self, global_batches: int) -> dict:
        """Exact loader state at the position where ``global_batches`` have
        been CONSUMED by training. ``state()`` reads the prefetch position,
        which runs ahead of the train step; checkpoints must record the
        consumed position so a resumed run replays no batch and skips none."""
        n = self.batches_per_epoch()
        return {"epoch": global_batches // n, "pos": global_batches % n, "seed": self._seed}

    def restore(self, state: dict) -> None:
        self._epoch = int(state["epoch"])
        self._pos = int(state["pos"])
        self._seed = int(state["seed"])
        self._perm = None


class GrainTrainLoader:
    """Grain-backed infinite shuffled loader (SURVEY.md §2.3 "grain
    sharded/prefetched sequence loader") — same interface as ``TrainLoader``.

    The pipeline is ``MapDataset.range(N) → per-host slice → per-epoch
    shuffle → repeat → batch(drop_remainder) → vectorized make_batch``,
    executed by grain worker threads with a prefetch buffer (batch assembly
    overlaps device compute). Because batching happens after ``repeat``,
    batches are always full even when a host's shard is smaller than the
    batch (epochs concatenate), and the grain iterator's ``get_state`` /
    ``set_state`` gives exact-batch-granular checkpoint/resume.
    """

    def __init__(
        self,
        examples: Examples,
        batch_size: int,
        seed: int = 0,
        host_id: int = 0,
        num_hosts: int = 1,
        prefetch: int = 2,
        num_threads: int = 2,
    ):
        if len(examples) == 0:
            raise ValueError("empty example set")
        import grain.python as grain

        self._ex = examples
        self._bs = batch_size
        self._host = host_id
        self._nhosts = num_hosts
        ds = (
            grain.MapDataset.range(len(examples))
            .slice(slice(host_id, None, num_hosts))
            .shuffle(seed=seed)
            .repeat()
            .batch(batch_size, drop_remainder=True)
            .map(lambda idx: make_batch(examples, np.asarray(idx)))
        )
        self._it = iter(
            ds.to_iter_dataset(
                grain.ReadOptions(num_threads=num_threads, prefetch_buffer_size=max(prefetch, 1))
            )
        )

    def __iter__(self) -> Iterator[Batch]:
        return self

    def __next__(self) -> Batch:
        return next(self._it)

    def close(self) -> None:
        pass  # grain worker threads are daemonized and GC'd with the iterator

    def batches_per_epoch(self) -> int:
        n_shard = len(range(self._host, len(self._ex), self._nhosts))
        return max(1, n_shard // self._bs)

    def seek(self, global_batches: int) -> None:
        # One element of the post-batch dataset == one batch, so the iterator
        # state is just the global batch count: resume is exact, not replayed.
        self._it.set_state({"next_index": int(global_batches)})

    def state(self) -> dict:
        return dict(self._it.get_state())

    def state_at(self, global_batches: int) -> dict:
        """Exact state at the consumed position (see TrainLoader.state_at):
        one post-batch dataset element == one batch, so it is the count."""
        return {"next_index": int(global_batches)}

    def restore(self, state: dict) -> None:
        self._it.set_state({"next_index": int(state["next_index"])})


def make_train_loader(
    examples: Examples,
    batch_size: int,
    seed: int = 0,
    host_id: int = 0,
    num_hosts: int = 1,
    backend: str = "threaded",
    prefetch: int = 2,
):
    """Loader factory: ``threaded`` (in-repo prefetch thread; none at
    ``prefetch=0``, where the caller's thread assembles each batch) or
    ``grain``."""
    cls = {"threaded": TrainLoader, "grain": GrainTrainLoader}.get(backend)
    if cls is None:
        raise ValueError(f"unknown loader backend {backend!r} (threaded|grain)")
    return cls(examples, batch_size, seed=seed, host_id=host_id, num_hosts=num_hosts, prefetch=prefetch)


def eval_batches(examples: Examples, batch_size: int) -> Iterator[tuple[Batch, np.ndarray, int]]:
    """Fixed-order eval iterator.

    Yields (batch, targets, n_valid). The final partial batch is padded by
    repeating row 0 (static shapes under jit); ``n_valid`` says how many rows
    count toward metrics.
    """
    n = len(examples)
    for s in range(0, n, batch_size):
        idx = np.arange(s, min(s + batch_size, n))
        n_valid = len(idx)
        if n_valid < batch_size:
            idx = np.concatenate([idx, np.zeros(batch_size - n_valid, np.int64)])
        yield make_batch(examples, idx), examples.target[idx], n_valid


class DevicePrefetcher:
    """Background device-feed: a worker thread pulls host batches and ships
    them to the device ahead of the training loop, so host batch assembly AND
    host→device transfer overlap device compute (SURVEY.md §3.2a "host CPU;
    prefetch → device"). ``produce()`` must return a device-ready element
    (``Trainer.put_chunk``: a copy queued on a side stream, which the
    consumer waits for); ``depth`` bounds how many in-flight elements
    buffer device memory. An exception in the worker is
    raised by the consumer's next ``next()``; ``close()`` joins the
    worker."""

    def __init__(self, produce, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._exc: BaseException | None = None

        def worker():
            try:
                while not self._stop.is_set():
                    item = produce()
                    while not self._stop.is_set():
                        try:
                            self._q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
            except BaseException as e:  # surfaced on the consumer side
                self._exc = e

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            if self._exc is not None:
                raise self._exc
            try:
                return self._q.get(timeout=0.1)
            except queue.Empty:
                continue

    def close(self) -> None:
        self._stop.set()
        # Drain so the worker's pending put() unblocks, then join: the
        # worker checks the flag between puts, so it ends once its current
        # produce() returns.
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join()
