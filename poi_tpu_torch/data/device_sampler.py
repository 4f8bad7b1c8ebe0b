"""Batches drawn on the device, counterpart of
``poi_tpu/data/device_sampler.py``.

The training example arrays are uploaded once; each step gathers its batch
on the device from indices drawn uniformly with replacement. The draw for
step N comes from a generator seeded with ``(seed, N)`` alone, so sampling
is stateless across resume, as in the TPU package. The draws themselves
differ from JAX's (another generator).
"""

from __future__ import annotations

import numpy as np
import torch

from poi_tpu_torch.data.dataset import Examples
from poi_tpu_torch.data.pipeline import Batch


def step_seed(seed: int, step: int, *stream: int) -> int:
    """A 63-bit generator seed that depends only on (seed, step) and, for
    the trainer's other draws, a stream number."""
    return int(np.random.SeedSequence((seed, step, *stream)).generate_state(1, np.uint64)[0] >> 1)


class DeviceSampler:
    """``rows``: keep these rows of each step's batch (one data shard's
    part of the global batch, which every data rank draws alike)."""

    def __init__(self, examples: Examples, batch_size: int, seed: int, device, rows: slice | None = None):
        if len(examples) == 0:
            raise ValueError("empty example set")
        self.batch_size = batch_size
        self.rows = rows
        self.num_examples = len(examples)
        self.seed = seed
        self.device = torch.device(device)
        self._gen = torch.Generator(device=self.device)
        self._dev = {}
        for f in Batch._fields:
            t = torch.from_numpy(np.ascontiguousarray(getattr(examples, f)))
            if t.dtype in (torch.int32, torch.int64):
                t = t.long()
            self._dev[f] = t.to(self.device)

    def sample(self, step: int) -> Batch:
        """The batch of ``step``: the same ids for the same (seed, step)."""
        self._gen.manual_seed(step_seed(self.seed, step))
        idx = torch.randint(0, self.num_examples, (self.batch_size,), generator=self._gen, device=self.device)
        if self.rows is not None:
            idx = idx[self.rows]
        b = {f: v[idx] for f, v in self._dev.items()}
        b["mask"] = b["mask"].float()
        return Batch(**b)
