"""The (data, model) mesh on ``torch.distributed``, counterpart of
``poi_tpu/parallel/mesh.py``.

One process a rank, one device a rank. The ranks form a ``data x model``
grid with the model axis minor (rank = data_index * model + model_index),
as ``make_mesh`` lays devices out: the ``data`` axis splits the batch, and
its gradients are summed over it; the ``model`` axis row-shards the catalog
tables, and the lookups and losses exchange over it. A ``Mesh`` holds one
process group per axis (the ranks that share this rank's other index),
made with ``dist.new_group``, which every rank calls in the same order.

A ``Mesh`` built with an explicit ``world_size`` and no process group holds
the shape alone: a model builds on it (one rank's shard of the tables) and
any collective on it raises. A 1 x 1 mesh needs no process group at all.
"""

from __future__ import annotations

import datetime
import logging
import os

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

DATA_AXIS = "data"
MODEL_AXIS = "model"
# How long a collective or the rendezvous waits for a lost rank before it raises.
TIMEOUT = datetime.timedelta(seconds=600)


def launched() -> bool:
    """Whether a launcher (``torch.distributed.run`` or the rig of
    ``parallel.launch``) started this process as one rank of several."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init_distributed(backend: str, timeout: datetime.timedelta = TIMEOUT) -> bool:
    """Join the process group from the launcher's variables (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, as ``torchrun`` sets
    them); a no-op without them, and when the group exists. ``backend`` is
    the caller's: ``nccl`` for a card a rank, ``gloo`` for the CPU or for
    ranks that share a card. Returns whether a process group is up."""
    if dist.is_initialized():
        return True
    if not launched():
        return False
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world, timeout=timeout)
    log.info("torch.distributed initialized: rank %d/%d, backend %s", rank, world, backend)
    return True


def rank_device(device) -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK % device_count}`` for a CUDA
    device without an index when a launcher started the process, else
    ``device`` as given (the CPU when the caller asks for it)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and launched():
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")) % torch.cuda.device_count())
    return device


def join_launch(device) -> torch.device:
    """An entry point's device: under a launcher, this rank joins the
    process group (``nccl`` for a card, ``gloo`` for the CPU; a group made
    first is kept, as gloo ranks sharing a card make one) and takes its
    ``rank_device``; without one, ``device`` as given."""
    device = torch.device(device)
    if not launched():
        return device
    init_distributed("nccl" if device.type == "cuda" else "gloo")
    return rank_device(device)


def mesh_shape(data: int, model: int, n: int) -> tuple[int, int]:
    """``(data, model)`` for ``n`` ranks, with ``make_mesh``'s errors;
    ``data=-1`` takes the rest of the ranks."""
    if model <= 0:
        raise ValueError("model axis size must be >= 1")
    if data == -1:
        if n % model != 0:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    return data, model


class Mesh:
    """The ``(data, model)`` grid and this rank's place in it.

    Without ``world_size`` the ranks are the process group's (1 without
    one), and a mesh of more than one rank makes its axis groups. With
    ``world_size`` (and ``rank``) it holds the shape alone, as for a model
    built on the meta device for one rank of a larger mesh."""

    def __init__(self, data: int = -1, model: int = 1, *, world_size: int | None = None, rank: int = 0):
        grouped = world_size is None and dist.is_initialized()
        if grouped:
            world_size, rank = dist.get_world_size(), dist.get_rank()
        world_size = 1 if world_size is None else world_size
        data, model = mesh_shape(data, model, world_size)
        self.shape = {DATA_AXIS: data, MODEL_AXIS: model}
        self.size = world_size
        self.rank = rank
        self.index = {DATA_AXIS: rank // model, MODEL_AXIS: rank % model}
        self.groups: dict[str, dist.ProcessGroup | None] = {DATA_AXIS: None, MODEL_AXIS: None}
        # Every rank makes every group of an axis longer than 1, in one
        # order (new_group is collective); an axis of 1 needs none.
        for i in range(data if grouped and model > 1 else 0):
            g = dist.new_group([i * model + j for j in range(model)])
            if i == self.index[DATA_AXIS]:
                self.groups[MODEL_AXIS] = g
        for j in range(model if grouped and data > 1 else 0):
            g = dist.new_group([i * model + j for i in range(data)])
            if j == self.index[MODEL_AXIS]:
                self.groups[DATA_AXIS] = g

    def __repr__(self) -> str:
        return f"Mesh(data={self.shape[DATA_AXIS]}, model={self.shape[MODEL_AXIS]}, rank={self.rank})"

    def group(self, axis: str) -> dist.ProcessGroup:
        """The process group of ``axis`` that holds this rank."""
        g = self.groups[axis]
        if g is None:
            raise RuntimeError(f"{self!r} has no process group for axis {axis!r}: it holds the mesh's shape only")
        return g

    def rows(self, n: int, axis: str = MODEL_AXIS) -> slice:
        """This rank's contiguous block of ``n`` rows split over ``axis``."""
        size = self.shape[axis]
        if n % size:
            raise ValueError(f"{n} rows do not split over {axis}={size}")
        per = n // size
        return slice(self.index[axis] * per, (self.index[axis] + 1) * per)


def local_data_batch(global_batch: int, mesh: Mesh) -> int:
    """This rank's share of the global batch: its data shard's rows."""
    data = mesh.shape[DATA_AXIS]
    if global_batch % data:
        raise ValueError(f"batch {global_batch} does not split over data={data}")
    return global_batch // data
