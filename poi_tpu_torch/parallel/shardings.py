"""Which tensors of a train state are row-sharded over ``model``, and how a
full state is cut into one rank's shard and put back together; counterpart
of ``poi_tpu/parallel/shardings.py``.

The rule is the reference's: a catalog-sized table (leading dimension
``num_pois_padded``) is row-sharded over the model axis in contiguous blocks
(rank j holds rows ``[j * Vp / M, (j + 1) * Vp / M)``). That is the POI table,
an untied output table, the output bias and their optimizer moments, which
carry the parameter's name. Everything else is replicated. Only the
catalog tables of ``params["embed"]`` are candidates, so a replicated table
of the same length (users) is never cut.

A state is nested dicts whose innermost keys are parameter names
(``embed.poi``, or ``{"mu": {"embed.poi": ...}}``); other leaves pass
through.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from poi_tpu_torch.parallel import collectives as cc
from poi_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh

CATALOG_TABLES = ("embed.poi", "embed.out", "embed.out_bias")


def is_sharded(name: str, shape, num_pois_padded: int) -> bool:
    """Whether the parameter (or moment) ``name`` of full shape ``shape`` is
    row-sharded over ``model``."""
    return name in CATALOG_TABLES and len(shape) >= 1 and shape[0] == num_pois_padded


def map_state(tree, fn: Callable, name: str | None = None):
    """``tree`` with ``fn(name, leaf)`` applied to each array leaf, ``name``
    the innermost dict key above it."""
    if isinstance(tree, dict):
        return {k: map_state(v, fn, k if isinstance(k, str) and "." in k else name) for k, v in tree.items()}
    if torch.is_tensor(tree) or isinstance(tree, np.ndarray):
        return fn(name, tree)
    return tree


def shard_state(tree, mesh: Mesh, num_pois_padded: int):
    """This rank's shard of a full state (tensors or numpy arrays): the
    sharded leaves cut to the rank's rows, the others as they are."""
    if mesh.shape[MODEL_AXIS] == 1:
        return tree

    def cut(name, x):
        return x[mesh.rows(x.shape[0])] if is_sharded(name, x.shape, num_pois_padded) else x

    return map_state(tree, cut)


def unshard_state(tree, mesh: Mesh, sharded: set[str]):
    """The full state from every model rank's shard: the leaves named in
    ``sharded`` gathered over ``model`` (every rank of the group calls
    this), the others as they are."""
    if mesh.shape[MODEL_AXIS] == 1:
        return tree

    def gather(name, x):
        return cc.all_gather(x.detach(), mesh, MODEL_AXIS) if name in sharded else x

    return map_state(tree, gather)
