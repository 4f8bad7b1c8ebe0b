"""Carry parameters between ``poi_tpu``'s param tree and the port's modules.

A ``poi_tpu`` param tree is nested dicts and lists of arrays
(``{"embed": {"poi": …}, "tower": {"layers": [{"wx": …}, …]}}``). Its flat
form joins the path with ``/`` (``tower/layers/0/wx``), which is also the key
layout of the ``.npz`` files that ``save_npz`` writes and the CLI's
``--params`` reads. The port's ``state_dict`` uses the same path joined with
``.``, so a tree loads with ``model.load_state_dict(params_from_jax(tree))``.
"""

from __future__ import annotations

import numpy as np
import torch


def flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dicts/lists → {"a/b/0/c": array}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out: dict[str, np.ndarray] = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def unflatten(flat: dict[str, np.ndarray]):
    """Inverse of ``flatten``: a level whose keys are all 0..n-1 is a list."""
    root: dict = {}
    for key, v in flat.items():
        node = root
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and sorted(node) == sorted(map(str, range(len(node)))):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    """A ``poi_tpu`` param tree (arrays as numpy, or anything ``np.asarray``
    takes) → the port's ``state_dict``, fp32 tensors on the CPU."""
    return {
        k.replace("/", "."): torch.from_numpy(np.array(v, dtype=np.float32))
        for k, v in flatten(tree).items()
    }


def params_to_numpy(model: torch.nn.Module):
    """The port's parameters → a ``poi_tpu``-layout tree of numpy arrays,
    copies (on the CPU ``.numpy()`` would alias the live parameters)."""
    flat = {k.replace(".", "/"): np.array(v.detach().cpu()) for k, v in model.state_dict().items()}
    return unflatten(flat)


def _find_adam_state(node):
    """The node of an optax state tree that holds Adam's (count, mu, nu)."""
    if all(hasattr(node, f) for f in ("count", "mu", "nu")):
        return node
    if isinstance(node, (list, tuple)):
        for child in node:
            found = _find_adam_state(child)
            if found is not None:
                return found
    return None


def adam_state_from_jax(opt_state, device="cpu") -> dict:
    """Adam's moments and count from a ``poi_tpu`` optax state → the port's
    optimizer state (``train.state.Optimizer``)."""
    node = _find_adam_state(opt_state)
    if node is None:
        raise ValueError("no Adam state (count, mu, nu) in this optimizer state")
    return {
        "count": int(np.asarray(node.count)),
        "mu": {k: v.to(device) for k, v in params_from_jax(node.mu).items()},
        "nu": {k: v.to(device) for k, v in params_from_jax(node.nu).items()},
    }


def adam_state_to_numpy(opt_state: dict) -> dict:
    """The port's Adam state → ``{"count", "mu", "nu"}`` with the moments as
    ``poi_tpu``-layout trees of numpy arrays."""

    def tree(d):
        return unflatten({k.replace(".", "/"): v.detach().cpu().numpy() for k, v in d.items()})

    return {"count": int(opt_state["count"]), "mu": tree(opt_state["mu"]), "nu": tree(opt_state["nu"])}


def sparse_adam_state_from_jax(opt_state, device="cpu") -> dict:
    """``poi_tpu``'s lazy-Adam ``SparseAdamState(count, m, v)`` → the port's
    ``train.sparse_opt.SparseTableOptimizer`` state."""
    if not all(hasattr(opt_state, f) for f in ("count", "m", "v")):
        raise ValueError("not a SparseAdamState (count, m, v)")
    return {
        "count": int(np.asarray(opt_state.count)),
        "m": {k: v.to(device) for k, v in params_from_jax(opt_state.m).items()},
        "v": {k: v.to(device) for k, v in params_from_jax(opt_state.v).items()},
    }


def sparse_adam_state_to_numpy(opt_state: dict) -> dict:
    """The port's lazy-Adam state → ``{"count", "m", "v"}`` with the
    moments as ``poi_tpu``-layout trees of numpy arrays, the fields of
    ``SparseAdamState``."""
    tree = adam_state_to_numpy({"count": opt_state["count"], "mu": opt_state["m"], "nu": opt_state["v"]})
    return {"count": tree["count"], "m": tree["mu"], "v": tree["nu"]}


def save_npz(path, tree) -> None:
    np.savez(path, **flatten(tree))


def load_npz(path):
    with np.load(path) as f:
        return unflatten({k: f[k] for k in f.files})
