"""Checkpoint and resume of the full train state, counterpart of
``poi_tpu/utils/checkpoint.py``.

A step is one file, ``<directory>/step_<N>.pt``, written by ``torch.save``:
the model's parameters, the optimizer state (dense Adam's ``mu``/``nu``,
adagrad's ``sum_of_squares`` or lazy Adam's ``m``/``v``, with ``count``),
the step, the host loader's position and the config as JSON. Every tensor
is copied to the host first, so a checkpoint written on the card restores
on a CPU-only machine and the reverse, and the file loads under
``torch.load(weights_only=True)``. The train step's random draws are keyed
by (seed, step, stream), so no generator state is saved: a resumed run
draws what the uninterrupted run drew.

A step is written under a temporary name and moved into place with
``os.replace``, so a crash mid-write never leaves a truncated latest step;
the oldest steps beyond ``max_to_keep`` go only after the new one is in
place. The best-on-val params live apart, in ``<directory>/selected/``
(one step, with the selection's metric and score), so the step sequence
always ends at the true end-of-run state.

``poi_tpu``'s orbax steps are step-numbered subdirectories; a directory
that holds them is refused, never read as empty.

On a mesh (``CheckpointManager(mesh=..., num_pois=...)``, every rank makes
one and calls it alike) the file is still one file of the whole state:
``save`` gathers the vocab-sharded tables and their moments over ``model``,
cuts the catalog tables to ``num_pois`` rows (the padding of that mesh's
vocab), and rank 0 writes; ``restore`` pads them to this mesh's padded
catalog (zero rows, a -1e30 bias) and keeps this rank's rows. So a step
written on one mesh restores on any other, and on one device.
"""

from __future__ import annotations

import json
import logging
import os
import re
from concurrent.futures import Future, ThreadPoolExecutor

import torch
import torch.distributed as dist

from poi_tpu_torch.parallel.mesh import MODEL_AXIS
from poi_tpu_torch.parallel.shardings import CATALOG_TABLES, map_state, shard_state, unshard_state
from poi_tpu_torch.train.state import TrainState

log = logging.getLogger(__name__)

EXPORT_SCRIPT = "scripts/export_params_npz.py"
SELECTED = "selected"
_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")
_ORBAX_STEP = re.compile(r"^\d+($|\.orbax-checkpoint-tmp)")


def _to_host(tree):
    """A copy of ``tree`` (nested dicts of tensors and plain values) with
    every tensor on the host. ``copy=True``: a CPU tensor must not alias the
    live parameter that the next step updates in place."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    return tree


def _copy_into(dst: dict, src: dict, what: str) -> None:
    """Copy the saved tensors ``src`` into the live tensors ``dst`` in place,
    keys and shapes checked (``copy_`` would broadcast a wrong shape)."""
    if dst.keys() != src.keys():
        raise KeyError(f"{what}: the checkpoint holds {sorted(src)}, the run {sorted(dst)}")
    for k, t in dst.items():
        s = src[k]
        if isinstance(t, dict):
            _copy_into(t, s, f"{what}.{k}")
        elif tuple(t.shape) != tuple(s.shape):
            raise ValueError(f"{what}.{k}: checkpoint shape {tuple(s.shape)} != run shape {tuple(t.shape)}")
        else:
            t.copy_(s)


def tensor_bytes(state: TrainState) -> int:
    """The bytes of the tensors a step file of ``state`` holds (its
    parameters and optimizer state): the file's size but for ``torch.save``'s
    zip and pickle framing, some kilobytes. Config #5's is ~6.2 GB."""

    def size(tree) -> int:
        if isinstance(tree, dict):
            return sum(size(v) for v in tree.values())
        return tree.numel() * tree.element_size() if torch.is_tensor(tree) else 0

    return size(state.params) + size(state.opt_state)


def _write(path: str, payload: dict) -> None:
    tmp = os.path.join(os.path.dirname(path), f".{os.path.basename(path)}.tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_STEP_FILE.match, os.listdir(directory)) if m)


def _refuse_orbax(directory: str) -> None:
    for d in (directory, os.path.join(directory, SELECTED)):
        if os.path.isdir(d) and any(_ORBAX_STEP.match(n) and os.path.isdir(os.path.join(d, n))
                                    for n in os.listdir(d)):
            raise ValueError(
                f"{d} holds poi_tpu (orbax) checkpoint steps, which poi_tpu_torch does not read: export their "
                f"params with `python {EXPORT_SCRIPT} --config C --checkpoint-dir {directory} --out P.npz` and "
                "pass --params P.npz, or give poi_tpu_torch a directory of its own"
            )


def _catalog_rows(tree, n: int, pad_bias: bool = False):
    """``tree``'s catalog tables at ``n`` rows: cut, or padded with zero
    rows (``-1e30`` for the output bias where ``pad_bias``)."""

    def fit(name, x):
        if name not in CATALOG_TABLES or x.shape[0] == n:
            return x
        if x.shape[0] > n:
            return x[:n]
        fill = -1e30 if pad_bias and name == "embed.out_bias" else 0.0
        return torch.cat([x, x.new_full((n - x.shape[0],) + tuple(x.shape[1:]), fill)])

    return map_state(tree, fit)


def local_part(tree, mesh, rows: int, pad_bias: bool):
    """This rank's part of a saved full ``tree`` (a step's, or a ``.npz``'s
    params): its catalog tables padded to ``mesh``'s padded catalog
    (``rows``, the live POI table's, on every model rank) and cut to this
    rank's rows. ``mesh`` None: one device."""
    sharded = mesh is not None and mesh.shape[MODEL_AXIS] > 1
    vp = rows * (mesh.shape[MODEL_AXIS] if sharded else 1)
    tree = _catalog_rows(tree, vp, pad_bias)
    return shard_state(tree, mesh, vp) if sharded else tree


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int | None = 3, async_save: bool = False, mesh=None,
                 num_pois: int | None = None):
        self.directory = os.path.abspath(directory)
        _refuse_orbax(self.directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        # Several ranks: one file, rank 0 writes it; the write is not
        # deferred, so every rank sees it when save returns.
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.num_pois = num_pois
        self.async_save = async_save and self.mesh is None
        self._pool: ThreadPoolExecutor | None = None
        self._pending: list[Future] = []

    def _path(self, step: int, sub: str = "") -> str:
        return os.path.join(self.directory, sub, f"step_{step}.pt")

    def _submit(self, fn, *args) -> None:
        """Run ``fn`` here, or on the writer thread when saving asynchronously."""
        if not self.async_save:
            fn(*args)
            return
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt-writer")
        self._pending.append(self._pool.submit(fn, *args))


    # ------------------------------------------------------------------ save
    def save(self, step: int, state: TrainState, loader_state: dict | None = None,
             config_json: str | None = None) -> None:
        """Persist ``state`` as step ``step``. The host copy is made here, on
        the caller's thread, so the train step may update the parameters in
        place as soon as this returns; with ``async_save`` the file is written
        on a worker thread that ``wait()`` joins."""
        payload = {"step": int(step), "params": self._whole(state.params),
                   "opt_state": self._whole(state.opt_state), "loader": loader_state, "config": config_json}
        self._submit_once(self._write_step, step, payload)

    def _whole(self, tree):
        """A host copy of ``tree`` with the sharded tables put back together
        (every model rank calls this) and cut to the catalog."""
        if self.mesh is None or self.mesh.shape[MODEL_AXIS] == 1:
            return _to_host(tree)
        whole = unshard_state(tree, self.mesh, set(CATALOG_TABLES))
        return _catalog_rows(_to_host(whole), self.num_pois)

    def local_part(self, tree, rows: int, pad_bias: bool):
        """``local_part`` on this manager's mesh."""
        return local_part(tree, self.mesh, rows, pad_bias)

    def _submit_once(self, fn, *args) -> None:
        """``fn`` on rank 0 only, then every rank waits for it."""
        if self.mesh is None:
            self._submit(fn, *args)
            return
        if self.mesh.rank == 0:
            fn(*args)
        dist.barrier()

    def _write_step(self, step: int, payload: dict) -> None:
        _write(self._path(step), payload)
        if self.max_to_keep and self.max_to_keep > 0:  # None (orbax's default) keeps every step
            steps = _steps(self.directory)
            for s in steps[: max(0, len(steps) - self.max_to_keep)]:
                os.remove(self._path(s))

    def wait(self) -> None:
        """Block until every asynchronous write is on disk; re-raises a
        writer's error."""
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()

    def delete(self, step: int) -> None:
        """Remove one step."""
        self.wait()
        os.remove(self._path(step))

    def close(self) -> None:
        try:
            self.wait()
        finally:
            if self._pool is not None:
                self._pool.shutdown()
                self._pool = None

    # --------------------------------------------------------------- restore
    def latest_step(self) -> int | None:
        self.wait()
        steps = _steps(self.directory)
        return steps[-1] if steps else None

    def load(self, step: int | None = None) -> dict:
        """Step ``step``'s (default: the latest's) file as saved, its tensors
        on the host: ``{"step", "params", "opt_state", "loader", "config"}``."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        path = self._path(step)
        if not os.path.exists(path):
            raise FileNotFoundError(f"no step {step} under {self.directory} (have {_steps(self.directory)})")
        return torch.load(path, map_location="cpu", weights_only=True, mmap=True)

    def restore(self, trainer_or_state, step: int | None = None) -> tuple[TrainState, dict]:
        """Restore step ``step`` (default: the latest) into a trainer's fresh
        state, or into the given ``TrainState``, in place: the parameters are
        the model's own ``nn.Parameter`` objects and keep their identity, the
        optimizer's tensors are filled where they live. Returns the state at
        the saved step and the saved loader state ({} if none)."""
        state = trainer_or_state.init_state() if hasattr(trainer_or_state, "init_state") else trainer_or_state
        saved = self.load(step)
        tensors = {k: v for k, v in state.opt_state.items() if k != "count"}
        rows = state.params["embed.poi"].shape[0]
        with torch.no_grad():
            _copy_into(state.params, self.local_part(saved["params"], rows, True), "params")
            _copy_into(tensors, self.local_part({k: v for k, v in saved["opt_state"].items() if k != "count"}, rows,
                                                False), "opt_state")
        # The lr schedule and Adam's bias correction read the count.
        state.opt_state["count"] = int(saved["opt_state"]["count"])
        return TrainState(int(saved["step"]), state.params, state.opt_state), (saved["loader"] or {})

    def saved_config(self, step: int | None = None) -> str | None:
        """The config JSON saved with a step (None if there is no step)."""
        try:
            return self.load(step)["config"]
        except FileNotFoundError:
            return None

    # ------------------------------------------------- selected (best-on-val)
    def save_selected(self, step: int, params: dict, metric: str | None = None, score: float | None = None) -> None:
        """Persist the best-on-val params under the step they were trained
        to, with the selection's metric and score, so a resumed run can seed
        its tracker and never replace a better earlier selection."""
        payload = {"step": int(step), "params": self._whole(params), "metric": metric,
                   "score": None if score is None else float(score)}
        self._submit_once(self._write_selected, step, payload)

    def _write_selected(self, step: int, payload: dict) -> None:
        os.makedirs(os.path.join(self.directory, SELECTED), exist_ok=True)
        _write(self._path(step, SELECTED), payload)
        for s in _steps(os.path.join(self.directory, SELECTED)):  # one selection: the one just written
            if s != step:
                os.remove(self._path(s, SELECTED))

    def selected_step(self) -> int | None:
        self.wait()
        steps = _steps(os.path.join(self.directory, SELECTED))
        return steps[-1] if steps else None

    def _load_selected(self) -> dict:
        step = self.selected_step()
        if step is None:
            raise FileNotFoundError(f"no selected checkpoint under {self.directory}")
        return torch.load(self._path(step, SELECTED), map_location="cpu", weights_only=True, mmap=True)

    def selected_info(self) -> dict | None:
        """{'step', 'metric', 'score'} of the persisted selection, or None."""
        if self.selected_step() is None:
            return None
        saved = self._load_selected()
        return {k: saved[k] for k in ("step", "metric", "score")}

    def restore_selected(self, like: dict[str, torch.Tensor] | None = None) -> dict[str, torch.Tensor]:
        """The selected params, on the host, by ``state_dict`` name; given
        the live params ``like``, this rank's part of them at its shapes."""
        params = self._load_selected()["params"]
        return params if like is None else self.local_part(params, like["embed.poi"].shape[0], True)


def warn_config_mismatch(saved_json: str | None, cfg, sections=("model", "data", "loss")) -> list[str]:
    """Compare semantics-bearing config sections against a checkpoint's saved
    config and log what differs. Same-shaped params under a different config
    (e.g. another attn_window or feature-bucketing) restore WITHOUT error and
    silently evaluate wrong — the one failure mode shape checking can't catch.
    ``train`` is not compared: a resume with a larger ``train.num_steps`` is
    how a run is extended. Returns the list of differing dotted keys."""
    if not saved_json:
        return []
    try:
        saved = json.loads(saved_json)
    except (TypeError, ValueError):
        return []
    live = json.loads(cfg.to_json())
    diffs = []
    for sec in sections:
        a, b = saved.get(sec, {}), live.get(sec, {})
        for k in sorted(set(a) | set(b)):
            if a.get(k) != b.get(k):
                diffs.append(f"{sec}.{k}: checkpoint={a.get(k)!r} vs run={b.get(k)!r}")
    if diffs:
        log.warning(
            "config differs from the one this checkpoint was trained with "
            "(same-shaped params restore silently; results may be wrong):\n  %s",
            "\n  ".join(diffs),
        )
    return diffs
