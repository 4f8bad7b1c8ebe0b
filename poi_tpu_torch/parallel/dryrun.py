"""The multi-rank dry run, counterpart of ``__graft_entry__.dryrun_multichip``:
the distributed matrix on tiny shapes, on ``n`` gloo ranks of this
machine's CPU (``parallel.launch.spawn``).

    python -m poi_tpu_torch.parallel.dryrun --ranks 4

On the meshes ``n/2 x 2`` (and ``2 x n/2`` from 8 ranks; ``n x 1`` for an
odd ``n``) it runs the reference's four combinations of attention impl,
lookup, loss and table update: (ring, a2a, CE, dense), (Ulysses, psum,
sampled softmax, sparse), (ring, psum, BPR, sparse), (Ulysses, a2a, CE,
dense), at the reference's settings (a2a capacity factor 8, the kernel
path's top-k, 64 sampled negatives, 2 BPR negatives). Each takes one train
step with a finite loss and then the vocab-sharded eval sweep. Then the
first one's state goes through a checkpoint and comes back the same bits,
and ``Recommender(mesh=...)`` answers a request with the ids of the
one-process ``Recommender`` on the same params. Rank 0 prints a line a
check; any failure fails its rank and the run.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from poi_tpu_torch.parallel.launch import spawn
from poi_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, init_distributed

# (attention impl, lookup, loss, table update); the first two run on the
# first mesh shape, the last two on the last (__graft_entry__.py:103-113).
COMBOS = (("ring", "a2a", "ce", "dense"), ("ulysses", "psum", "sampled_softmax", "sparse"),
          ("ring", "psum", "bpr", "sparse"), ("ulysses", "a2a", "ce", "dense"))


def mesh_shapes(n: int) -> list[tuple[int, int]]:
    """The reference's meshes of ``n`` ranks, ``(data, model)``."""
    if n % 2:
        return [(n, 1)]
    return [(n // 2, 2), (2, n // 2)] if n >= 8 else [(n // 2, 2)]


def tiny_setup(batch: int, num_pois: int = 512, num_users: int = 64):
    """The reference's tiny attention config, its synthetic corpus and its
    first batch (``__graft_entry__._tiny_setup``)."""
    from poi_tpu_torch.configs.presets import get_config
    from poi_tpu_torch.data.checkins import synthesize_checkins
    from poi_tpu_torch.data.dataset import build_dataset
    from poi_tpu_torch.data.pipeline import TrainLoader

    cfg = get_config("smoke").with_overrides({
        "model.kind": "attention", "model.embed_dim": "32", "model.hidden_dim": "32", "model.attn_heads": "4",
        "model.attn_window": "6", "train.batch_size": str(batch)})
    ds = build_dataset(synthesize_checkins(num_users, num_pois, 30, seed=0), cfg.data)
    loader = TrainLoader(ds.train, batch_size=batch, seed=0)
    first = next(loader)
    loader.close()
    return cfg, ds, first


def _say(msg: str) -> None:
    if dist.get_rank() == 0:
        print(f"dryrun_multichip({dist.get_world_size()}): {msg}", flush=True)


def _all(ok: bool) -> bool:
    """Whether ``ok`` holds on every rank."""
    t = torch.tensor([0.0 if ok else 1.0])
    dist.all_reduce(t)
    return float(t) == 0.0


def rank_main(work: str) -> None:
    """One rank of the dry run (``spawn`` starts ``n`` of them)."""
    from poi_tpu_torch.cli import model_with_params
    from poi_tpu_torch.data.pipeline import Batch
    from poi_tpu_torch.eval.evaluate import evaluate
    from poi_tpu_torch.eval.serve import Checkin, Recommender
    from poi_tpu_torch.models.base import DataDims, batch_to
    from poi_tpu_torch.parallel.shardings import unshard_state
    from poi_tpu_torch.train.loop import Trainer
    from poi_tpu_torch.utils.checkpoint import CheckpointManager

    torch.set_num_threads(1)
    init_distributed("gloo")
    n = dist.get_world_size()
    shapes = mesh_shapes(n)
    first = None
    for i, (attn, emb, loss_kind, update) in enumerate(COMBOS):
        d, m = shapes[0] if i < 2 else shapes[-1]
        mesh = Mesh(d, m)
        cfg, ds, batch = tiny_setup(max(16, 2 * d))
        cfg = cfg.with_overrides({
            "mesh.data": str(d), "mesh.model": str(m), "mesh.embedding_mode": emb, "mesh.a2a_capacity_factor": "8.0",
            "model.attn_impl": attn if m > 1 else "blockwise", "eval.topk_impl": "pallas",
            "eval.batch_size": str(max(16, 2 * d)), "loss.kind": loss_kind, "loss.num_sampled": "64",
            "loss.num_negatives": "2", "train.table_update": update})
        trainer = Trainer(cfg, DataDims.from_dataset(ds), device="cpu", mesh=mesh)
        assert (trainer.model.tower.sp_mha is not None) == (m > 1), "SP attention not injected"
        state = trainer.init_state()
        rows = mesh.rows(batch.poi_tgt.shape[0], DATA_AXIS)
        state, metrics = trainer.step(state, batch_to(Batch(*(a[rows] for a in batch)), "cpu"))
        loss = float(metrics["loss"])
        assert math.isfinite(loss), f"non-finite loss {loss} ({attn}/{emb}/{loss_kind})"
        _say(f"mesh={d}x{m} attn={attn} emb={emb} loss_kind={loss_kind} table={update} loss={loss:.4f} OK")
        em = evaluate(trainer.model, ds, cfg, mesh=mesh)
        assert math.isfinite(em["recall@10"]), em
        _say(f"mesh={d}x{m} sharded eval sweep recall@10={em['recall@10']:.4f} OK")
        if first is None:
            first = (trainer, state, cfg, ds)

    # Checkpoint round trip of the first combination's sharded state.
    trainer, state, cfg, ds = first
    mesh = trainer.mesh
    directory = os.path.join(work, "ckpt")
    CheckpointManager(directory, mesh=mesh, num_pois=trainer.dims.num_pois).save(state.step, state)
    again = Trainer(cfg, trainer.dims, device="cpu", mesh=mesh)
    restored, _ = CheckpointManager(directory, mesh=mesh, num_pois=trainer.dims.num_pois).restore(again)
    same = restored.step == state.step and all(torch.equal(restored.params[k], p) for k, p in state.params.items())
    same = same and all(torch.equal(restored.opt_state[w][k], t) for w, v in state.opt_state.items() if w != "count"
                        for k, t in v.items())
    assert _all(same), "the restored state differs"
    _say(f"mesh={mesh.shape[DATA_AXIS]}x{mesh.shape[MODEL_AXIS]} sharded save/restore round-trip OK")

    # Serving on the mesh against one process on the same params.
    ex = ds.test
    histories = [[Checkin(poi=int(p), timestamp=float(tb) * 3600.0 + 1800.0)
                  for p, tb in zip(ex.poi_in[i, :int(ex.mask[i].sum())], ex.time_bucket[i, :int(ex.mask[i].sum())])]
                 for i in range(3)]
    rank0 = dist.get_rank() == 0
    got = Recommender(trainer.model, cfg, ds, mesh=mesh).recommend(histories if rank0 else None, k=10)
    whole = unshard_state({k: p.detach() for k, p in trainer.model.named_parameters()}, mesh, trainer.sharded)
    if rank0:
        one = Recommender(model_with_params(cfg, ds, whole, torch.device("cpu")), cfg, ds)
        want = one.recommend(histories, k=10)
        assert np.array_equal(got, want), (got, want)
        _say(f"Recommender on the mesh answers {len(histories)} histories with the one-process ids OK")
    dist.barrier()
    dist.destroy_process_group()


def dryrun_multichip(n_ranks: int, timeout: float = 600.0) -> None:
    """Run the matrix on ``n_ranks`` gloo ranks of the CPU; prints rank 0's
    lines and raises ``RuntimeError`` (with the failed ranks' log tails)
    when a rank fails."""
    with tempfile.TemporaryDirectory(prefix="dryrun_") as work:
        try:
            spawn("poi_tpu_torch.parallel.dryrun:rank_main", n_ranks, {"work": work}, timeout=timeout, log_dir=work,
                  cwd=str(Path(__file__).resolve().parents[2]),  # where poi_tpu_torch imports from
                  env={"OMP_NUM_THREADS": "1", "POI_TPU_TORCH_DATA_CACHE": "off"})
        finally:
            with open(os.path.join(work, "rank0.log"), errors="replace") as f:
                print("".join(ln for ln in f if ln.startswith("dryrun_multichip")), end="", flush=True)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m poi_tpu_torch.parallel.dryrun")
    parser.add_argument("--ranks", type=int, default=4, help="gloo ranks on this machine's CPU (default: 4)")
    parser.add_argument("--timeout", type=float, default=600.0, help="seconds before the ranks are ended")
    args = parser.parse_args(argv)
    dryrun_multichip(args.ranks, args.timeout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
