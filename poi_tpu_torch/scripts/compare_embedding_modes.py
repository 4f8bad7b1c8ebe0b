"""psum against a2a vocab-sharded lookups: the collective bytes each moves,
the counterpart of ``scripts/compare_embedding_modes.py``.

    python -m poi_tpu_torch.scripts.compare_embedding_modes [--ranks 4] [--dim 512] [--vocab 65536]
        [--batch 512] [--seqlen 64] [--capacity-factor 2.0] [--device cuda]

The reference compiles both lookups on a fake 8-device mesh and sums the
collectives' result bytes in the optimized HLO. The port counts what its
collectives move at run time instead: it starts ``--ranks`` gloo ranks on
this machine (``parallel.launch.spawn``; with ``--device cuda`` all on the
one card), and on each (data, model) mesh of them with model 2, 4 and 8 (as
far as the ranks go; data = ranks / model) runs each lookup forward and
backward of this rank's share of ``batch x seqlen`` ids under
``parallel.collectives.count_bytes``, the table's gradient summed over data
as the reference's ``jax.grad`` of a data-replicated table does. Rank 0
prints the reference's table: payload and ring-weighted wire MB a device,
and the payload by op and direction. The ids are uniform over the catalog,
as the reference's sizes are what its HLO fixes; the port's a2a moves int64
ids where the reference's moves int32.
"""

from __future__ import annotations

import argparse
import sys

import torch

from poi_tpu_torch.scripts._timing import add_device_arg, setup

MODELS = (2, 4, 8)


def rank_main(dim: int, vocab: int, batch: int, seqlen: int, capacity_factor: float, device: str) -> None:
    """One rank: every mesh shape and both lookups; rank 0 prints."""
    import torch.distributed as dist

    from poi_tpu_torch.ops.embedding import make_lookup
    from poi_tpu_torch.parallel import collectives as cc
    from poi_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, init_distributed, rank_device

    init_distributed("gloo")
    dev = rank_device(device)
    world, lead = dist.get_world_size(), dist.get_rank() == 0
    n_ids = batch * seqlen
    if lead:
        print(f"ranks={world} V={vocab} D={dim} ids={n_ids} factor={capacity_factor} "
              f"(dense vectors = {n_ids * dim * 4 / 1e6:.1f} MB fp32)", flush=True)
        print(f"{'model':>5} {'data':>4} {'mode':>6} {'payload MB/device':>18} {'wire MB/device':>15}  breakdown",
              flush=True)
    gen = torch.Generator().manual_seed(0)
    for m in (m for m in MODELS if m <= world and world % m == 0):
        mesh = Mesh(world // m, m)
        rows = -(-vocab // m)
        b_local = batch // mesh.shape[DATA_AXIS]
        ids = torch.randint(0, vocab, (b_local, seqlen), generator=gen).to(dev)
        for mode in ("psum", "a2a"):
            table = torch.randn(rows, dim, generator=gen).to(dev).requires_grad_()
            lookup = make_lookup(mesh, mode, capacity_factor)
            with cc.count_bytes() as c:
                lookup(table, ids).square().sum().backward()
                cc.all_reduce_(table.grad, mesh, DATA_AXIS, tally=("all_reduce_", "bwd"))
            if lead:
                total, wire = sum(c.payload.values()), sum(c.wire.values())
                parts = ", ".join(f"{op}/{d}={b / 1e6:.2f}MB" for (op, d), b in sorted(c.payload.items()))
                print(f"{m:>5} {mesh.shape[DATA_AXIS]:>4} {mode:>6} {total / 1e6:>18.2f} {wire / 1e6:>15.2f}  {parts}",
                      flush=True)
    dist.barrier()
    dist.destroy_process_group()


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m poi_tpu_torch.scripts.compare_embedding_modes", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ranks", type=int, default=4, help="gloo ranks on this machine (model shards up to this)")
    p.add_argument("--dim", type=int, default=512)
    p.add_argument("--vocab", type=int, default=65536, help="the reference's scaled-down 1M catalog")
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--seqlen", type=int, default=64)
    p.add_argument("--capacity-factor", type=float, default=2.0)
    add_device_arg(p)
    args = p.parse_args(argv)
    setup(args.device)
    from poi_tpu_torch.parallel.launch import spawn

    spawn("poi_tpu_torch.scripts.compare_embedding_modes:rank_main", args.ranks,
          {"dim": args.dim, "vocab": args.vocab, "batch": args.batch, "seqlen": args.seqlen,
           "capacity_factor": args.capacity_factor, "device": args.device}, timeout=900)
    return 0


if __name__ == "__main__":
    sys.exit(main())
