"""Blockwise, ring and Ulysses attention: the collective bytes each moves,
the counterpart of ``scripts/compare_attention_modes.py``.

    python -m poi_tpu_torch.scripts.compare_attention_modes [--ranks 4] [--dim 512] [--heads 8]
        [--window 16] [--batch 512] [--seqlen 64] [--device cuda]

The reference compiles the attention block forward and backward on a fake
8-device mesh, with the resharding of the time axis that the SP modes
impose on the tower around them, and sums the collectives' result bytes in
the optimized HLO. The port counts what its collectives move at run time:
it starts ``--ranks`` gloo ranks on this machine
(``parallel.launch.spawn``; with ``--device cuda`` all on the one card),
and on each (data, model) mesh of them with model 2, 4 and 8 (as far as the
ranks go; data = ranks / model) runs the block on this rank's rows of the
batch under ``parallel.collectives.count_bytes``: the local windowed
attention (``blockwise``, replicated over model) and
``parallel.sp_attention``'s ring and Ulysses, whose time split
(``collectives.split``, its gradient gathered back) and output gather are
that resharding; the block's loss is the reference's ``sum((h + o)^2)``,
and the four projections' gradients are summed over data, as the
reference's ``jax.grad`` of replicated weights does. Rank 0 prints the
reference's table: ring-weighted wire MB a device and the payload by op
and direction.
"""

from __future__ import annotations

import argparse
import sys

import torch

from poi_tpu_torch.scripts._timing import add_device_arg, setup

MODELS = (2, 4, 8)
IMPLS = ("blockwise", "ring", "ulysses")


def rank_main(dim: int, heads: int, window: int, batch: int, seqlen: int, device: str) -> None:
    """One rank: every mesh shape and each attention; rank 0 prints."""
    import torch.distributed as dist

    from poi_tpu_torch.models.attention import init_mha
    from poi_tpu_torch.ops.attention import multihead_attention
    from poi_tpu_torch.parallel import collectives as cc
    from poi_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, init_distributed, rank_device
    from poi_tpu_torch.parallel.sp_attention import make_sp_attention

    init_distributed("gloo")
    dev = rank_device(device)
    world, lead = dist.get_world_size(), dist.get_rank() == 0
    B, T, D, H, W = batch, seqlen, dim, heads, window
    if lead:
        print(f"attention block fwd+bwd, ranks={world} B={B} T={T} D={D} heads={H} window={W} (activation "
              f"{B * T * D * 4 / 1e6:.1f} MB fp32); wire MB/device = ring-protocol-weighted payload, the SP "
              "modes' split and gather included", flush=True)
        print(f"{'model':>5} {'data':>4} {'impl':>10} {'wire MB/dev':>12} {'payload MB/dev':>15}  breakdown",
              flush=True)
    gen = torch.Generator().manual_seed(0)
    params = {k: v.to(dev) for k, v in init_mha(gen, D).items()}
    for m in (m for m in MODELS if m <= world and world % m == 0):
        mesh = Mesh(world // m, m)
        h = torch.randn(B // mesh.shape[DATA_AXIS], T, D, generator=gen).to(dev)
        for impl in IMPLS:
            if impl == "blockwise":
                mha = lambda x, p: multihead_attention(x, p, H, W)  # noqa: E731
            else:
                mha = make_sp_attention(mesh, H, W, impl)
            p = {k: v.clone().requires_grad_() for k, v in params.items()}
            x = h.clone().requires_grad_()
            with cc.count_bytes() as c:
                (x + mha(x, p)).square().sum().backward()
                for w in p.values():
                    cc.all_reduce_(w.grad, mesh, DATA_AXIS, tally=("all_reduce_", "bwd"))
            if lead:
                parts = ", ".join(f"{op}/{d}={b / 1e6:.2f}MB" for (op, d), b in sorted(c.payload.items()))
                print(f"{m:>5} {mesh.shape[DATA_AXIS]:>4} {impl:>10} {sum(c.wire.values()) / 1e6:>12.2f} "
                      f"{sum(c.payload.values()) / 1e6:>15.2f}  {parts or '(none)'}", flush=True)
    dist.barrier()
    dist.destroy_process_group()


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m poi_tpu_torch.scripts.compare_attention_modes", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ranks", type=int, default=4, help="gloo ranks on this machine (model shards up to this)")
    p.add_argument("--dim", type=int, default=512)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--window", type=int, default=16)
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--seqlen", type=int, default=64)
    add_device_arg(p)
    args = p.parse_args(argv)
    setup(args.device)
    from poi_tpu_torch.parallel.launch import spawn

    spawn("poi_tpu_torch.scripts.compare_attention_modes:rank_main", args.ranks,
          {"dim": args.dim, "heads": args.heads, "window": args.window, "batch": args.batch, "seqlen": args.seqlen,
           "device": args.device}, timeout=900)
    return 0


if __name__ == "__main__":
    sys.exit(main())
