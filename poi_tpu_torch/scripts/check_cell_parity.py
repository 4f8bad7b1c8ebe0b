"""Kernel cell against the plain cell at the presets' shapes, the counterpart
of ``scripts/check_cell_parity.py``.

    python -m poi_tpu_torch.scripts.check_cell_parity [--device cuda]

Runs the GRU and LSTM layers (``models.gru.gru_layer``,
``models.lstm.lstm_layer``) in bf16 through the CUDA kernels
(``cell_impl="pallas"``: B1/B2, B3/B4) and through the plain recurrence
under autograd (``cell_impl="scan"``) on the same inputs, at the
reference's (B, T, H): config #2's LSTM 64/64/128, config #4's GRU
64/128/256 and the bench workload's GRU 256/64/128, ragged lengths in
[T/2, T]. The loss is ``sum(h · mask · 0.1)``; it prints the forward
values and, for every parameter and the input, the largest difference of
the gradients and its ratio to the plain gradient's largest entry, with
``<-- DIVERGES`` past 0.05, as the reference does.
"""

from __future__ import annotations

import argparse
import sys

import torch

from poi_tpu_torch.scripts._timing import add_device_arg, setup

SHAPES = (("lstm", 64, 64, 128), ("gru", 64, 128, 256), ("gru", 256, 64, 128))
DIVERGES = 0.05


def check(kind: str, B: int, T: int, H: int, dev: torch.device, D: int | None = None) -> int:
    """Prints one shape's lines; returns how many diverged."""
    from poi_tpu_torch.models.gru import gru_layer, init_gru_layer
    from poi_tpu_torch.models.lstm import init_lstm_layer, lstm_layer

    D = D or H
    init, layer = {"gru": (init_gru_layer, gru_layer), "lstm": (init_lstm_layer, lstm_layer)}[kind]
    gen = torch.Generator().manual_seed(0)
    p0 = {k: v.to(dev) for k, v in init(gen, D, H).items()}
    x0 = (torch.randn(B, T, D, generator=gen) * 0.5).to(dev)
    lengths = torch.randint(T // 2, T + 1, (B, 1), generator=gen)
    mask = (torch.arange(1, T + 1)[None, :] <= lengths).float().to(dev)

    def run(impl: str):
        p = {k: v.clone().requires_grad_() for k, v in p0.items()}
        x = x0.clone().requires_grad_()
        val = (layer(p, x, mask, torch.bfloat16, cell_impl=impl) * mask[:, :, None] * 0.1).sum()
        val.backward()
        return float(val.detach()), {k: v.grad for k, v in p.items()}, x.grad

    v_s, gp_s, gx_s = run("scan")
    v_p, gp_p, gx_p = run("pallas")
    print(f"{kind} B={B} T={T} H={H}: fwd scan={v_s:.6f} kernel={v_p:.6f} diff={abs(v_s - v_p):.2e}", flush=True)
    bad = 0
    for name, a, b in [*((k, gp_s[k], gp_p[k]) for k in gp_s), ("x", gx_s, gx_p)]:
        diff = float((a - b).abs().max())
        rel = diff / max(float(a.abs().max()), 1e-9)
        flag = "  <-- DIVERGES" if rel > DIVERGES else ""
        bad += rel > DIVERGES
        print(f"    d{name}: max|Δ|={diff:.3e} rel={rel:.3e}{flag}", flush=True)
    return bad


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m poi_tpu_torch.scripts.check_cell_parity", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_device_arg(p)
    dev = setup(p.parse_args(argv).device)
    bad = sum(check(kind, B, T, H, dev) for kind, B, T, H in SHAPES)
    print(f"{bad} gradient(s) diverged past {DIVERGES}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
