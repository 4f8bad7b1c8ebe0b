"""The recurrence kernels (B1/B2 GRU, B3/B4 LSTM, B5/B6 RNN) against their
plain versions at config #4/#5 widths, the counterpart of
``scripts/bench_cells.py``.

    python -m poi_tpu_torch.scripts.bench_cells [--device cuda]

The JAX script's points (B, H) at T=64, forward and forward+backward
(``sum(hs**2)`` through the autograd Function, whose backward is the BPTT
kernel), and the same for the plain versions through autograd. The LSTM and
RNN also run at the GRU's widths 256 and 512. Each pair takes widths up to
a limit (LSTM 512, RNN 640: ``lstm_max_hidden()``, ``rnn_max_hidden()``);
a point past its limit prints the wrapper's refusal as its row (any other
error of the wrapper stops the run). The last
column is cuDNN's ``nn.GRU``/``nn.LSTM``/``nn.RNN`` bf16 forward at the same
B, T, H: a yardstick (its own input projection, no mask, other GRU gates).
"""

from __future__ import annotations

import argparse
import sys

import torch

from poi_tpu_torch.scripts._timing import add_device_arg, cudnn_ms, setup, sync, time_ms

T = 64
ITERS, PLAIN_ITERS = 10, 5  # timed calls a point (a kernel call takes 64-124 ms at H=512)
# What the recurrence wrappers' width refusal says; any other ValueError is a fault.
REFUSAL = "is not taken by the kernels"
GATES = {"gru": 3, "lstm": 4, "rnn": 1}
POINTS = {
    "gru": ((256, 128), (256, 256), (256, 512), (64, 256), (512, 512)),
    "lstm": ((64, 128), (256, 128), (256, 256), (256, 512)),
    "rnn": ((64, 128), (256, 128), (256, 256), (256, 512)),
}


def cell(kind: str):
    """(kernel forward, plain forward, differentiable kernel path) of
    ``kind``, each ``f(x, mask, w) -> hs``; looked up at call time."""
    from poi_tpu_torch.ops import fused_gru, fused_lstm, fused_rnn

    if kind == "gru":  # the GRU folds its mask into x
        return (lambda x, m, w: fused_gru.fused_gru_scan(x, w), lambda x, m, w: fused_gru.gru_scan_reference(x, w),
                lambda x, m, w: fused_gru.fused_gru(x, w))
    if kind == "lstm":
        return (lambda x, m, w: fused_lstm.fused_lstm_scan(x, m, w)[0],
                lambda x, m, w: fused_lstm.lstm_scan_reference(x, m, w)[0], fused_lstm.fused_lstm)
    return fused_rnn.fused_rnn_scan, fused_rnn.rnn_scan_reference, fused_rnn.fused_rnn


def bench_point(kind: str, B: int, H: int, dev) -> dict | str:
    """Times of one point, or the wrapper's refusal of its width."""
    scan, ref, diff = cell(kind)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(B, T, GATES[kind] * H, generator=gen, device=dev)
    w = 0.1 * torch.randn(H, GATES[kind] * H, generator=gen, device=dev)
    w16 = w.to(torch.bfloat16)
    mask = torch.ones(B, T, device=dev)
    try:
        scan(x, mask, w16)
    except ValueError as e:
        if REFUSAL not in str(e):
            raise
        return str(e)
    sync(dev)
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()

    def fwd_bwd(f, weights):
        def run():
            xg.grad = wg.grad = None
            (f(xg, mask, weights()) ** 2).sum().backward()
        return run

    return {
        "fwd": time_ms(lambda: scan(x, mask, w16), ITERS, dev=dev),
        "fwd_plain": time_ms(lambda: ref(x, mask, w16), PLAIN_ITERS, dev=dev),
        "fb": time_ms(fwd_bwd(diff, lambda: wg), ITERS, dev=dev),
        "fb_plain": time_ms(fwd_bwd(ref, lambda: wg.to(torch.bfloat16)), PLAIN_ITERS, dev=dev),
        "cudnn": cudnn_ms(kind, B, T, H, dev, ITERS) if dev.type == "cuda" else None,
    }


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m poi_tpu_torch.scripts.bench_cells", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_device_arg(p)
    args = p.parse_args(argv)
    dev = setup(args.device)
    lib = "cuDNN fwd" if dev.type == "cuda" else "(no cuDNN)"
    print(f"{'cell':>5} {'B':>4} {'H':>4} {'fwd kern':>9} {'fwd plain':>10} {'x':>6} {'f+b kern':>9} "
          f"{'f+b plain':>10} {'x':>6} {lib:>10}   (ms, T={T})", flush=True)
    for kind, pts in POINTS.items():
        for B, H in pts:
            r = bench_point(kind, B, H, dev)
            if isinstance(r, str):
                print(f"{kind:>5} {B:>4} {H:>4} refused: {r}", flush=True)
                continue
            cudnn = f"{r['cudnn']:>10.4f}" if r["cudnn"] is not None else f"{'-':>10}"
            print(f"{kind:>5} {B:>4} {H:>4} {r['fwd']:>9.4f} {r['fwd_plain']:>10.4f} {r['fwd_plain'] / r['fwd']:>6.1f} "
                  f"{r['fb']:>9.4f} {r['fb_plain']:>10.4f} {r['fb_plain'] / r['fb']:>6.1f} {cudnn}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
