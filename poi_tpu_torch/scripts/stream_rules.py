"""The streamed recurrences' two measured rules in ``csrc/grid_stream.cuh``,
each timed against its alternative on the same inputs, on the card:

- ``evict_last``: the streamed weight's L2 policy (``evict_first_policy``:
  evicted first, whatever its bytes) against keeping it in L2 from step to
  step (evict-last), at weights that fit the 50 MB L2: the GRU at H = 2304
  (31.9 MB) and 2560 (39.3 MB) on the bench workload's batch 512, T = 64;
  the LSTM at H = 2048 (33.6 MB) on config #2's batch 64, T = 64; the RNN at
  H = 4096 (33.6 MB) on config #3's batch 64, T = 32. Forward and
  backward.
- ``pass64``: the forward's passes of 128 rows (``stream_shape``'s mt = 4,
  where the LSTM's 128 fp32 accumulators a thread spill) against passes of
  64, at the LSTM's H = 4096 and serving batch 256. Forward only.

    python -m poi_tpu_torch.scripts.stream_rules [--rounds N]

Each alternative is the package's recurrence sources with the rule's one
line replaced, built by nvcc (one process a source, all started together,
beside the package's own library) under ``build/stream_rules/<name>/`` and
bound as ``_build`` binds the package's library. A case runs the rule and
the alternative in turns (rule, alternative, alternative, rule, ``--rounds``
times) on one set of random inputs; every run must give the first run's
bits (an L2 hint or a pass size changes no sum), and each is timed on the
card by ``torch.profiler`` (``_timing.kernel_ms``): the forward, and the
backward in all and its streamed carry. Needs a CUDA card. Prints the
card's line first and a JSON object of every run's times last.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

# name -> (the rule's line in grid_stream.cuh, the alternative's).
VARIANTS = {
    "evict_last": (r'  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));',
                   r'  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(p));'),
    "pass64": ("  s.mt = s.rows <= 32 ? 1 : (bwd || s.rows <= 64) ? 2 : 4;", "  s.mt = s.rows <= 32 ? 1 : 2;"),
}
# name -> cases (recurrence, B, T, H, with the backward).
CASES = {
    "evict_last": (("gru", 512, 64, 2304, True), ("gru", 512, 64, 2560, True), ("lstm", 64, 64, 2048, True),
                   ("rnn", 64, 32, 4096, True)),
    "pass64": (("lstm", 256, 64, 4096, False),),
}
SOURCES = ("gru_fwd.cu", "gru_bwd.cu", "lstm.cu", "rnn.cu")  # gru_fwd.cu also holds poi_cuda_error_string
GATES = {"gru": 3, "lstm": 4, "rnn": 1}
ITERS = 10  # calls a profiled record


def start_builds(root: Path) -> dict:
    """Starts nvcc on each variant's copy of the sources; returns name ->
    (the library's path, its object paths, the compile processes)."""
    from poi_tpu_torch import _build

    nvcc = _build._nvcc()
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    out = {}
    for name, (rule, other) in VARIANTS.items():
        work = root / name
        shutil.rmtree(work, ignore_errors=True)
        shutil.copytree(_build.CSRC, work)
        header = work / "grid_stream.cuh"
        text = header.read_text()
        if text.count(rule) != 1:
            raise SystemExit(f"grid_stream.cuh no longer holds the {name} rule's line {rule!r}")
        header.write_text(text.replace(rule, other))
        objs = [work / (Path(src).stem + ".o") for src in SOURCES]
        procs = [subprocess.Popen([nvcc, *flags, "-c", "-o", str(obj), str(work / src)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for src, obj in zip(SOURCES, objs)]
        out[name] = (work / f"lib_{name}.so", objs, procs)
    return out


def finish_build(so: Path, objs: list, procs: list) -> ctypes.CDLL:
    """Waits for a variant's compiles, links them and binds the library's
    entry points as ``_build.library`` binds the package's."""
    from poi_tpu_torch import _build

    for proc in procs:
        text = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {so.name}: {text[-3000:]}")
    nvcc = _build._nvcc()
    subprocess.run([nvcc, "-shared", "-o", str(so), *map(str, objs), *_build._libcuda_link_flags(nvcc)], check=True)
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in _build._SIGNATURES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = _build._RESTYPES.get(fn, ctypes.c_int)
    return lib


def case_inputs(kind: str, B: int, T: int, H: int, gen) -> tuple:
    """Random inputs at the init scale, every step valid: the forward's
    arguments (the GRU's xw and wh; the LSTM's and RNN's x, mask, w)."""
    G = GATES[kind]
    x = torch.randn(B, T, G * H, generator=gen, device="cuda")
    w = (torch.randn(H, G * H, generator=gen, device="cuda") / H**0.5).to(torch.bfloat16)
    return (x, w) if kind == "gru" else (x, torch.ones(B, T, device="cuda"), w)


def ops(kind: str):
    """The recurrence's (forward, backward) wrappers."""
    from poi_tpu_torch.ops import fused_gru, fused_lstm, fused_rnn

    return {"gru": (fused_gru.fused_gru_scan, fused_gru.fused_gru_bwd),
            "lstm": (fused_lstm.fused_lstm_scan, fused_lstm.fused_lstm_bwd),
            "rnn": (fused_rnn.fused_rnn_scan, fused_rnn.fused_rnn_bwd)}[kind]


def one_run(kind: str, args: tuple, with_bwd: bool) -> tuple[dict, tuple]:
    """Device ms of the forward (and the backward, in all and its streamed
    carry) on the library ``_build.library`` returns now, and the outputs."""
    from poi_tpu_torch.scripts._timing import kernel_ms

    scan, bwd = ops(kind)
    carries = scan(*args)
    carries = carries if isinstance(carries, tuple) else (carries,)
    fwd = kernel_ms(lambda: scan(*args), ITERS, expect=(f"{kind}_fwd_stream",))
    out = {"fwd_ms": sum(fwd.values())}
    grads = ()
    if with_bwd:
        dhs = torch.ones_like(carries[0])
        grads = bwd(*args, *carries, dhs)
        parts = kernel_ms(lambda: bwd(*args, *carries, dhs), ITERS, expect=(f"{kind}_bwd_stream_carry",))
        out["bwd_ms"] = sum(parts.values())
        out["carry_ms"] = sum(v for k, v in parts.items() if "stream_carry" in k)
    return out, carries + tuple(grads)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m poi_tpu_torch.scripts.stream_rules", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--rounds", type=int, default=2, help="rule, alternative, alternative, rule: this many times")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: torch.cuda.is_available() is false: the rules are timed on a CUDA card", file=sys.stderr)
        return 2

    from poi_tpu_torch import _build
    from poi_tpu_torch.scripts._timing import setup

    setup("cuda")  # prints the card's line
    builds = start_builds(_build.BUILD_DIR.parent / "stream_rules")
    real = _build.library
    libs = {"rule": real()}
    libs.update({name: finish_build(*b) for name, b in builds.items()})
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {}
    try:
        for name, cases in CASES.items():
            for kind, B, T, H, with_bwd in cases:
                inputs = case_inputs(kind, B, T, H, gen)
                mb = H * GATES[kind] * H * 2 / 1e6
                runs, first = [], None
                for which in ("rule", name, name, "rule") * args.rounds:
                    _build.library = lambda lib=libs[which]: lib
                    times, outs = one_run(kind, inputs, with_bwd)
                    first = first or outs
                    if not all(torch.equal(a, b) for a, b in zip(first, outs)):
                        raise SystemExit(f"{name} {kind} B={B} T={T} H={H}: {which} gives other bits")
                    runs.append({"which": which, **times})
                    print(f"[{name}] {kind} B={B} T={T} H={H} ({mb:.1f} MB of weight), "
                          f"{'the rule' if which == 'rule' else name}: forward device {times['fwd_ms']:.4f} ms"
                          + (f"; backward {times['bwd_ms']:.4f} ms (streamed carry {times['carry_ms']:.4f})"
                             if with_bwd else ""), flush=True)
                del inputs, first
                torch.cuda.empty_cache()
                for key in ("fwd_ms", "carry_ms", "bwd_ms"):
                    if key in runs[0]:
                        a = statistics.median(r[key] for r in runs if r["which"] == "rule")
                        b = statistics.median(r[key] for r in runs if r["which"] != "rule")
                        print(f"[{name}] {kind} H={H} {key[:-3]}: median rule {a:.4f} ms, {name} {b:.4f} ms "
                              f"({(b - a) / a:+.1%} for the alternative)", flush=True)
                result[f"{name}_{kind}_{B}x{T}x{H}"] = runs
    finally:
        _build.library = real
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
