#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port's serving path (config #1).

    python3 chip_smoke.py          # from the repository root, on a machine with one CUDA card

Builds the port's CUDA kernels from ``poi_tpu_torch/csrc``, compares each
with its plain PyTorch version on the card, serves 256 requests of config #1
(``gru_foursquare_nyc``: GRU 64-d, T=64, 6,749-POI catalog, random weights
from a fixed seed) through ``Recommender`` and through ``python -m
poi_tpu_torch serve``, and times the kernels and ``recommend``. Any failed
phase prints its traceback and exits non-zero. The last two lines of
standard output are the kernels' JSON record and
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parent
CONFIG = "gru_foursquare_nyc"
SEED = 0
DEV = "cuda"

# GRU: kernel and plain version both round h to bf16 before the recurrent
# product and sum exact products in fp32, in different orders. Where the two
# fp32 values of h straddle a bf16 rounding boundary they round apart, which
# moves one pre-activation by ~|h|·2^-9·|w| ≈ 1e-4; a few such flips over 64
# steps, damped by the gates, stay well below 5e-3. A wrong gate or update
# moves h by ~1e-1.
GRU_TOL = 5e-3
# Top-k values: fp32 sums of 64 exact bf16 products of magnitude <= ~20 in
# different orders differ by a few ulps of ~10, far below 1e-4.
TOPK_TOL = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms (CUDA events around each call)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median host time of ``fn`` in ms; ``fn`` ends with a device sync."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# ----------------------------------------------------------------- phases


def build_phase() -> None:
    from poi_tpu_torch import _build

    t0 = time.perf_counter()
    path, out = _build.build()
    log(f"[build] {path.name} in {time.perf_counter() - t0:.1f} s")
    for line in out.splitlines():
        if "registers" in line or "smem" in line or "spill" in line or "Compiling entry" in line:
            log(f"[build]   {line.strip()}")
    _build.library()


def gru_case(B: int, T: int, H: int, gen):
    import torch

    from poi_tpu_torch.ops.fused_gru import MASK_NEG

    xw = torch.randn(B, T, 3 * H, generator=gen, device=DEV)
    wh = (torch.randn(H, 3 * H, generator=gen, device=DEV) / H**0.5).to(torch.bfloat16)
    lengths = torch.randint(1, T + 1, (B,), generator=gen, device=DEV)
    lengths[0] = T
    mask = torch.arange(T, device=DEV)[None, :] < lengths[:, None]
    xw[:, :, :H] = torch.where(mask[:, :, None], xw[:, :, :H], MASK_NEG)
    return xw, wh, mask, lengths


def gru_phase() -> float:
    import torch

    from poi_tpu_torch.ops.fused_gru import fused_gru_scan, gru_scan_reference

    gen = torch.Generator(device=DEV).manual_seed(SEED)
    worst = 0.0
    for H in (64, 128):
        for B in (1, 7, 256):
            xw, wh, mask, lengths = gru_case(B, 64, H, gen)
            got = fused_gru_scan(xw, wh)
            torch.cuda.synchronize()
            want = gru_scan_reference(xw, wh)
            torch.cuda.synchronize()
            err = float(((got - want).abs() * mask[:, :, None]).max())
            assert torch.isfinite(got).all(), f"GRU B={B} H={H}: non-finite output"
            assert err < GRU_TOL, f"GRU B={B} H={H}: max |kernel - plain| {err} >= {GRU_TOL}"
            # The folded mask carries h through the padded tail unchanged.
            last = got[torch.arange(B, device=DEV), lengths - 1]
            tail = torch.where(mask[:, :, None], last[:, None, :], got)
            assert torch.equal(tail, last[:, None, :].expand_as(got)), f"GRU B={B} H={H}: masked tail moved h"
            worst = max(worst, err)
            log(f"[gru] B={B:3d} T=64 H={H:3d}: max |kernel - plain| at valid steps {err:.3e} (tol {GRU_TOL})")
    return worst


def topk_phase() -> float:
    import torch

    from poi_tpu_torch.ops.topk import fused_topk, topk_reference

    gen = torch.Generator(device=DEV).manual_seed(SEED + 1)
    D = 64
    worst = 0.0
    # The padded config #1 catalog at request batch 1 and 256, and one case
    # whose batch fills the card with one slice per row, on the unpadded V.
    for B, V, k in ((1, 8192, 10), (1, 8192, 128), (256, 8192, 10), (256, 8192, 128), (300, 6749, 128)):
        q = torch.randn(B, D, generator=gen, device=DEV)
        table = torch.randn(V, D, generator=gen, device=DEV)
        bias = torch.randn(V, generator=gen, device=DEV)
        bias[6749:] = -1e30  # the padded tail of the config #1 catalog
        vals, ids = fused_topk(q, table, bias, k)
        torch.cuda.synchronize()
        want_v, want_i = topk_reference(q, table, bias, k)
        err = float((vals - want_v).abs().max())
        assert err < TOPK_TOL, f"top-k B={B} k={k}: max |vals - plain| {err}"
        exact = q.to(torch.bfloat16).double() @ table.to(torch.bfloat16).double().T + bias.double()
        rows = torch.arange(B, device=DEV)[:, None]
        near = (exact[rows, ids.long()] - exact[rows, want_i.long()]).abs() < TOPK_TOL
        assert ((ids == want_i) | near).all(), f"top-k B={B} k={k}: ids differ beyond near-ties"
        assert int(ids.max()) < 6749, f"top-k B={B} k={k}: a padded row won"
        worst = max(worst, err)
        log(f"[topk] B={B:3d} V={V} D={D} k={k:3d}: max |vals - plain| {err:.3e}, ids equal "
            f"{int((ids == want_i).sum())}/{ids.numel()} (rest near-ties < {TOPK_TOL})")
    # Duplicated rows across the catalog: the tie order must be exact.
    V = 8192
    q = torch.randn(4, D, generator=gen, device=DEV)
    table = torch.randn(16, D, generator=gen, device=DEV)[torch.randint(0, 16, (V,), generator=gen, device=DEV)]
    bias = torch.zeros(V, device=DEV)
    for k in (10, 128):
        _, ids = fused_topk(q, table, bias, k)
        _, want_i = topk_reference(q, table, bias, k)
        assert torch.equal(ids, want_i), f"top-k duplicated rows k={k}: tie order differs"
    log("[topk] duplicated rows: tie order (value desc, id asc) exact for k=10 and k=128")
    return worst


def config1_params(ds, cfg):
    """Full-width config #1 params in poi_tpu's layout and init scales
    (models/base.py init_embed_params, models/gru.py init_gru_layer), from
    numpy with a fixed seed."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    m = cfg.model
    d, h = m.embed_dim, m.hidden_dim
    normal = lambda shape, s: (s * rng.normal(size=shape)).astype(np.float32)  # noqa: E731
    embed = {
        "poi": normal((ds.num_pois, d), 0.02),
        "out_bias": np.zeros(ds.num_pois, np.float32),
        "time": normal((ds.num_time_buckets, d), 0.02),
        "geo": normal((ds.num_geo_buckets, d), 0.02),
    }
    layer = {"wx": normal((d, 3 * h), d**-0.5), "wh": normal((h, 3 * h), h**-0.5), "b": np.zeros(3 * h, np.float32)}
    return {"embed": embed, "tower": {"layers": [layer]}}


def histories_from_test(ds, n: int):
    """Raw histories rebuilt from eval rows: POI ids and hour-of-week, with
    the catalog's coordinates."""
    import numpy as np

    from poi_tpu_torch.eval.serve import Checkin

    ex = ds.test
    out = []
    for i in np.linspace(0, len(ex) - 1, n).astype(int):
        m = int(ex.mask[i].sum())
        out.append([Checkin(int(p), float(tb) * 3600.0 + 1800.0) for p, tb in zip(ex.poi_in[i, :m], ex.time_bucket[i, :m])])
    return out


def slice_phase(state):
    import torch

    from poi_tpu.configs.presets import get_config
    from poi_tpu.data.dataset import load_dataset
    from poi_tpu_torch.convert import params_from_jax
    from poi_tpu_torch.eval.serve import Recommender
    from poi_tpu_torch.models.base import DataDims, batch_to, build_model
    from poi_tpu_torch.ops.fused_gru import fused_gru_scan
    from poi_tpu_torch.ops.topk import fused_topk

    cfg = get_config(CONFIG)
    t0 = time.perf_counter()
    ds = load_dataset(cfg.data)
    log(f"[slice] {CONFIG}: {ds.num_pois} POIs, T={ds.max_seq_len}, {len(ds.test)} test rows "
        f"(loaded in {time.perf_counter() - t0:.1f} s)")
    tree = config1_params(ds, cfg)
    dims = DataDims.from_dataset(ds)
    model = build_model(cfg.model, dims, device=DEV)
    model.load_state_dict(params_from_jax(tree))
    rec = Recommender(model, cfg, ds)
    histories = histories_from_test(ds, 256)

    fused_gru_scan.launches = 0
    fused_topk.launches = 0
    got = rec.recommend(histories, k=10, exclude_visited=True)
    torch.cuda.synchronize()
    launches = {"gru_fwd": fused_gru_scan.launches, "topk": fused_topk.launches}
    log(f"[slice] recommend(256 histories, k=10, exclude_visited) launches: {launches}")
    assert launches["gru_fwd"] > 0 and launches["topk"] > 0, f"main path skipped a kernel: {launches}"
    assert got.shape == (256, 10), got.shape
    assert (got != -1).all(), "a row came back short"
    assert ((got >= 0) & (got < ds.num_pois)).all(), "an id is not a real POI"
    for row, hist in zip(got, histories):
        assert not set(row.tolist()) & {c.poi for c in hist}, "a visited POI was returned"
        assert len(set(row.tolist())) == 10, "a row repeats a POI"

    # The same Recommender through the plain versions on the card.
    plain_cfg = cfg.with_overrides({"model.cell_impl": "scan", "eval.topk_impl": "xla"})
    plain_model = build_model(plain_cfg.model, dims, device=DEV)
    plain_model.load_state_dict(params_from_jax(tree))
    plain = Recommender(plain_model, plain_cfg, ds)
    want = plain.recommend(histories, k=10, exclude_visited=True)
    with torch.inference_mode():
        batch = batch_to(rec._featurize(histories), DEV)
        q_k, q_p = model.queries_last(batch).double(), plain_model.queries_last(batch).double()
    table = model.embed["poi"].detach().to(torch.bfloat16).double()
    scores = q_p.to(torch.bfloat16).double() @ table.T  # out_bias is zero
    # Two ids may swap only if their scores lie within what the two paths'
    # query difference can move a score (|Δq|·max|e| per row) plus fp32 noise.
    bound = ((q_k - q_p).abs() @ table.abs().max(dim=0).values[:, None]).squeeze(1) * 2 + 1e-5
    g, w = torch.as_tensor(got, device=DEV).long(), torch.as_tensor(want, device=DEV).long()
    rows = torch.arange(256, device=DEV)[:, None]
    near = (scores[rows, g] - scores[rows, w]).abs() <= bound[:, None]
    assert bool(((g == w) | near).all()), "kernel path and plain path disagree beyond near-ties"
    log(f"[slice] kernel path vs plain path: ids equal {int((g == w).sum())}/{g.numel()}, "
        f"max |Δq| {float((q_k - q_p).abs().max()):.3e}")
    state.update(cfg=cfg, ds=ds, tree=tree, rec=rec, plain=plain, histories=histories, launches=launches)


def cli_phase(state) -> None:
    import numpy as np

    from poi_tpu_torch.convert import save_npz

    hist = state["histories"]
    reqs = [
        json.dumps([[{"poi": c.poi, "timestamp": c.timestamp} for c in h] for h in hist[:2]]),
        "{not json",
        json.dumps({"histories": [[{"poi": c.poi, "timestamp": c.timestamp} for c in hist[2]]], "k": 5}),
    ]
    with tempfile.TemporaryDirectory() as tmp:
        npz = os.path.join(tmp, "params.npz")
        save_npz(npz, state["tree"])
        proc = subprocess.run(
            [sys.executable, "-m", "poi_tpu_torch", "serve", "--config", CONFIG, "--params", npz, "--device", DEV],
            input="\n".join(reqs) + "\n", capture_output=True, text=True, cwd=REPO, timeout=600,
            env=dict(os.environ, PYTHONPATH=str(REPO)),
        )
    assert proc.returncode == 0, f"serve exited {proc.returncode}:\n{proc.stderr[-3000:]}"
    lines = [json.loads(line) for line in proc.stdout.strip().splitlines()]
    assert len(lines) == 3, proc.stdout
    assert "error" in lines[1], lines[1]
    want = state["rec"].recommend(hist[:2], k=10)
    assert np.array_equal(np.asarray(lines[0]["ids"]), want), (lines[0], want)
    assert np.asarray(lines[2]["ids"]).shape == (1, 5), lines[2]
    log(f"[cli] serve --device {DEV}: 2 answers + 1 error line, exit 0; first answer equals in-process recommend")


def timing_phase(state, gpu: str) -> dict:
    import torch

    from poi_tpu_torch.models.base import batch_to
    from poi_tpu_torch.ops.fused_gru import fused_gru_scan, gru_scan_reference
    from poi_tpu_torch.ops.topk import fused_topk, topk_reference

    gen = torch.Generator(device=DEV).manual_seed(SEED + 2)
    out = {}
    xw, wh, _, _ = gru_case(256, 64, 64, gen)
    out["gru_fwd"] = (time_ms(lambda: fused_gru_scan(xw, wh)), time_ms(lambda: gru_scan_reference(xw, wh)))
    log(f"[time] gru_fwd B=256 T=64 H=64: kernel {out['gru_fwd'][0]:.4f} ms, plain {out['gru_fwd'][1]:.4f} ms  ({gpu})")
    prep = state["rec"]._prep
    q = torch.randn(256, 64, generator=gen, device=DEV)
    for k in (128, 10):
        t = (time_ms(lambda: fused_topk(q, prep.table, prep.bias, k)),
             time_ms(lambda: topk_reference(q, prep.table, prep.bias, k)))
        out.setdefault("topk", t)  # the slice's own fetch (k=128) goes in the record
        log(f"[time] topk B=256 V={prep.table.shape[0]} D=64 k={k}: kernel {t[0]:.4f} ms, plain {t[1]:.4f} ms  ({gpu})")
    hist = state["histories"]
    rec = state["rec"]
    for n in (1, 256):
        batch = rec._featurize(hist[:n])
        with torch.inference_mode():
            bt = batch_to(batch, DEV)
            ql = rec.model.queries_last(bt)
            ids = fused_topk(ql, prep.table, prep.bias, 128)[1].cpu().numpy()
            parts = (
                host_ms(lambda: rec._featurize(hist[:n])),
                host_ms(lambda: (batch_to(batch, DEV), torch.cuda.synchronize())),
                time_ms(lambda: rec.model.queries_last(bt)),
                time_ms(lambda: fused_topk(ql, prep.table, prep.bias, 128)),
                host_ms(lambda: rec._finalize(prep.id_map[ids], hist[:n], 10, True)),
            )
        log(f"[time] recommend batch {n:3d} parts: featurize {parts[0]:.3f} ms (host), to device {parts[1]:.3f} ms, "
            f"queries_last {parts[2]:.4f} ms (device), topk k=128 {parts[3]:.4f} ms (device), "
            f"visited filter {parts[4]:.3f} ms (host)  ({gpu})")
    for n in (1, 64, 256):
        for name, rec in (("kernels", state["rec"]), ("plain", state["plain"])):
            ms = host_ms(lambda: rec.recommend(hist[:n], k=10))
            log(f"[time] recommend batch {n:3d} ({name}): {ms:.3f} ms median of 20  ({gpu})")
    return out


def main() -> int:
    if not (REPO / "poi_tpu_torch").is_dir() or not (REPO / "poi_tpu").is_dir():
        print(f"error: {REPO} is not a checkout of the repository (no poi_tpu_torch/ or poi_tpu/)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    # The dataset cache would live outside the checkout; config #1 builds in about a second.
    os.environ.setdefault("POI_TPU_DATA_CACHE", "off")
    import torch

    if not torch.cuda.is_available():
        print("error: torch.cuda.is_available() is false: this smoke run needs a CUDA card", file=sys.stderr)
        return 2
    gpu = gpu_line()
    log(f"[setup] torch {torch.__version__} CUDA {torch.version.cuda}, card: {gpu}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    build_phase()
    gru_err = gru_phase()
    topk_err = topk_phase()
    state: dict = {}
    slice_phase(state)
    cli_phase(state)
    times = timing_phase(state, gpu)
    assert "jax" not in sys.modules, "JAX was imported"

    kernels = [
        {"name": "gru_fwd", "route": "cuda", "source": "poi_tpu_torch/csrc/gru_fwd.cu",
         "replaces": "poi_tpu/ops/fused_gru.py:71", "launches": state["launches"]["gru_fwd"],
         "max_abs_err": gru_err, "ms": times["gru_fwd"][0], "plain_ms": times["gru_fwd"][1]},
        {"name": "topk", "route": "cuda", "source": "poi_tpu_torch/csrc/topk.cu",
         "replaces": "poi_tpu/ops/topk.py:58", "launches": state["launches"]["topk"],
         "max_abs_err": topk_err, "ms": times["topk"][0], "plain_ms": times["topk"][1]},
    ]
    print(gpu, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)
