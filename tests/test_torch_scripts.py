"""The port's measurement scripts (``poi_tpu_torch.scripts``) run on the CPU at
tiny sizes, where they take the kernels' plain versions; each is checked for
the rows it prints (their module constants shrink the runs: the number of
timed calls, the bench workload, ``bench_cells``' points). ``mem_budget``'s accounting is held against the JAX
package's (``jax.eval_shape`` of ``poi_tpu``'s ``Trainer.init_state``), the
step FLOP count of ``bench_variants`` and ``bench_attn_step`` against
``bench.py``'s, and ``quality_runs`` on 4 gloo ranks against one rank. On
the card, ``chip_smoke.py`` runs every script at its default size."""

import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from poi_tpu.models.base import DataDims as JaxDataDims
from poi_tpu.train.loop import Trainer as JaxTrainer
from poi_tpu.utils.config import Config as JaxConfig
from poi_tpu_torch.configs.presets import get_config
from poi_tpu_torch.data.dataset import load_dataset
from poi_tpu_torch.models.base import DataDims
from poi_tpu_torch.ops import fused_lstm, fused_rnn
from poi_tpu_torch.scripts import (_timing, bench_1m, bench_attn_step, bench_cells, bench_eval_path, bench_serve,
                                   bench_variants, check_cell_parity, compare_attention_modes, compare_embedding_modes,
                                   host_feed, mem_budget, profile_1m, profile_attn, profile_step, quality_runs,
                                   scaling_bench, step_time, sweep_ce_bwd, sweep_ce_fwd, tune_attention, tune_strnn)
from poi_tpu_torch.train.loop import Trainer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]
SMALL = {"data.num_users": "64", "data.num_pois": "400", "data.max_seq_len": "12", "model.embed_dim": "32",
         "model.hidden_dim": "32"}
SMALL_SET = [f"{k}={v}" for k, v in SMALL.items()]
SCRIPTS = {
    "sweep_ce_fwd": (sweep_ce_fwd, []), "sweep_ce_bwd": (sweep_ce_bwd, []), "profile_step": (profile_step, []),
    "profile_attn": (profile_attn, []), "bench_cells": (bench_cells, []), "bench_serve": (bench_serve, []),
    "mem_budget": (mem_budget, []), "quality_runs": (quality_runs, ["gru_foursquare_nyc"]),
    "bench_1m": (bench_1m, []), "profile_1m": (profile_1m, []), "step_time": (step_time, []),
    "compare_embedding_modes": (compare_embedding_modes, []), "compare_attention_modes": (compare_attention_modes, []),
    "scaling_bench": (scaling_bench, []), "check_cell_parity": (check_cell_parity, []),
    "bench_eval_path": (bench_eval_path, []), "tune_strnn": (tune_strnn, []), "tune_attention": (tune_attention, []),
    "host_feed": (host_feed, []), "bench_variants": (bench_variants, []), "bench_attn_step": (bench_attn_step, []),
}
# Config #5's scripts at a tiny size: 64 users, a 400-POI corpus, the
# catalog forced to 2,000 rows, 32-d, S = 64.
TINY_1M = {"data.num_users": "64", "data.num_pois": "400", "data.mean_checkins_per_user": "20",
           "data.max_seq_len": "12", "model.embed_dim": "32", "model.hidden_dim": "32", "model.attn_heads": "2",
           "model.attn_window": "4", "loss.num_sampled": "64"}


@pytest.fixture(autouse=True)
def _no_dataset_cache(monkeypatch):
    monkeypatch.setenv("POI_TPU_TORCH_DATA_CACHE", "off")


def _run(capsys, module, argv) -> list[str]:
    assert module.main(argv + CPU) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("cpu: ")  # the device line comes first
    return out


def test_sweep_ce_fwd_prints_six_cells_and_the_best(capsys, monkeypatch):
    monkeypatch.setattr(sweep_ce_fwd, "ITERS", 1)
    out = _run(capsys, sweep_ce_fwd, ["--n", "70", "--v", "300", "--d", "32"])
    cells = [line for line in out if re.match(r"(base|exp2|nomax) +rows=", line)]
    assert [c.split(":")[0].replace(" ", "") for c in cells] == [f"{v}rows={r}" for v in ("base", "exp2", "nomax")
                                                                  for r in (128, 256)]
    assert all("max |kernel - plain| 0.00e+00" in c for c in cells)  # the wrapper takes the plain versions here
    assert any("nomax is safe on these inputs" in line for line in out)
    assert out[-4].startswith("ce_lse (the train path's kernel): ") and "max |kernel - plain| 0.00e+00" in out[-4]
    assert out[-3].startswith("ce_lse_variant launches: 0 ")
    assert re.match(r"best: (base|exp2|nomax) rows=(128|256): ", out[-1])


def test_sweep_ce_bwd_prints_both_flop_counts(capsys, monkeypatch):
    monkeypatch.setattr(sweep_ce_bwd, "ITERS", 1)
    out = "\n".join(_run(capsys, sweep_ce_bwd, ["--n", "70", "--v", "300", "--d", "32"]))
    assert re.search(r"ce_bwd \(dq \+ dtable\): .* TFLOP/s \(3 products\) .* TFLOP/s \(4 products\)", out)
    assert "no tile axis" in out and "rel err against the plain version: dq 0.00e+00" in out


ONCE = {"topk_slice_kernel<64, 16>": 1, "topk_merge_kernel<32>": 1}
# bench_eval_path's two paths under the blockwise attention: their queries
# (O(1) after the layer norm) differ by a few bf16 roundings of p (2^-8
# relative each; measured 4.8e-3 and 4.1e-3 on the two shrunk configs).
BLOCKWISE_LAST_TOL = 2 ** -5


@pytest.mark.parametrize("counts, expect, fault", [
    ({"topk_slice_kernel<64, 16>": 20, "topk_merge_kernel<32>": 20}, ("topk_slice", "topk_merge"), None),
    ({"topk_slice_kernel<64, 16>": 5, "topk_merge_kernel<32>": 20}, (), "20 calls recorded"),  # launches lost
    ({"topk_merge_kernel<32>": 20}, (), "20 calls recorded"),  # a kernel lost in every call
    ({**{k: 20 for k in ONCE}, "Memset (Device)": 1}, (), "20 calls recorded"),  # one more
    ({k: 20 for k in ONCE}, ("sum_splits",), "no kernel named like ['sum_splits']"),
])
def test_kernel_ms_record_check(counts, expect, fault):
    """``kernel_ms`` takes a profile of n calls only if it holds each kernel
    of one profiled call n times as often, no other, and the named ones."""
    got = _timing.record_fault(ONCE, counts, 20, expect)
    assert got is None if fault is None else fault in got


def test_kernel_ms_retakes_an_incomplete_record(monkeypatch, capsys):
    records = iter([{"a": (1, 5.0)}, {"a": (3, 20.0)},  # the first 4-call record lost a launch
                    {"a": (1, 5.0)}, {"a": (4, 20.0)}])
    monkeypatch.setattr(_timing, "RETAKE_PAUSE_S", 0.0)
    monkeypatch.setattr(_timing, "_device_record", lambda fn, calls: next(records))
    assert _timing.kernel_ms(lambda: None, 4) == {"a": 20.0 / 1e3 / 4}
    assert f"profiler record 1/{_timing.PROFILE_TRIES} incomplete" in capsys.readouterr().out
    monkeypatch.setattr(_timing, "_device_record", lambda fn, calls: {"a": (calls, 1.0)} if calls == 1 else {})
    with pytest.raises(RuntimeError, match=f"missed launches in {_timing.PROFILE_TRIES} records"):
        _timing.kernel_ms(lambda: None, 4)


def test_sweep_ce_bwd_pass_ms_groups_the_kernels(monkeypatch):
    record = {"void (anonymous namespace)::ce_bwd_pass<128, false>(CUtensorMap, ...)": 1.5,
              "void (anonymous namespace)::ce_bwd_pass<128, true>(CUtensorMap, ...)": 2.0,
              "(anonymous namespace)::sum_splits(float const*, float*, long long, int)": 0.25}
    seen = {}
    monkeypatch.setattr(sweep_ce_bwd, "kernel_ms", lambda fn, n, expect: seen.update(expect=expect) or record)
    assert sweep_ce_bwd.pass_ms(None, 10) == {"dq pass": 1.5, "dtable pass": 2.0, "sum_splits": 0.25}
    assert {"ce_bwd_pass<", ", false>", ", true>"} <= set(seen["expect"])


@pytest.mark.parametrize("module, consts, names", [
    (profile_step, {"BENCH_OVERRIDES": {**profile_step.BENCH_OVERRIDES, **SMALL}, "STEPS": 2, "TRIALS": 1},
     ("embed lookup fwd+bwd", "tower fwd", "tower fwd+bwd", "CE fwd (fixed q)", "CE fwd+bwd (fixed q)",
      "full loss fwd+bwd", "optimizer update", "global norms x2", "CE fwd eff", "CE bwd eff", "full step",
      "sampled 10-step")),
    (profile_attn, {"OVERRIDES": {**profile_attn.OVERRIDES, **SMALL, "data.dataset": "synthetic",
                                  "loss.num_sampled": "64"}},
     ("embed lookup fwd+bwd", "tower fwd", "tower fwd+bwd", "loss fwd+bwd (fixed q)", "full loss fwd+bwd",
      "optimizer update")),
])
def test_profile_scripts_print_every_region(capsys, monkeypatch, module, consts, names):
    for name, value in {"ITERS": 1, **consts}.items():
        monkeypatch.setattr(module, name, value)
    out = _run(capsys, module, ["--batch", "8"])
    rows = {line.split(":")[0].strip() for line in out if line.startswith("  ")}
    assert set(names) <= rows, set(names) - rows
    assert all(np.isfinite(float(m)) for m in re.findall(r": +([0-9.]+) ms", "\n".join(out)))


def test_bench_1m_prints_topk_and_both_training_rates(capsys, monkeypatch):
    monkeypatch.setattr(bench_1m, "OVERRIDES", {**bench_1m.OVERRIDES, **TINY_1M})
    for name, value in {"FORCE_V": 2000, "TOPK_SHAPE": (8, 3000, 32, 10), "ITERS": 1, "CHUNK": 2, "CHUNKS": 1,
                        "TRIALS": 1}.items():
        monkeypatch.setattr(bench_1m, name, value)
    out = "\n".join(_run(capsys, bench_1m, ["--table-update", "both", "--batch", "8"]))
    assert re.search(r"fused top-k @ V=3,000 \(padded 4,096\) D=32 B=8 k=10: [0-9,]+ qps", out), out
    assert "model dims V=2,000 D=32 B=8 S=64" in out
    rates = re.findall(r"config #5 one-card training \((dense|sparse)\): ([0-9,.]+) seq/s", out)
    assert [r[0] for r in rates] == ["dense", "sparse"] and all(float(r[1].replace(",", "")) > 0 for r in rates)


def test_profile_1m_prints_every_region_and_the_crossover(capsys, monkeypatch):
    """The regions (the rows step's full gradient beside the dense path's)
    and lazy Adam's two forms at two table shapes, here shrunk."""
    monkeypatch.setattr(profile_1m, "OVERRIDES", {**profile_1m.OVERRIDES, **TINY_1M})
    monkeypatch.setattr(profile_1m, "FORCE_V", 2000)
    monkeypatch.setattr(profile_1m, "ITERS", 1)
    monkeypatch.setattr(profile_1m, "CROSSOVER", (("config #4", 300, 16, 50), ("config #5", 900, 32, 70)))
    from poi_tpu_torch.train import sparse_opt

    threshold = sparse_opt.DENSE_LAZY_MAX_BYTES
    out = _run(capsys, profile_1m, ["--batch", "8"])
    assert sparse_opt.DENSE_LAZY_MAX_BYTES == threshold  # the crossover puts the threshold back
    rows = {line.split(":")[0].strip(): line for line in out if line.startswith("  ")}
    want = {"embed lookup fwd+bwd", "tower fwd", "tower fwd+bwd", "mha+ln fwd+bwd (fixed h)", "full grads (rows)",
            "full grads (dense path)", "dense-grad scatter alone", "loss fwd+bwd (fixed q)", "optimizer DENSE adam",
            "optimizer SPARSE adam", *(f"{c} {p}" for c in ("config #4", "config #5")
                                       for p in ("masked-dense", "gather/scatter"))}
    assert want <= rows.keys(), want - rows.keys()
    assert all(np.isfinite(float(m)) for m in re.findall(r": +([0-9.]+) ms", "\n".join(out)))


def test_step_time_prints_each_config(capsys, monkeypatch):
    """Each configuration's step time, shrunk; the package it timed is named
    (the same file times another checkout's package)."""
    tiny = {"data.num_users": "64", "data.num_pois": "400", "data.max_seq_len": "12", "model.embed_dim": "32",
            "model.hidden_dim": "32", "train.batch_size": "8"}
    monkeypatch.setattr(step_time, "CONFIGS", {"bench": ("smoke", tiny),
                                               "multihost_1m": ("multihost_1m", {**tiny, **TINY_1M, "mesh.model": "1"})})
    monkeypatch.setattr(step_time, "CHUNK", 2)
    monkeypatch.setattr(step_time, "TRIALS", 1)
    assert step_time.main(["bench", "multihost_1m", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("cpu: ") and re.search(r"package: .*poi_tpu_torch/__init__.py", out)
    for name in ("bench", "multihost_1m"):
        assert re.search(rf"{name}: [0-9.]+ ms a step, [0-9,]+ seq/s at batch 8", out), out


def _bench_py():
    """The repository root's ``bench.py`` (it imports no JAX at module level)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("bench", os.path.join(REPO, "bench.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


BENCH_SETS = {**_timing.BENCH_OVERRIDES, "train.batch_size": "512"}
WIDE_SETS = {"model.embed_dim": "512", "model.hidden_dim": "1024"}
WIDER_SETS = {"model.embed_dim": "1024", "model.hidden_dim": "1024"}


@pytest.mark.parametrize("preset, overrides, num_pois, model_shards", [
    ("gru_foursquare_nyc", {}, 6749, 1),       # config #1
    ("lstm_bpr_foursquare", {}, 35880, 1),     # config #2: BPR's negatives + 1
    ("strnn_gowalla", {}, 36969, 1),           # config #3: the catalog
    ("attention_gowalla", {}, 36969, 1),       # config #4: attention, the sampled pool + 1
    ("attention_gowalla", {**bench_attn_step.OVERRIDES, "train.batch_size": "256"}, 36969, 1),
    ("multihost_1m", {}, 903889, 4),           # config #5 on its 1 x 4: the catalog padded to the model axis
    ("multihost_1m", {"mesh.model": "1"}, 903889, 1),
    ("smoke", BENCH_SETS, 44170, 1),           # the bench workload
    ("smoke", {**BENCH_SETS, "train.batch_size": "1024"}, 44170, 1),
    ("smoke", {**BENCH_SETS, **WIDE_SETS}, 44170, 1),  # the wide paths: H != D, an untied projection
    ("lstm_bpr_foursquare", WIDE_SETS, 35880, 1),
    ("strnn_gowalla", WIDE_SETS, 36969, 1),
    ("smoke", {**BENCH_SETS, **WIDER_SETS}, 44170, 1),  # the wider paths: D = H = 1024
    ("attention_gowalla", WIDER_SETS, 36969, 1),
    ("smoke", {"model.tie_output_embedding": "false", "model.num_layers": "2"}, 512, 1),
], ids=lambda v: v if isinstance(v, str) else None)
def test_step_flops_equals_bench_py(preset, overrides, num_pois, model_shards):
    """``_timing.step_flops`` counts to the FLOP what ``bench.py``'s
    ``_step_flops`` counts, on the same overrides and catalog (poi_tpu's
    ``Config`` and ``DataDims`` on the JAX side)."""
    from poi_tpu.models.base import DataDims as JaxDims

    cfg = get_config(preset).with_overrides(overrides)
    sizes = dict(num_users=100, num_pois=num_pois, num_time_buckets=168, num_geo_buckets=64, num_tgap_buckets=8,
                 num_dist_buckets=8)
    dims, jdims = DataDims(**sizes).padded_to(model_shards), JaxDims(**sizes).padded_to(model_shards)
    got = _timing.step_flops(cfg, dims)
    want = _bench_py()._step_flops(JaxConfig.from_dict(cfg.to_dict()), jdims)
    assert got == want and got > 0


def _rows(out: list[str], pattern: str) -> list[re.Match]:
    return [m for line in out if (m := re.match(pattern, line))]


ROW = (r" +[\d,.]+ seq/s \( *[\d.]+ ms/step, MFU not measured \(cpu\), analytic ([\d.]+) GFLOP/step\)$")


def test_bench_variants_prints_a_row_a_point(capsys, monkeypatch):
    """The sweep shrunk (a tiny bench workload, two batches x two chunk
    lengths, one window): a row a point in order, each with its analytic
    GFLOP; no MFU on the CPU."""
    monkeypatch.setattr(bench_variants, "OVERRIDES", {**bench_variants.OVERRIDES, **SMALL})
    monkeypatch.setattr(bench_variants, "BATCHES", (8, 16))
    monkeypatch.setattr(bench_variants, "SPCS", (2, 4))
    monkeypatch.setattr(bench_variants, "MIN_STEPS", 4)
    out = _run(capsys, bench_variants, ["1"])
    rows = _rows(out, r"batch= +(\d+) spc= +(\d+):" + ROW)
    assert [(int(m.group(1)), int(m.group(2))) for m in rows] == [(8, 2), (8, 4), (16, 2), (16, 4)], out
    ds = load_dataset(get_config("smoke").with_overrides(bench_variants.OVERRIDES).data)
    for m in rows:
        cfg = get_config("smoke").with_overrides({**bench_variants.OVERRIDES, "train.batch_size": m.group(1)})
        assert m.group(3) == f"{_timing.step_flops(cfg, DataDims.from_dataset(ds)) / 1e9:.1f}"


def test_bench_attn_step_prints_a_row_a_point(capsys, monkeypatch):
    """Config #4 shrunk (synthetic, 32-d, S = 64, chunks of 2): batch x
    table update in ``ATTN_BENCH_MODES``' order; a bad list exits before
    any work, as the reference's does."""
    monkeypatch.setattr(bench_attn_step, "OVERRIDES", {
        **bench_attn_step.OVERRIDES, **SMALL, "data.dataset": "synthetic", "loss.num_sampled": "64",
        "train.steps_per_call": "2"})
    monkeypatch.setattr(bench_attn_step, "BATCHES", (8, 16))
    monkeypatch.setattr(bench_attn_step, "STEPS", 4)
    monkeypatch.setattr(bench_attn_step, "REPEATS", 1)
    monkeypatch.setenv("ATTN_BENCH_MODES", "dense, sparse")
    out = _run(capsys, bench_attn_step, [])
    rows = _rows(out, r"attention batch= +(\d+) \((sparse|dense) *\):" + ROW)
    assert [(int(m.group(1)), m.group(2)) for m in rows] == [(8, "dense"), (8, "sparse"), (16, "dense"),
                                                              (16, "sparse")], out
    for bad in ("sparse,fast", " , "):
        monkeypatch.setenv("ATTN_BENCH_MODES", bad)
        with pytest.raises(SystemExit, match="ATTN_BENCH_MODES must be a comma list of sparse|dense"):
            bench_attn_step.main(CPU)


def test_bench_cells_rows_and_refused_widths(capsys, monkeypatch):
    """Past the LSTM's and the RNN's width limits the wrapper refuses (on the
    card; here a stand-in raises its message) and the refusal is the row."""
    assert bench_cells.POINTS["lstm"][:2] == ((64, 128), (256, 128)) and (256, 512) in bench_cells.POINTS["gru"]
    for mod, name, limit in ((fused_lstm, "fused_lstm_scan", 512), (fused_rnn, "fused_rnn_scan", 640)):
        real = getattr(mod, name)

        def limited(x, mask, w, real=real, name=name, limit=limit):
            if w.shape[0] > limit:
                raise ValueError(f"{name}: H={w.shape[0]} is not taken by the kernels: ... so H <= {limit}")
            return real(x, mask, w)
        monkeypatch.setattr(mod, name, limited)
    for name, value in {"T": 3, "ITERS": 1, "PLAIN_ITERS": 1, "POINTS": {
            "gru": ((2, 8),), "lstm": ((3, 8), (1, 513)), "rnn": ((2, 16), (1, 641))}}.items():
        monkeypatch.setattr(bench_cells, name, value)
    out = _run(capsys, bench_cells, [])
    rows = {tuple(line.split()[:3]): line for line in out[2:]}
    assert set(rows) == {("gru", "2", "8"), ("lstm", "3", "8"), ("lstm", "1", "513"), ("rnn", "2", "16"),
                         ("rnn", "1", "641")}
    assert "refused: fused_lstm_scan: H=513" in rows["lstm", "1", "513"] and "H <= 512" in rows["lstm", "1", "513"]
    assert "refused: fused_rnn_scan: H=641" in rows["rnn", "1", "641"] and "H <= 640" in rows["rnn", "1", "641"]
    assert len(rows["gru", "2", "8"].split()) == 10  # cell, B, H, six times and ratios, no cuDNN on the cpu


def test_bench_cells_stops_on_any_other_error(capsys, monkeypatch):
    """Only the width refusal is printed as a row: a point whose inputs are
    built wrong (here the LSTM given three gates' columns, not four) raises
    the wrapper's shape error out of main()."""
    for name, value in {"T": 3, "ITERS": 1, "PLAIN_ITERS": 1, "POINTS": {"lstm": ((2, 8),)},
                        "GATES": {**bench_cells.GATES, "lstm": 3}}.items():
        monkeypatch.setattr(bench_cells, name, value)
    with pytest.raises(ValueError, match=r"fused_lstm: need xw \[B,T,4H\]"):
        bench_cells.main(CPU)


def test_bench_serve_prints_four_batches(capsys, monkeypatch):
    monkeypatch.setattr(bench_serve, "BENCH_OVERRIDES", {**bench_serve.BENCH_OVERRIDES, "data.num_users": "64"})
    monkeypatch.setattr(bench_serve, "REPS", 2)
    out = _run(capsys, bench_serve, ["--num-pois", "300", "--dim", "32"])
    batches = [int(m.group(1)) for line in out if (m := re.match(r"batch= *(\d+): p50 .* p99 .* req/s", line))]
    assert batches == [1, 8, 64, 256]
    assert out[-1].startswith("marginal cost ")


def test_quality_runs_prints_the_row(capsys):
    out = _run(capsys, quality_runs, ["gru_foursquare_nyc", "data.num_users=64", "data.num_pois=400",
                                      "data.max_seq_len=12", "train.num_steps=10", "train.eval_every=5",
                                      "train.log_every=5", "train.warmup_steps=2"])
    row = out[-1]
    assert row.startswith("ROW gru_foursquare_nyc: steps=10 ")
    assert re.search(r"r@10=0\.\d{4} ndcg@10=0\.\d{4} \[selected step (5|10) val recall@10=", row)
    assert re.search(r"\| pop r@1=0\.\d{4} r@5=0\.\d{4} r@10=0\.\d{4} ndcg=0\.\d{4} \|", row)
    assert "seq/s (median window)" in row and ("BEATS POP" in row or "BELOW FLOOR" in row)


def _row_numbers(row: str) -> dict:
    return {k: float(v) for k, v in re.findall(r" (loss|r@10)=([0-9.]+)", row.split(" | ")[0])}


# Config #5 at TINY_1M's size with a val split, selected every 10 of 20 steps.
MESH_QUALITY_SETS = [f"{k}={v}" for k, v in {
    **TINY_1M, "data.min_poi_checkins": "1", "data.val_fraction": "0.1", "train.batch_size": "8",
    "train.num_steps": "20", "train.eval_every": "10", "train.log_every": "5", "train.warmup_steps": "2"}.items()]


def test_quality_runs_on_a_mesh_matches_one_rank(capsys, tmp_path):
    """``quality_runs`` on 4 gloo ranks (config #5's 1 x 4, a2a at capacity
    factor 4, where no id drops): rank 0 prints one ``ROW`` (and the a2a
    drop line, a share of 0), the other ranks none, and the row's loss and
    recall@10 are the one-rank run's to PERF.md §2's limits (1e-3
    relative, 0.01)."""
    from poi_tpu_torch.parallel.launch import spawn

    argv = ["multihost_1m", *MESH_QUALITY_SETS, "mesh.model=4", "mesh.a2a_capacity_factor=4", *CPU]
    spawn("tests.torch_mesh_jobs:quality_job", 4, {"argv": argv}, timeout=300, cwd=REPO, log_dir=str(tmp_path),
          env={"POI_TPU_TORCH_DATA_CACHE": "off", "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO})
    logs = [(tmp_path / f"rank{r}.log").read_text().splitlines() for r in range(4)]
    rows = [[line for line in log if line.startswith("ROW ")] for log in logs]
    assert len(rows[0]) == 1 and not any(rows[1:]), rows
    assert rows[0][0].startswith("ROW multihost_1m: steps=20 ") and " mesh=1x4 " in rows[0][0]
    drops = [line for line in logs[0] if line.startswith("a2a lookup at mesh.a2a_capacity_factor=4.0: ")]
    assert len(drops) == 1 and "dropped a share 0.000000 " in drops[0], drops
    one = _run(capsys, quality_runs, ["multihost_1m", *MESH_QUALITY_SETS, "mesh.model=1"])[-1]
    assert one.startswith("ROW multihost_1m: steps=20 ") and " mesh=1x1 " in one
    got, want = _row_numbers(rows[0][0]), _row_numbers(one)
    assert abs(got["loss"] - want["loss"]) <= 1e-3 * want["loss"], (got, want)
    assert abs(got["r@10"] - want["r@10"]) <= 0.01, (got, want)


def _jax_split(tree, vp):
    table = dense = 0
    for x in jax.tree.leaves(tree):
        b = int(np.prod(x.shape)) * x.dtype.itemsize
        if x.ndim >= 1 and x.shape[0] == vp:
            table += b
        else:
            dense += b
    return table, dense


@pytest.mark.parametrize("preset, overrides", [
    ("smoke", {}),  # dense Adam (optax: clip, scale_by_adam, the schedule)
    ("attention_gowalla", {"data.dataset": "synthetic", "loss.num_sampled": "64"}),  # lazy Adam
    ("lstm_bpr_foursquare", {"loss.num_negatives": "4"}),  # a user table beside the catalog's
])
def test_mem_budget_accounting_equals_poi_tpus(preset, overrides):
    """The port's params and optimizer state bytes, tables and dense, equal
    the leaves of jax.eval_shape(poi_tpu Trainer.init_state) but for one
    named difference: poi_tpu keeps each optimizer step count as an int32
    device scalar (optax's adam and schedule counts, or SparseAdamState's),
    the port as a host int."""
    cfg = get_config(preset).with_overrides({**SMALL, **overrides})
    ds = load_dataset(cfg.data)
    trainer = Trainer(cfg, DataDims.from_dataset(ds), device="cpu")
    got = mem_budget.accounting(trainer, trainer.init_state())

    jt = JaxTrainer(JaxConfig.from_dict(cfg.to_dict()), JaxDataDims.from_dataset(ds))
    abstract = jax.eval_shape(jt.init_state)
    vp = jt.dims.num_pois_padded
    assert vp == trainer.dims.num_pois_padded
    pt, pd = _jax_split(abstract.params, vp)
    ot, od = _jax_split(abstract.opt_state, vp)
    counts = [x for x in jax.tree.leaves(abstract.opt_state) if x.ndim == 0]
    assert counts and all(x.dtype == np.int32 for x in counts)
    assert (got["params_tables"], got["params_dense"], got["opt_tables"]) == (pt, pd, ot)
    assert got["opt_dense"] + 4 * len(counts) == od
    assert got["params_tables"] > 0 and got["opt_tables"] == 2 * got["params_tables"]


def test_mem_budget_runs_a_step(capsys, monkeypatch):
    """A device-sampled chunk at the smoke size; then config #5's
    rows-gradient step (forced at a tiny size by a threshold of 0), whose
    table gradient is its [N, D + 1] rows."""
    from poi_tpu_torch.train import sparse_opt

    out = "\n".join(_run(capsys, mem_budget, ["smoke", "--set", *SMALL_SET, "data.sampler=device",
                                              "train.steps_per_call=2"]))
    assert "params      tables" in out and "opt state   tables" in out and "one step_sampled chunk of 2 steps" in out
    monkeypatch.setattr(sparse_opt, "DENSE_LAZY_MAX_BYTES", 0)
    out = "\n".join(_run(capsys, mem_budget, ["multihost_1m", "--set", *SMALL_SET, "mesh.model=1",
                                              "mesh.embedding_mode=psum", "loss.num_sampled=64",
                                              "train.batch_size=8"]))
    n = 2 * 8 * 12 + 64
    assert "(rows-gradient step, gather/scatter lazy Adam)" in out and f"[{n:,}, D + 1] rows" in out
    assert "one Trainer.step on a host batch" in out


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_script_refuses_cuda_without_a_card(name):
    """``--device`` defaults to cuda, and a run asked for the card on a
    machine without one stops: no fallback to the CPU."""
    module, argv = SCRIPTS[name]
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="torch.cuda.is_available"):
        module.main(argv)


def test_scripts_run_as_modules():
    """Every script runs as ``python -m poi_tpu_torch.scripts.<name>`` (its
    ``--help`` here)."""
    code = ("import runpy, sys\n"
            "for name in sys.argv[1:]:\n"
            "    sys.argv = [name, '--help']\n"
            "    try:\n"
            "        runpy.run_module(f'poi_tpu_torch.scripts.{name}', run_name='__main__')\n"
            "    except SystemExit as e:\n"
            "        assert e.code == 0, (name, e.code)\n"
            "    print('ran', name)\n")
    proc = subprocess.run([sys.executable, "-c", code, *sorted(SCRIPTS)], capture_output=True, text=True, cwd=REPO,
                          timeout=300, env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert [line for line in proc.stdout.splitlines() if line.startswith("ran ")] == [f"ran {n}" for n in
                                                                                      sorted(SCRIPTS)]


def _spawned(capfd, module, argv) -> list[str]:
    """A script whose ranks print from their own processes (stdout is the
    file descriptor's)."""
    assert module.main(argv + CPU) == 0
    return [line for line in capfd.readouterr().out.splitlines() if "socket.cpp" not in line]


def test_compare_embedding_modes_prints_both_modes_at_each_mesh(capfd):
    """Four gloo ranks: model 2 (data 2) and 4 (data 1), psum and a2a, each
    row's payload the sum of its breakdown and the wire below it."""
    out = _spawned(capfd, compare_embedding_modes, ["--dim", "16", "--vocab", "1024", "--batch", "16",
                                                    "--seqlen", "8"])
    rows = [line.split() for line in out if re.match(r" +[248] +[124] +(psum|a2a) ", line)]
    assert [(r[0], r[1], r[2]) for r in rows] == [("2", "2", "psum"), ("2", "2", "a2a"), ("4", "1", "psum"),
                                                  ("4", "1", "a2a")]
    assert all(float(r[4]) <= float(r[3]) + 0.01 for r in rows)
    assert any("psum/fwd=" in line for line in out) and any("all_to_all/bwd=" in line for line in out)


def test_compare_attention_modes_prints_three_impls_at_each_mesh(capfd):
    out = _spawned(capfd, compare_attention_modes, ["--dim", "16", "--heads", "4", "--batch", "8", "--seqlen", "8",
                                                    "--window", "3"])
    rows = [line.split() for line in out if re.match(r" +[248] +[124] +(blockwise|ring|ulysses) ", line)]
    assert [(r[0], r[2]) for r in rows] == [(m, i) for m in ("2", "4") for i in ("blockwise", "ring", "ulysses")]
    ring = next(line for line in out if re.match(r" +4 +1 +ring ", line))
    assert "ppermute_ring/fwd=" in ring and "split/bwd=" in ring and "all_gather/fwd=" in ring
    assert next(r for r in rows if r[:3] == ["4", "1", "blockwise"])[5] == "(none)"


def test_scaling_bench_records_the_row_and_names_the_rig(capfd, tmp_path):
    """Two local gloo ranks: rank 0 appends the row and prints the table;
    then one process alone adds the N = 1 row, the efficiency's base."""
    out_file = tmp_path / "scaling.json"
    argv = ["--steps", "4", "--warmup", "1", "--repeats", "1", "--out", str(out_file), "--set", *SMALL_SET]
    out = _spawned(capfd, scaling_bench, ["--local-processes", "2", *argv])
    assert any(line.startswith("SCALING ") and '"processes": 2' in line for line in out)
    out = _spawned(capfd, scaling_bench, argv)
    import json

    rows = json.loads(out_file.read_text())
    assert [r["processes"] for r in rows] == [1, 2] and rows[1]["rig"] and not rows[0]["rig"]
    assert re.match(r" +2 +[\d.]+ +[\d.]+ +[\d.]+%", [line for line in out if line.lstrip().startswith("2 ")][0])


def test_check_cell_parity_prints_every_gradient(capsys, monkeypatch):
    """Both cells (here the plain versions on both sides, so no difference):
    a forward line and one line a parameter and the input."""
    monkeypatch.setattr(check_cell_parity, "SHAPES", (("lstm", 4, 6, 8), ("gru", 3, 5, 16)))
    out = _run(capsys, check_cell_parity, [])
    assert [line.split(":")[0] for line in out if line.startswith(("lstm", "gru"))] == \
           ["lstm B=4 T=6 H=8", "gru B=3 T=5 H=16"]
    assert sum(line.strip().startswith(("dwx", "dwh", "db", "dx")) for line in out) == 8
    assert "DIVERGES" not in "\n".join(out) and out[-1] == "0 gradient(s) diverged past 0.05"


def _bench_eval_path(capsys, monkeypatch, sets: dict) -> list[str]:
    """Config #4 and config #5 shrunk (config #5's catalog forced to 3,000)
    with ``sets`` on both: each one's line."""
    tiny = {**SMALL, "data.dataset": "synthetic", "data.val_fraction": "0", "model.dropout": "0", **sets}
    monkeypatch.setattr(bench_eval_path, "CASES", (
        ("attention_gowalla", tiny, 16, None),
        ("multihost_1m", {**TINY_1M, "mesh.model": "1", "mesh.embedding_mode": "psum", **sets}, 8, 3000)))
    monkeypatch.setattr(bench_eval_path, "ITERS", 1)
    out = _run(capsys, bench_eval_path, [])
    rows = [line for line in out if "full-T path" in line]
    assert [r.split()[0] for r in rows] == ["attention_gowalla", "multihost_1m"]
    assert "V=3000" in rows[1]
    return rows


def test_bench_eval_path_prints_both_configs(capsys, monkeypatch):
    """The presets' blockwise attention: both paths' queries agree to bf16
    rounding (BLOCKWISE_LAST_TOL): the full-T path rounds the unnormalised
    p to bf16, as poi_tpu's blockwise form does, the last-position path the
    normalised p, as poi_tpu's does."""
    rows = _bench_eval_path(capsys, monkeypatch, {})
    diffs = [float(re.search(r"max \|diff\| ([\d.e+-]+)", r).group(1)) for r in rows]
    assert all(d <= BLOCKWISE_LAST_TOL for d in diffs), diffs


def test_bench_eval_path_vanilla_paths_agree_exactly(capsys, monkeypatch):
    """The vanilla attention, whose normalised bf16 p the last-position path
    shares: both paths' queries the same bits."""
    rows = _bench_eval_path(capsys, monkeypatch, {"model.attn_impl": "vanilla"})
    assert all("max |diff| 0.00e+00" in r for r in rows), rows


@pytest.mark.parametrize("spc", ["1", "2"])
def test_host_feed_prints_each_feed_and_puts_train_back(capsys, spc):
    """Every feed, a round of each, at one step a call and at chunks of 2
    (whose tail replays the chunk); afterwards ``train()`` has its own
    loader and prefetcher again."""
    from poi_tpu_torch.data.pipeline import DevicePrefetcher, make_train_loader
    from poi_tpu_torch.train import loop

    out = _run(capsys, host_feed, ["--config", "smoke", "--spc", spc, "--steps", "3", "--warmup", "1", "--rounds",
                                   "1", "--set", *SMALL_SET])
    for kind in ("round 1", "median"):
        rows = [line for line in out if line.startswith(kind)]
        assert [r.split()[2 if kind == "round 1" else 1] for r in rows] == list(host_feed.FEEDS), rows
        assert all(float(re.search(r": ([\d.]+) seq/s", r).group(1)) > 0 for r in rows)
    assert loop.make_train_loader is make_train_loader and loop.DevicePrefetcher is DevicePrefetcher


@pytest.mark.parametrize("module, names", [(tune_strnn, ("base", "h256")), (tune_attention, ("base", "user"))])
def test_tune_scripts_print_a_probe_line_each(capsys, monkeypatch, module, names):
    """The probes shrunk (their overrides, the steps an argument); each is
    scored on val beside the popularity floor."""
    tiny = {**SMALL, "data.dataset": "synthetic", "train.batch_size": "8", "loss.num_sampled": "64"}
    monkeypatch.setattr(module, "BASE", {**module.BASE, **tiny})
    monkeypatch.setattr(module, "PROBES", {n: {**tiny, **module.PROBES[n]} for n in names})
    out = _run(capsys, module, ["3"])
    probes = [line for line in out if line.startswith("PROBE")]
    assert [p.split()[1] for p in probes] == [f"{n}:" for n in names]
    assert all(" VAL r@1=" in p and "| pop r@10=" in p for p in probes)
