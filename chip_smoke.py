#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port: serving config #1, training,
configs #2 to #5, the multi-GPU layer on the one card, and the measurement
scripts.

    python3 chip_smoke.py          # from the repository root, on a machine with one CUDA card

Builds the port's CUDA kernels from ``poi_tpu_torch/csrc`` and compares each
with its plain PyTorch version on the card. Then it drives the paths:

- serving: 256 requests of config #1 (``gru_foursquare_nyc``: GRU 64-d,
  T=64, 6,749-POI catalog, random weights from a fixed seed) through
  ``Recommender`` and ``python -m poi_tpu_torch serve``;
- training: 20 device-sampled steps of the workload ``bench.py`` times (GRU
  128-d, T=64, batch 512, bf16, 44,170-POI catalog, full-catalog CE) through
  ``train()``, on the kernel path and on the plain path, then ``evaluate()``
  on test; a few steps of config #1; and ``python -m poi_tpu_torch train``
  on config #1 and on the bench workload;
- config #4 (``attention_gowalla``: GRU 256-d + windowed attention, T=128,
  batch 64, dropout 0.3, sampled softmax over 1,024 negatives, lazy Adam,
  36,969-POI catalog): 20 device-sampled steps through ``train()`` on both
  paths, ``evaluate()``, ``Recommender`` at request batch 1 and 256 on both
  paths, and ``python -m poi_tpu_torch train``;
- config #2 (``lstm_bpr_foursquare``: LSTM 128-d + user embedding, BPR with
  32 negatives a position, T=64, batch 64, 35,880 POIs) and config #3
  (``strnn_gowalla``: ST-RNN 128-d, 8 time-gap and 8 distance buckets, user
  embedding, dropout 0.5, full CE over 36,969 POIs, T=32, batch 64), each the
  same way as config #4;
- the wide path (the bench workload at D = 512, H = 1024: GRU widths past
  the clusters' 640 on the grid-resident kernels, the full-catalog CE at D =
  512): ``python -m poi_tpu_torch train`` 20 steps with B1, B2, B7 and B8
  launched, 5 steps through ``train()`` on both paths, and ``Recommender``
  at request batch 1 and 256 on both paths; before it, B1 and B2 at H =
  648, 768, 1024 and the limit, B7 and B8 at D = 384 and 512;
- the wide LSTM and ST-RNN paths (configs #2 and #3 at D = 512, H = 1024:
  the LSTM past the clusters' 512 and the RNN past their 640 on the
  grid-resident kernels): ``python -m poi_tpu_torch train`` 20 steps with
  B3 and B4, or B5, B6, B7 and B8, launched, 5 steps through ``train()`` on
  both paths, and ``Recommender`` at request batch 1 and 256 on both
  paths; before them, B3/B4 at H = 520, 768, 1024 and the limit, B5/B6 at
  H = 648, 768, 1024 and the limit;
- the wider paths (the bench workload and config #4 at D = H = 1024, the
  losses past D = 512 on the K-chunked kernels): ``python -m poi_tpu_torch
  train`` 10 steps with B1, B2, B7 and B8 (config #4: B9 and B10) and B11
  launched, 5 steps through ``train()`` on both paths, and ``Recommender``
  at request batch 1 and 256 on both paths; before them, B7 and B8 at D =
  600, 768, 1000 and 1024, B9 and B10 at 640, 768 and 1024, the kernels'
  block plans held to their Python mirrors, and D = 1025 refused;
- config #5 on one card (``multihost_1m --set mesh.model=1
  mesh.embedding_mode=psum data.min_poi_checkins=1 data.val_fraction=0.05``:
  GRU 512-d + 8-head attention, T=64, batch 512, sampled softmax over 4,096
  negatives at D = 512, the rows-gradient step with gather/scatter lazy
  Adam, 903,889 POIs): 20 device-sampled steps through ``train()`` on both
  paths, ``evaluate()`` on val, the rows step against the dense-gradient
  step and its bits run to run, ``Recommender`` at request batch 1 and 256
  on both paths, and ``python -m poi_tpu_torch train``;
- the multi-GPU layer on this card (the ``mesh`` phase): 4 ranks, processes
  that share the card over gloo, train config #5 on its preset's 1 x 4 mesh
  (a2a lookups) and the bench workload on 2 x 2 (psum lookups, the sharded
  CE) through ``train()`` and ``evaluate()``, each held to its one-rank run
  (losses, config #5's table after step 1, the top-k at the init); config
  #5 at the preset's own a2a capacity, its drops counted; B1, B2, B9, B10
  and B11 launched on every rank and rank 0's calls held to their plain
  versions; NCCL at world size 1 against gloo. A correctness and cost rig:
  no scaling figure;
- checkpoint and resume: ``python -m poi_tpu_torch train`` on configs #1
  and #4 uninterrupted (twice) and stopped by ``train.fault_inject_step``
  then resumed, the final steps compared tensor by tensor; ``eval``,
  ``recommend`` and ``serve`` from the checkpoints; ``--metrics-dir`` and
  ``--profile-dir``; a step file's size and its save and restore times;
- the sweep of the CE forward's variants (B12, ``scripts/sweep_ce_fwd``),
  B12's main path, called in this process at its own shape;
- the measurement scripts (``python -m poi_tpu_torch.scripts.<name>``), each
  once as a subprocess.

It times the kernels against their plain versions (and against a PyTorch
call that computes the same function, where there is one), ``recommend``
and the train steps.

    python3 chip_smoke.py --ab DIR  # DIR: another checkout, e.g. the parent commit's

instead times the kernels a change redesigns (``AB_TIMED``) at their main
path's shapes in both checkouts on this card, in turns (DIR, this, this,
DIR), each in a fresh process with its checkout's own wrappers and
helpers, logs how far their outputs moved, and asserts that the kernels it
must leave alone (``AB_KEPT``) give DIR's bits. Any failed phase prints
its traceback and exits non-zero. The last lines of standard output are the
card's name and power limit, the kernels' JSON record (each with its least
possible time on the card, ``bound_ms``) and ``{"ok": true, "device":
{...}}``. Imports nothing of JAX and nothing of the JAX package
``poi_tpu``.
"""

from __future__ import annotations

import inspect
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parent
if not (REPO / "poi_tpu_torch").is_dir():
    sys.exit(f"error: {REPO} is not a checkout of the repository (no poi_tpu_torch/)")
sys.path.insert(0, str(REPO))
# The timer, the cuDNN yardstick and the bench workload are the measurement scripts'.
from poi_tpu_torch.scripts import _timing  # noqa: E402
from poi_tpu_torch.scripts._timing import cudnn_ms, time_ms  # noqa: E402

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
# Top-k values: fp32 sums of 64 or 128 exact bf16 products, scores of
# magnitude <= ~50, in different orders differ by a few ulps of ~50
# (4e-6 each), far below 1e-4.
TOPK_TOL = 1e-4
# GRU backward, relative to each output's largest element: kernel and plain
# version keep every cotangent fp32 and differ only in fp32 summation order
# (3H terms per step for dh, B·T = 32,768 terms for dwh) and in expf/tanhf.
# A cotangent rounded to bf16 anywhere would show at ~4e-3.
GRU_BWD_TOL = 1e-5
# CE forward, absolute: fp32 sums of up to 44,170 exponentials in different
# orders, each exp within ~2 ulp; lse is ~10.
CE_LSE_TOL = 1e-4
# CE backward dq and dtable, relative to their largest element: gp is rounded
# to bf16 before the products, and where the kernel's exp and torch's differ
# by an ulp, gp can round to the neighbouring bf16 value (2^-8 apart) for a
# few terms of the sum. dbias sums the unrounded gp: fp32 order only.
CE_GRAD_TOL = 2e-3
CE_DBIAS_TOL = 1e-5
# B10 at these widths is held element by element to the bound that its
# arithmetic allows (b10_bound_ratios), not to CE_GRAD_TOL: at D = 512 the
# max-over-max ratio reached 1.71e-3 and 2.03e-3 on correct runs.
B10_BOUND_DIMS = (512,)

# The training workload bench.py times (bench.py:126-153, 44,170 POIs and
# 4,925 training windows after filtering) at batch 512, device-sampled in
# 40-step chunks, evaluated through the top-k kernel.
BENCH_OVERRIDES = {
    **_timing.BENCH_OVERRIDES,
    "train.batch_size": "512",
    "train.steps_per_call": "40",
    "data.sampler": "device",
    "eval.topk_impl": "pallas",
}
PLAIN_OVERRIDES = {"model.cell_impl": "scan", "loss.impl": "xla", "eval.topk_impl": "xla"}
TRAIN_STEPS = 40
# Steps a path through train() in the train, config #2-#4 phases (40, as
# TRAIN_STEPS, before the wider paths' phases came).
PATH_STEPS = 20
# Per-step loss, kernel path vs plain path, relative. Step 1: the same params
# and batch, so only summation order and the CE's target logit differ (fp32
# operands in the fused CE, bf16 ones in the dense oracle; the logits are
# ~1e-3 at init). Later steps: the gradients differ at bf16 resolution (the
# dense oracle's autodiff rounds dq and dtable to bf16, the scan cell's the
# recurrent cotangent; the kernels keep fp32), and Adam turns that into
# parameter moves of up to ±lr for elements whose gradient is within it.
LOSS_TOL_FIRST = 1e-5
LOSS_TOL_LAST = 1e-3  # measured ~4e-5 at step 40 on an H100
# recall@10 of one model through the top-k kernel and through its plain
# version: only near-tie swaps move a hit.
RECALL_TIE_TOL = 1e-3
# recall@10 of the kernel-trained and the plain-trained model, whose
# parameters drift apart as above.
RECALL_PATH_TOL = 1e-2
# LSTM (config #2's train shape) and RNN (config #3's), the forward at the
# valid steps, absolute. Kernel and plain version round h to bf16 before the
# recurrent product and sum exact products in fp32 in different orders; where
# h straddles a bf16 rounding boundary the two round apart. The LSTM's gates
# damp such a flip; the RNN's tanh chain has no gate to damp it (two fp32
# summation orders of the plain version differ by ~4e-4 (LSTM) and ~4e-3 (RNN)
# at these shapes on the CPU), so its tolerance is wider. A wrong gate, blend
# or carry moves h by ~1e-1.
LSTM_TOL = 5e-3
RNN_TOL = 2e-2
# Their backward, relative to each output's largest element: kernel and plain
# version get the same hs (and cs), so the gate recompute rounds the same
# bf16 h_prev; they differ in fp32 summation order only (4H or H terms a
# step for dh, B·T for dwh), as the GRU's.
REC_BWD_TOL = GRU_BWD_TOL
# (B, T, H): config #2's and config #3's train shapes first, then a ragged
# batch and a width of two rows a block; the LSTM also at a width that is no
# multiple of 8 (the kernels zero-pad the last octet), at 169 and 170 (the
# old limits), at 200 (ragged, above them), at the reference's 256-d config
# #2 probe (config #2's B and T), and at 512, the pair's limit
# (lstm_max_hidden()).
LSTM_SHAPES = ((64, 64, 128), (7, 64, 128), (33, 16, 64), (9, 64, 100), (7, 64, 169), (5, 64, 170), (7, 64, 200),
               (64, 64, 256), (3, 64, 512))
# B3 timed beside cuDNN's nn.LSTM forward (B, T, H): serving's request batch
# 1 and 256 at config #2's width, and the reference's 256-d config #2 probe.
LSTM_TIMED = {"b1": (1, 64, 128), "b256": (256, 64, 128), "h256": (64, 64, 256)}
# B3's cluster choice, timed at each cluster that fits (B, T, H): config #2's
# train shape, serving's request batch 1 and 256, then H = 256 and H = 64 at
# config #2's B and T (the widths where the pick is 8 and 2 blocks).
LSTM_CLUSTER_CASES = ((64, 64, 128), (1, 64, 128), (256, 64, 128), (64, 64, 256), (64, 64, 64))
# The RNN also at widths that are no multiple of 16 (the kernels zero-pad
# the last octet and K; 45 is no multiple of 4 either, so B5 moves xin by
# cp.async, on 300 rows), at 339 (the old limit), 512, and 640 (the pair's
# limit, rnn_max_hidden()), and at serving's request batch 1.
RNN_SHAPES = ((64, 32, 128), (7, 32, 128), (33, 16, 64), (9, 32, 100), (300, 16, 45), (5, 32, 339), (5, 32, 512),
              (3, 32, 640), (1, 32, 128))
# B5 timed beside cuDNN's nn.RNN forward (B, T, H): serving's request batch
# 1 and 256 at config #3's width, and H = 512 at batch 256; B6 also at the
# last (``h512``).
RNN_TIMED = {"b1": (1, 32, 128), "b256": (256, 32, 128), "h512": (256, 32, 512)}
# B5's cluster choice, timed at each cluster and rows a group that fit
# (B, T, H): config #3's train shape, serving's request batch 1 and 256,
# then H = 64, 339 and 512 at config #3's B and T, and H = 512 at batch 256
# (where 8-row groups on clusters of 8 would not all fit on the card).
RNN_FWD_CLUSTER_CASES = ((64, 32, 128), (1, 32, 128), (256, 32, 128), (64, 32, 64), (64, 32, 339), (64, 32, 512),
                         (256, 32, 512))
# B6's cluster choice, timed at each cluster that fits (B, T, H): config
# #3's train shape, then H = 64, 339 and 512 at its B and T (the pick is 8
# blocks at H = 128, 339 and 512, 4 at H = 64), then H = 128 at a batch of 7
# and of 256 (where the pick's clusters of 8-row groups would not all fit,
# so it takes 16-row groups; smaller clusters keep 8).
RNN_CLUSTER_CASES = ((64, 32, 128), (64, 32, 64), (64, 32, 339), (64, 32, 512), (7, 32, 128), (256, 32, 128))
# B3/B4 and B5/B6 past the clusters' widths (512, 640), on the grid-resident
# kernels (B, T, H): the wide paths' train shapes (config #2's and #3's at
# H = 1024, where both directions are also timed), 5 rows at 768, and 7 rows
# just past the clusters' limits (520, ragged for the LSTM; 648); then each
# pair's limit (lstm_max_hidden(), rnn_max_hidden()) on 3 rows.
LSTM_WIDE_H1024 = (64, 64, 1024)
LSTM_WIDE_SHAPES = (LSTM_WIDE_H1024, (5, 64, 768), (7, 32, 520))
RNN_WIDE_H1024 = (64, 32, 1024)
RNN_WIDE_SHAPES = (RNN_WIDE_H1024, (5, 32, 768), (7, 16, 648))
# The widths and batches at which the LSTM's and the RNN's Python dispatch
# (design, grid_shape) is held to the C side's picks.
REC_PICK_WIDTHS = (1, 20, 64, 128, 256, 511, 512, 513, 520, 600, 639, 640, 641, 648, 768, 1000, 1024, 1104, 1105, 1500,
                   1600, 1601, 2048, 2896, 2897, 3168, 3169, 4096)
REC_PICK_BATCHES = (1, 7, 64, 256, 512)
# Configs #2 and #3 at full width, device-sampled like config #4: the preset
# and the kernels its train step launches (the recurrence's forward first).
REC_CONFIGS = {"lstm": ("lstm_bpr_foursquare", ("lstm_fwd", "lstm_bwd")),
               "strnn": ("strnn_gowalla", ("rnn_fwd", "rnn_bwd", "ce_lse", "ce_bwd"))}
# The card's published peaks (NVIDIA H100 SXM data sheet, dense, at 700 W):
# the least time a function could take is the larger of its bytes (each input
# read once, each output written once) over the memory rate and its
# operations over the peak rate of their type.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12
# Exponentials (ex2, and log2 and the other special functions) go to the
# special-function units: 16 results a clock per SM at compute capability
# 9.0, against 128 fp32 FMAs (256 FLOP) a clock (NVIDIA's CUDA C++
# documentation, the throughput table of the arithmetic instructions), so a
# sixteenth of the fp32 rate above: 4.19e12 a second.
SFU_PER_S = FP32_FLOP_PER_S / 16
# Shapes the training kernels are timed at: the bench workload's GRU
# (B, T, H) and CE (N = B*T, V, D), and the dense-vs-fused CE cases around the
# 8,192 threshold (config #1's shape, then the bench shape at both catalogs).
GRU_TRAIN_SHAPE = (512, 64, 128)
CE_TRAIN_SHAPE = (32768, 44170, 128)
CE_C3_SHAPE = (2048, 36969, 128)  # config #3's CE: batch 64 x T=32 rows, 36,969 POIs
# B7/B8 at the widths past 128 (N, V, D, real POIs): config #3's shape at
# its 256-d probe (path 1), the bench shape at D = 256, and widths the
# kernels are not built for, padded with zero columns: 200 (to 256) on ragged
# N and V with a -1e30 tail, 130 (to 192).
CE_C3_D256 = (2048, 36969, 256)
CE_WIDE_CASES = (CE_C3_D256 + (36969,), (32768, 44170, 256, 44170), (300, 8193, 200, 8000), (1000, 5000, 130, 5000))
# B7/B8 at D = 384 and 512 (N, V, D, real POIs): config #3's shape at D =
# 512, the wide path's CE (the bench shape at D = 512), a ragged 384 with a
# -1e30 tail, and 300, which the kernels are not built for (run at 384).
CE_C3_D512 = (2048, 36969, 512)
CE_BENCH_D512 = (32768, 44170, 512)
CE_D512_CASES = (CE_C3_D512 + (36969,), CE_BENCH_D512 + (44170,), (300, 8193, 384, 8000), (1000, 5000, 300, 5000))
# B7/B8 at D = 768 and 1024, the K-chunked kernels (N, V, D, real POIs): the
# wider bench path's CE (the bench shape at D = 1024), config #3's shape at
# 768 (the forward's split-V, the backward's three column ranges), and widths
# the kernels are not built for: 600 (run at 768) on ragged N and V with a
# -1e30 tail, and 1000 (run at 1024).
CE_BENCH_D1024 = (32768, 44170, 1024)
CE_C3_D768 = (2048, 36969, 768)
CE_D1024_CASES = (CE_BENCH_D1024 + (44170,), CE_C3_D768 + (36969,), (300, 8193, 600, 8000), (1000, 5000, 1000, 5000))
# B8 at these widths is held element by element to the bound its arithmetic
# allows (ce_bound_ratios, b10_bound_ratios' without the hit mask) beside
# CE_GRAD_TOL of the max-over-max error: at D = 512 a block sums half the
# output columns, as B10's, whose correct runs reached 1.71e-3 and 2.03e-3.
B8_BOUND_DIMS = (384, 512)


def kchunked(D: int) -> bool:
    """Whether the loss kernels run width ``D`` (already padded) on the
    K-chunked design (csrc/kchunk.cuh). There B8 and B10 are held element by
    element by their bounds alone, every output (dq and dE or dtable by
    ``ce_bound_ratios`` / ``b10_bound_ratios``, db by the same bound's db
    term): a block sums a third or a quarter of the output columns and the
    logits' fp32 error grows with D, so the max-over-max errors pass
    CE_GRAD_TOL and CE_DBIAS_TOL on correct runs (dq 4.7e-3 at the bench
    shape at D = 1024, 0.18 of its element-wise bound; db 1.05e-5 on an
    all-hit pool at 1024, 0.001 of it)."""
    return D > 512
# B11's other main-path catalogs, (V, D, real POIs), each padded to a multiple
# of 2,048 with -1e30 rows as the eval and serving code pad them: the bench
# eval sweep's, config #4's eval sweep's, bench_serve's (70,953 POIs),
# config #5's, and the wider bench path's eval sweep at D = 1024.
TOPK_CATALOGS = {"eval": (45056, 128, 44170), "c4": (38912, 256, 36969), "serve70k": (71680, 256, 70953),
                 "c5": (905216, 512, 903889), "eval1024": (45056, 1024, 44170)}
CE_THRESHOLD_CASES = ((2048, 6749, 64), (32768, 6749, 128), (32768, 44170, 128))
# Config #4 at full width: GRU + attention 256-d, T=128, batch 64, dropout
# 0.3, sampled softmax (S=1,024), lazy Adam, 36,969 POIs. The device sampler
# draws its batches (configs #2 and #3 too); each config's step is timed over
# chunks of STEP_TIME_CHUNK steps (20 before the wider paths' phases came;
# the bench workload's over BENCH_TIME_CHUNK, 40 before).
ATTN_CONFIG = "attention_gowalla"
SAMPLER_OVERRIDES = {"data.sampler": "device", "train.steps_per_call": str(TRAIN_STEPS)}
STEP_TIME_CHUNK = 10
BENCH_TIME_CHUNK = 20
# The ported measurement scripts, each run once as a subprocess: the sweeps,
# bench_cells and bench_serve at their defaults (bench_serve also at --dim
# 1024: B1 on the grid, B11 at D = 1024); profile_step at the bench
# workload's batch and profile_attn at config #4's; mem_budget on the bench
# workload (one 40-step device-sampled chunk) and on config #4 (one
# host-loader step); quality_runs on config #1 cut from its 3,000 steps to
# 300 (best-on-val at 100, 200, 300); mem_budget on config #5 (one
# host-loader rows step), profile_1m at its default, bench_1m's training at
# V = 1M with the preset's lazy Adam (its top-k is timed in the timing phase
# at V = 903,889), step_time on the bench workload; tune_strnn and
# tune_attention at 25 steps a probe (50 before the wider paths' phases
# came; tune_strnn's h256 runs B7/B8 at D = 256), check_cell_parity (a
# DIVERGES line fails the run), bench_eval_path, compare_embedding_modes and
# compare_attention_modes on 4 gloo ranks sharing the card, scaling_bench on
# 2 of them (20 steps, one repeat; 60 and 3 before), host_feed one round of
# 25 steps (50 before).
SCRIPT_RUNS = (
    ("sweep_ce_fwd", []),
    ("sweep_ce_bwd", []),
    ("profile_step", ["--batch", "512"]),
    ("profile_attn", ["--batch", "64"]),
    ("bench_cells", []),
    ("bench_serve", []),
    ("bench_serve", ["--dim", "1024"]),
    ("mem_budget", ["smoke", "--set", *(f"{k}={v}" for k, v in BENCH_OVERRIDES.items())]),
    ("mem_budget", [ATTN_CONFIG]),
    ("quality_runs", [CONFIG, "train.num_steps=300", "train.eval_every=100"]),
    ("mem_budget", ["multihost_1m", "--set", "mesh.model=1", "mesh.embedding_mode=psum", "data.min_poi_checkins=1",
                    "data.val_fraction=0.05"]),
    ("profile_1m", []),
    ("bench_1m", ["--skip-topk", "--table-update", "sparse"]),
    ("step_time", ["bench"]),
    ("tune_strnn", ["25"]),
    ("tune_attention", ["25"]),
    ("check_cell_parity", []),
    ("bench_eval_path", []),
    ("compare_embedding_modes", []),
    ("compare_attention_modes", []),
    ("scaling_bench", ["--local-processes", "2", "--steps", "20", "--repeats", "1"]),
    ("host_feed", ["--rounds", "1", "--steps", "25"]),
)
# The GRU kernels at the larger widths: config #4's train shape, a ragged
# batch, config #5's width on a few rows and at its batch of 512, and the
# clusters' limit, 640 (past it the grid-resident kernels: GRU_WIDE_SHAPES).
GRU_FWD_H512 = (512, 64, 512)  # config #5's batch and width, where B1 is also timed
GRU_BIG_SHAPES = ((64, 128, 256), (7, 128, 256), (5, 64, 512), GRU_FWD_H512, (3, 64, 640))
# B1 at widths that are no multiple of 8 (B, H, blocks a row group that the
# kernel picks for them): H = 100 at a batch whose 69 row groups on clusters
# of 4 overflow the card (276 CTAs on 132 SMs), H = 200 on a cluster of 8,
# and H = 45, odd, whose xw rows are no multiple of 16 bytes (moved by 4-byte
# cp.async, not TMA).
GRU_FWD_RAGGED = ((1100, 100, 4), (7, 200, 8), (300, 45, 2))
# B1's cluster choice, timed at each cluster that fits (B, T, H): serving
# config #1 at request batch 1 and 256, the bench workload, config #4.
GRU_CLUSTER_CASES = ((1, 64, 64), (256, 64, 64), (512, 64, 128), (64, 128, 256))
# B1 and B2 past the clusters' 640, on the grid-resident kernels (B, T, H):
# the wide path's shape (the bench workload at H = 1024, where both are also
# timed), 5 rows at 768, and 7 rows at 648, ragged just past 640; then the
# pair's limit (gru_max_hidden()) on 3 rows.
GRU_WIDE_H1024 = (512, 64, 1024)
GRU_WIDE_SHAPES = (GRU_WIDE_H1024, (5, 64, 768), (7, 32, 648))
# The widths and batches at which the Python dispatch (fused_gru.design,
# grid_shape) is held to the C side's picks.
GRU_PICK_WIDTHS = (1, 20, 64, 100, 128, 256, 512, 600, 639, 640, 641, 648, 700, 768, 1000, 1024, 1500, 2048)
GRU_PICK_BATCHES = (1, 7, 64, 512, 1100)
# The kernels of B1's and B2's calls past 640: the grid forward; B2's gates
# pass, grid carry, outputs and dwh.
GRU_FWD_GRID_KERNELS = ("gru_fwd_grid_kernel",)
GRU_BWD_GRID_KERNELS = ("gru_bwd_gates", "gru_bwd_grid_carry", "gru_bwd_outputs", "recurrent_dw")
# B2 at widths that are no multiple of 16 (B, H, blocks a row group that the
# kernel picks for them): H = 100 on one block, at a batch whose 69 row groups
# would not fit on the card on clusters of 2, and H = 200 on a cluster.
GRU_BWD_RAGGED = ((1100, 100, 1), (7, 200, 8))
# Sampled softmax (N, S, D, V, pad, hits): config #4's train shape (B*T =
# 8,192 rows, a pool of 1,024 from 36,969 POIs); a pool of 1,000 padded to
# 1,024 the way the TPU kernel pads it; a pool of 200 (no multiple of the
# tile) whose entries 3 and 199 are every row's target (hits "two"); D =
# 128; D = 64 with neither N nor the padded pool a tile multiple; and a pool
# of 130 entries all of one id, padded to 320, which is the target of rows
# 0-19 (hits "all": every pool entry of those rows is a hit or padding; one
# block of 100 rows splits the 5 tiles into 5 ranges, the last two wholly
# padding). Small catalogs make accidental hits common. Then D = 512:
# config #5's train shape (B*T = 32,768 rows, a pool of 4,096 from 903,889
# POIs; ~150 accidental hits), its pool of 4,000 padded to 4,096 with two
# entries every row's target, a ragged padded pool, and every entry a hit.
# Last D = 384, which the kernels are not built for: the wrappers pad it
# with zero columns to 512 (config #4's shape, two hits a row, a ragged
# padded pool).
# Then the K-chunked kernels: config #4's shape at D = 1024 (the wider
# config #4 path's), config #5's rows at 768, a ragged 640 (run at 768, a
# ragged padded pool) and every entry a hit at 1024.
SAMPLED_C5 = (32768, 4096, 512, 903889, 0, None)
SAMPLED_C4_D1024 = (8192, 1024, 1024, 36969, 0, None)
SAMPLED_C5_D768 = (32768, 4096, 768, 903889, 0, None)
SAMPLED_CASES = ((8192, 1024, 256, 36969, 0, None), (8192, 1000, 256, 2000, 24, None),
                 (300, 200, 256, 50, 0, "two"), (1000, 300, 128, 500, 0, None), (777, 300, 64, 400, 33, None),
                 (100, 130, 256, 400, 190, "all"), SAMPLED_C5, (32768, 4000, 512, 903889, 96, "two"),
                 (777, 300, 512, 400, 33, None), (100, 130, 512, 400, 190, "all"),
                 (8192, 1024, 384, 36969, 0, None), (300, 200, 384, 50, 0, "two"), (777, 300, 384, 400, 33, None),
                 SAMPLED_C4_D1024, SAMPLED_C5_D768, (777, 300, 640, 400, 33, None), (100, 130, 1024, 400, 190, "all"))
# The sampled cases timed, by the key of their times.
SAMPLED_TIMED = {SAMPLED_CASES[0]: "", SAMPLED_C5: "_d512", SAMPLED_C4_D1024: "_d1024", SAMPLED_C5_D768: "_d768"}
# B10's split rule (the dq pass's, the dE pass's: 2 and 16 at config #4's
# shape) against fewer and more ranges of the streamed rows; (0, 0) is the
# rule.
SAMPLED_SPLITS = ((0, 0), (1, 0), (4, 0), (0, 4), (0, 8), (0, 32))
# B9's split rule (0: 2 ranges at config #4's shape) against one range and
# more ranges of the pool's tiles.
SAMPLED_LSE_SPLITS = (0, 1, 4, 8)
# B12, the CE forward's variants, beside the sweep's own shape (N, V, D,
# real POIs): a ragged catalog padded with -1e30 rows past a tile boundary,
# and D = 32 with neither N nor V a tile multiple.
CE_VARIANT_CASES = ((300, 8193, 128, 8000), (70, 700, 32, 650))
# B7's split-V edges (N, V, D, real POIs): 2 row blocks of 256 split a
# catalog of 8,192 into 32 ranges of 256, the last three wholly in the -1e30
# tail; 1 row block splits 700 POIs (V < S * 64) into 11 one-tile ranges of
# 64, the last of 60 columns, 10 of them padded.
CE_SPLIT_CASES = ((300, 8192, 128, 7424), (129, 700, 64, 650))


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


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


def device_ms(fn, iters: int = 20, expect=()) -> float:
    """Device time of one call of ``fn`` in ms: the sum of its kernels' time
    in ``torch.profiler`` over ``iters`` calls, the record checked to hold
    every launch and each kernel named in ``expect`` (``_timing.kernel_ms``)."""
    return sum(_timing.kernel_ms(fn, iters, expect).values())


# ----------------------------------------------------------------- phases


def build_phase() -> None:
    from poi_tpu_torch import _build

    t0 = time.perf_counter()
    path, out = _build.build()
    log(f"[build] {path.name} in {time.perf_counter() - t0:.1f} s")
    for line in out.splitlines():
        if any(w in line for w in ("registers", "smem", "spill", "Compiling entry", "warning")):
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


def check_gru_fwd(xw, wh, mask, lengths):
    """B1 against ``gru_scan_reference`` at the valid steps, the carry held
    through the padded tail, and the same bits on a second launch; returns
    (hs, max abs error)."""
    import torch

    from poi_tpu_torch.ops.fused_gru import fused_gru_scan, gru_scan_reference

    B, T, H = mask.shape[0], mask.shape[1], wh.shape[0]
    hs = fused_gru_scan(xw, wh)
    torch.cuda.synchronize()
    want = gru_scan_reference(xw, wh)
    err = float(((hs - want).abs() * mask[:, :, None]).max())
    assert torch.isfinite(hs).all(), f"GRU B={B} T={T} H={H}: non-finite output"
    assert err < GRU_TOL, f"GRU B={B} T={T} H={H}: max |kernel - plain| {err} >= {GRU_TOL}"
    # The folded mask carries h through the padded tail unchanged.
    last = hs[torch.arange(B, device=DEV), lengths - 1]
    tail = torch.where(mask[:, :, None], last[:, None, :], hs)
    assert torch.equal(tail, last[:, None, :].expand_as(hs)), f"GRU B={B} T={T} H={H}: masked tail moved h"
    assert torch.equal(fused_gru_scan(xw, wh), hs), f"GRU B={B} T={T} H={H}: run-to-run bits"
    return hs, err


def check_gru_bwd(xw, wh, hs, dhs, mask):
    """B2 against ``gru_bwd_reference`` (relative to each output's largest
    element), dxw exactly 0 on padded steps, the same bits on a second
    launch. Returns (rel err dxw, rel err dwh, max abs error, padded steps)."""
    import torch

    from poi_tpu_torch.ops.fused_gru import fused_gru_bwd, gru_bwd_reference

    B, H = mask.shape[0], wh.shape[0]
    dxw, dwh = fused_gru_bwd(xw, wh, hs, dhs)
    torch.cuda.synchronize()
    want_x, want_w = gru_bwd_reference(xw, wh, hs, dhs)
    ex, ew = rel_err(dxw, want_x), rel_err(dwh, want_w)
    assert torch.isfinite(dxw).all() and torch.isfinite(dwh).all(), f"GRU bwd B={B} H={H}: non-finite"
    assert ex < GRU_BWD_TOL and ew < GRU_BWD_TOL, f"GRU bwd B={B} H={H}: rel err dxw {ex}, dwh {ew}"
    pad = dxw[~mask]
    assert bool((pad == 0).all()), f"GRU bwd B={B} H={H}: nonzero dxw on a padded step"
    again = fused_gru_bwd(xw, wh, hs, dhs)  # no atomics: the same bits every run
    assert torch.equal(again[0], dxw) and torch.equal(again[1], dwh), f"GRU bwd B={B} H={H}: run-to-run bits"
    worst = max(float((dxw - want_x).abs().max()), float((dwh - want_w).abs().max()))
    return ex, ew, worst, pad.shape[0]


def gru_phase() -> float:
    """B1 against its plain version at H = 64 and 128, then at ragged widths
    (``GRU_FWD_RAGGED``); returns the largest absolute error."""
    import torch

    from poi_tpu_torch import _build

    gen = torch.Generator(device=DEV).manual_seed(SEED)
    worst = 0.0
    cases = [(B, H, None) for H in (64, 128) for B in (1, 7, 256)] + list(GRU_FWD_RAGGED)
    for B, H, want_blocks in cases:
        blocks = _build.library().gru_fwd_cluster_size(H)
        assert want_blocks in (None, blocks), f"GRU B={B} H={H}: the kernel picks {blocks} blocks, not {want_blocks}"
        _, err = check_gru_fwd(*gru_case(B, 64, H, gen))
        worst = max(worst, err)
        log(f"[gru] B={B:4d} T=64 H={H:3d} ({blocks} block{'s' if blocks > 1 else ''} a row group): max |kernel - "
            f"plain| at valid steps {err:.3e} (tol {GRU_TOL}); masked tail unchanged; a second run gives the same bits")
    return worst


def topk_phase() -> float:
    import torch

    from poi_tpu_torch.configs.presets import get_config
    from poi_tpu_torch.ops.topk import fused_topk, topk_reference

    gen = torch.Generator(device=DEV).manual_seed(SEED + 1)
    worst = 0.0
    # (B, V, D, k, real POIs). Serving: the padded config #1 catalog at
    # request batch 1 and 256, and one case whose batch fills the card with
    # one slice per row, on the unpadded V. Training's eval sweep: the bench
    # catalog (44,170 POIs padded to 45,056) at D=128, at the eval batch and
    # at 256 rows; and config #4's sweep (36,969 POIs padded to 38,912, D=256,
    # its eval batch of 256).
    eval_batch = get_config("smoke").with_overrides(BENCH_OVERRIDES).eval.batch_size
    cases = [(1, 8192, 64, 10, 6749), (1, 8192, 64, 128, 6749), (256, 8192, 64, 10, 6749),
             (256, 8192, 64, 128, 6749), (300, 6749, 64, 128, 6749),
             (eval_batch, 45056, 128, 10, 44170), (256, 45056, 128, 10, 44170), (256, 38912, 256, 10, 36969)]
    # bench_serve's catalog (70,953 POIs padded to 71,680, D=256) at its fetch
    # of k = 32, a whole 32-entry list, at batch 1 (its widest slice plan)
    # and 256. The narrower blocks of D > 256 at config #5's D = 512 and at
    # the kernel's limit of 1024, and D = 520, whose K is zero-padded to a
    # multiple of 16, on a ragged batch.
    cases += [(1, 71680, 256, 32, 70953), (256, 71680, 256, 32, 70953), (256, 8192, 512, 10, 8000),
              (256, 8192, 512, 128, 8000), (256, 8192, 1024, 10, 8000), (256, 8192, 1024, 128, 8000),
              (7, 8192, 520, 128, 8000)]
    # D = 100, no multiple of 8: the wrapper pads q and the table with zero
    # columns to 104.
    cases += [(256, 8192, 100, 10, 8000), (7, 8192, 100, 128, 8000)]
    for B, V, D, k, real in cases:
        # Scores of the same spread at either width (std ~8).
        q = torch.randn(B, D, generator=gen, device=DEV) * (64 / D) ** 0.5
        table = torch.randn(V, D, generator=gen, device=DEV)
        bias = torch.randn(V, generator=gen, device=DEV)
        bias[real:] = -1e30  # the catalog's padded tail
        vals, ids = fused_topk(q, table, bias, k)
        torch.cuda.synchronize()
        want_v, want_i = topk_reference(q, table, bias, k)
        err = float((vals - want_v).abs().max())
        assert err < TOPK_TOL, f"top-k B={B} V={V} D={D} k={k}: max |vals - plain| {err}"
        exact = q.to(torch.bfloat16).double() @ table.to(torch.bfloat16).double().T + bias.double()
        rows = torch.arange(B, device=DEV)[:, None]
        near = (exact[rows, ids.long()] - exact[rows, want_i.long()]).abs() < TOPK_TOL
        assert ((ids == want_i) | near).all(), f"top-k B={B} V={V} D={D} k={k}: ids differ beyond near-ties"
        assert int(ids.max()) < real, f"top-k B={B} V={V} D={D} k={k}: a padded row won"
        worst = max(worst, err)
        log(f"[topk] B={B:3d} V={V} D={D:3d} k={k:3d}{' (-1e30 tail)' if real < V else ''}: max |vals - plain| "
            f"{err:.3e}, ids equal {int((ids == want_i).sum())}/{ids.numel()} (rest near-ties < {TOPK_TOL})")
    # Duplicated rows across the catalog: the tie order must be exact.
    D, V = 64, 8192
    q = torch.randn(4, D, generator=gen, device=DEV)
    table = torch.randn(16, D, generator=gen, device=DEV)[torch.randint(0, 16, (V,), generator=gen, device=DEV)]
    bias = torch.zeros(V, device=DEV)
    for k in (10, 128):
        _, ids = fused_topk(q, table, bias, k)
        _, want_i = topk_reference(q, table, bias, k)
        assert torch.equal(ids, want_i), f"top-k duplicated rows k={k}: tie order differs"
    log("[topk] duplicated rows: tie order (value desc, id asc) exact for k=10 and k=128")
    return worst


def bound(inputs, outputs, bf16_flop: float = 0.0, fp32_flop: float = 0.0, exps: float = 0.0) -> dict:
    """The least time the card could take for a function of ``inputs`` to
    ``outputs``: its bytes at the memory rate, and each kind of operation at
    the peak rate of the pipe that does it (bf16 products on the tensor
    cores, fp32 ones on the CUDA cores, exponentials on the special-function
    units). The pipes run at once, so the largest of these times bounds it;
    ``bound_pipe`` names which."""
    nbytes = sum(t.numel() * t.element_size() for t in (*inputs, *outputs))
    times = {"memory": nbytes / HBM_BYTES_PER_S, "tensor": bf16_flop / BF16_FLOP_PER_S,
             "fp32": fp32_flop / FP32_FLOP_PER_S, "sfu": exps / SFU_PER_S}
    pipe = max(times, key=times.get)
    return {"bound_ms": times[pipe] * 1e3, "bound_by": "bytes" if pipe == "memory" else "operations",
            "bound_pipe": pipe}


def ce_lse_bound(q, table, bias, lse) -> dict:
    """B7's and B12's bound: the catalog product on the tensor cores, one
    exponential a logit on the special-function units, and the two fp32
    operations a logit that every variant does (the bias add and the sum)."""
    N, D = q.shape
    V = table.shape[0]
    return bound((q, table, bias), (lse,), bf16_flop=2 * N * V * D, fp32_flop=2 * N * V, exps=N * V)


def gru_bwd_bound(xw, wh, hs, dhs, outs) -> dict:
    """B2's bound: the gate recompute and the carry product on the tensor
    cores, the carry's fp32 cotangent counted as the kernel runs it, three
    exact bf16 products (so four products of 2 * B * T * H * 3H FLOPs), and
    dwh's fp32 product on the CUDA cores."""
    B, T, H = hs.shape
    flop = 2 * B * T * H * 3 * H
    return bound((xw, wh, hs, dhs), outs, bf16_flop=4 * flop, fp32_flop=flop)


def lstm_bwd_bound(x, mask, w, carries, dhs, outs) -> dict:
    """B4's bound, counted as the kernel runs it: the gate recompute and the
    carry product on the tensor cores, the carry's fp32 cotangent as three
    exact bf16 products (so four products of 2 * B * T * H * 4H FLOPs), and
    dwh's fp32 product on the CUDA cores."""
    B, T, H = carries[0].shape
    flop = 2 * B * T * H * 4 * H
    return bound((x, mask, w, *carries, dhs), outs, bf16_flop=4 * flop, fp32_flop=flop)


# The kernels of B1's, B2's, B4's and B7's calls, as the profiler names
# them: B1's one kernel; B2's three passes and the dwh product it shares; B4's
# gates and carry passes and that dwh product; B7's catalog kernel and its
# merge.
GRU_FWD_KERNELS = ("gru_fwd_kernel",)
GRU_BWD_KERNELS = ("gru_bwd_gates", "gru_bwd_carry", "gru_bwd_outputs", "recurrent_dw")
LSTM_BWD_KERNELS = ("lstm_bwd_gates", "lstm_bwd_carry", "recurrent_dw")
CE_LSE_KERNELS = ("ce_lse_wg_kernel", "lse_merge")
# B9's kernel and the ordered merge of its ranges; B10's dq pass, dE/db
# pass and the ordered sum of split partials; B3's kernel; B5's; B6's
# coefficients pass, carry and dC (its partials and their ordered reduce).
SAMPLED_LSE_KERNELS = ("sampled_lse_wg_kernel", "sampled_lse_merge")
SAMPLED_BWD_KERNELS = ("sampled_dq_pass", "sampled_de_pass", "sum_splits")
# B7's and B9's kernels past D = 512 (csrc/kchunk.cuh), and their merges.
CE_LSE_KC_KERNELS = ("ce_lse_kc_kernel", "lse_merge")
SAMPLED_LSE_KC_KERNELS = ("sampled_lse_kc_kernel", "sampled_lse_merge")


def ce_lse_kernels(D: int) -> tuple:
    """B7's kernel and merge at the width ``D`` runs at."""
    return CE_LSE_KC_KERNELS if kchunked(D) else CE_LSE_KERNELS


def loss_kernel_flop(name: str, N: int, V: int, D: int) -> float:
    """The bf16 product operations a loss kernel's call runs at its padded
    width, counted as it runs them (the function's own count is 2 N V D for
    the forward, 6 N V D for the backward): B7 and B9 one catalog or pool
    product; B8 and B10 two passes, each the logits once a column range
    (``bwd_plan`` / ``plan``) and the gradient product once."""
    from poi_tpu_torch.ops import fused_ce, fused_sampled

    if name in ("ce_lse", "sampled_lse"):
        return 2 * N * V * D
    ranges = fused_ce.bwd_plan(D)[2] if name == "ce_bwd" else fused_sampled.plan(D)[5]
    return 2 * (2 * ranges + 2) * N * V * D
LSTM_FWD_KERNELS = ("lstm_fwd_kernel",)
RNN_FWD_KERNELS = ("rnn_fwd_kernel",)
RNN_BWD_KERNELS = ("rnn_bwd_coef", "rnn_bwd_carry", "recurrent_dw")
# B3's and B5's grid kernels; B4's gates pass, grid carry and dwh; B6's
# coefficients pass, grid carry and dC: the calls past the clusters' widths.
LSTM_FWD_GRID_KERNELS = ("lstm_fwd_grid_kernel",)
LSTM_BWD_GRID_KERNELS = ("lstm_bwd_gates", "lstm_bwd_grid_carry", "recurrent_dw")
RNN_FWD_GRID_KERNELS = ("rnn_fwd_grid_kernel",)
RNN_BWD_GRID_KERNELS = ("rnn_bwd_coef", "rnn_bwd_grid_carry", "recurrent_dw")


def device_parts(fn, names) -> dict:
    """Device ms of one call of ``fn`` (``_timing.kernel_ms``, the record
    checked to hold ``names[0]``): in all (``device_ms``), and in the kernels
    named like each of ``names`` (``<name>_ms``)."""
    parts = _timing.kernel_ms(fn, 10, expect=names[:1])
    return {"device_ms": sum(parts.values()),
            **{f"{n}_ms": sum(v for k, v in parts.items() if n in k) for n in names}}


def parts_text(t: dict, names) -> str:
    return f"device {t['device_ms']:.4f} ms: " + ", ".join(f"{n} {t[n + '_ms']:.4f}" for n in names)


def rel_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def gru_bwd_phase() -> float:
    """B2 against ``gru_bwd_reference`` at H = 64 and 128, then at ragged
    widths (``GRU_BWD_RAGGED``); returns the largest absolute error."""
    import torch

    from poi_tpu_torch import _build
    from poi_tpu_torch.ops.fused_gru import fused_gru_scan

    gen = torch.Generator(device=DEV).manual_seed(SEED + 3)
    worst = 0.0
    cases = [(B, H, None) for H in (64, 128) for B in (1, 7, 512)] + list(GRU_BWD_RAGGED)
    for B, H, want_blocks in cases:
        blocks = _build.library().gru_bwd_cluster_size(B, H)
        assert want_blocks in (None, blocks), f"GRU bwd B={B} H={H}: the kernel picks {blocks} blocks, not {want_blocks}"
        xw, wh, mask, _ = gru_case(B, 64, H, gen)
        hs = fused_gru_scan(xw, wh)
        dhs = torch.randn(B, 64, H, generator=gen, device=DEV)  # nonzero on padded steps too
        ex, ew, err, n_pad = check_gru_bwd(xw, wh, hs, dhs, mask)
        worst = max(worst, err)
        log(f"[gru_bwd] B={B:3d} T=64 H={H:3d} ({blocks} block{'s' if blocks > 1 else ''} a row group): rel err dxw "
            f"{ex:.2e}, dwh {ew:.2e} (tol {GRU_BWD_TOL}); dxw on {n_pad} padded steps exactly 0; a second run gives "
            f"the same bits")
    return worst


def ce_case(tag: str, N: int, V: int, D: int, real: int, gen) -> dict:
    """B7 and B8 on one (N, V, D) catalog whose rows past ``real`` are -1e30
    padding, against their plain versions: lse at ``CE_LSE_TOL``; dq and
    dtable at ``CE_GRAD_TOL`` of the max-over-max error and, at
    ``B8_BOUND_DIMS``, element by element within ``ce_bound_ratios``'
    bound; dbias at ``CE_DBIAS_TOL``; padded catalog rows get exactly zero
    gradient; a second run gives the same bits. Returns the largest
    absolute errors of lse and of the gradients, dq's and dtable's relative
    errors and bound ratios (None below ``B8_BOUND_DIMS``)."""
    import torch

    from poi_tpu_torch import _build
    from poi_tpu_torch.ops.fused_ce import KERNEL_DIMS, ce_bwd, ce_bwd_reference, ce_lse, ce_lse_reference, lse_rows
    from poi_tpu_torch.ops.widths import padded_dim

    q = 0.3 * torch.randn(N, D, generator=gen, device=DEV)
    table = 0.3 * torch.randn(V, D, generator=gen, device=DEV)
    bias = torch.randn(V, generator=gen, device=DEV)
    bias[real:] = -1e30
    g = torch.rand(N, generator=gen, device=DEV)
    lse = ce_lse(q, table, bias)
    torch.cuda.synchronize()
    want_lse = ce_lse_reference(q, table, bias)
    e_lse = float((lse - want_lse).abs().max())
    assert e_lse < CE_LSE_TOL, f"ce_lse N={N} V={V} D={D}: max |kernel - plain| {e_lse}"
    got = ce_bwd(q, table, bias, want_lse, g)
    torch.cuda.synchronize()
    want = ce_bwd_reference(q, table, bias, want_lse, g)
    errs = [rel_err(a, b) for a, b in zip(got, want)]
    Dp = padded_dim(D, KERNEL_DIMS, "ce_lse")
    ratios = (ce_bound_ratios((q, table, bias, want_lse, g), got, want, with_db=kchunked(Dp))
              if Dp in B8_BOUND_DIMS or kchunked(Dp) else None)
    assert kchunked(Dp) or (errs[0] < CE_GRAD_TOL and errs[1] < CE_GRAD_TOL and errs[2] < CE_DBIAS_TOL), \
        f"ce_bwd N={N} V={V} D={D}: rel err dq/dtable/dbias {errs}, element-wise bound ratios {ratios}"
    assert ratios is None or max(ratios) <= 1.0, \
        f"ce_bwd N={N} V={V} D={D}: |err| / bound dq/dtable{'/dbias' * kchunked(Dp)} {ratios}"
    assert bool((got[1][real:] == 0).all()) and bool((got[2][real:] == 0).all()), "a padded catalog row got gradient"
    again = ce_bwd(q, table, bias, want_lse, g)  # no atomics: the same bits every run
    assert torch.equal(ce_lse(q, table, bias), lse) and all(torch.equal(a, b) for a, b in zip(again, got)), \
        f"ce N={N} V={V} D={D}: run-to-run bits"
    splits = max(1, _build.library().ce_lse_scratch(N, V, Dp, lse_rows(D)) // (2 * N))
    log(f"[{tag}] N={N:5d} V={V} D={D:3d}{f' (run at {Dp})' if Dp != D else ''}"
        f"{' (-1e30 tail)' if real < V else ''}, ce_lse at {lse_rows(D)} rows a block in {splits} catalog "
        f"range{'s' if splits > 1 else ''}: lse max err {e_lse:.2e} (tol {CE_LSE_TOL}); rel err dq {errs[0]:.2e}, "
        f"dtable {errs[1]:.2e} ({'held by the element-wise bound' if kchunked(Dp) else f'tol {CE_GRAD_TOL}'})"
        + (f", |err| / element-wise bound dq {ratios[0]:.3f}, dtable {ratios[1]:.3f}" if ratios else "")
        + (f", dbias {ratios[2]:.3f} (each <= 1; dbias rel err {errs[2]:.2e})" if kchunked(Dp) else
           (" (<= 1)" if ratios else "") + f", dbias {errs[2]:.2e} (tol {CE_DBIAS_TOL})")
        + "; a second run gives the same bits")
    return {"lse_err": e_lse, "grad_err": max(float((a - b).abs().max()) for a, b in zip(got, want)),
            "rel": tuple(errs[:2]), "ratios": ratios}


def ce_phase() -> tuple[float, float]:
    """B7 and B8 against their plain versions (``ce_case``); returns the
    largest absolute errors of (lse, gradients)."""
    import torch

    gen = torch.Generator(device=DEV).manual_seed(SEED + 4)
    worst_lse = worst_grad = 0.0
    # Config #1's catalog at batch 1, a catalog one past a tile multiple, the
    # bench shape, config #1's catalog padded to 8,192 with -1e30 rows,
    # config #3's shape (its 16 row blocks split the catalog: B7's
    # split-and-merge and B8's split-and-reduce paths), D = 32 (the smoke
    # preset's width, whose tiles take the 64-byte swizzle) on ragged N and V
    # with a padded tail, and B7's split edges (CE_SPLIT_CASES).
    # Then the widths past 128 (CE_WIDE_CASES), padded where the kernels
    # are not built for the width.
    for N, V, D, real in ((1, 6749, 64, 6749), (300, 8193, 128, 8193), CE_TRAIN_SHAPE + (CE_TRAIN_SHAPE[1],),
                          (2048, 8192, 64, 6749), CE_C3_SHAPE + (CE_C3_SHAPE[1],), (300, 8193, 32, 8000),
                          *CE_SPLIT_CASES, *CE_WIDE_CASES):
        r = ce_case("ce", N, V, D, real, gen)
        worst_lse, worst_grad = max(worst_lse, r["lse_err"]), max(worst_grad, r["grad_err"])
    return worst_lse, worst_grad


def ce_bound_ratios(args, got, want, chunk: int = 4096, with_db: bool = False) -> tuple:
    """B8's dq and dtable against the plain version's, element by element:
    the largest |dq - dq_plain| / bound and |dtable - dtable_plain| / bound,
    each <= 1 for a correct kernel (0/0 counts as 0). ``args``: (q, table,
    bias, lse, g). The bound is ``b10_bound_ratios``' (every term written out
    there) for the logits z = bf16(q) bf16(table)^T + bias, without the hit
    mask: with u = 2^-24, x = z - lse and gp = exp(x) g,
    delta = 3 D u (|q| |table|^T) + 4 u (|z| + |x|) + 2 u + (4 + 1.2 |x|) 2u,
    c = 2^-7 + 1.01 delta, and
    |dq - dq_plain| <= (c |gp| + 3.03 (V - 1) u |bf16(gp)|) @ |table_bf16|,
    |dtable - dtable_plain| <= (c |gp| + 3.03 (N - 1) u |bf16(gp)|)^T @ |q_bf16|.
    Computed over catalog chunks of ``chunk`` rows (the dq bound summed over
    them), so the bench shape's [N, V] never lies on the card at once.
    ``with_db``: also the largest |dbias - dbias_plain| / bound, dbias being
    fp32 sums of the unrounded gp: |dbias - dbias_plain| <= colsum(1.01 delta
    |gp| + 3.03 (N - 1) u |gp|)."""
    import torch

    q, table, bias, lse, g = args
    u = 2.0 ** -24
    N, D = q.shape
    V = table.shape[0]
    qb = q.to(torch.bfloat16).float()
    qa = qb.abs()
    dq_bound = torch.zeros(N, D, device=q.device)
    ratio_dt = ratio_db = 0.0
    for v0 in range(0, V, chunk):
        tb = table[v0:v0 + chunk].to(torch.bfloat16).float()
        ta = tb.abs()
        z = qb @ tb.T + bias[v0:v0 + chunk].float()
        x = z - lse.float()[:, None]
        gp = torch.exp(x) * g.float()[:, None]
        gpa = gp.abs()
        gpba = gp.to(torch.bfloat16).float().abs()
        del gp
        delta = 3 * D * u * (qa @ ta.T) + 4 * u * (z.abs() + x.abs()) + 2 * u + (4 + 1.2 * x.abs()) * 2 * u
        del z, x
        if with_db:
            db_bound = ((1.01 * delta + 3.03 * (N - 1) * u) * gpa).sum(dim=0)
            err = (got[2][v0:v0 + chunk] - want[2][v0:v0 + chunk]).abs()
            ratio_db = max(ratio_db, float(torch.where(err == 0, 0.0, err / db_bound).max()))
        cg = (2.0 ** -7 + 1.01 * delta) * gpa
        del delta, gpa
        dq_bound += (cg + 3.03 * (V - 1) * u * gpba) @ ta
        bd = (cg + 3.03 * (N - 1) * u * gpba).T @ qa
        del cg, gpba
        err = (got[1][v0:v0 + chunk] - want[1][v0:v0 + chunk]).abs()
        ratio_dt = max(ratio_dt, float(torch.where(err == 0, 0.0, err / bd).max()))
    err = (got[0] - want[0]).abs()
    ratio_dq = float(torch.where(err == 0, 0.0, err / dq_bound).max())
    return (ratio_dq, ratio_dt, ratio_db) if with_db else (ratio_dq, ratio_dt)


def ce_cases(tag: str, cases, gen) -> dict:
    """``ce_case`` at each of ``cases``; the largest absolute errors,
    relative errors and bound ratios over them."""
    import itertools

    out = {"lse_err": 0.0, "grad_err": 0.0, "ratios": (), "rel": (0.0, 0.0)}
    for N, V, D, real in cases:
        r = ce_case(tag, N, V, D, real, gen)
        out["lse_err"], out["grad_err"] = max(out["lse_err"], r["lse_err"]), max(out["grad_err"], r["grad_err"])
        out["rel"] = tuple(map(max, out["rel"], r["rel"]))
        out["ratios"] = tuple(map(max, itertools.zip_longest(out["ratios"], r["ratios"], fillvalue=0.0)))
    return out


def expect_loss_width_limit(tag: str, D: int) -> None:
    """Both pairs (B7/B8, B9/B10) refuse width ``D`` on CUDA tensors, naming
    the limit, before any launch."""
    import torch

    from poi_tpu_torch.ops.fused_ce import ce_bwd, ce_lse
    from poi_tpu_torch.ops.fused_sampled import sampled_bwd, sampled_lse

    q, z = torch.zeros(4, D, device=DEV), torch.zeros(4, device=DEV)
    i = torch.zeros(4, dtype=torch.int32, device=DEV)
    for fn, args in ((ce_lse, (q, q, z)), (ce_bwd, (q, q, z, z, z)), (sampled_lse, (q, q, z, i, i)),
                     (sampled_bwd, (q, q, z, i, i, z, z))):
        try:
            fn(*args)
        except ValueError as e:
            assert "D <= 1024" in str(e) and f"D={D}" in str(e), e
            log(f"[{tag}] D={D} refused: {e}")
        else:
            raise AssertionError(f"{fn.__name__} took D = {D}")


def ce_wide_phase() -> dict:
    """B7 and B8 at D = 384 and 512 (``CE_D512_CASES``, ``ce_case``: B8
    also element by element within ``ce_bound_ratios``' bound), and D = 513,
    the limit before D = 768 and 1024 were built, taken (run at 768).
    Returns the largest absolute errors, relative errors and bound
    ratios."""
    import torch

    gen = torch.Generator(device=DEV).manual_seed(SEED + 19)
    out = ce_cases("ce_wide", CE_D512_CASES, gen)
    ce_case("ce_wide", 100, 700, 513, 650, gen)
    log("[ce_wide] D=513 taken: run at 768 within the bounds above")
    return out


def check_plans() -> None:
    """The wrappers' Python mirrors of the kernels' block shapes
    (``fused_ce.lse_plan``, ``bwd_plan``, ``fused_sampled.plan``) against
    the C side's (``ce_lse_plan``, ``ce_bwd_plan``, ``sampled_plan``) at
    every width the kernels are built for and at widths they run padded."""
    import ctypes

    from poi_tpu_torch import _build
    from poi_tpu_torch.ops import fused_ce, fused_sampled
    from poi_tpu_torch.ops.widths import padded_dim

    lib = _build.library()
    buf = (ctypes.c_int * 8)()

    def c_plan(fn, D, n):
        assert fn(D, buf) == 1, D
        return tuple(buf[:n])

    widths = sorted(set(fused_ce.KERNEL_DIMS) | set(fused_sampled.KERNEL_DIMS) | {100, 300, 513, 600, 640, 1000})
    for D in widths:
        Dc = padded_dim(D, fused_ce.KERNEL_DIMS, "ce")
        assert fused_ce.lse_plan(D) == c_plan(lib.ce_lse_plan, Dc, 3), (D, fused_ce.lse_plan(D))
        assert fused_ce.bwd_plan(D) == c_plan(lib.ce_bwd_plan, Dc, 4), (D, fused_ce.bwd_plan(D))
        Ds = padded_dim(max(D, 64), fused_sampled.KERNEL_DIMS, "sampled")
        assert fused_sampled.plan(D) == c_plan(lib.sampled_plan, Ds, 7), (D, fused_sampled.plan(D))
    assert lib.ce_lse_plan(1025, buf) == 0 and lib.sampled_plan(1025, buf) == 0
    log(f"[ce_wider] the Python block plans equal the C side's at D = {widths}: "
        + "; ".join(f"{D}: ce_lse {fused_ce.lse_plan(D)}, ce_bwd {fused_ce.bwd_plan(D)}, sampled {fused_sampled.plan(D)}"
                    for D in (512, 768, 1024)))


def ce_wider_phase() -> dict:
    """B7 and B8 at D = 768 and 1024 on the K-chunked kernels
    (``CE_D1024_CASES``, ``ce_case``: B8 element by element within
    ``ce_bound_ratios``' bound), the block plans' Python mirrors against the
    C side (``check_plans``), and D = 1025 refused by both loss pairs,
    naming the limit. Returns the largest absolute errors, relative errors
    and bound ratios."""
    import torch

    check_plans()
    out = ce_cases("ce_wider", CE_D1024_CASES, torch.Generator(device=DEV).manual_seed(SEED + 23))
    expect_loss_width_limit("ce_wider", 1025)
    return out


def check_variant(name: str, got, want, base, q, table, bias, shape: str) -> float:
    """One B12 instantiation's output against its plain version's: within
    ``CE_LSE_TOL``, the same bits on a second launch, and base/256 (``ce_lse``'s
    own instantiation) the same bits as ``ce_lse``. Returns the largest
    absolute error."""
    import torch

    from poi_tpu_torch.ops.fused_ce import ce_lse_variant

    variant, rows = name.split("/")
    err = float((got - want).abs().max())
    assert bool(torch.isfinite(got).all()) and err < CE_LSE_TOL, f"ce_lse_variant {name} {shape}: {err}"
    assert torch.equal(ce_lse_variant(q, table, bias, variant, int(rows)), got), f"{name} {shape}: run-to-run bits"
    assert name != "base/256" or torch.equal(got, base), \
        f"base/256 differs from ce_lse by {float((got - base).abs().max())} at {shape}"
    log(f"[ce_variants] {name:9s} {shape}: max |kernel - plain| {err:.2e} (tol {CE_LSE_TOL}); a second launch "
        f"gives the same bits" + ("; the same bits as ce_lse" if name == "base/256" else ""))
    return err


def ce_variants_phase() -> dict:
    """B12's main path, the sweep (``scripts/sweep_ce_fwd.sweep``) at its own
    shape and inputs (logits under ~3, far below the ~88 where nomax
    overflows), then ``CE_VARIANT_CASES`` and B7's split edges
    (``CE_SPLIT_CASES``). Each of the six instantiations (variant x rows a
    block) is held against its plain version; base at 256 rows equals
    ``ce_lse`` bit for bit and a second launch of each gives the same bits.
    Keeps, at the sweep's shape, each one's launches in the sweep's timed
    runs, its time (the sweep's), its plain version's time, the bound, and
    the inputs (``args``) for its device time (``ce_variants_device_phase``)."""
    import torch

    from poi_tpu_torch import _build
    from poi_tpu_torch.ops.fused_ce import VARIANT_REFERENCES, ce_lse, ce_lse_variant
    from poi_tpu_torch.scripts import sweep_ce_fwd

    N, V, D = sweep_ce_fwd.N, sweep_ce_fwd.V, sweep_ce_fwd.D
    q, table, bias = sweep_ce_fwd.inputs(N, V, D, DEV)
    cells = sweep_ce_fwd.sweep(q, table, bias)
    base = ce_lse(q, table, bias)
    for name, c in cells.items():
        variant = name.split("/")[0]
        want = VARIANT_REFERENCES[variant](q, table, bias)
        c["max_abs_err"] = check_variant(name, c.pop("lse"), want, base, q, table, bias, f"N={N} V={V} D={D}")
        # No one PyTorch call gives a row LSE over a product (as B7): no library time.
        c.update(plain_ms=time_ms(lambda: VARIANT_REFERENCES[variant](q, table, bias), 5), library_ms=None,
                 **ce_lse_bound(q, table, bias, base), args=(q, table, bias))
        log(f"[time] ce_lse_variant {name} N={N} V={V} D={D}: kernel {c['ms']:.4f} ms "
            f"({2 * N * V * D / c['ms'] / 1e9:.1f} TFLOP/s), plain {c['plain_ms']:.4f} ms; bound "
            f"{c['bound_ms']:.4f} ms ({c['bound_by']}, {c['bound_pipe']}); {c['launches']} launches in the sweep")
    gen = torch.Generator(device=DEV).manual_seed(SEED + 12)
    for N, V, D, real in (*CE_VARIANT_CASES, *CE_SPLIT_CASES):
        q = 0.3 * torch.randn(N, D, generator=gen, device=DEV)
        table = 0.3 * torch.randn(V, D, generator=gen, device=DEV)
        bias = torch.randn(V, generator=gen, device=DEV)
        bias[real:] = -1e30
        base = ce_lse(q, table, bias)
        for name, c in cells.items():
            variant, rows = name.split("/")
            got = ce_lse_variant(q, table, bias, variant, int(rows))
            want = VARIANT_REFERENCES[variant](q, table, bias)
            splits = max(1, _build.library().ce_lse_scratch(N, V, D, int(rows)) // (2 * N))
            err = check_variant(name, got, want, base, q, table, bias,
                                f"N={N} V={V} D={D}" + (" (-1e30 tail)" if real < V else "")
                                + f", {splits} catalog range{'s' if splits > 1 else ''}")
            c["max_abs_err"] = max(c["max_abs_err"], err)
    return cells


def ce_variants_device_phase(variants: dict, gpu: str) -> None:
    """Device time by kernel (``CE_LSE_KERNELS``) of each B12 instantiation
    at the sweep's shape, on the inputs ``ce_variants_phase`` timed. After
    the timing phases, as every profiler reading."""
    from poi_tpu_torch.ops.fused_ce import ce_lse_variant

    for name, c in variants.items():
        q, table, bias = c.pop("args")
        variant, rows = name.split("/")
        c.update(device_parts(lambda: ce_lse_variant(q, table, bias, variant, int(rows)), CE_LSE_KERNELS))
        log(f"[time] ce_lse_variant {name} N={q.shape[0]} V={table.shape[0]} D={q.shape[1]}: "
            f"{parts_text(c, CE_LSE_KERNELS)} (CUDA events {c['ms']:.4f} ms)  ({gpu})")


def gru_big_phase() -> dict:
    """B1 and B2 at the larger widths against their plain versions: config
    #4's (B, T, H), a ragged batch, and config #5's H = 512 on a few rows and
    at its batch of 512. Returns the largest absolute errors and config #4's
    and config #5's times."""
    import torch

    from poi_tpu_torch.ops.fused_gru import fused_gru_bwd, fused_gru_scan, gru_bwd_reference, gru_scan_reference

    gen = torch.Generator(device=DEV).manual_seed(SEED + 6)
    out = {"fwd_err": 0.0, "bwd_err": 0.0}
    for B, T, H in GRU_BIG_SHAPES:
        xw, wh, mask, lengths = gru_case(B, T, H, gen)
        hs, err = check_gru_fwd(xw, wh, mask, lengths)
        dhs = torch.randn(B, T, H, generator=gen, device=DEV)
        ex, ew, bwd_err, n_pad = check_gru_bwd(xw, wh, hs, dhs, mask)
        out["fwd_err"] = max(out["fwd_err"], err)
        out["bwd_err"] = max(out["bwd_err"], bwd_err)
        log(f"[gru_big] B={B:3d} T={T} H={H}: forward max |kernel - plain| at valid steps {err:.3e} (tol {GRU_TOL}); "
            f"backward rel err dxw {ex:.2e}, dwh {ew:.2e} (tol {GRU_BWD_TOL}); dxw on {n_pad} padded steps "
            f"exactly 0; a second run gives the same bits")
        if (B, T, H) == GRU_FWD_H512:
            out["fwd_h512"] = {"ms": time_ms(lambda: fused_gru_scan(xw, wh)),
                               "plain_ms": time_ms(lambda: gru_scan_reference(xw, wh), 5),
                               "library_ms": cudnn_ms("gru", B, T, H, DEV),
                               **bound((xw, wh), (hs,), bf16_flop=2 * B * T * H * 3 * H)}
            out["fwd_h512"]["args"] = (xw, wh)
            out["bwd_h512"] = {"ms": time_ms(lambda: fused_gru_bwd(xw, wh, hs, dhs)),
                               "plain_ms": time_ms(lambda: gru_bwd_reference(xw, wh, hs, dhs), 5), "library_ms": None,
                               **gru_bwd_bound(xw, wh, hs, dhs, fused_gru_bwd(xw, wh, hs, dhs)),
                               "args": (xw, wh, hs, dhs)}
            t, tb = out["fwd_h512"], out["bwd_h512"]
            log(f"[time] gru_fwd B={B} T={T} H={H}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, cuDNN "
                f"nn.GRU forward {t['library_ms']:.4f} ms; bound {t['bound_ms']:.4f} ms ({t['bound_by']}, "
                f"{t['bound_pipe']}); gru_bwd: kernel {tb['ms']:.4f} ms, plain {tb['plain_ms']:.4f} ms; bound "
                f"{tb['bound_ms']:.4f} ms ({tb['bound_by']}, {tb['bound_pipe']})")
        if (B, T, H) == GRU_BIG_SHAPES[0]:
            G = 3 * H
            out["fwd"] = {"ms": time_ms(lambda: fused_gru_scan(xw, wh)),
                          "plain_ms": time_ms(lambda: gru_scan_reference(xw, wh), 5),
                          "library_ms": cudnn_ms("gru", B, T, H, DEV),
                          **bound((xw, wh), (hs,), bf16_flop=2 * B * T * H * G), "args": (xw, wh)}
            out["bwd"] = {"ms": time_ms(lambda: fused_gru_bwd(xw, wh, hs, dhs)),
                          "plain_ms": time_ms(lambda: gru_bwd_reference(xw, wh, hs, dhs), 5), "library_ms": None,
                          **gru_bwd_bound(xw, wh, hs, dhs, fused_gru_bwd(xw, wh, hs, dhs)),
                          "args": (xw, wh, hs, dhs)}
            for d in ("fwd", "bwd"):
                t = out[d]
                lib = f", cuDNN nn.GRU forward {t['library_ms']:.4f} ms" if t["library_ms"] is not None else ""
                log(f"[time] gru_{d} B={B} T={T} H={H}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} "
                    f"ms{lib}; bound {t['bound_ms']:.4f} ms ({t['bound_by']}, {t['bound_pipe']})")
    return out


def gru_picks() -> None:
    """The dispatch the wrappers run (``fused_gru.design`` and
    ``grid_shape``, pure Python) against the C side's own picks at
    ``GRU_PICK_WIDTHS`` x ``GRU_PICK_BATCHES`` and at the limit: the clusters
    take H exactly where the design says "cluster", the grid shapes agree,
    and ``gru_max_hidden()`` is ``fused_gru.MAX_HIDDEN``."""
    import ctypes

    from poi_tpu_torch import _build
    from poi_tpu_torch.ops import fused_gru

    lib = _build.library()
    limit = lib.gru_max_hidden()
    assert limit == fused_gru.MAX_HIDDEN, f"gru_max_hidden() {limit}, fused_gru.MAX_HIDDEN {fused_gru.MAX_HIDDEN}"
    got = (ctypes.c_int * 4)()
    n = 0
    for H in (*GRU_PICK_WIDTHS, limit, limit + 1):
        cluster = H <= fused_gru.CLUSTER_MAX_HIDDEN
        assert (lib.gru_fwd_cluster_size(H) > 0) == cluster, (H, lib.gru_fwd_cluster_size(H))
        assert all((lib.gru_bwd_cluster_size(B, H) > 0) == cluster for B in GRU_PICK_BATCHES), H
        if H <= limit:
            assert fused_gru.design(H) == ("cluster" if cluster else "grid"), H
        for B in GRU_PICK_BATCHES:
            for bwd in (0, 1):
                c = tuple(got) if lib.gru_grid_shape(B, H, bwd, got) else None
                assert c == fused_gru.grid_shape(B, H, bool(bwd)), (B, H, bwd, c, fused_gru.grid_shape(B, H, bool(bwd)))
                n += 1
    log(f"[gru_wide] the Python dispatch agrees with the C side: clusters exactly to H = "
        f"{fused_gru.CLUSTER_MAX_HIDDEN}, {n} grid shapes (the wide path's {fused_gru.grid_shape(512, 1024, False)} "
        f"forward, {fused_gru.grid_shape(512, 1024, True)} backward: octets a block, unit slices, row groups, rows "
        f"a group), gru_max_hidden() = {limit}")


def gru_wide_phase() -> dict:
    """B1 and B2 past the clusters' 640, on the grid-resident kernels, at
    ``GRU_WIDE_SHAPES`` and at the limit: the forward at ``GRU_TOL`` with
    the carry held through the padding, the backward at ``GRU_BWD_TOL`` with
    dxw exactly 0 on padded steps, the same bits on a second launch of
    each; the width past the limit refused, naming it. Returns the largest
    errors and the wide path's times (with cuDNN's ``nn.GRU`` at H = 1024)."""
    import torch

    from poi_tpu_torch.ops import fused_gru
    from poi_tpu_torch.ops.fused_gru import fused_gru_bwd, fused_gru_scan, gru_bwd_reference, gru_scan_reference

    gru_picks()
    gen = torch.Generator(device=DEV).manual_seed(SEED + 18)
    out = {"fwd_err": 0.0, "bwd_err": 0.0}
    for B, T, H in (*GRU_WIDE_SHAPES, (3, 16, fused_gru.MAX_HIDDEN)):
        xw, wh, mask, lengths = gru_case(B, T, H, gen)
        hs, err = check_gru_fwd(xw, wh, mask, lengths)
        dhs = torch.randn(B, T, H, generator=gen, device=DEV)
        ex, ew, bwd_err, n_pad = check_gru_bwd(xw, wh, hs, dhs, mask)
        out["fwd_err"] = max(out["fwd_err"], err)
        out["bwd_err"] = max(out["bwd_err"], bwd_err)
        ocp, U, R, rows = fused_gru.grid_shape(B, H, False)
        log(f"[gru_wide] B={B:3d} T={T} H={H} (forward on {U} unit slices x {R} row groups of {rows} rows, {ocp} "
            f"octets a block): forward max |kernel - plain| at valid steps {err:.3e} (tol {GRU_TOL}); backward rel "
            f"err dxw {ex:.2e}, dwh {ew:.2e} (tol {GRU_BWD_TOL}); dxw on {n_pad} padded steps exactly 0; a second "
            f"run of each gives the same bits")
        if (B, T, H) == GRU_WIDE_H1024:
            out["fwd"] = {"ms": time_ms(lambda: fused_gru_scan(xw, wh)),
                          "plain_ms": time_ms(lambda: gru_scan_reference(xw, wh), 5),
                          "library_ms": cudnn_ms("gru", B, T, H, DEV),
                          **bound((xw, wh), (hs,), bf16_flop=2 * B * T * H * 3 * H), "args": (xw, wh)}
            out["bwd"] = {"ms": time_ms(lambda: fused_gru_bwd(xw, wh, hs, dhs), 5),
                          "plain_ms": time_ms(lambda: gru_bwd_reference(xw, wh, hs, dhs), 3), "library_ms": None,
                          **gru_bwd_bound(xw, wh, hs, dhs, fused_gru_bwd(xw, wh, hs, dhs)),
                          "args": (xw, wh, hs, dhs)}
            t, tb = out["fwd"], out["bwd"]
            log(f"[time] gru_fwd B={B} T={T} H={H} (grid): kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
                f"cuDNN nn.GRU forward {t['library_ms']:.4f} ms; bound {t['bound_ms']:.4f} ms ({t['bound_by']}, "
                f"{t['bound_pipe']}); gru_bwd (grid carry): kernel {tb['ms']:.4f} ms, plain {tb['plain_ms']:.4f} ms; "
                f"bound {tb['bound_ms']:.4f} ms ({tb['bound_by']}, {tb['bound_pipe']})")
    H = fused_gru.MAX_HIDDEN + 1
    xw, wh = torch.zeros(2, 3, 3 * H, device=DEV), torch.zeros(H, 3 * H, device=DEV, dtype=torch.bfloat16)
    for fn, args in ((fused_gru_scan, (xw, wh)), (fused_gru_bwd, (xw, wh, xw[..., :H], xw[..., :H]))):
        msg = expect_width_limit(fn, *args)
        assert f"H <= {fused_gru.MAX_HIDDEN} (gru_max_hidden())" in msg, msg
        log(f"[gru_wide] {fn.__name__} H={H} refused: {msg}")
    return out


def recurrence_device_phase(times: dict, big: dict, lstm: dict, gpu: str, wide: dict) -> None:
    """Device time by kernel, on the inputs the earlier phases timed: B1 at
    the serve shapes (batch 256 and 1), the bench shape, config #4's and
    config #5's; B2 at config #4's and config #5's; B1 and B2 on the grid at
    the wide path's shape (``gru_wide``); B4 at config #2's, pass by pass. It runs after the
    timing phases, as every profiler reading does: in a run that profiled
    here, before the training phases, the top-k timing's later records came
    back empty."""
    from poi_tpu_torch.ops.fused_gru import fused_gru_bwd, fused_gru_scan
    from poi_tpu_torch.ops.fused_lstm import fused_lstm_bwd

    for t in (times["gru_fwd"], times["gru_fwd_b1"], times["gru_fwd_train"], big["fwd"]):
        xw, wh = t.pop("args")
        t.update(device_parts(lambda: fused_gru_scan(xw, wh), GRU_FWD_KERNELS))
        log(f"[time] gru_fwd B={xw.shape[0]} T={xw.shape[1]} H={wh.shape[0]}: device {t['device_ms']:.4f} ms "
            f"(CUDA events {t['ms']:.4f} ms)  ({gpu})")
    t = big["fwd_h512"]
    xw, wh = t.pop("args")
    t.update(device_parts(lambda: fused_gru_scan(xw, wh), GRU_FWD_KERNELS))
    log(f"[time] gru_fwd B={xw.shape[0]} T={xw.shape[1]} H={wh.shape[0]}: device {t['device_ms']:.4f} ms "
        f"(CUDA events {t['ms']:.4f} ms)  ({gpu})")
    for t in (big["bwd"], big["bwd_h512"]):
        xw, wh, hs, dhs = t.pop("args")
        t.update(device_parts(lambda: fused_gru_bwd(xw, wh, hs, dhs), GRU_BWD_KERNELS))
        log(f"[time] gru_bwd B={xw.shape[0]} T={xw.shape[1]} H={wh.shape[0]}: {parts_text(t, GRU_BWD_KERNELS)}  "
            f"({gpu})")
    # B1 and B2 on the grid at the wide path's shape.
    xw, wh = wide["fwd"].pop("args")
    wide["fwd"].update(device_parts(lambda: fused_gru_scan(xw, wh), GRU_FWD_GRID_KERNELS))
    xw, wh, hs, dhs = wide["bwd"].pop("args")
    wide["bwd"].update(device_parts(lambda: fused_gru_bwd(xw, wh, hs, dhs), GRU_BWD_GRID_KERNELS))
    log(f"[time] gru_fwd B={xw.shape[0]} T={xw.shape[1]} H={wh.shape[0]} (grid): device {wide['fwd']['device_ms']:.4f} "
        f"ms (CUDA events {wide['fwd']['ms']:.4f} ms); gru_bwd: {parts_text(wide['bwd'], GRU_BWD_GRID_KERNELS)}  ({gpu})")
    t = lstm["bwd"]
    args = t.pop("args")
    t.update(device_parts(lambda: fused_lstm_bwd(*args), LSTM_BWD_KERNELS))
    log(f"[time] lstm_bwd B={args[0].shape[0]} T={args[0].shape[1]} H={args[2].shape[0]}: "
        f"{parts_text(t, LSTM_BWD_KERNELS)}  ({gpu})")


def pool_recurrence_device_phase(sampled: dict, lstm: dict, rnn: dict, gpu: str, lstm_wide: dict,
                                 rnn_wide: dict) -> None:
    """Device time by kernel, on the inputs the earlier phases timed: B9
    (kernel and merge apart, also at ``SAMPLED_LSE_SPLITS``) and B10 (pass by
    pass, also at ``SAMPLED_SPLITS``) at config #4's shape, both at config
    #5's (D = 512), at config #4's at D = 1024 and config #5's rows at 768,
    B3 at config
    #2's and at ``LSTM_TIMED`` (and at each cluster of
    ``LSTM_CLUSTER_CASES``), B5 at config #3's and at ``RNN_TIMED`` (and at
    each cluster of ``RNN_FWD_CLUSTER_CASES``), B6 (pass by pass, and at each
    cluster of ``RNN_CLUSTER_CASES``) at config #3's and at ``RNN_TIMED``'s
    H = 512; B3/B4 and B5/B6 on the grid at the wide paths' shapes (pass by
    pass). After the timing phases, as every profiler reading."""
    from poi_tpu_torch.ops.fused_lstm import fused_lstm_bwd, fused_lstm_scan
    from poi_tpu_torch.ops.fused_rnn import fused_rnn_bwd, fused_rnn_scan
    from poi_tpu_torch.ops.fused_sampled import sampled_bwd, sampled_lse

    cases = [("sampled_lse", sampled["lse"], sampled_lse, SAMPLED_LSE_KERNELS),
             ("sampled_bwd", sampled["bwd"], sampled_bwd, SAMPLED_BWD_KERNELS),
             ("sampled_lse", sampled["lse_d512"], sampled_lse, SAMPLED_LSE_KERNELS),
             ("sampled_bwd", sampled["bwd_d512"], sampled_bwd, SAMPLED_BWD_KERNELS),
             *((f"sampled_{d}", sampled[f"{d}_d{w}"], fn, names) for w in (1024, 768)
               for d, fn, names in (("lse", sampled_lse, SAMPLED_LSE_KC_KERNELS),
                                    ("bwd", sampled_bwd, SAMPLED_BWD_KERNELS))),
             *(("lstm_fwd", lstm[k], fused_lstm_scan, LSTM_FWD_KERNELS)
               for k in ("fwd", *(f"fwd_{k}" for k in LSTM_TIMED))),
             *(("rnn_fwd", rnn[k], fused_rnn_scan, RNN_FWD_KERNELS) for k in ("fwd", *(f"fwd_{k}" for k in RNN_TIMED))),
             *(("rnn_bwd", rnn[k], fused_rnn_bwd, RNN_BWD_KERNELS) for k in ("bwd", "bwd_h512")),
             ("lstm_fwd_grid", lstm_wide["fwd"], fused_lstm_scan, LSTM_FWD_GRID_KERNELS),
             ("lstm_bwd_grid", lstm_wide["bwd"], fused_lstm_bwd, LSTM_BWD_GRID_KERNELS),
             ("rnn_fwd_grid", rnn_wide["fwd"], fused_rnn_scan, RNN_FWD_GRID_KERNELS),
             ("rnn_bwd_grid", rnn_wide["bwd"], fused_rnn_bwd, RNN_BWD_GRID_KERNELS)]
    sampled_split_times(sampled["bwd"]["args"], gpu)
    sampled_lse_split_times(sampled["lse"]["args"], gpu)
    for tag, t, fn, names in cases:
        args = t.pop("args")
        t.update(device_parts(lambda: fn(*args), names))
        log(f"[time] {tag} {'x'.join(map(str, args[0].shape))}: {parts_text(t, names)} (CUDA events {t['ms']:.4f} "
            f"ms)  ({gpu})")
    lstm_cluster_choice(gpu)
    rnn_fwd_cluster_choice(gpu)
    rnn_cluster_choice(gpu)


def sampled_case(N: int, S: int, D: int, V: int, gen, pad: int = 0, hits=None):
    """Queries, a pool of S draws from V ids with ``pad`` entries appended
    as the TPU kernel pads its pool (bias -1e30, id -1), targets, and the
    lse/g a backward receives. ``hits`` "two": every row's target is id 7,
    which pool entries 3 and S-1 carry; "all": every pool entry is id 7, the
    target of rows 0-19."""
    import torch

    from poi_tpu_torch.ops.fused_sampled import NEG, log_q, sampled_lse_reference

    q = 0.3 * torch.randn(N, D, generator=gen, device=DEV)
    e = 0.3 * torch.randn(S + pad, D, generator=gen, device=DEV)
    b = 0.1 * torch.randn(S + pad, generator=gen, device=DEV) - log_q(S, V)
    ids = torch.randint(0, V, (S + pad,), generator=gen, device=DEV)
    b[S:], ids[S:] = NEG, -1
    tgt = torch.randint(0, V, (N,), generator=gen, device=DEV)
    if hits == "two":
        tgt[:] = 7
        ids[[3, S - 1]] = 7
    elif hits == "all":
        tgt[:20], ids[:S] = 7, 7
        tgt[20:] = torch.where(tgt[20:] == 7, 8, tgt[20:])
    s_pos = 0.3 * torch.randn(N, generator=gen, device=DEV)
    lse_tot = torch.logaddexp(sampled_lse_reference(q, e, b, ids, tgt), s_pos)
    g = torch.rand(N, generator=gen, device=DEV) / N
    return q, e, b, ids, tgt, lse_tot, g


def sampled_phase() -> dict:
    """B9 and B10 against their plain versions at config #4's shape and
    config #5's (D = 512), at D = 384 (padded to 512), at pools that are no
    multiple of the 64-row tile (padded as the TPU pads them), and with pool
    entries that are a hit for every row; then the K-chunked kernels at
    config #4's shape at D = 1024, config #5's rows at 768 and a ragged 640;
    both timed at ``SAMPLED_TIMED``'s shapes."""
    import torch

    from poi_tpu_torch.ops.fused_sampled import (NEG, sampled_bwd, sampled_bwd_reference, sampled_lse,
                                                 sampled_lse_reference)

    gen = torch.Generator(device=DEV).manual_seed(SEED + 7)
    out = {"lse_err": 0.0, "grad_err": 0.0}
    for N, S, D, V, pad, hits in SAMPLED_CASES:
        q, e, b, ids, tgt, lse_tot, g = sampled_case(N, S, D, V, gen, pad, hits)
        full_hits = torch.tensor([3, S - 1] if hits == "two" else [], dtype=torch.long, device=DEV)
        lse = sampled_lse(q, e, b, ids, tgt)
        torch.cuda.synchronize()
        want_lse = sampled_lse_reference(q, e, b, ids, tgt)
        e_lse = float((lse - want_lse).abs().max())
        assert bool(torch.isfinite(lse).all()), f"sampled_lse N={N} S={S} D={D}: non-finite lse"
        assert e_lse < CE_LSE_TOL, f"sampled_lse N={N} S={S} D={D}: max |kernel - plain| {e_lse}"
        if hits == "all":
            assert bool((lse[:20] == NEG).all()), f"sampled_lse: rows whose every entry is a hit gave {lse[:20]}"
        sampled_lse_splits(q, e, b, ids, tgt, lse)
        got = sampled_bwd(q, e, b, ids, tgt, lse_tot, g)
        torch.cuda.synchronize()
        want = sampled_bwd_reference(q, e, b, ids, tgt, lse_tot, g)
        errs = [rel_err(a, w) for a, w in zip(got, want)]
        checked = b10_check((q, e, b, ids, tgt, lse_tot, g), got, want, f"sampled_bwd N={N} S={S} D={D}")
        if b10_bounded(D):
            out.setdefault("b10_ratios", []).append({"case": [N, S, D, V, pad, hits], "dq": checked[0],
                                                     "de": checked[1], **({"db": checked[2]} if len(checked) > 2
                                                                          else {})})
        zero_rows = torch.cat([full_hits, torch.arange(S, S + pad, device=DEV)])
        assert bool((got[1][zero_rows] == 0).all()) and bool((got[2][zero_rows] == 0).all()), \
            "a hit column or a padded pool entry got gradient"
        again = (sampled_lse(q, e, b, ids, tgt), *sampled_bwd(q, e, b, ids, tgt, lse_tot, g))
        assert all(torch.equal(a, w) for a, w in zip(again, (lse, *got))), f"sampled N={N} S={S}: run-to-run bits"
        out["lse_err"] = max(out["lse_err"], e_lse)
        out["grad_err"] = max(out["grad_err"], *(float((a - w).abs().max()) for a, w in zip(got, want)))
        n_hits = int((ids[None, :] == tgt[:, None]).sum())
        all_hit = "; rows 0-19 (every entry a hit or padding) give -1e30" if hits == "all" else ""
        log(f"[sampled] N={N} S={S}{f'+{pad} padded' if pad else ''} D={D}: {n_hits} hits; lse max err {e_lse:.2e} "
            f"(tol {CE_LSE_TOL}){all_hit}; rel err dq {errs[0]:.2e}, de {errs[1]:.2e} ("
            + (f"element-wise bound: largest |err| / bound dq {checked[0]:.4f}, de {checked[1]:.4f}"
               + (f", db {checked[2]:.4f}" if len(checked) > 2 else "") + ", each <= 1"
               if b10_bounded(D) else f"tol {CE_GRAD_TOL}")
            + f"), db {errs[2]:.2e}" + ("" if len(checked) > 2 else f" (tol {CE_DBIAS_TOL})")
            + f"; {len(zero_rows)} hit/padded pool rows exactly 0; a second run gives "
            f"the same bits; every forced split of B9 within the tolerance")
        key = SAMPLED_TIMED.get((N, S, D, V, pad, hits))
        if key is not None:
            # No single PyTorch call computes the masked pool LSE or its
            # gradients: no library time.
            if key:  # the wider rows' own parity (the top-level rows carry every case's worst)
                out["lse_err" + key] = e_lse
                out["grad_err" + key] = max(float((a - w).abs().max()) for a, w in zip(got, want))
            out["lse" + key] = {"ms": time_ms(lambda: sampled_lse(q, e, b, ids, tgt)),
                                "plain_ms": time_ms(lambda: sampled_lse_reference(q, e, b, ids, tgt)),
                                "library_ms": None, **bound((q, e, b, ids, tgt), (lse,), bf16_flop=2 * N * S * D),
                                "bound_kernel_ms": loss_kernel_flop("sampled_lse", N, S, D) / BF16_FLOP_PER_S * 1e3,
                                "args": (q, e, b, ids, tgt)}
            out["bwd" + key] = {"ms": time_ms(lambda: sampled_bwd(q, e, b, ids, tgt, lse_tot, g)),
                                "plain_ms": time_ms(lambda: sampled_bwd_reference(q, e, b, ids, tgt, lse_tot, g)),
                                "library_ms": None,
                                **bound((q, e, b, ids, tgt, lse_tot, g), got, bf16_flop=6 * N * S * D),
                                "bound_kernel_ms": loss_kernel_flop("sampled_bwd", N, S, D) / BF16_FLOP_PER_S * 1e3,
                                "args": (q, e, b, ids, tgt, lse_tot, g)}
            for d in ("lse", "bwd"):
                t = out[d + key]
                log(f"[time] sampled_{d} N={N} S={S} D={D}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms; "
                    f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}; the kernel's own count "
                    f"{t['bound_kernel_ms']:.4f} ms)")
            sampled_splits(q, e, b, ids, tgt, lse_tot, g, got)
            sampled_nll_bits(q, e, b, ids, tgt, g)
    # The K-chunked B10's largest |err| / element-wise bound, dq's and dE's, by width.
    out["b10_ratios_max"] = {w: [max(r[k] for r in out["b10_ratios"] if r["case"][2] == w)
                                 for k in ("dq", "de", "db")] for w in (768, 1024)}
    return out


def b10_bound_ratios(args, got, want, with_db: bool = False) -> tuple:
    """B10's outputs ``got`` against the plain version's ``want`` element by
    element: the largest |dq - dq_plain| / bound and |dE - dE_plain| /
    bound, each <= 1 for a correct kernel (0/0 counts as 0). ``args``: the
    wrapper's inputs (q, e, b, ids, tgt, lse_tot, g).

    The bound follows the arithmetic of both sides, with u = 2^-24 (fp32's
    unit roundoff) and gp = exp(z - lse) * g the plain version's fp32 gp:

    - Each side rounds its own gp to bf16 (the TPU kernel does the same,
      poi_tpu/ops/fused_sampled.py:122), each within 2^-8 of it (bf16's unit
      roundoff). Where the two fp32 gp straddle a rounding midpoint they land
      one bf16 step apart, and a step is below 2^-7 of gp: so |gpb_kernel -
      gpb_plain| <= 2^-7 |gp| + 1.01 |gp_kernel - gp_plain|.
    - The two fp32 gp differ by at most delta |gp| (first order): the logit's
      D-term sum, fp32 on both sides in other orders, the kernel's on the
      tensor cores, allowed to truncate: 3 D u (|q| @ |e|^T); the bias add,
      the lse subtraction and the g product, one rounding each a side:
      4 u (|z| + |z - lse|) + 2 u; the kernel's __expf against torch.exp:
      (2 + 1.173 |z - lse|) ulps (CUDA's bound for __expf) plus 2 ulps, an
      ulp 2^-23: (4 + 1.2 |z - lse|) 2u.
    - The products' fp32 sums over the n terms (S for dq, N for dE), any
      order: (n - 1) u on the plain side and (n - 1) 2u on the kernel's,
      of sum |gpb| |operand|; 3.03 (n - 1) u with 1% for the kernel's gpb.

    So |dq - dq_plain| <= (c |gp| + 3.03 (S - 1) u |gpb|) @ |E_bf16| and
    |dE - dE_plain| <= (c |gp| + 3.03 (N - 1) u |gpb|)^T @ |q_bf16|, with
    c = 2^-7 + 1.01 delta. Unlike the largest error over the largest value
    (``rel_err``), it catches one small element that is far off. Hit and
    padded columns have gp = 0 on both sides, so their bound is 0.
    ``with_db``: also db's ratio, db being fp32 sums of the unrounded gp over
    the N rows: |db - db_plain| <= colsum(1.01 delta |gp| + 3.03 (N - 1) u
    |gp|)."""
    import torch

    from poi_tpu_torch.ops.fused_sampled import sampled_logits_reference

    q, e, b, ids, tgt, lse_tot, g = args
    u = 2.0 ** -24
    N, D = q.shape
    S = e.shape[0]
    qa, ea = q.to(torch.bfloat16).float().abs(), e.to(torch.bfloat16).float().abs()
    z = sampled_logits_reference(q, e, b, ids, tgt)
    x = z - lse_tot.float()[:, None]
    gp = torch.exp(x) * g.float()[:, None]
    gpa = gp.abs()
    gpba = gp.to(torch.bfloat16).float().abs()
    del gp
    delta = 3 * D * u * (qa @ ea.T) + 4 * u * (z.abs() + x.abs()) + 2 * u + (4 + 1.2 * x.abs()) * 2 * u
    del z, x
    bounds = [((1.01 * delta + 3.03 * (N - 1) * u) * gpa).sum(dim=0)] if with_db else []
    cg = (2.0 ** -7 + 1.01 * delta) * gpa
    del delta, gpa
    bounds = [(cg + 3.03 * (S - 1) * u * gpba) @ ea, (cg + 3.03 * (N - 1) * u * gpba).T @ qa, *bounds]
    ratios = []
    for a, w, bd in zip(got, want, bounds):
        err = (a - w).abs()
        ratios.append(float(torch.where(err == 0, 0.0, err / bd).max()))
    return tuple(ratios)


def b10_bounded(D: int) -> bool:
    """Whether ``b10_check`` holds B10 at width ``D`` by its element-wise
    bound: at ``B10_BOUND_DIMS`` and where the kernels run K-chunked."""
    from poi_tpu_torch.ops.fused_sampled import KERNEL_DIMS
    from poi_tpu_torch.ops.widths import padded_dim

    return D in B10_BOUND_DIMS or kchunked(padded_dim(D, KERNEL_DIMS, "sampled_bwd"))


def b10_check(args, got, want, what: str) -> tuple:
    """B10's outputs against the plain version's: dq and dE by the
    element-wise bound at ``B10_BOUND_DIMS`` (the ratios returned, each
    <= 1), by ``CE_GRAD_TOL`` of ``rel_err`` below (those returned); db by
    ``CE_DBIAS_TOL`` (fp32 sums of the unrounded gp). Where the kernels run
    K-chunked (``kchunked``), all three by the bound (three ratios
    returned)."""
    from poi_tpu_torch.ops.fused_sampled import KERNEL_DIMS
    from poi_tpu_torch.ops.widths import padded_dim

    db = rel_err(got[2], want[2])
    if kchunked(padded_dim(args[0].shape[1], KERNEL_DIMS, "sampled_bwd")):
        ratios = b10_bound_ratios(args, got, want, with_db=True)
        assert max(ratios) <= 1.0, f"{what}: |err| / element-wise bound dq/de/db {ratios}, db rel err {db}"
        return ratios
    if args[0].shape[1] in B10_BOUND_DIMS:
        ratios = b10_bound_ratios(args, got, want)
        assert max(ratios) <= 1.0 and db < CE_DBIAS_TOL, \
            f"{what}: |err| / element-wise bound dq/de {ratios}, db rel err {db}"
        return ratios
    errs = (rel_err(got[0], want[0]), rel_err(got[1], want[1]))
    assert max(errs) < CE_GRAD_TOL and db < CE_DBIAS_TOL, f"{what}: rel err dq/de/db {(*errs, db)}"
    return errs


def sampled_lse_at(args, splits: int):
    """B9 through its C entry with the pool ranges to force; the wrapper
    always passes 0, the rule. ``args``: the wrapper's inputs. Returns
    lse."""
    import torch

    from poi_tpu_torch import _build
    from poi_tpu_torch.ops.fused_sampled import KERNEL_DIMS, _kernel_args
    from poi_tpu_torch.ops.widths import padded_dim

    lib = _build.library()
    ins = _kernel_args(*args, padded_dim(args[0].shape[1], KERNEL_DIMS, "sampled_lse"))
    (N, D), S = ins[0].shape, ins[1].shape[0]
    lse = torch.empty(N, device=DEV)
    scratch = torch.empty(max(1, lib.sampled_lse_scratch(N, S, D, splits)), device=DEV)
    rc = lib.sampled_lse(*(a.data_ptr() for a in ins), lse.data_ptr(), scratch.data_ptr(), N, S, D, splits,
                         ins[0].device.index, torch.cuda.current_stream().cuda_stream)
    _build.check(rc, f"sampled_lse at splits {splits}")
    return lse


def sampled_lse_splits(q, e, b, ids, tgt, want) -> None:
    """B9 at each of ``SAMPLED_LSE_SPLITS``, within ``CE_LSE_TOL`` of the
    rule's ``want`` and the same bits on a second launch; every row of
    ``want`` at -1e30 stays there. The ranges change the merge's fp32 order,
    so their bits differ from the rule's."""
    import torch

    for splits in SAMPLED_LSE_SPLITS:
        got = sampled_lse_at((q, e, b, ids, tgt), splits)
        err = float((got - want).abs().max())
        assert err < CE_LSE_TOL and torch.isfinite(got).all(), (splits, err)
        all_hit = want == -1e30
        assert torch.equal(got[all_hit], want[all_hit]), splits
        assert torch.equal(sampled_lse_at((q, e, b, ids, tgt), splits), got), (splits, "bits")


def sampled_lse_split_times(args, gpu: str) -> None:
    """B9's device time at each of ``SAMPLED_LSE_SPLITS``, kernel and merge
    apart: the measurement behind its split rule."""
    N, D = args[0].shape
    S = args[1].shape[0]
    for splits in SAMPLED_LSE_SPLITS:
        t = device_parts(lambda: sampled_lse_at(args, splits), SAMPLED_LSE_KERNELS)
        log(f"[time] sampled_lse splits = {splits or 'rule'} N={N} S={S} D={D}: "
            f"{parts_text(t, SAMPLED_LSE_KERNELS)}  ({gpu})")


def sampled_nll_bits(q, e, b, ids, tgt, g) -> None:
    """``SampledNLL`` hands its forward's bf16/int32 kernel arguments to its
    backward: B10's outputs through it are the bits of ``sampled_bwd`` on
    the fp32 inputs, cast in the call."""
    import torch

    from poi_tpu_torch.ops.fused_sampled import sampled_bwd, sampled_lse, sampled_nll_rows

    s_pos = torch.randn(q.shape[0], generator=torch.Generator(device=DEV).manual_seed(SEED + 15), device=DEV)
    leaves = [t.clone().requires_grad_() for t in (q, e, b, s_pos)]
    sampled_nll_rows(*leaves, tgt, ids).backward(g)
    lse_tot = torch.logaddexp(sampled_lse(q, e, b, ids, tgt), s_pos)
    want = sampled_bwd(q, e, b, ids, tgt, lse_tot, g)
    assert all(torch.equal(a.grad, w) for a, w in zip(leaves, want)), "SampledNLL's backward: other bits"
    log("[sampled] SampledNLL's backward on its forward's kernel arguments: B10's bits on the fp32 inputs")


def sampled_bwd_at(args, splits):
    """B10 through its C entry with the (dq, dE) splits to force; the
    wrapper always passes (0, 0), the kernels' own rule. ``args``: the
    wrapper's inputs. Returns (dq, de, db)."""
    import torch

    from poi_tpu_torch import _build
    from poi_tpu_torch.ops.fused_sampled import KERNEL_DIMS, bwd_kernel_args
    from poi_tpu_torch.ops.widths import padded_dim

    lib = _build.library()
    ins = bwd_kernel_args(*args, padded_dim(args[0].shape[1], KERNEL_DIMS, "sampled_bwd"))
    (N, D), S = ins[0].shape, ins[1].shape[0]
    dq, de, db = torch.empty(N, D, device=DEV), torch.empty(S, D, device=DEV), torch.empty(S, device=DEV)
    scratch = torch.empty(max(1, lib.sampled_bwd_scratch(N, S, D, *splits)), device=DEV)
    rc = lib.sampled_bwd(*(a.data_ptr() for a in ins), dq.data_ptr(), de.data_ptr(), db.data_ptr(),
                         scratch.data_ptr(), N, S, D, *splits, ins[0].device.index,
                         torch.cuda.current_stream().cuda_stream)
    _build.check(rc, f"sampled_bwd at splits {splits}")
    return dq, de, db


def sampled_splits(q, e, b, ids, tgt, lse_tot, g, want) -> None:
    """B10 at each of ``SAMPLED_SPLITS`` within the tolerances of the rule's
    run (``want``); ``sampled_split_times`` times them."""
    for dq_s, de_s in SAMPLED_SPLITS:
        got = sampled_bwd_at((q, e, b, ids, tgt, lse_tot, g), (dq_s, de_s))
        errs = [rel_err(a, w) for a, w in zip(got, want)]
        assert errs[0] < CE_GRAD_TOL and errs[1] < CE_GRAD_TOL and errs[2] < CE_DBIAS_TOL, (dq_s, de_s, errs)
    log(f"[sampled] forced splits (dq, dE) {', '.join(map(str, SAMPLED_SPLITS[1:]))}: within the tolerances of "
        f"the rule's results")


def sampled_split_times(args, gpu: str) -> None:
    """B10's device time at each of ``SAMPLED_SPLITS``, pass by pass: the
    measurement behind the split rule."""
    from poi_tpu_torch import _build

    N, D = args[0].shape
    S = args[1].shape[0]
    for dq_s, de_s in SAMPLED_SPLITS:
        t = device_parts(lambda: sampled_bwd_at(args, (dq_s, de_s)), SAMPLED_BWD_KERNELS)
        scratch = _build.library().sampled_bwd_scratch(N, S, D, dq_s, de_s) * 4 / 2**20
        log(f"[time] sampled_bwd splits (dq, dE) = ({dq_s or 'rule'}, {de_s or 'rule'}) N={N} S={S} D={D}: "
            f"{parts_text(t, SAMPLED_BWD_KERNELS)}; scratch {scratch:.1f} MiB  ({gpu})")


def recurrence_case(B: int, T: int, H: int, gates: int, gen):
    """Gate inputs [B, T, gates·H], a ragged [B, T] mask (row 0 full) and
    bf16 recurrent weights [H, gates·H] at the init scale."""
    import torch

    x = torch.randn(B, T, gates * H, generator=gen, device=DEV)
    w = (torch.randn(H, gates * H, generator=gen, device=DEV) / H**0.5).to(torch.bfloat16)
    lengths = torch.randint(1, T + 1, (B,), generator=gen, device=DEV)
    lengths[0] = T
    mask = (torch.arange(T, device=DEV)[None, :] < lengths[:, None]).float()
    return x, mask, w, lengths


def check_recurrence(tag: str, scan, scan_ref, bwd, bwd_ref, x, mask, w, lengths, tol: float) -> dict:
    """A recurrence kernel pair against its plain versions: the forward at
    the valid steps (every carry it returns), the carries held exactly
    through the padded tail, the backward relative to each output's largest
    element, its input cotangent exactly 0 on padded steps, and the same
    bits on a second launch of each. Returns the errors and the tensors."""
    import torch

    B, T = mask.shape
    carries = scan(x, mask, w)
    carries = carries if isinstance(carries, tuple) else (carries,)
    torch.cuda.synchronize()
    want = scan_ref(x, mask, w)
    want = want if isinstance(want, tuple) else (want,)
    valid = mask[:, :, None] > 0
    fwd_err = max(float(((c - r).abs() * valid).max()) for c, r in zip(carries, want))
    assert all(torch.isfinite(c).all() for c in carries), f"{tag} B={B} T={T}: non-finite forward"
    assert fwd_err < tol, f"{tag} B={B} T={T}: max |kernel - plain| at valid steps {fwd_err} >= {tol}"
    rows = torch.arange(B, device=DEV)
    for c in carries:
        last = c[rows, lengths - 1]
        assert torch.equal(torch.where(valid, last[:, None, :], c), last[:, None, :].expand_as(c)), \
            f"{tag} B={B} T={T}: a padded step moved a carry"
    again = scan(x, mask, w)
    assert all(torch.equal(a, c) for a, c in zip(again if isinstance(again, tuple) else (again,), carries)), \
        f"{tag} B={B} T={T}: forward run-to-run bits"
    dhs = torch.randn_like(carries[0])  # nonzero on padded steps too
    dx, dw = bwd(x, mask, w, *carries, dhs)
    torch.cuda.synchronize()
    want_x, want_w = bwd_ref(x, mask, w, *carries, dhs)
    ex, ew = rel_err(dx, want_x), rel_err(dw, want_w)
    assert torch.isfinite(dx).all() and torch.isfinite(dw).all(), f"{tag} bwd B={B} T={T}: non-finite"
    assert ex < REC_BWD_TOL and ew < REC_BWD_TOL, f"{tag} bwd B={B} T={T}: rel err dx {ex}, dw {ew}"
    pad = dx[mask == 0]
    assert bool((pad == 0).all()), f"{tag} bwd B={B} T={T}: nonzero input cotangent on a padded step"
    again = bwd(x, mask, w, *carries, dhs)
    assert torch.equal(again[0], dx) and torch.equal(again[1], dw), f"{tag} bwd B={B} T={T}: run-to-run bits"
    bwd_err = max(float((dx - want_x).abs().max()), float((dw - want_w).abs().max()))
    log(f"[{tag}] B={B:2d} T={T} H={w.shape[0]}: forward max |kernel - plain| at valid steps {fwd_err:.3e} (tol "
        f"{tol}), carries exact through {int((mask == 0).sum())} padded steps; backward rel err dx {ex:.2e}, dw "
        f"{ew:.2e} (tol {REC_BWD_TOL}), dx on padded steps exactly 0; second launches give the same bits")
    return {"fwd_err": fwd_err, "bwd_err": bwd_err, "carries": carries, "dhs": dhs}


def expect_width_limit(fn, *args) -> str:
    """``fn`` must refuse a hidden width past the kernels' limit and name it."""
    try:
        fn(*args)
    except ValueError as e:
        assert "H <=" in str(e), str(e)
        return str(e)
    raise AssertionError(f"{fn.__name__} took a width past its limit")


def recurrence_phase(tag: str, gates: int, shapes, tol: float, ops) -> dict:
    """B3/B4 (``gates`` = 4) or B5/B6 (1) against their plain versions at
    ``shapes``; times both directions at the first shape (the config's train
    shape) against the plain versions and cuDNN's forward, with their bounds.
    (The widths past the cluster kernels, and the refusal past the pairs'
    limits: ``rec_wide_phase``.)"""
    import torch

    scan, scan_ref, bwd, bwd_ref = ops
    gen = torch.Generator(device=DEV).manual_seed(SEED + 8 + gates)
    out = {"fwd_err": 0.0, "bwd_err": 0.0}
    for B, T, H in shapes:
        x, mask, w, lengths = recurrence_case(B, T, H, gates, gen)
        r = check_recurrence(tag, scan, scan_ref, bwd, bwd_ref, x, mask, w, lengths, tol)
        out["fwd_err"] = max(out["fwd_err"], r["fwd_err"])
        out["bwd_err"] = max(out["bwd_err"], r["bwd_err"])
        if (B, T, H) != shapes[0]:
            continue
        carries, dhs = r["carries"], r["dhs"]
        G = gates * H
        out["fwd"] = {"ms": time_ms(lambda: scan(x, mask, w)), "plain_ms": time_ms(lambda: scan_ref(x, mask, w), 5),
                      "library_ms": cudnn_ms("lstm" if gates == 4 else "rnn", B, T, H, DEV),
                      **bound((x, mask, w), carries, bf16_flop=2 * B * T * H * G), "args": (x, mask, w)}
        dx_dw = bwd(x, mask, w, *carries, dhs)
        out["bwd"] = {"ms": time_ms(lambda: bwd(x, mask, w, *carries, dhs)),
                      "plain_ms": time_ms(lambda: bwd_ref(x, mask, w, *carries, dhs), 5), "library_ms": None,
                      **(lstm_bwd_bound(x, mask, w, carries, dhs, dx_dw) if gates == 4 else
                         bound((x, mask, w, *carries, dhs), dx_dw, bf16_flop=2 * B * T * H * G,
                               fp32_flop=4 * B * T * H * G)),
                      "args": (x, mask, w, *carries, dhs)}
        for d in ("fwd", "bwd"):
            t = out[d]
            lib = f", cuDNN forward {t['library_ms']:.4f} ms" if t["library_ms"] is not None else ""
            log(f"[time] {tag}_{d} B={B} T={T} H={H}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms{lib}; "
                f"bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
    return out


def lstm_phase() -> dict:
    """B3/B4 at ``LSTM_SHAPES``, then B3 timed at ``LSTM_TIMED`` beside its
    plain version and cuDNN's forward."""
    import torch

    from poi_tpu_torch.ops.fused_lstm import fused_lstm_bwd, fused_lstm_scan, lstm_bwd_reference, lstm_scan_reference

    out = recurrence_phase("lstm", 4, LSTM_SHAPES, LSTM_TOL,
                           (fused_lstm_scan, lstm_scan_reference, fused_lstm_bwd, lstm_bwd_reference))
    gen = torch.Generator(device=DEV).manual_seed(SEED + 13)
    for key, (B, T, H) in LSTM_TIMED.items():
        x, mask, w, _ = recurrence_case(B, T, H, 4, gen)
        t = {"ms": time_ms(lambda: fused_lstm_scan(x, mask, w)),
             "plain_ms": time_ms(lambda: lstm_scan_reference(x, mask, w), 5),
             "library_ms": cudnn_ms("lstm", B, T, H, DEV),
             **bound((x, mask, w), fused_lstm_scan(x, mask, w), bf16_flop=2 * B * T * H * 4 * H), "args": (x, mask, w)}
        out[f"fwd_{key}"] = t
        log(f"[time] lstm_fwd B={B} T={T} H={H}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, cuDNN "
            f"nn.LSTM forward {t['library_ms']:.4f} ms; bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
    return out


def lstm_cluster_choice(gpu: str) -> None:
    """B3 at each cluster size that fits, beside the one the kernel picks,
    at ``LSTM_CLUSTER_CASES`` by device time: the measurement behind the
    pick. A warp's arithmetic does not depend on the cluster, so every
    cluster gives the pick's bits. The C entry takes the cluster size to
    force; the wrapper always passes 0, the kernel's own pick."""
    import torch

    from poi_tpu_torch import _build
    from poi_tpu_torch.ops.fused_lstm import fused_lstm_scan

    lib = _build.library()
    gen = torch.Generator(device=DEV).manual_seed(SEED + 14)
    for B, T, H in LSTM_CLUSTER_CASES:
        x, mask, w, _ = recurrence_case(B, T, H, 4, gen)
        want = fused_lstm_scan(x, mask, w)
        hs, cs = torch.empty(B, T, H, device=DEV), torch.empty(B, T, H, device=DEV)

        def at(c):
            rc = lib.lstm_fwd(x.data_ptr(), mask.data_ptr(), w.data_ptr(), hs.data_ptr(), cs.data_ptr(), B, T, H, c,
                              x.device.index, torch.cuda.current_stream().cuda_stream)
            _build.check(rc, f"lstm_fwd on a cluster of {c}")

        times = {}
        for c in (1, 2, 4, 8, 16):
            if not lib.lstm_fwd_fits(H, c):
                continue
            at(c)
            assert torch.equal(hs, want[0]) and torch.equal(cs, want[1]), f"lstm_fwd C={c} B={B} H={H}: other bits"
            times[c] = device_ms(lambda: at(c), expect=LSTM_FWD_KERNELS)
        log(f"[time] lstm_fwd cluster choice B={B} T={T} H={H}, device time: "
            + ", ".join(f"C={c} {ms:.4f} ms" for c, ms in times.items())
            + f"; each the pick's bits; the kernel picks C={lib.lstm_fwd_cluster_size(H)}  ({gpu})")


def rnn_cluster_choice(gpu: str) -> None:
    """B6 at each cluster size that fits its carry, beside the one the
    kernel picks, at ``RNN_CLUSTER_CASES`` by device time, pass by pass: the
    measurement behind the pick. A warp's arithmetic does not depend on the
    cluster, so every cluster gives the pick's bits. The C entry takes the
    cluster size to force; the wrapper always passes 0, the kernel's own
    pick."""
    import torch

    from poi_tpu_torch import _build
    from poi_tpu_torch.ops.fused_rnn import fused_rnn_bwd, fused_rnn_scan

    lib = _build.library()
    gen = torch.Generator(device=DEV).manual_seed(SEED + 16)
    for B, T, H in RNN_CLUSTER_CASES:
        x, mask, w, _ = recurrence_case(B, T, H, 1, gen)
        hs = fused_rnn_scan(x, mask, w)
        dhs = torch.randn(B, T, H, generator=gen, device=DEV)
        want = fused_rnn_bwd(x, mask, w, hs, dhs)
        dx, dc = torch.empty(B, T, H, device=DEV), torch.empty(H, H, device=DEV)
        partial = torch.empty(lib.rnn_bwd_splits(B, T, H), H, H, device=DEV)

        def at(c):
            rc = lib.rnn_bwd(x.data_ptr(), mask.data_ptr(), w.data_ptr(), hs.data_ptr(), dhs.data_ptr(),
                             dx.data_ptr(), partial.data_ptr(), dc.data_ptr(), B, T, H, c, x.device.index,
                             torch.cuda.current_stream().cuda_stream)
            _build.check(rc, f"rnn_bwd on a cluster of {c}")

        times = {}
        for c in (1, 2, 4, 8, 16):
            if not lib.rnn_bwd_fits(H, c):
                continue
            at(c)
            assert torch.equal(dx, want[0]) and torch.equal(dc, want[1]), f"rnn_bwd C={c} B={B} H={H}: other bits"
            times[c] = device_parts(lambda: at(c), RNN_BWD_KERNELS)
        log(f"[time] rnn_bwd cluster choice B={B} T={T} H={H}, device time (carry): "
            + ", ".join(f"C={c} {t['device_ms']:.4f} ms ({t['rnn_bwd_carry_ms']:.4f})" for c, t in times.items())
            + f"; each the pick's bits; the kernel picks C={lib.rnn_bwd_cluster_size(H)}  ({gpu})")


def rnn_phase() -> dict:
    """B5/B6 at ``RNN_SHAPES``, then B5 timed at ``RNN_TIMED`` beside its
    plain version and cuDNN's forward, and B6 at its H = 512 shape beside
    its plain version."""
    import torch

    from poi_tpu_torch.ops.fused_rnn import fused_rnn_bwd, fused_rnn_scan, rnn_bwd_reference, rnn_scan_reference

    out = recurrence_phase("rnn", 1, RNN_SHAPES, RNN_TOL,
                           (fused_rnn_scan, rnn_scan_reference, fused_rnn_bwd, rnn_bwd_reference))
    gen = torch.Generator(device=DEV).manual_seed(SEED + 17)
    for key, (B, T, H) in RNN_TIMED.items():
        x, mask, w, _ = recurrence_case(B, T, H, 1, gen)
        hs = fused_rnn_scan(x, mask, w)
        t = {"ms": time_ms(lambda: fused_rnn_scan(x, mask, w)),
             "plain_ms": time_ms(lambda: rnn_scan_reference(x, mask, w), 5),
             "library_ms": cudnn_ms("rnn", B, T, H, DEV),
             **bound((x, mask, w), (hs,), bf16_flop=2 * B * T * H * H), "args": (x, mask, w)}
        out[f"fwd_{key}"] = t
        log(f"[time] rnn_fwd B={B} T={T} H={H}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, cuDNN "
            f"nn.RNN forward {t['library_ms']:.4f} ms; bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
        if key != "h512":
            continue
        dhs = torch.randn(B, T, H, generator=gen, device=DEV)
        args = (x, mask, w, hs, dhs)
        t = {"ms": time_ms(lambda: fused_rnn_bwd(*args)), "plain_ms": time_ms(lambda: rnn_bwd_reference(*args), 5),
             "library_ms": None, **bound(args, fused_rnn_bwd(*args), bf16_flop=2 * B * T * H * H,
                                         fp32_flop=4 * B * T * H * H), "args": args}
        out["bwd_h512"] = t
        log(f"[time] rnn_bwd B={B} T={T} H={H}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms; bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']})")
    return out


def rnn_fwd_cluster_choice(gpu: str) -> None:
    """B5 at each cluster size and rows a group that fit, beside the pair
    the kernel picks, at ``RNN_FWD_CLUSTER_CASES`` by device time: the
    measurement behind the pick. A warp's arithmetic depends on neither, so
    every pair gives the pick's bits. The C entry takes the cluster and the
    rows to force; the wrapper always passes 0, the kernel's own pick."""
    import torch

    from poi_tpu_torch import _build
    from poi_tpu_torch.ops.fused_rnn import fused_rnn_scan

    lib = _build.library()
    gen = torch.Generator(device=DEV).manual_seed(SEED + 18)
    for B, T, H in RNN_FWD_CLUSTER_CASES:
        x, mask, w, _ = recurrence_case(B, T, H, 1, gen)
        want = fused_rnn_scan(x, mask, w)
        hs = torch.empty(B, T, H, device=DEV)

        def at(c, r):
            rc = lib.rnn_fwd(x.data_ptr(), mask.data_ptr(), w.data_ptr(), hs.data_ptr(), B, T, H, c, r,
                             x.device.index, torch.cuda.current_stream().cuda_stream)
            _build.check(rc, f"rnn_fwd on a cluster of {c}, {r} rows a group")

        times = {}
        for c in (1, 2, 4, 8, 16):
            for r in (8, 16):
                if not lib.rnn_fwd_fits(H, c, r):
                    continue
                hs.zero_()
                at(c, r)
                assert torch.equal(hs, want), f"rnn_fwd C={c} R={r} B={B} H={H}: other bits"
                times[c, r] = device_ms(lambda: at(c, r), expect=RNN_FWD_KERNELS)
        pick = lib.rnn_fwd_cluster_size(B, H)
        log(f"[time] rnn_fwd cluster choice B={B} T={T} H={H}, device time: "
            + ", ".join(f"C={c}/R={r} {ms:.4f} ms" for (c, r), ms in times.items())
            + f"; each the pick's bits; the kernel picks C={pick}/R={lib.rnn_fwd_group_rows(B, pick)}  ({gpu})")


def exchange_bytes(B: int, H: int, mod) -> dict:
    """The backward carry's L2 exchange a step, reckoned for the two designs
    on ``mod``'s grid for (B, H) (``grid_shape(B, H, True)``): partial-free
    (each block reads its row group's three bf16 terms of every gate column,
    rows x G H x 3 x 2 bytes; the kernels' design) and partials (each block
    writes an fp32 [rows, H] partial of its own columns, and the owners read
    the U partials of their 8 ocp units); their totals over the R x U
    blocks, and the partials' buffer a step parity."""
    ocp, U, R, rows = mod.grid_shape(B, H, True)
    free = rows * mod.GATES * H * 3 * 2
    part = rows * H * 4 + U * rows * 8 * ocp * 4
    return {"partial_free_block": free, "partial_free_step": free * U * R, "partials_block": part,
            "partials_step": part * U * R, "partials_parity": R * rows * U * H * 4}


def rec_picks(tag: str, mod) -> None:
    """The LSTM's (``tag`` lstm) or the RNN's (rnn) dispatch in Python
    (``mod.design``, ``mod.grid_shape``) against the C side's own picks at
    ``REC_PICK_WIDTHS`` x ``REC_PICK_BATCHES`` and at the limit: the clusters
    take H exactly where the design says "cluster", the grid shapes agree,
    and the limits are the module's."""
    import ctypes

    from poi_tpu_torch import _build

    lib = _build.library()
    limit, cluster_max = getattr(lib, f"{tag}_max_hidden")(), mod.CLUSTER_MAX_HIDDEN
    assert limit == mod.MAX_HIDDEN, (tag, limit, mod.MAX_HIDDEN)
    shape = getattr(lib, f"{tag}_grid_shape")
    got = (ctypes.c_int * 4)()
    n = 0
    for H in (*REC_PICK_WIDTHS, limit, limit + 1):
        cluster = H <= cluster_max
        if tag == "lstm":
            assert (lib.lstm_fwd_cluster_size(H) > 0) == cluster, (H, lib.lstm_fwd_cluster_size(H))
        else:
            assert (lib.rnn_bwd_cluster_size(H) > 0) == cluster, (H, lib.rnn_bwd_cluster_size(H))
            assert all((lib.rnn_fwd_cluster_size(B, H) > 0) == cluster for B in REC_PICK_BATCHES), H
        if H <= limit:
            assert mod.design(H) == ("cluster" if cluster else "grid"), H
        for B in REC_PICK_BATCHES:
            for bwd in (0, 1):
                c = tuple(got) if shape(B, H, bwd, got) else None
                assert c == mod.grid_shape(B, H, bool(bwd)), (tag, B, H, bwd, c, mod.grid_shape(B, H, bool(bwd)))
                n += 1
    B, _, H = LSTM_WIDE_H1024 if tag == "lstm" else RNN_WIDE_H1024
    for b in (B, 256):
        log(f"[{tag}_wide] the backward carry's L2 exchange at B={b}, H={H}, reckoned: "
            + ", ".join(f"{k} {v:,} bytes" for k, v in exchange_bytes(b, H, mod).items()))
    log(f"[{tag}_wide] the Python dispatch agrees with the C side: clusters exactly to H = {cluster_max}, {n} grid "
        f"shapes (the wide path's {mod.grid_shape(B, H, False)} forward, {mod.grid_shape(B, H, True)} backward, "
        f"{mod.grid_shape(256, H, False)} forward at request batch 256: octets a block, unit slices, row groups, "
        f"rows a group), {tag}_max_hidden() = {limit}")


def rec_wide_phase(tag: str, gates: int, shapes, tol: float, ops, mod) -> dict:
    """B3/B4 (``tag`` lstm, ``gates`` = 4) or B5/B6 (rnn, 1) past the
    clusters' widths, on the grid-resident kernels: the dispatch held to the
    C side (``rec_picks``), then ``recurrence_phase`` at ``shapes`` and at
    the pair's limit (both directions timed at the first shape, the wide
    path's, beside their plain versions, cuDNN's forward and their bounds);
    the width past the limit refused, naming it."""
    import torch

    rec_picks(tag, mod)
    shapes = (*shapes, (3, 16, mod.MAX_HIDDEN))
    for B, T, H in shapes:
        ocp, U, R, rows = mod.grid_shape(B, H, False)
        bo, bu, br, brows = mod.grid_shape(B, H, True)
        log(f"[{tag}_wide] B={B} T={T} H={H}: forward on {U} unit slices x {R} row groups of {rows} rows, {ocp} octets "
            f"a block; backward carry on {bu} x {br} of {brows}, {bo} octets")
    out = recurrence_phase(f"{tag}_wide", gates, shapes, tol, ops)
    scan, _, bwd, _ = ops
    H = mod.MAX_HIDDEN + 1
    x = torch.zeros(2, 3, gates * H, device=DEV)
    ones, w = torch.ones(2, 3, device=DEV), torch.zeros(H, gates * H, device=DEV, dtype=torch.bfloat16)
    carries = (x[..., :H],) * (2 if gates == 4 else 1)
    for fn, args in ((scan, (x, ones, w)), (bwd, (x, ones, w, *carries, x[..., :H]))):
        msg = expect_width_limit(fn, *args)
        assert f"H <= {mod.MAX_HIDDEN} ({tag}_max_hidden())" in msg, msg
        log(f"[{tag}_wide] {fn.__name__} H={H} refused: {msg}")
    return out


def lstm_wide_phase() -> dict:
    from poi_tpu_torch.ops import fused_lstm

    return rec_wide_phase("lstm", 4, LSTM_WIDE_SHAPES, LSTM_TOL,
                          (fused_lstm.fused_lstm_scan, fused_lstm.lstm_scan_reference, fused_lstm.fused_lstm_bwd,
                           fused_lstm.lstm_bwd_reference), fused_lstm)


def rnn_wide_phase() -> dict:
    from poi_tpu_torch.ops import fused_rnn

    return rec_wide_phase("rnn", 1, RNN_WIDE_SHAPES, RNN_TOL,
                          (fused_rnn.fused_rnn_scan, fused_rnn.rnn_scan_reference, fused_rnn.fused_rnn_bwd,
                           fused_rnn.rnn_bwd_reference), fused_rnn)


def gru_params(ds, cfg, seed: int = SEED):
    """Full-width params of a GRU config with a tied table, time and geo
    embeddings, in poi_tpu's layout and init scales (models/base.py
    init_embed_params, models/gru.py init_gru_layer), from numpy with a fixed
    seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    m = cfg.model
    d, h = m.embed_dim, m.hidden_dim
    normal = lambda shape, s: (s * rng.normal(size=shape)).astype(np.float32)  # noqa: E731
    embed = {
        "poi": normal((ds.num_pois, d), 0.02),
        "out_bias": np.zeros(ds.num_pois, np.float32),
        "time": normal((ds.num_time_buckets, d), 0.02),
        "geo": normal((ds.num_geo_buckets, d), 0.02),
    }
    layers = []
    for i in range(m.num_layers):
        d_in = d if i == 0 else h
        layers.append({"wx": normal((d_in, 3 * h), d_in**-0.5), "wh": normal((h, 3 * h), h**-0.5),
                       "b": np.zeros(3 * h, np.float32)})
    return {"embed": embed, "tower": {"layers": layers}}


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

    from poi_tpu_torch.configs.presets import get_config
    from poi_tpu_torch.data.dataset import load_dataset
    from poi_tpu_torch.convert import params_from_jax
    from poi_tpu_torch.eval.serve import Recommender
    from poi_tpu_torch.models.base import DataDims, build_model
    from poi_tpu_torch.ops.fused_gru import fused_gru_scan
    from poi_tpu_torch.ops.topk import fused_topk

    cfg = get_config(CONFIG)
    t0 = time.perf_counter()
    ds = load_dataset(cfg.data)
    log(f"[slice] {CONFIG}: {ds.num_pois} POIs, T={ds.max_seq_len}, {len(ds.test)} test rows "
        f"(loaded in {time.perf_counter() - t0:.1f} s)")
    tree = gru_params(ds, cfg)
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
    compare_paths("slice", rec, plain, histories, got)
    state.update(cfg=cfg, ds=ds, tree=tree, rec=rec, plain=plain, histories=histories, launches=launches)


def compare_paths(tag: str, rec, plain, histories, got) -> None:
    """The kernel path's ids ``got`` against the plain ``Recommender``'s on
    the same histories: equal, or a swap of two candidates whose scores lie
    within what the two paths' query difference can move a score."""
    import torch

    from poi_tpu_torch.models.base import batch_to, output_table

    want = plain.recommend(histories, k=got.shape[1], exclude_visited=True)
    with torch.inference_mode():
        batch = batch_to(rec._featurize(histories), DEV)
        q_k, q_p = rec.model.queries_last(batch).double(), plain.model.queries_last(batch).double()
    table, bias = output_table(rec.model.embed, rec.cfg.model)
    table = table.detach().to(torch.bfloat16).double()
    scores = q_p.to(torch.bfloat16).double() @ table.T + bias.detach().double()
    # Two ids may swap only if their scores lie within what the two paths'
    # query difference can move a score (|Δq|·max|e| per row) plus fp32 noise.
    bound = ((q_k - q_p).abs() @ table.abs().max(dim=0).values[:, None]).squeeze(1) * 2 + 1e-5
    g, w = torch.as_tensor(got, device=DEV).long(), torch.as_tensor(want, device=DEV).long()
    rows = torch.arange(len(histories), device=DEV)[:, None]
    near = (scores[rows, g] - scores[rows, w]).abs() <= bound[:, None]
    assert bool(((g == w) | near).all()), f"{tag}: kernel path and plain path disagree beyond near-ties"
    log(f"[{tag}] kernel path vs plain path, batch {len(histories)}: ids equal {int((g == w).sum())}/{g.numel()}, "
        f"max |Δq| {float((q_k - q_p).abs().max()):.3e}")


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


def kernel_wrappers() -> dict:
    from poi_tpu_torch.ops.fused_ce import ce_bwd, ce_lse, ce_lse_variant
    from poi_tpu_torch.ops.fused_gru import fused_gru_bwd, fused_gru_scan
    from poi_tpu_torch.ops.fused_lstm import fused_lstm_bwd, fused_lstm_scan
    from poi_tpu_torch.ops.fused_rnn import fused_rnn_bwd, fused_rnn_scan
    from poi_tpu_torch.ops.fused_sampled import sampled_bwd, sampled_lse
    from poi_tpu_torch.ops.topk import fused_topk

    return {"gru_fwd": fused_gru_scan, "gru_bwd": fused_gru_bwd, "lstm_fwd": fused_lstm_scan,
            "lstm_bwd": fused_lstm_bwd, "rnn_fwd": fused_rnn_scan, "rnn_bwd": fused_rnn_bwd, "ce_lse": ce_lse,
            "ce_bwd": ce_bwd, "topk": fused_topk, "sampled_lse": sampled_lse, "sampled_bwd": sampled_bwd,
            "ce_lse_variant": ce_lse_variant}


def reset_launches() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def train_both_paths(tag: str, cfg, ds, tree, used: tuple, fwd: str = "gru_fwd", steps: int = PATH_STEPS,
                     split: str = "test"):
    """``steps`` (20) device-sampled steps through ``train()``, the loop a
    user runs, on the kernel path and on the plain path (``PLAIN_OVERRIDES``)
    from the params ``tree``; every step a log step, so the history holds
    each step's loss (read once, after the chunk). Compares the per-step
    losses, checks that the kernel path launched each kernel of ``used`` and
    no other, the plain path nothing, then ``evaluate()`` on ``split``: the
    kernel-trained model through the top-k kernel (and the recurrence's
    forward kernel ``fwd``) and through its plain version, the plain-trained
    model, and the popularity baseline. Returns (kernel trainer, the kernel
    path's launches in training, in its evaluate)."""
    import math

    import torch

    from poi_tpu_torch.eval.evaluate import evaluate, popularity_baseline
    from poi_tpu_torch.train.loop import make_trainer, train

    cmp_cfg = cfg.with_overrides({"train.log_every": "1"})
    plain_cfg = cmp_cfg.with_overrides(PLAIN_OVERRIDES)
    kern, plain = make_trainer(cmp_cfg, ds, DEV), make_trainer(plain_cfg, ds, DEV)

    reset_launches()
    _, kst, k_hist = train(cmp_cfg, ds, num_steps=steps, trainer=kern, state=kern.init_state(tree))
    k_loss = torch.tensor([row["loss"] for row in k_hist], dtype=torch.float64)
    launches = read_launches()
    log(f"[{tag}] kernel path, train() over {steps} device-sampled steps, launches: {launches}")
    for name in used:
        assert launches[name] > 0, f"{tag}: the training path skipped {name}: {launches}"
    assert not any(n for name, n in launches.items() if name not in used), f"{tag}: launches {launches}"
    reset_launches()
    _, pst, p_hist = train(plain_cfg, ds, num_steps=steps, trainer=plain, state=plain.init_state(tree))
    p_loss = torch.tensor([row["loss"] for row in p_hist], dtype=torch.float64)
    plain_launches = read_launches()
    assert kst.step == pst.step == steps and len(k_loss) == len(p_loss) == steps, (kst.step, pst.step)
    assert not any(plain_launches.values()), f"{tag}: the plain path launched a kernel: {plain_launches}"
    assert torch.isfinite(k_loss).all() and torch.isfinite(p_loss).all(), f"{tag}: non-finite loss"
    rel = (k_loss - p_loss).abs() / p_loss.abs()
    log(f"[{tag}] loss kernel vs plain: step 1 {k_loss[0]:.6f} / {p_loss[0]:.6f}, step {steps} "
        f"{k_loss[-1]:.6f} / {p_loss[-1]:.6f}; rel diff "
        + ", ".join(f"@{i + 1} {float(rel[i]):.2e}" for i in sorted({0, 9, 19, steps - 1}) if i < steps)
        + f" (tol {LOSS_TOL_FIRST} at step 1, {LOSS_TOL_LAST} after)")
    assert float(rel[0]) < LOSS_TOL_FIRST, f"{tag}: step-1 loss differs: {float(rel[0])}"
    assert float(rel.max()) < LOSS_TOL_LAST, f"{tag}: loss trajectories drift apart: {rel.tolist()}"
    assert float(k_loss[-1]) < float(k_loss[0]), f"{tag}: loss did not drop: {k_loss.tolist()}"

    reset_launches()
    m_kern = evaluate(kern.model, ds, cfg, split)
    eval_launches = read_launches()
    assert eval_launches["topk"] > 0 and eval_launches[fwd] > 0, f"{tag}: evaluate skipped a kernel: {eval_launches}"
    m_tie = evaluate(kern.model, ds, cfg.with_overrides({"eval.topk_impl": "xla"}), split)
    m_plain = evaluate(plain.model, ds, plain_cfg, split)
    for m in (m_kern, m_tie, m_plain):
        assert all(math.isfinite(v) for v in m.values()), m
    log(f"[{tag}] evaluate on {split} ({int(m_kern['eval_examples'])} rows): kernel path recall@10 "
        f"{m_kern['recall@10']:.4f} ndcg@10 {m_kern['ndcg@10']:.4f} (launches {eval_launches}); same model, plain "
        f"top-k {m_tie['recall@10']:.4f}; plain-trained model {m_plain['recall@10']:.4f}; popularity baseline "
        f"{popularity_baseline(ds)['recall@10']:.4f}")
    assert abs(m_kern["recall@10"] - m_tie["recall@10"]) <= RECALL_TIE_TOL, (m_kern, m_tie)
    assert abs(m_kern["recall@10"] - m_plain["recall@10"]) <= RECALL_PATH_TOL, (m_kern, m_plain)
    return kern, launches, eval_launches


def train_phase(state) -> None:
    import math

    from poi_tpu_torch.configs.presets import get_config
    from poi_tpu_torch.data.dataset import load_dataset
    from poi_tpu_torch.train.loop import make_trainer, train

    cfg = get_config("smoke").with_overrides(BENCH_OVERRIDES)
    t0 = time.perf_counter()
    ds = load_dataset(cfg.data)
    log(f"[train] bench workload: {ds.num_pois} POIs, {len(ds.train)} training windows, T={ds.max_seq_len}, "
        f"batch {cfg.train.batch_size}, GRU {cfg.model.hidden_dim}-d {cfg.model.compute_dtype} "
        f"(loaded in {time.perf_counter() - t0:.1f} s)")
    tree = gru_params(ds, cfg)
    _, launches, _ = train_both_paths("train", cfg, ds, tree, used=("gru_fwd", "gru_bwd", "ce_lse", "ce_bwd"))

    # Config #1 at its own width: 6,749 POIs is below the fused-CE threshold,
    # so it trains through the GRU kernels and the dense CE, as in poi_tpu.
    c1 = get_config(CONFIG)
    tr1 = make_trainer(c1, state["ds"], DEV)
    reset_launches()
    _, s1, hist = train(c1, state["ds"], num_steps=5, trainer=tr1, state=tr1.init_state(state["tree"]))
    c1_launches = read_launches()
    log(f"[train] {CONFIG}: 5 host-loader steps, loss {hist[-1]['loss']:.4f}, launches {c1_launches}")
    assert c1_launches["ce_lse"] == 0 and c1_launches["ce_bwd"] == 0, c1_launches
    assert c1_launches["gru_fwd"] > 0 and c1_launches["gru_bwd"] > 0, c1_launches
    assert s1.step == 5 and math.isfinite(hist[-1]["loss"])
    state.update(train_launches=launches, bench_cfg=cfg, bench_ds=ds, bench_tree=tree)


def attention_train_phase(state) -> None:
    """Config #4 trains 20 device-sampled steps through ``train()`` on the
    kernel path and on the plain path from the same random init, at its full
    width (dropout 0.3, sampled softmax over 1,024 negatives, lazy Adam on
    the tables); both paths draw the pool and the dropout masks from the
    same step-keyed generators. Then ``evaluate()`` on test."""
    from poi_tpu_torch.configs.presets import get_config
    from poi_tpu_torch.data.dataset import load_dataset
    from poi_tpu_torch.convert import params_to_numpy
    from poi_tpu_torch.train.loop import make_trainer

    cfg = get_config(ATTN_CONFIG).with_overrides(SAMPLER_OVERRIDES)
    t0 = time.perf_counter()
    ds = load_dataset(cfg.data)
    m = cfg.model
    log(f"[attn] {ATTN_CONFIG}: {ds.num_pois} POIs, {len(ds.train)} training windows, T={ds.max_seq_len}, batch "
        f"{cfg.train.batch_size}, GRU {m.hidden_dim}-d + {m.attn_heads}-head attention over {m.attn_window} steps, "
        f"dropout {m.dropout}, sampled softmax S={cfg.loss.num_sampled}, table_update={cfg.train.table_update} "
        f"(loaded in {time.perf_counter() - t0:.1f} s)")
    tree = params_to_numpy(make_trainer(cfg, ds, DEV).model)  # the trainer's own seeded init
    kern, launches, _ = train_both_paths("attn", cfg, ds, tree,
                                         used=("gru_fwd", "gru_bwd", "sampled_lse", "sampled_bwd"))
    state.update(attn_launches=launches, attn_cfg=cfg, attn_ds=ds, attn_tree=tree,
                 attn_trained=params_to_numpy(kern.model))


def serve_both_paths(tag: str, cfg, ds, trained, fwd: str = "gru_fwd") -> None:
    """``Recommender`` with the trained parameters at request batch 1 and
    256, kernel path (the recurrence's forward kernel ``fwd`` and top-k)
    against plain path."""
    from poi_tpu_torch.convert import params_from_jax
    from poi_tpu_torch.eval.serve import Recommender
    from poi_tpu_torch.models.base import DataDims, build_model

    plain_cfg = cfg.with_overrides({"model.cell_impl": "scan", "eval.topk_impl": "xla"})
    recs = []
    for c in (cfg, plain_cfg):
        model = build_model(c.model, DataDims.from_dataset(ds), device=DEV)
        model.load_state_dict(params_from_jax(trained))
        recs.append(Recommender(model, c, ds))
    rec, plain = recs
    histories = histories_from_test(ds, 256)
    for n in (1, 256):
        reset_launches()
        got = rec.recommend(histories[:n], k=10, exclude_visited=True)
        launches = read_launches()
        assert launches[fwd] > 0 and launches["topk"] > 0, f"{tag} recommend skipped a kernel: {launches}"
        assert got.shape == (n, 10) and ((got >= 0) & (got < ds.num_pois)).all(), got
        for row, hist in zip(got, histories[:n]):
            assert not set(row.tolist()) & {c.poi for c in hist}, "a visited POI was returned"
        compare_paths(tag, rec, plain, histories[:n], got)


def recurrent_config_phase(state, tag: str) -> None:
    """Config #2 (``tag`` lstm) or #3 (strnn) at full width: 40
    device-sampled steps through ``train()`` on both paths from the
    trainer's own seeded init (config #3 at its dropout 0.5, both paths
    drawing the same step-keyed masks), ``evaluate()``, then ``Recommender``
    on both paths."""
    from poi_tpu_torch.configs.presets import get_config
    from poi_tpu_torch.convert import params_to_numpy
    from poi_tpu_torch.data.dataset import load_dataset
    from poi_tpu_torch.train.loop import make_trainer

    config, used = REC_CONFIGS[tag]
    cfg = get_config(config).with_overrides(SAMPLER_OVERRIDES)
    t0 = time.perf_counter()
    ds = load_dataset(cfg.data)
    m = cfg.model
    log(f"[{tag}] {config}: {ds.num_pois} POIs, {ds.num_users} users, {len(ds.train)} training windows, "
        f"T={ds.max_seq_len}, batch {cfg.train.batch_size}, {m.kind} {m.hidden_dim}-d {m.compute_dtype}, user "
        f"embedding {m.use_user_embedding}, dropout {m.dropout}, loss {cfg.loss.kind}"
        f"{f' with {cfg.loss.num_negatives} negatives a position' if cfg.loss.kind == 'bpr' else ''} "
        f"(loaded in {time.perf_counter() - t0:.1f} s)")
    tree = params_to_numpy(make_trainer(cfg, ds, DEV).model)
    kern, launches, _ = train_both_paths(tag, cfg, ds, tree, used=used, fwd=used[0])
    serve_both_paths(f"{tag} serve", cfg, ds, params_to_numpy(kern.model), used[0])
    state[tag] = {"cfg": cfg, "ds": ds, "tree": tree, "launches": launches}


# Config #5 on one card: BASELINE.md:29's command (multihost_1m at
# mesh.model=1, V = 903,889 after min_poi_checkins=1, D = 512, batch 512,
# T = 64, S = 4,096, the rows-gradient step with lazy Adam), device-sampled,
# with no warmup so that a few steps move the loss (the preset warms up over
# 100). C5_STEPS steps a path; the train CLI runs C5_CLI_STEPS.
C5_CONFIG = "multihost_1m"
C5_SETS = {"mesh.model": "1", "mesh.embedding_mode": "psum", "data.min_poi_checkins": "1",
           "data.val_fraction": "0.05", "data.sampler": "device", "train.warmup_steps": "0"}
C5_STEPS, C5_CLI_STEPS = 20, 10
C5_POIS = 903_889


def rows_against_dense(trainer, tree) -> None:
    """Config #5's rows-gradient step against the dense-gradient sparse step
    (``rows_mode`` off: autograd's [V, D] table gradient, gathered at the
    deduplicated touched ids) from one state, batch and pool, at the
    reference's tolerances for this comparison (tests/test_sparse_opt.py:
    loss 1e-5, grad norm 1e-4 relative, params 2e-6 + 2e-5 relative); then
    the lazy-Adam update of the rows step, called twice on its gradients
    from that state, and the whole rows step twice: the same bits."""
    import torch

    from poi_tpu_torch.train.state import TrainState

    state = trainer.init_state(tree)
    batch = trainer.sampler.sample(0)
    snap = {k: v.detach().clone() for k, v in state.params.items()}
    snap_m = {w: {k: v.clone() for k, v in state.opt_state[w].items()} for w in ("m", "v")}

    def reset():
        with torch.no_grad():
            for k, p in state.params.items():
                p.copy_(snap[k])
            for w in ("m", "v"):
                for k, t in state.opt_state[w].items():
                    t.copy_(snap_m[w][k])
        state.opt_state["count"] = 0
        return TrainState(0, state.params, state.opt_state)

    def live():
        return [p.detach() for p in state.params.values()] + [t for w in ("m", "v") for t in state.opt_state[w].values()]

    def same_bits(ref) -> bool:
        return all(torch.equal(a, b) for a, b in zip(live(), ref))

    real, calls = trainer.optimizer.update, []

    def recorded(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    def step(rows: bool) -> tuple[float, float]:
        trainer.rows_mode = rows
        trainer.optimizer.update = recorded
        try:
            _, m = trainer.step(reset(), batch)
        finally:
            trainer.optimizer.update = real
            trainer.rows_mode = True
        return float(m["loss"]), float(m["grad_norm"])

    l_r, g_r = step(True)
    ref = [t.clone() for t in live()]
    l_d, g_d = step(False)
    assert abs(l_r - l_d) < 1e-5 and abs(g_r - g_d) < 1e-4 * max(1.0, g_d), (l_r, l_d, g_r, g_d)
    worst = 0.0
    for (k, p), a in zip(state.params.items(), ref):
        assert torch.allclose(p.detach(), a, atol=2e-6, rtol=2e-5), f"rows vs dense path: {k} differs"
        worst = max(worst, float((p.detach() - a).abs().max()))
    step(True)
    assert same_bits(ref), "two rows steps from one state: other bits"
    args, kwargs = calls[0]
    for _ in range(2):
        reset()
        real(*args, **kwargs)
        assert same_bits(ref), "the rows step's lazy-Adam update, replayed on its gradients: other bits"
    log(f"[c5] rows step vs the dense-gradient step, one state, batch and pool: loss {l_r:.7f} / {l_d:.7f}, grad "
        f"norm {g_r:.6f} / {g_d:.6f}, params max |diff| {worst:.3e} (tol 2e-6 + 2e-5 relative); the rows step twice "
        f"and its lazy-Adam update twice on the same gradients: the same bits ({len(ref)} tensors)")


def config5_phase(state, gpu: str) -> None:
    """Config #5 at full width through the entry points: ``train()`` for
    ``C5_STEPS`` steps on the kernel path and the plain path (losses
    compared step by step), ``evaluate()`` on val, the rows step against the
    dense-gradient step and its bits, ``Recommender`` at request batch 1 and
    256 on both paths, the train CLI (started first, a process of its own),
    and the step file's size."""
    import torch

    from poi_tpu_torch.configs.presets import get_config
    from poi_tpu_torch.convert import params_to_numpy
    from poi_tpu_torch.data.dataset import load_dataset
    from poi_tpu_torch.train.loop import make_trainer
    from poi_tpu_torch.utils.checkpoint import tensor_bytes

    sets = [f"{k}={v}" for k, v in C5_SETS.items()]
    cli_sets = sets + [f"train.num_steps={C5_CLI_STEPS}", f"train.eval_every={C5_CLI_STEPS // 2}",
                       f"train.log_every={C5_CLI_STEPS // 2}", f"train.steps_per_call={C5_CLI_STEPS // 2}"]
    cli_job = cli_proc("train", C5_CONFIG, ["--set", *cli_sets, "--no-checkpoint"])
    cfg = get_config(C5_CONFIG).with_overrides({**C5_SETS, "train.steps_per_call": str(C5_STEPS)})
    t0 = time.perf_counter()
    ds = load_dataset(cfg.data)
    m = cfg.model
    log(f"[c5] {C5_CONFIG} {' '.join(sets)}: {ds.num_pois} POIs, {ds.num_users} users, {len(ds.train)} training "
        f"windows, {len(ds.val)} val, T={ds.max_seq_len}, batch {cfg.train.batch_size}, GRU {m.hidden_dim}-d + "
        f"{m.attn_heads}-head attention over {m.attn_window} steps, sampled softmax S={cfg.loss.num_sampled}, "
        f"table_update={cfg.train.table_update} (loaded in {time.perf_counter() - t0:.1f} s)")
    assert ds.num_pois == C5_POIS, ds.num_pois
    trainer = make_trainer(cfg, ds, DEV)
    assert trainer.rows_mode and trainer.rows_fused, "config #5 must take the rows-gradient step on the kernels"
    tree = params_to_numpy(trainer.model)
    st = trainer.init_state()
    log(f"[c5] step file: {tensor_bytes(st)} bytes of tensors (utils/checkpoint.tensor_bytes: params and lazy Adam's "
        f"m, v; {sum(p.numel() for p in st.params.values())} params)")
    del trainer, st
    kern, launches, eval_launches = train_both_paths("c5", cfg, ds, tree, used=("gru_fwd", "gru_bwd", "sampled_lse",
                                                                               "sampled_bwd"),
                                                     steps=C5_STEPS, split="val")
    trained = params_to_numpy(kern.model)
    rows_against_dense(kern, tree)
    del kern
    torch.cuda.empty_cache()
    reset_launches()
    serve_both_paths("c5 serve", cfg, ds, trained)
    serve_launches = read_launches()
    run_cli_train(C5_CONFIG, cli_sets, C5_CLI_STEPS, cli_job)
    state["c5"] = {"cfg": cfg, "ds": ds, "tree": tree, "launches": launches, "eval_launches": eval_launches,
                   "serve_launches": serve_launches}
    torch.cuda.empty_cache()


def run_cli_train(config: str, overrides: list[str], steps: int, job: tuple | None = None) -> dict:
    """``python -m poi_tpu_torch train --no-checkpoint`` on the card (or the
    run ``job`` that ``cli_proc`` started); returns its final JSON line after
    checking the exit code, the step count, a dropping loss and finite final
    metrics."""
    stdout, _ = cli_done(job or cli_proc("train", config, ["--set", *overrides, "--no-checkpoint"]))
    out = json.loads(stdout.strip().splitlines()[-1])
    losses = [row["loss"] for row in out["history"]]
    assert out["steps"] == steps and len(losses) == 2 and losses[-1] < losses[0], out["history"]
    assert all(math.isfinite(v) for v in out["final"].values()), out["final"]
    assert len(out["periodic_evals"]) == 2, out["periodic_evals"]
    log(f"[cli] train --config {config} ({steps} steps) --device {DEV}: exit 0, loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} ({out['history'][-1]['seqs_per_sec']:.1f} seq/s over the last log interval), "
        f"selected step {out['selected_step']}, final recall@10 {out['final']['recall@10']:.4f} "
        f"(popularity {out['popularity_baseline']['recall@10']:.4f})")
    return out


def cli_train_phase(state) -> None:
    run_cli_train(CONFIG, ["train.num_steps=20", "train.eval_every=10", "train.log_every=10"], 20)
    # The bench workload: device sampler in 40-step chunks, test evaluated
    # through the top-k kernel at steps 40 and 80 and at the end.
    steps = 2 * TRAIN_STEPS
    out = run_cli_train("smoke", [f"{k}={v}" for k, v in BENCH_OVERRIDES.items()]
                        + [f"train.num_steps={steps}", f"train.eval_every={TRAIN_STEPS}",
                           f"train.log_every={TRAIN_STEPS}"], steps)
    # At the random init every POI scores about alike, a loss of ~ln(V):
    # the loss logged at step 40 must already be below it.
    assert out["history"][0]["loss"] < math.log(state["bench_ds"].num_pois), out["history"]
    # Config #4 as a user runs it, cut to 40 steps (best-on-val at 20 and 40).
    run_cli_train(ATTN_CONFIG, [f"train.num_steps={TRAIN_STEPS}", f"train.eval_every={TRAIN_STEPS // 2}",
                                f"train.log_every={TRAIN_STEPS // 2}", "data.sampler=device"], TRAIN_STEPS)
    # Configs #2 and #3 as a user runs them, cut to 20 steps (best-on-val at 10 and 20).
    for config, _ in REC_CONFIGS.values():
        run_cli_train(config, ["train.num_steps=20", "train.eval_every=10", "train.log_every=10",
                               "data.sampler=device"], 20)


# The wide path: the bench workload at D = 512 and H = 1024 through the
# train CLI (WIDE_CLI_STEPS steps, 5 a call, best-on-val off: evaluated at
# the end), then WIDE_STEPS steps a path through train() and Recommender on
# both paths: B1/B2 on the grid, B7/B8 at D = 512, B11 at D = 512.
WIDE_SETS = {"model.embed_dim": "512", "model.hidden_dim": "1024"}
# The wide and wider paths' steps are timed over WIDE_TIME_CHUNK-step
# chunks (10 before the wider paths' phases came).
WIDE_CLI_STEPS, WIDE_STEPS, WIDE_TIME_CHUNK = 10, 5, 5


# Path 1: config #3 at its reference's 256-d probe (BASELINE.md:27,
# scripts/tune_strnn.py's h256) as a user runs it, through the host loader
# at the preset's one step a call: B5/B6 at H = 256, B7/B8 at D = 256.
C3_D256_STEPS = 10
C3_D256_SETS = ["model.embed_dim=256", "model.hidden_dim=256", f"train.num_steps={C3_D256_STEPS}",
                f"train.eval_every={C3_D256_STEPS}", f"train.log_every={C3_D256_STEPS // 2}"]


def strnn_d256_phase(state) -> None:
    """``python -m poi_tpu_torch train --config strnn_gowalla --set
    model.embed_dim=256 model.hidden_dim=256`` for ``C3_D256_STEPS`` steps,
    run in this process (``cli.main``) so its launches are counted: exit 0,
    finite losses, and B5, B6, B7 and B8 launched."""
    import contextlib
    import io

    from poi_tpu_torch import cli

    argv = ["train", "--config", REC_CONFIGS["strnn"][0], "--device", DEV, "--no-checkpoint", "--set", *C3_D256_SETS]
    reset_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    launches = read_launches()
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    losses = [row["loss"] for row in out["history"]]
    log(f"[strnn_d256] python -m poi_tpu_torch {' '.join(argv)}: exit {rc}, loss by log step {losses}, final "
        f"recall@10 {out['final']['recall@10']:.4f}, {out['history'][-1]['seqs_per_sec']:.1f} seq/s over the last "
        f"log interval; launches {launches}")
    assert rc == 0 and out["steps"] == C3_D256_STEPS and all(math.isfinite(v) for v in losses), out["history"]
    assert all(math.isfinite(v) for v in out["final"].values()), out["final"]
    for name in ("rnn_fwd", "rnn_bwd", "ce_lse", "ce_bwd"):
        assert launches[name] > 0, f"strnn_d256: no {name} launch: {launches}"
    state["c3_d256_launches"] = launches


def gru_wide_path_phase(state) -> None:
    """The wide path as a user runs it: ``python -m poi_tpu_torch train
    --config smoke --set <BENCH_OVERRIDES> model.embed_dim=512
    model.hidden_dim=1024`` for ``WIDE_CLI_STEPS`` steps, run in this process
    (``cli.main``) so its launches are counted (exit 0, finite losses, B1,
    B2, B7 and B8 launched); then ``WIDE_STEPS`` device-sampled steps
    through ``train()`` on the kernel and the plain path from one init
    (``train_both_paths``: losses at PERF.md §2's limits, evaluate on test),
    and ``Recommender`` at request batch 1 and 256 on both paths
    (``serve_both_paths``: B1 at H = 1024, B11 at D = 512)."""
    import contextlib
    import io

    from poi_tpu_torch import cli
    from poi_tpu_torch.convert import params_to_numpy
    from poi_tpu_torch.train.loop import make_trainer

    sets = {**BENCH_OVERRIDES, **WIDE_SETS, "train.num_steps": str(WIDE_CLI_STEPS), "train.steps_per_call": "5",
            "train.eval_every": str(WIDE_CLI_STEPS), "train.log_every": "5"}
    argv = ["train", "--config", "smoke", "--device", DEV, "--no-checkpoint", "--set",
            *(f"{k}={v}" for k, v in sets.items())]
    reset_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    launches = read_launches()
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    losses = [row["loss"] for row in out["history"]]
    log(f"[gru_wide_path] python -m poi_tpu_torch {' '.join(argv)}: exit {rc} in {time.perf_counter() - t0:.1f} s, "
        f"loss by log step {losses}, final recall@10 {out['final']['recall@10']:.4f} (popularity "
        f"{out['popularity_baseline']['recall@10']:.4f}), {out['history'][-1]['seqs_per_sec']:.1f} seq/s over the "
        f"last log interval; launches {launches}")
    assert rc == 0 and out["steps"] == WIDE_CLI_STEPS and all(math.isfinite(v) for v in losses), out["history"]
    assert all(math.isfinite(v) for v in out["final"].values()), out["final"]
    for name in ("gru_fwd", "gru_bwd", "ce_lse", "ce_bwd"):
        assert launches[name] > 0, f"gru_wide_path: no {name} launch: {launches}"
    cfg, ds = state["bench_cfg"].with_overrides(WIDE_SETS), state["bench_ds"]
    tree = params_to_numpy(make_trainer(cfg, ds, DEV).model)  # the trainer's own seeded init
    kern, both, _ = train_both_paths("gru_wide_path", cfg, ds, tree, used=("gru_fwd", "gru_bwd", "ce_lse", "ce_bwd"),
                                     steps=WIDE_STEPS)
    serve_both_paths("gru_wide_path serve", cfg, ds, params_to_numpy(kern.model))
    state["wide"] = {"launches": launches, "both_launches": both, "cfg": cfg, "tree": tree}


# The LSTM and ST-RNN towers at the same widths (configs #2 and #3 with
# model.embed_dim=512 model.hidden_dim=1024): the train CLI for
# REC_WIDE_CLI_STEPS steps at the preset's host loader (best-on-val and the
# test evaluation once, at the end), then WIDE_STEPS device-sampled steps a
# path through train() from one init, and Recommender on both paths: B3/B4
# or B5/B6 on the grid, B7/B8 at D = 512 on config #3's 2,048 rows, B11 at
# D = 512. The train() runs warm up over 20 steps: the presets' 100 move
# config #3's loss in 5 steps by less than its batches' noise, and none
# lets config #3 at H = 1024 spike at step 4 (grad norm 0.4 to 3.6), where
# the two paths' losses parted by 3.9e-3 on an H100.
REC_WIDE_CLI_STEPS = 10
REC_WIDE_TRAIN_SETS = {**WIDE_SETS, "train.warmup_steps": "20"}


def rec_wide_path_phase(state, tag: str) -> None:
    """The wide LSTM path (``tag`` lstm) or ST-RNN path (strnn) as a user
    runs it: ``python -m poi_tpu_torch train --config <config #2 or #3> --set
    model.embed_dim=512 model.hidden_dim=1024`` for ``REC_WIDE_CLI_STEPS``
    steps, run in this process (``cli.main``) so its launches are counted
    (exit 0, finite losses, the recurrence's kernels launched, and B7/B8 on
    config #3); then ``WIDE_STEPS`` device-sampled steps through ``train()``
    on the kernel and the plain path from one init (``train_both_paths``:
    losses at PERF.md §2's limits, evaluate on test), and ``Recommender`` at
    request batch 1 and 256 on both paths (``serve_both_paths``: B3 or B5 at
    H = 1024, B11 at D = 512)."""
    import contextlib
    import io

    from poi_tpu_torch import cli
    from poi_tpu_torch.convert import params_to_numpy
    from poi_tpu_torch.train.loop import make_trainer

    config, used = REC_CONFIGS[tag]
    sets = {**WIDE_SETS, "train.num_steps": str(REC_WIDE_CLI_STEPS), "train.eval_every": str(REC_WIDE_CLI_STEPS),
            "train.log_every": "5"}
    argv = ["train", "--config", config, "--device", DEV, "--no-checkpoint", "--set",
            *(f"{k}={v}" for k, v in sets.items())]
    reset_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    launches = read_launches()
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    losses = [row["loss"] for row in out["history"]]
    log(f"[{tag}_wide_path] python -m poi_tpu_torch {' '.join(argv)}: exit {rc} in {time.perf_counter() - t0:.1f} s, "
        f"loss by log step {losses}, final recall@10 {out['final']['recall@10']:.4f} (popularity "
        f"{out['popularity_baseline']['recall@10']:.4f}), {out['history'][-1]['seqs_per_sec']:.1f} seq/s over the "
        f"last log interval; launches {launches}")
    assert rc == 0 and out["steps"] == REC_WIDE_CLI_STEPS and all(math.isfinite(v) for v in losses), out["history"]
    assert all(math.isfinite(v) for v in out["final"].values()), out["final"]
    for name in used:
        assert launches[name] > 0, f"{tag}_wide_path: no {name} launch: {launches}"
    cfg, ds = state[tag]["cfg"].with_overrides(REC_WIDE_TRAIN_SETS), state[tag]["ds"]
    tree = params_to_numpy(make_trainer(cfg, ds, DEV).model)  # the trainer's own seeded init
    kern, both, _ = train_both_paths(f"{tag}_wide_path", cfg, ds, tree, used=used, fwd=used[0], steps=WIDE_STEPS)
    serve_both_paths(f"{tag}_wide_path serve", cfg, ds, params_to_numpy(kern.model), used[0])
    state[f"{tag}_wide"] = {"launches": launches, "both_launches": both, "cfg": cfg, "tree": tree}


# The wider paths: the bench workload ("bench") and config #4 ("c4") at
# D = H = 1024, which the reference trains and the port refused before the
# K-chunked loss kernels (csrc/kchunk.cuh): the train CLI for
# WIDER_CLI_STEPS steps in this process (the bench workload device-sampled
# in calls of 5 steps, config #4 through the preset's host loader; the val
# and test evaluations at the end), then WIDE_STEPS device-sampled steps a
# path through train() from one init (config #4 at the preset's dropout),
# and Recommender at request batch 1 and 256 on both paths: B1/B2 on the
# grid, B7/B8 (bench) or B9/B10 (config #4) at D = 1024, B11 at D = 1024.
WIDER_SETS = {"model.embed_dim": "1024", "model.hidden_dim": "1024"}
WIDER_CLI_STEPS = 10
WIDER_PATHS = {"bench": ("smoke", ("gru_fwd", "gru_bwd", "ce_lse", "ce_bwd")),
               "c4": (ATTN_CONFIG, ("gru_fwd", "gru_bwd", "sampled_lse", "sampled_bwd"))}


def wider_path_phase(state, tag: str) -> None:
    """The wider bench path (``tag`` bench) or the wider config #4 path (c4)
    as a user runs it: ``python -m poi_tpu_torch train --config <smoke --set
    BENCH_OVERRIDES, or attention_gowalla> --set model.embed_dim=1024
    model.hidden_dim=1024`` for ``WIDER_CLI_STEPS`` steps, run in this
    process (``cli.main``) so its launches are counted (exit 0, finite
    losses, the path's four kernels and B11 launched); then ``WIDE_STEPS``
    device-sampled steps through ``train()`` on the kernel and the plain
    path from one init (``train_both_paths``: losses at PERF.md §2's limits,
    evaluate on test), and ``Recommender`` at request batch 1 and 256 on both
    paths (``serve_both_paths``: B1 at H = 1024, B11 at D = 1024)."""
    import contextlib
    import io

    from poi_tpu_torch import cli
    from poi_tpu_torch.convert import params_to_numpy
    from poi_tpu_torch.train.loop import make_trainer

    config, used = WIDER_PATHS[tag]
    sets = {**WIDER_SETS, "train.num_steps": str(WIDER_CLI_STEPS), "train.eval_every": str(WIDER_CLI_STEPS),
            "train.log_every": "5"}
    if tag == "bench":
        sets = {**BENCH_OVERRIDES, **sets, "train.steps_per_call": "5"}
    argv = ["train", "--config", config, "--device", DEV, "--no-checkpoint", "--set",
            *(f"{k}={v}" for k, v in sets.items())]
    reset_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    launches = read_launches()
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    losses = [row["loss"] for row in out["history"]]
    log(f"[wider_{tag}_path] python -m poi_tpu_torch {' '.join(argv)}: exit {rc} in {time.perf_counter() - t0:.1f} s, "
        f"loss by log step {losses}, final recall@10 {out['final']['recall@10']:.4f} (popularity "
        f"{out['popularity_baseline']['recall@10']:.4f}), {out['history'][-1]['seqs_per_sec']:.1f} seq/s over the "
        f"last log interval; launches {launches}")
    assert rc == 0 and out["steps"] == WIDER_CLI_STEPS and all(math.isfinite(v) for v in losses), out["history"]
    assert all(math.isfinite(v) for v in out["final"].values()), out["final"]
    for name in (*used, "topk"):
        assert launches[name] > 0, f"wider_{tag}_path: no {name} launch: {launches}"
    base, ds = (state["bench_cfg"], state["bench_ds"]) if tag == "bench" else (state["attn_cfg"], state["attn_ds"])
    cfg = base.with_overrides(WIDER_SETS)
    tree = params_to_numpy(make_trainer(cfg, ds, DEV).model)  # the trainer's own seeded init
    kern, both, _ = train_both_paths(f"wider_{tag}_path", cfg, ds, tree, used=used, steps=WIDE_STEPS)
    serve_both_paths(f"wider_{tag}_path serve", cfg, ds, params_to_numpy(kern.model))
    state[f"wider_{tag}"] = {"launches": launches, "both_launches": both, "cfg": cfg, "tree": tree, "ds": ds}


# Path 2: config #4 at full width through the host loader (the preset's
# data.sampler=host): HOST_LOADER_STEPS steps at steps_per_call 1 (twice:
# the spread of two runs) and 10 (chunks through DevicePrefetcher) from one
# init,
# every step a log step, for the losses. The rates come from warmed runs at
# the preset's log_every (host_loader_timing), HOST_TIMING_ROUNDS of each
# spc in turns.
HOST_LOADER_STEPS = 40
HOST_LOADER_SPC = (1, 1, 10)
HOST_TIMING_STEPS, HOST_TIMING_WARMUP, HOST_TIMING_PROFILED = 100, 10, 10
HOST_TIMING_ROUNDS = 1


def host_loader_run(cfg, ds, tree, spc: int, steps: int):
    """``train()`` of ``cfg`` at ``steps_per_call`` ``spc`` from ``tree``,
    every step a log step: (per-step losses, the launches)."""
    from poi_tpu_torch.train.loop import make_trainer, train

    c = cfg.with_overrides({"train.steps_per_call": str(spc), "train.log_every": "1"})
    tr = make_trainer(c, ds, DEV)
    st = tr.init_state(tree)
    reset_launches()
    _, st, hist = train(c, ds, num_steps=steps, trainer=tr, state=st)
    assert st.step == steps and len(hist) == steps, (st.step, len(hist))
    return [row["loss"] for row in hist], read_launches()


def host_loader_timing(cfg, ds, spc: int, steps: int, warmup: int, profiled: int) -> dict:
    """``train()`` of ``cfg`` at ``steps_per_call`` ``spc`` and the
    preset's log_every, after ``warmup`` steps: seq/s and ms a step over
    ``steps`` timed steps, then the device ms a step from torch.profiler's
    kernels over ``profiled`` more (the profiler slows the host, so the idle
    share sets them against the timed step). ``--ab`` runs this source in
    either checkout."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    from poi_tpu_torch.train.loop import make_trainer, train

    c = cfg.with_overrides({"train.steps_per_call": str(spc)})
    tr = make_trainer(c, ds, "cuda")
    _, state, _ = train(c, ds, num_steps=warmup, trainer=tr, state=tr.init_state())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, state, _ = train(c, ds, num_steps=steps, trainer=tr, state=state)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        train(c, ds, num_steps=profiled, trainer=tr, state=state)
    busy = sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")) / 1e3 / profiled
    return {"seq_per_s": c.train.batch_size / step_ms * 1e3, "step_ms": step_ms, "device_ms": busy,
            "idle": max(0.0, 1 - busy / step_ms)}


def host_loader_phase(state) -> None:
    """Path 2: config #4 trains ``HOST_LOADER_STEPS`` host-loader steps at
    steps_per_call 1, 1 and 10 (chunks through the prefetcher); the ``spc =
    10`` losses must lie within the spread of the two ``spc = 1`` runs
    (the same bits where that spread is 0), every run launching B1, B2, B9
    and B10."""
    from poi_tpu_torch.configs.presets import get_config
    from poi_tpu_torch.convert import params_to_numpy
    from poi_tpu_torch.train.loop import make_trainer

    cfg = get_config(ATTN_CONFIG)
    assert cfg.data.sampler == "host" and cfg.train.steps_per_call == 1, (cfg.data.sampler, cfg.train.steps_per_call)
    ds = state["attn_ds"]
    tree = params_to_numpy(make_trainer(cfg, ds, DEV).model)
    runs = [host_loader_run(cfg, ds, tree, spc, HOST_LOADER_STEPS) for spc in HOST_LOADER_SPC]
    for (losses, launches), spc in zip(runs, HOST_LOADER_SPC):
        assert all(math.isfinite(v) for v in losses), losses
        for name in ("gru_fwd", "gru_bwd", "sampled_lse", "sampled_bwd"):
            assert launches[name] > 0, f"host_loader spc={spc}: no {name} launch: {launches}"
    (a, launches), (b, _), (c, _) = runs
    spread = max(abs(x - y) for x, y in zip(a, b))
    diff = max(abs(x - y) for x, y in zip(a, c))
    log(f"[host_loader] config #4, {HOST_LOADER_STEPS} host-loader steps: losses at spc=1 {a[0]:.6f} -> {a[-1]:.6f}; "
        f"largest |spc=1 - spc=1| {spread:.3e}, |spc=10 - spc=1| {diff:.3e}; launches at spc=1 {launches}")
    assert diff <= spread, f"host_loader: spc=10's losses leave the spread of two spc=1 runs: {diff} > {spread}"


def host_loader_device_phase(state, gpu: str) -> None:
    """Path 2's rates: ``host_loader_timing`` at spc 1 and 10 in turns,
    ``HOST_TIMING_ROUNDS`` rounds, each with its device idle share."""
    from poi_tpu_torch.configs.presets import get_config

    cfg, ds = get_config(ATTN_CONFIG), state["attn_ds"]
    for r in range(HOST_TIMING_ROUNDS):
        for spc in (1, 10):
            t = host_loader_timing(cfg, ds, spc, HOST_TIMING_STEPS, HOST_TIMING_WARMUP, HOST_TIMING_PROFILED)
            log(f"[host_loader] round {r + 1} spc={spc}: {t['seq_per_s']:.1f} seq/s ({t['step_ms']:.3f} ms a step over "
                f"{HOST_TIMING_STEPS} steps after {HOST_TIMING_WARMUP}, log_every {cfg.train.log_every}); "
                f"{t['device_ms']:.3f} ms of device time a step; device idle share {t['idle']:.3f}  ({gpu})")


# The checkpoint phase's resume drill, per configuration: (config, extra
# --set flags, steps, checkpoint and eval period, fault step, the kernels
# its train path must launch). Config #1 takes the host TrainLoader and
# dense Adam, config #4 the device sampler, lazy Adam, dropout 0.3 and the
# sampled softmax.
CKPT_DRILLS = {
    "c1": (CONFIG, [], 20, 10, 15, ("gru_fwd", "gru_bwd", "topk")),
    "c4": (ATTN_CONFIG, ["data.sampler=device"], 40, 20, 30, ("gru_fwd", "gru_bwd", "sampled_lse", "sampled_bwd",
                                                              "topk")),
}
CKPT_TIMED = 3  # save and restore calls timed a configuration (median)


def cli_proc(verb: str, config: str, args: list, stdin: str | None = None) -> tuple:
    """``python -m poi_tpu_torch <verb> --config <config> --device DEV <args>``,
    started; ``cli_done`` feeds it ``stdin`` and waits for it."""
    proc = subprocess.Popen([sys.executable, "-m", "poi_tpu_torch", verb, "--config", config, "--device", DEV, *args],
                            stdin=subprocess.PIPE if stdin is not None else subprocess.DEVNULL,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
                            env=dict(os.environ, PYTHONPATH=str(REPO)))
    return proc, stdin


def cli_done(job: tuple, rc: int | None = 0) -> tuple[str, str]:
    """Wait for a ``cli_proc`` job, check its exit code (``rc``, or any
    nonzero for None) and return its stdout and stderr."""
    proc, stdin = job
    try:
        out, err = proc.communicate(stdin, timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    ok = proc.returncode != 0 if rc is None else proc.returncode == rc
    assert ok, f"{' '.join(proc.args[2:])} exited {proc.returncode}:\n{err[-3000:]}"
    return out, err


def step_tensors(saved: dict) -> dict:
    """{path: tensor} of a step file's params and optimizer moments."""
    out = {f"params.{k}": v for k, v in saved["params"].items()}
    for part, d in saved["opt_state"].items():
        if part != "count":
            out.update({f"{part}.{k}": v for k, v in d.items()})
    return out


def step_spread(a: dict, b: dict) -> dict:
    """{path: max |a - b| / max |a|} of the tensors that differ."""
    out = {}
    for k, x in a.items():
        if not x.equal(b[k]):
            out[k] = float((x.double() - b[k].double()).abs().max() / x.double().abs().max().clamp_min(1e-30))
    return out


def grad_spread(cfg, ds) -> tuple[dict, list]:
    """Where two uninterrupted runs part: the first step's gradients, twice
    from the same state, batch and draws ({param: relative spread} of those
    that differ), and the PyTorch ops on the step that warn under
    ``torch.use_deterministic_algorithms`` (a third pass in that mode)."""
    import warnings

    import numpy as np
    import torch

    from poi_tpu_torch.data.pipeline import make_batch
    from poi_tpu_torch.models.base import batch_to
    from poi_tpu_torch.train.loop import DROPOUT_STREAM, make_trainer

    trainer = make_trainer(cfg, ds, DEV)
    params = trainer.init_state().params
    batch = trainer.sampler.sample(0) if trainer.sampler is not None else \
        batch_to(make_batch(ds.train, np.arange(cfg.train.batch_size)), DEV)

    def grads():
        for p in params.values():
            p.grad = None
        drop = trainer.generator(0, DROPOUT_STREAM) if cfg.model.dropout > 0.0 else None
        trainer.loss(batch, trainer.draw_negatives(0, batch), drop).backward()
        return {k: p.grad.clone() for k, p in params.items() if p.grad is not None}

    spread = step_spread(grads(), grads())
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            grads()
        finally:
            torch.use_deterministic_algorithms(False)
    ops = sorted({str(w.message).splitlines()[0][:160] for w in caught if "determinis" in str(w.message)})
    return spread, ops


def checkpoint_phase(gpu: str) -> None:
    """Checkpoint and resume as a user runs them, on configs #1 and #4 at
    full width: uninterrupted ``train`` runs into A (in this process, its
    kernel launches counted) and A2 (a subprocess; config #1's with
    ``--metrics-dir`` and ``--profile-dir``), a run into B that the fault
    stops, and the same command again, which resumes. The final steps of A,
    A2 and B must agree bit for bit (where they do not, the first step's
    gradients are taken twice from one state to say which parameter's
    differ). Then ``eval``,
    ``recommend`` and ``serve`` from A, and the size, save and restore time
    of a step file."""
    import contextlib
    import io
    import logging
    import statistics

    import numpy as np
    import torch

    from poi_tpu_torch import cli
    from poi_tpu_torch.configs.presets import get_config
    from poi_tpu_torch.data.dataset import load_dataset
    from poi_tpu_torch.eval.serve import Recommender
    from poi_tpu_torch.utils.checkpoint import CheckpointManager

    with tempfile.TemporaryDirectory() as tmp:
        def d(tag, name):
            return os.path.join(tmp, f"{tag}_{name}")

        def train_args(tag, *extra):
            config, sets, steps, every, _, _ = CKPT_DRILLS[tag]
            return ["--checkpoint-dir", d(tag, extra[0]), *extra[1:], "--set", *sets, f"train.num_steps={steps}",
                    f"train.checkpoint_every={every}", f"train.eval_every={every}", f"train.log_every={every}"]

        first = {}
        for tag, (config, _, _, _, fault, _) in CKPT_DRILLS.items():
            obs = ["--metrics-dir", d(tag, "M"), "--profile-dir", d(tag, "P")] if tag == "c1" else []
            first[tag] = (cli_proc("train", config, train_args(tag, "A2", *obs)),
                          cli_proc("train", config, train_args(tag, "B") + [f"train.fault_inject_step={fault}"]))
        outs = {}
        # cli.main's logging.basicConfig finds this handler and leaves this process's logging as it is.
        quiet = logging.NullHandler()
        for tag, (config, _, steps, _, _, used) in CKPT_DRILLS.items():
            reset_launches()
            buf = io.StringIO()
            logging.getLogger().addHandler(quiet)
            try:
                with contextlib.redirect_stdout(buf):
                    assert cli.main(["train", "--config", config, "--device", DEV, *train_args(tag, "A")]) == 0
            finally:
                logging.getLogger().removeHandler(quiet)
            launches = read_launches()
            outs[tag] = json.loads(buf.getvalue().strip().splitlines()[-1])
            log(f"[checkpoint] {tag} train --config {config} ({steps} steps) into A, in this process: final "
                f"recall@10 {outs[tag]['final']['recall@10']:.4f}, selected step {outs[tag]['selected_step']}, "
                f"launches {launches}")
            assert all(launches[k] > 0 for k in used), f"{tag}: the train path skipped a kernel: {launches}"
            assert outs[tag]["steps"] == steps and outs[tag]["resumed_from"] is None, outs[tag]
        resumed = {}
        for tag, (a2, fault_run) in first.items():
            cli_done(a2)
            _, err = cli_done(fault_run, rc=None)
            assert "FaultInjected" in err, f"{tag}: the fault run did not stop at the fault:\n{err[-3000:]}"
            resumed[tag] = cli_proc("train", CKPT_DRILLS[tag][0], train_args(tag, "B"))
        for tag, (config, _, steps, every, fault, _) in CKPT_DRILLS.items():
            out, err = cli_done(resumed[tag])
            assert f"resumed from checkpoint step {every}" in err, err[-3000:]
            assert json.loads(out.strip().splitlines()[-1])["resumed_from"] == every
            a, a2, b = (step_tensors(CheckpointManager(d(tag, n)).load(steps)) for n in ("A", "A2", "B"))
            run_spread, resume_spread = step_spread(a, a2), step_spread(a, b)
            if run_spread or resume_spread:
                cfg = get_config(config).with_overrides(dict(x.split("=", 1) for x in CKPT_DRILLS[tag][1]))
                step_grads, ops = grad_spread(cfg, load_dataset(cfg.data))
                log(f"[checkpoint] {tag}: A against A2 {run_spread}, against B {resume_spread}; step 1's gradients "
                    f"twice from one state differ in {step_grads}; ops that warn under "
                    f"torch.use_deterministic_algorithms: {ops}")
            assert not run_spread and not resume_spread, f"{tag}: A, A2 and B differ: {run_spread}, {resume_spread}"
            log(f"[checkpoint] {tag}: fault at step {fault}, resumed from {every}: the final step ({steps}) of "
                f"A, A2 and B agree bit for bit ({len(a)} tensors: params and optimizer moments)")

        # eval, recommend and serve from A.
        c1_cfg, _, c1_steps, c1_every, _, _ = CKPT_DRILLS["c1"]
        ds = load_dataset(get_config(c1_cfg).data)
        hist = histories_from_test(ds, 3)
        request = json.dumps([[{"poi": c.poi, "timestamp": c.timestamp} for c in h] for h in hist[:2]])
        reqs = [request, "{not json", json.dumps({"histories": [[{"poi": c.poi, "timestamp": c.timestamp}
                                                                  for c in hist[2]]], "k": 5})]
        procs = {}
        for tag, (config, sets, steps, every, _, _) in CKPT_DRILLS.items():
            where = ["--checkpoint-dir", d(tag, "A"), "--set", *sets]
            procs[f"{tag} eval"] = cli_proc("eval", config, where)
            procs[f"{tag} eval --step {every}"] = cli_proc("eval", config, [*where, "--step", str(every)])
        procs["recommend"] = cli_proc("recommend", c1_cfg, ["--checkpoint-dir", d("c1", "A")], stdin=request)
        procs["serve"] = cli_proc("serve", c1_cfg, ["--checkpoint-dir", d("c1", "A"), "--step", str(c1_steps)],
                                  stdin="\n".join(reqs) + "\n")
        got = {name: cli_done(p)[0].strip().splitlines() for name, p in procs.items()}
        for tag, (config, _, steps, every, _, _) in CKPT_DRILLS.items():
            full, at = json.loads(got[f"{tag} eval"][-1]), json.loads(got[f"{tag} eval --step {every}"][-1])
            assert full["metrics"] == outs[tag]["final"], (full, outs[tag]["final"])
            assert full["step"] == outs[tag]["selected_step"] and at["step"] == every, (full, at)
            log(f"[checkpoint] {tag} eval --checkpoint-dir A: {full['metrics']} (step {full['step']}, the selected "
                f"params), the metrics train printed; eval --step {every}: recall@10 {at['metrics']['recall@10']:.4f}")
        mgr = CheckpointManager(d("c1", "A"))
        cfg1 = get_config(c1_cfg)
        for name, params in (("recommend", mgr.restore_selected()), ("serve", mgr.load(c1_steps)["params"])):
            rec = Recommender(cli.model_with_params(cfg1, ds, params, torch.device(DEV)), cfg1, ds)
            want = rec.recommend(hist[:2], k=10)
            lines = [json.loads(x) for x in got[name]]
            if name == "recommend":
                assert np.array_equal(np.asarray(lines[-1]), want), (lines[-1], want)
            else:
                assert len(lines) == 3 and "error" in lines[1], lines
                assert np.array_equal(np.asarray(lines[0]["ids"]), want) and np.asarray(lines[2]["ids"]).shape == (1, 5)
        log(f"[checkpoint] c1 recommend --checkpoint-dir A: the ids of an in-process Recommender on the selected "
            f"params; serve --step {c1_steps}: 2 answers (those of the step's params) + 1 error line")

        # The metrics and the profiler window of config #1's A2 run.
        rows = []
        for name in os.listdir(d("c1", "M")):
            with open(os.path.join(d("c1", "M"), name)) as f:
                rows += [json.loads(line) for line in f]
        mem = [r for r in rows if "hbm_bytes_in_use_gib" in r]
        keys = ("hbm_bytes_in_use_gib", "hbm_peak_bytes_in_use_gib", "hbm_bytes_limit_gib")
        assert mem and all(r[k] > 0 for r in mem for k in keys), rows[:5]
        traces = os.listdir(d("c1", "P"))
        with open(os.path.join(d("c1", "P"), traces[0])) as f:
            trace = f.read()
        missing = [k for k in (*GRU_FWD_KERNELS, *GRU_BWD_KERNELS) if k not in trace]
        assert traces and not missing, f"the profile {traces} names no {missing}"
        log(f"[checkpoint] c1 --metrics-dir: {len(rows)} rows, memory at steps {[r['step'] for r in mem]}: "
            f"{[{k: round(r[k], 4) for k in keys} for r in mem]}; --profile-dir: {traces[0]} "
            f"({len(trace)} bytes) names {GRU_FWD_KERNELS + GRU_BWD_KERNELS}")

        # A step file's size, and the time to save it (synchronous, and with
        # async_save up to the caller's return) and to restore it.
        from poi_tpu_torch.train.loop import make_trainer

        for tag, (config, sets, steps, _, _, _) in CKPT_DRILLS.items():
            cfg = get_config(config).with_overrides(dict(s.split("=", 1) for s in sets))
            trainer = make_trainer(cfg, ds if tag == "c1" else load_dataset(cfg.data), DEV)
            st = trainer.init_state()
            src = CheckpointManager(d(tag, "A"))
            times = {"save": [], "async_return": [], "async_on_disk": [], "restore": []}
            for i in range(CKPT_TIMED):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st, _ = src.restore(st, steps)
                torch.cuda.synchronize()
                times["restore"].append((time.perf_counter() - t0) * 1e3)
                for mode in (False, True):
                    out = CheckpointManager(d(tag, f"T{int(mode)}"), async_save=mode)
                    t0 = time.perf_counter()
                    out.save(steps, st, config_json=cfg.to_json())
                    times["async_return" if mode else "save"].append((time.perf_counter() - t0) * 1e3)
                    out.wait()
                    if mode:
                        times["async_on_disk"].append((time.perf_counter() - t0) * 1e3)
            size = os.path.getsize(os.path.join(d(tag, "A"), f"step_{steps}.pt"))
            n = sum(v.numel() for v in st.params.values())
            log(f"[checkpoint] {tag} {config}: step file {size} bytes ({n} params + optimizer moments); ms, median "
                f"of {CKPT_TIMED}: " + ", ".join(f"{k} {statistics.median(v):.3f} ({', '.join(f'{x:.3f}' for x in v)})"
                                                 for k, v in times.items()) + f"; card: {gpu}")


def scripts_phase(state) -> None:
    """Each ported script as a user runs it (``python -m
    poi_tpu_torch.scripts.<name>``) on the card, at ``SCRIPT_RUNS``; a
    nonzero exit fails the run."""
    for name, args in SCRIPT_RUNS:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", f"poi_tpu_torch.scripts.{name}", *args, "--device", DEV],
                              capture_output=True, text=True, cwd=REPO, timeout=600,
                              env=dict(os.environ, PYTHONPATH=str(REPO)))
        for line in proc.stdout.splitlines():
            log(f"[{name}] {line}")
        assert proc.returncode == 0, f"{name} {' '.join(args)} exited {proc.returncode}:\n{proc.stderr[-3000:]}"
        # Every point of bench_cells is within its recurrence's width limit.
        assert name != "bench_cells" or "refused" not in proc.stdout, "bench_cells: a point was refused"
        assert name != "check_cell_parity" or "DIVERGES" not in proc.stdout, "check_cell_parity: a cell diverged"
        log(f"[scripts] {name} {' '.join(args)}: exit 0 in {time.perf_counter() - t0:.1f} s")


def topk_kernels(B: int, V: int, D: int, k: int) -> tuple:
    """The kernels one ``fused_topk`` call launches: pass 1, and the merge
    pass where its plan cuts the catalog into more than one slice."""
    import ctypes

    from poi_tpu_torch import _build

    slices = _build.library().topk_plan(V, k, B, D, ctypes.byref(ctypes.c_int(0)))
    return ("topk_slice_kernel", "topk_merge_kernel") if slices > 1 else ("topk_slice_kernel",)


def timing_phase(state, gpu: str) -> dict:
    import torch

    from poi_tpu_torch.models.base import batch_to
    from poi_tpu_torch.ops.fused_gru import fused_gru_scan, gru_scan_reference
    from poi_tpu_torch.ops.topk import fused_topk, topk_reference

    gen = torch.Generator(device=DEV).manual_seed(SEED + 2)
    out = {}
    # B1 at the serve shape (config #1, 256 histories) and at request batch 1.
    for name, B in (("gru_fwd", 256), ("gru_fwd_b1", 1)):
        T, H = 64, 64
        xw, wh, _, _ = gru_case(B, T, H, gen)
        out[name] = {"ms": time_ms(lambda: fused_gru_scan(xw, wh)), "plain_ms": time_ms(lambda: gru_scan_reference(xw, wh)),
                     "library_ms": cudnn_ms("gru", B, T, H, DEV),
                     **bound((xw, wh), (fused_gru_scan(xw, wh),), bf16_flop=2 * B * T * H * 3 * H), "args": (xw, wh)}
        t = out[name]
        log(f"[time] gru_fwd B={B} T={T} H={H}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, cuDNN nn.GRU "
            f"forward {t['library_ms']:.4f} ms; bound {t['bound_ms']:.4f} ms ({t['bound_by']})  ({gpu})")
    gru_cluster_choice(gen, gpu)
    # B11 at the serve shape (config #1's padded catalog) at request batch 1
    # and 256, k = 128 (recommend's fetch) and 10, and at the bench eval
    # sweep's shape, each beside torch.topk over the materialised logits (bf16
    # product, fp32 scores): CUDA events around a call (host launch work
    # included) and the profiler's device time.
    # bench_serve's 20-check-in histories fetch k = 32 (next_pow2(10 + 20)).
    prep = state["rec"]._prep
    catalogs = {"serve": (prep.table, prep.bias)}
    for key, (V, D, real) in TOPK_CATALOGS.items():
        bias = torch.randn(V, generator=gen, device=DEV)
        bias[real:] = -1e30
        catalogs[key] = (torch.randn(V, D, generator=gen, device=DEV).to(torch.bfloat16), bias)
    eval_batch = state["bench_cfg"].eval.batch_size
    cases = [("topk", 256, "serve", 128), ("topk_k10", 256, "serve", 10), ("topk_b1", 1, "serve", 128),
             ("topk_b1_k10", 1, "serve", 10), ("topk_eval", eval_batch, "eval", 10), ("topk_eval256", 256, "eval", 10),
             ("topk_c4", 256, "c4", 10), ("topk_serve70k", 256, "serve70k", 32), ("topk_serve70k_b1", 1, "serve70k", 32),
             ("topk_c5", 512, "c5", 10), ("topk_eval_d1024", eval_batch, "eval1024", 10)]
    for name, B, cat, k in cases:
        table, bias = catalogs[cat]
        q = torch.randn(B, table.shape[1], generator=gen, device=DEV)
        lib = lambda: torch.topk(torch.nn.functional.linear(q.to(torch.bfloat16), table).float() + bias, k)  # noqa: E731
        t = {"ms": time_ms(lambda: fused_topk(q, table, bias, k)),
             "plain_ms": time_ms(lambda: topk_reference(q, table, bias, k)), "library_ms": time_ms(lib),
             "device_ms": device_ms(lambda: fused_topk(q, table, bias, k), expect=topk_kernels(B, *table.shape, k)),
             "library_device_ms": device_ms(lib),
             **bound((q, table, bias), fused_topk(q, table, bias, k), bf16_flop=2 * B * table.shape[0] * table.shape[1])}
        out[name] = t
        log(f"[time] {name} B={B} V={table.shape[0]} D={table.shape[1]} k={k}: kernel {t['ms']:.4f} ms (device "
            f"{t['device_ms']:.4f}), plain {t['plain_ms']:.4f} ms, torch.topk over the logits {t['library_ms']:.4f} ms "
            f"(device {t['library_device_ms']:.4f}); bound {t['bound_ms']:.4f} ms ({t['bound_by']})  ({gpu})")
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
            ms = host_ms(lambda: rec.recommend(hist[:n], k=10), iters=10)
            log(f"[time] recommend batch {n:3d} ({name}): {ms:.3f} ms median of 10  ({gpu})")
    return out


def gru_cluster_choice(gen, gpu: str) -> None:
    """B1 at each cluster size that fits, beside the one the kernel picks,
    at ``GRU_CLUSTER_CASES`` (CUDA events): the measurement behind the pick.
    The C entry takes the cluster size to force; the wrapper always passes 0,
    the kernel's own pick."""
    import torch

    from poi_tpu_torch import _build

    lib = _build.library()
    for B, T, H in GRU_CLUSTER_CASES:
        xw, wh, _, _ = gru_case(B, T, H, gen)
        hs = torch.empty(B, T, H, device=DEV)

        def at(c):
            rc = lib.gru_fwd(xw.data_ptr(), wh.data_ptr(), hs.data_ptr(), B, T, H, c, xw.device.index,
                             torch.cuda.current_stream().cuda_stream)
            _build.check(rc, f"gru_fwd on a cluster of {c}")

        times = {c: time_ms(lambda: at(c)) for c in (1, 2, 4, 8, 16) if lib.gru_fwd_fits(H, c)}
        log(f"[time] gru_fwd cluster choice B={B} T={T} H={H}: " + ", ".join(f"C={c} {ms:.4f} ms" for c, ms in
                                                                              times.items())
            + f"; the kernel picks C={lib.gru_fwd_cluster_size(H)}  ({gpu})")


def step_timing(label: str, trainers: dict, tree, chunk: int, gpu: str, profiled: int = 5) -> dict:
    """The whole train step on the kernel and the plain path in turns
    (kernels, plain, plain, kernels), each over one ``chunk``-step
    device-sampled chunk fenced by reading its last loss, after a warm-up
    chunk; then where the kernel path's step spends device time, over
    ``profiled`` steps. The host
    clock is also read when the chunk's launches are all queued: a share
    near 1 means the host waited for the card inside the chunk. Returns the
    better ms per step of each path."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    states = {name: tr.init_state(tree) for name, tr in trainers.items()}
    for name, tr in trainers.items():  # warm-up chunk: allocator, cuBLAS handles
        states[name], m = tr.step_sampled(states[name], chunk)
        m["loss"][-1].item()
    bs = trainers["kernels"].cfg.train.batch_size
    runs = {"kernels": [], "plain": []}
    queued = {"kernels": [], "plain": []}
    for name in ("kernels", "plain", "plain", "kernels"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states[name], m = trainers[name].step_sampled(states[name], chunk)
        t1 = time.perf_counter()
        m["loss"][-1].item()
        t2 = time.perf_counter()
        runs[name].append((t2 - t0) * 1e3 / chunk)
        queued[name].append((t1 - t0) / (t2 - t0))
    for name, ms in runs.items():
        log(f"[time] train step ({name}), {label}: {ms[0]:.3f} / {ms[1]:.3f} ms per step over "
            f"{chunk}-step chunks, {bs / (min(ms) / 1e3):.1f} seq/s at the better; launches queued at "
            f"{queued[name][0]:.3f} / {queued[name][1]:.3f} of the chunk's time  ({gpu})")
    best = {k: min(v) for k, v in runs.items()}

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        states["kernels"], m = trainers["kernels"].step_sampled(states["kernels"], profiled)
        m["loss"][-1].item()
    events = prof.key_averages()
    kernels = [e for e in events if str(e.device_type).endswith("CUDA")]
    dev_us = [(e.key, e.count, getattr(e, "self_device_time_total", 0.0)) for e in kernels]
    busy_ms = sum(t for _, _, t in dev_us) / 1e3 / profiled
    # Runtime calls that make the host wait for the card (the closing
    # .item() accounts for one copy and one sync).
    waits = {e.key: e.count for e in events
             if e.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
                          "cudaMemcpyAsync", "cudaMemcpy")}
    # The profiler slows the host, so the idle share compares the device time
    # a step needs with the unprofiled step time measured above.
    log(f"[profile] kernel path, {label}: {busy_ms:.3f} ms of device time a step against a {best['kernels']:.3f} ms "
        f"step (device idle share {max(0.0, 1 - busy_ms / best['kernels']):.3f}); host-waiting runtime calls over "
        f"{profiled} steps {waits}  ({gpu})")
    for key, count, t in sorted(dev_us, key=lambda r: -r[2])[:20]:
        log(f"[profile]   {t / 1e3 / profiled:8.3f} ms/step  x{count // profiled:<4d} {key[:90]}")
    return best


def train_timing_phase(state, gpu: str) -> dict:
    """The training kernels at the bench shapes, the whole train step on both
    paths, the dense-vs-fused CE around the fused-CE threshold, and the
    kernel path's step broken down by kernel (torch.profiler)."""
    import torch

    from poi_tpu_torch.ops.fused_ce import ce_bwd, ce_bwd_reference, ce_lse, ce_lse_reference, fused_ce_loss
    from poi_tpu_torch.ops.fused_gru import fused_gru_bwd, fused_gru_scan, gru_bwd_reference, gru_scan_reference
    from poi_tpu_torch.scripts import sweep_ce_bwd
    from poi_tpu_torch.train.losses import ce_loss

    gen = torch.Generator(device=DEV).manual_seed(SEED + 5)
    out = {}
    B, T, H = GRU_TRAIN_SHAPE
    xw, wh, _, _ = gru_case(B, T, H, gen)
    hs = fused_gru_scan(xw, wh)
    dhs = torch.randn(B, T, H, generator=gen, device=DEV)
    G = 3 * H
    out["gru_fwd_train"] = {"ms": time_ms(lambda: fused_gru_scan(xw, wh)),
                            "plain_ms": time_ms(lambda: gru_scan_reference(xw, wh), 5),
                            "library_ms": cudnn_ms("gru", B, T, H, DEV),
                            **bound((xw, wh), (hs,), bf16_flop=2 * B * T * H * G), "args": (xw, wh)}
    out["gru_bwd"] = {"ms": time_ms(lambda: fused_gru_bwd(xw, wh, hs, dhs)),
                      "plain_ms": time_ms(lambda: gru_bwd_reference(xw, wh, hs, dhs), 5), "library_ms": None,
                      **gru_bwd_bound(xw, wh, hs, dhs, fused_gru_bwd(xw, wh, hs, dhs)),
                      **device_parts(lambda: fused_gru_bwd(xw, wh, hs, dhs), GRU_BWD_KERNELS)}
    for name in ("gru_fwd_train", "gru_bwd"):
        t = out[name]
        lib = f", cuDNN nn.GRU forward {t['library_ms']:.4f} ms" if t["library_ms"] is not None else ""
        dev = "; " + parts_text(t, GRU_BWD_KERNELS) if name == "gru_bwd" else ""
        log(f"[time] {name} B={B} T={T} H={H}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms{lib}; bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}, {t['bound_pipe']}){dev}  ({gpu})")
    # No single PyTorch call computes a row LSE over a product, or its
    # gradients from a given LSE: no library time. B8 at the bench shape and
    # at config #3's, its two passes apart from the profiler's device time.
    # Then B7/B8 at D = 256: config #3's 256-d shape (path 1) and the bench
    # shape; at D = 512: config #3's shape and the bench shape (the wide
    # path's CE); and on the K-chunked kernels: the bench shape at D = 1024
    # (the wider bench path's CE) and config #3's at 768. Each bound at the
    # function's count and at the kernel's own (loss_kernel_flop).
    for key, (N, V, D) in (("", CE_TRAIN_SHAPE), ("_c3", CE_C3_SHAPE), ("_c3_d256", CE_C3_D256),
                           ("_d256", CE_WIDE_CASES[1][:3]), ("_c3_d512", CE_C3_D512), ("_d512", CE_BENCH_D512),
                           ("_d1024", CE_BENCH_D1024), ("_c3_d768", CE_C3_D768)):
        q = 0.3 * torch.randn(N, D, generator=gen, device=DEV)
        table = 0.3 * torch.randn(V, D, generator=gen, device=DEV)
        bias = torch.randn(V, generator=gen, device=DEV)
        g = torch.rand(N, generator=gen, device=DEV)
        lse = ce_lse_reference(q, table, bias)
        flop = 2 * N * V * D
        # B7 at both shapes, its split kernel and merge apart in device time.
        lse_names = ce_lse_kernels(D)
        out["ce_lse" + key] = {"ms": time_ms(lambda: ce_lse(q, table, bias)),
                               "plain_ms": time_ms(lambda: ce_lse_reference(q, table, bias), 5), "library_ms": None,
                               **ce_lse_bound(q, table, bias, lse),
                               "bound_kernel_ms": loss_kernel_flop("ce_lse", N, V, D) / BF16_FLOP_PER_S * 1e3,
                               **device_parts(lambda: ce_lse(q, table, bias), lse_names)}
        for n in CE_LSE_KERNELS:  # the record's keys, under B7's kernel names at every width
            out["ce_lse" + key][f"{n}_ms"] = out["ce_lse" + key].pop(f"{lse_names[CE_LSE_KERNELS.index(n)]}_ms")
        t = {"ms": time_ms(lambda: ce_bwd(q, table, bias, lse, g)),
             "plain_ms": time_ms(lambda: ce_bwd_reference(q, table, bias, lse, g), 5), "library_ms": None,
             **bound((q, table, bias, lse, g), ce_bwd(q, table, bias, lse, g), bf16_flop=3 * flop),
             "bound_kernel_ms": loss_kernel_flop("ce_bwd", N, V, D) / BF16_FLOP_PER_S * 1e3}
        parts = sweep_ce_bwd.pass_ms(lambda: ce_bwd(q, table, bias, lse, g), 10)
        t.update({f"{name.split()[0]}_ms": parts[name] for name in ("dq pass", "dtable pass")},
                 sum_splits_ms=parts.get("sum_splits"))
        out["ce_bwd" + key] = t
        for name in ("ce_lse" + key, "ce_bwd" + key):
            t = out[name]
            rate = loss_kernel_flop(name.split("_c3")[0].split("_d")[0], N, V, D) / t["ms"] / 1e9
            apart = ("; " + parts_text({**t, f"{lse_names[0]}_ms": t[f"{CE_LSE_KERNELS[0]}_ms"]}, lse_names)
                     if name.startswith("ce_lse") else
                     f"; device time dq pass {t['dq_ms']:.4f} ms, dtable pass {t['dtable_ms']:.4f} ms"
                     + (f", sum_splits {t['sum_splits_ms']:.4f} ms" if t["sum_splits_ms"] is not None else ""))
            log(f"[time] {name} N={N} V={V} D={D}: kernel {t['ms']:.4f} ms ({rate:.1f} TFLOP/s of the kernel's "
                f"catalog products), plain {t['plain_ms']:.4f} ms; bound "
                f"{t['bound_ms']:.4f} ms ({t['bound_by']}, {t['bound_pipe']}; at the kernel's own count "
                f"{t['bound_kernel_ms']:.4f} ms){apart}  ({gpu})")

    from poi_tpu_torch.train.loop import make_trainer

    cfg, ds, tree = state["bench_cfg"], state["bench_ds"], state["bench_tree"]
    trainers = {"kernels": make_trainer(cfg, ds, DEV), "plain": make_trainer(cfg.with_overrides(PLAIN_OVERRIDES), ds, DEV)}
    out["train_step"] = step_timing("bench workload", trainers, tree, BENCH_TIME_CHUNK, gpu)

    # Dense vs fused CE loss (forward + backward) on both sides of the 8,192
    # threshold: config #1's shape, and the bench shape at both catalogs.
    for n, v, d in CE_THRESHOLD_CASES:
        qq = (0.3 * torch.randn(n // 64, 64, d, generator=gen, device=DEV)).requires_grad_()
        tt = (0.3 * torch.randn(v, d, generator=gen, device=DEV)).requires_grad_()
        bb = torch.zeros(v, device=DEV, requires_grad=True)
        y = torch.randint(0, v, (n // 64, 64), generator=gen, device=DEV)
        mask = torch.ones(n // 64, 64, device=DEV)
        fused = time_ms(lambda: fused_ce_loss(qq, tt, bb, y, mask).backward(), 5)
        dense = time_ms(lambda: ce_loss(qq, tt, bb, y, mask).backward(), 5)
        log(f"[time] CE loss fwd+bwd N={n} V={v} D={d}: fused kernels {fused:.4f} ms, dense {dense:.4f} ms  ({gpu})")

    return out


def config_timing_phase(state, gpu: str) -> dict:
    """Config #4's train step on both paths, with its device-time profile;
    then configs #2 and #3, the wide path, the wide LSTM and ST-RNN paths,
    and the wider bench and config #4 paths."""
    from poi_tpu_torch.train.loop import make_trainer

    out = {}
    for tag, label, cfg, ds, tree in (("attn", "config #4", state["attn_cfg"], state["attn_ds"], state["attn_tree"]),
                                      *((tag, f"config {REC_CONFIGS[tag][0]}", state[tag]["cfg"], state[tag]["ds"],
                                         state[tag]["tree"]) for tag in REC_CONFIGS)):
        trainers = {"kernels": make_trainer(cfg, ds, DEV),
                    "plain": make_trainer(cfg.with_overrides(PLAIN_OVERRIDES), ds, DEV)}
        out[f"{tag}_train_step"] = step_timing(label, trainers, tree, STEP_TIME_CHUNK, gpu)
    # The wide path's step (the bench workload at D = 512, H = 1024), over
    # WIDE_TIME_CHUNK-step chunks and 2 profiled steps.
    cfg, ds = state["wide"]["cfg"], state["bench_ds"]
    trainers = {"kernels": make_trainer(cfg, ds, DEV), "plain": make_trainer(cfg.with_overrides(PLAIN_OVERRIDES), ds, DEV)}
    out["wide_train_step"] = step_timing("the wide path (bench workload at D = 512, H = 1024)", trainers,
                                         state["wide"]["tree"], WIDE_TIME_CHUNK, gpu, profiled=2)
    # The wide LSTM and ST-RNN paths' steps (configs #2 and #3 at D = 512,
    # H = 1024), the same way.
    for tag in REC_CONFIGS:
        w = state[f"{tag}_wide"]
        trainers = {"kernels": make_trainer(w["cfg"], state[tag]["ds"], DEV),
                    "plain": make_trainer(w["cfg"].with_overrides(PLAIN_OVERRIDES), state[tag]["ds"], DEV)}
        out[f"{tag}_wide_train_step"] = step_timing(f"the wide {tag} path (config {REC_CONFIGS[tag][0]} at D = 512, "
                                                    f"H = 1024)", trainers, w["tree"], WIDE_TIME_CHUNK, gpu,
                                                    profiled=2)
    # The wider paths' steps (the bench workload and config #4 at D = H =
    # 1024), the same way.
    for tag, (config, _) in WIDER_PATHS.items():
        w = state[f"wider_{tag}"]
        trainers = {"kernels": make_trainer(w["cfg"], w["ds"], DEV),
                    "plain": make_trainer(w["cfg"].with_overrides(PLAIN_OVERRIDES), w["ds"], DEV)}
        out[f"wider_{tag}_train_step"] = step_timing(f"the wider {tag} path ({config} at D = H = 1024)", trainers,
                                                     w["tree"], WIDE_TIME_CHUNK, gpu, profiled=2)
    return out


def config5_timing_phase(state, gpu: str) -> None:
    """Config #5's train step on both paths and its kernel path's device
    time by kernel over 2 steps. The last phase that reads the profiler in
    this process: after its record of two config #5 steps (~3,000 kernels
    and their host ops) the profiler's later records here came back empty."""
    from poi_tpu_torch.train.loop import make_trainer

    c5 = state["c5"]
    trainers = {"kernels": make_trainer(c5["cfg"], c5["ds"], DEV),
                "plain": make_trainer(c5["cfg"].with_overrides(PLAIN_OVERRIDES), c5["ds"], DEV)}
    step_timing("config #5", trainers, c5["tree"], STEP_TIME_CHUNK, gpu, profiled=2)


# --ab: kernels timed in both checkouts at their main path's shapes
# (``AB_TIMED``: those a change redesigns, their outputs' difference logged),
# and kernels whose outputs must keep the other checkout's bits
# (``AB_KEPT``: asserted). ``AB_CHILD`` runs in each checkout's directory,
# with its chip_smoke.py's helpers, and holds a call for every kernel
# either names; its second argument lists the kernels to time.
AB_TIMED = ("ce_lse_variant_base", "ce_lse_variant_exp2", "ce_lse_variant_nomax")
AB_KEPT = ("gru_fwd", "gru_bwd", "lstm_fwd", "lstm_bwd", "sampled_bwd", "rnn_bwd", "sampled_lse", "ce_lse", "ce_bwd",
           "rnn_fwd", *AB_TIMED)
# Path 2's host-loader train() in each checkout (seq/s and device idle share
# at steps_per_call 1 and 10 by this checkout's host_loader_timing; a
# checkout whose loop ignores steps_per_call runs both synchronously).
AB_HOST = "host_loader"
AB_CHILD = r"""
import json, sys
import torch
import chip_smoke as cs
from poi_tpu_torch.ops.fused_gru import fused_gru_bwd, fused_gru_scan, gru_scan_reference
from poi_tpu_torch.ops.fused_lstm import fused_lstm_bwd, fused_lstm_scan, lstm_scan_reference
from poi_tpu_torch.ops.fused_rnn import fused_rnn_bwd, fused_rnn_scan, rnn_scan_reference
from poi_tpu_torch.ops.fused_ce import ce_bwd, ce_lse, ce_lse_variant
from poi_tpu_torch.ops.fused_sampled import sampled_bwd, sampled_lse
from poi_tpu_torch.scripts import sweep_ce_fwd
torch.backends.cuda.matmul.allow_tf32 = False
cs.build_phase()
gen = torch.Generator(device="cuda").manual_seed(1234)
x, mask, w, _ = cs.recurrence_case(64, 32, 128, 1, gen)
hs = rnn_scan_reference(x, mask, w)  # B6's input the same in both checkouts, whatever their B5
dhs = torch.randn(64, 32, 128, generator=gen, device="cuda")
q, e, b, ids, tgt, lse_tot, g = cs.sampled_case(8192, 1024, 256, 36969, gen)
xw, wh, _, _ = cs.gru_case(64, 64, 128, gen)
gh = fused_gru_scan(xw, wh)
gdh = torch.randn(64, 64, 128, generator=gen, device="cuda")
# B1/B2 at the clusters' widest H, 640, and B7/B8 at D = 256 on config #3's
# rows: both checkouts take them.
xw6, wh6, _, _ = cs.gru_case(3, 64, 640, gen)
gh6 = gru_scan_reference(xw6, wh6)
gdh6 = torch.randn(3, 64, 640, generator=gen, device="cuda")
wq, wt = (0.3 * torch.randn(n, 256, generator=gen, device="cuda") for n in cs.CE_C3_D256[:2])
wb = torch.randn(cs.CE_C3_D256[1], generator=gen, device="cuda")
lx, lmask, lw, _ = cs.recurrence_case(64, 64, 128, 4, gen)
lst = fused_lstm_scan(lx, lmask, lw)
ldh = torch.randn(64, 64, 128, generator=gen, device="cuda")
# B1/B2 on the grid (H = 648 and 1024), B3/B4 at the clusters' widest H,
# 512, and B5/B6 at theirs, 640: the parent takes each. The backward's
# inputs come from the plain forward, the same in both checkouts.
gw = [cs.gru_case(B, 32, H, gen)[:2] for B, H in ((7, 648), (5, 1024))]
gwh = [gru_scan_reference(a, w) for a, w in gw]
gwd = [torch.randn(*h.shape, generator=gen, device="cuda") for h in gwh]
lx5, lmask5, lw5, _ = cs.recurrence_case(3, 32, 512, 4, gen)
lst5 = lstm_scan_reference(lx5, lmask5, lw5)
ldh5 = torch.randn(3, 32, 512, generator=gen, device="cuda")
x6, mask6, w6, _ = cs.recurrence_case(3, 32, 640, 1, gen)
hs6 = rnn_scan_reference(x6, mask6, w6)
dhs6 = torch.randn(3, 32, 640, generator=gen, device="cuda")
cq, ct, cb = sweep_ce_fwd.inputs(sweep_ce_fwd.N, sweep_ce_fwd.V, sweep_ce_fwd.D, "cuda")
bq, bt = (0.3 * torch.randn(n, 128, generator=gen, device="cuda") for n in cs.CE_TRAIN_SHAPE[:2])
bb = torch.randn(cs.CE_TRAIN_SHAPE[1], generator=gen, device="cuda")
bl = torch.randn(cs.CE_TRAIN_SHAPE[0], generator=gen, device="cuda") + 8.0
bg = torch.rand(cs.CE_TRAIN_SHAPE[0], generator=gen, device="cuda")
sq, st, sb = (0.3 * torch.randn(300, 32, generator=gen, device="cuda"), 0.3 * torch.randn(8193, 32, generator=gen,
              device="cuda"), torch.randn(8193, generator=gen, device="cuda"))
# B7/B8 at D = 512 and 384 on config #3's rows, and B9/B10 at D = 512 on
# config #4's: the widest the parent took before D = 768 and 1024.
xq, xt = (0.3 * torch.randn(n, 512, generator=gen, device="cuda") for n in cs.CE_C3_D512[:2])
xb = torch.randn(cs.CE_C3_D512[1], generator=gen, device="cuda")
q5, e5, b5, ids5, tgt5, lse5, g5 = cs.sampled_case(8192, 1024, 512, 36969, gen)
# B12 at the sweep's shape and 128 rows, which both checkouts take; "ce_lse"
# names the kernel of either design (ce_lse_kernel, ce_lse_wg_kernel). B7 at
# the bench shape, and on config #3's 2,048 rows (its split-and-merge path).
variant = lambda v: (lambda: (ce_lse_variant(cq, ct, cb, v, 128),), ("ce_lse",))  # noqa: E731
calls = {**{f"ce_lse_variant_{v}": variant(v) for v in ("base", "exp2", "nomax")},
         "ce_lse": (lambda: (ce_lse(bq, bt, bb), ce_lse(bq[:cs.CE_C3_SHAPE[0]], bt, bb), ce_lse(wq, wt, wb),
                             ce_lse(wq[:, :192], wt[:, :192], wb), ce_lse(xq, xt, xb),
                             ce_lse(xq[:, :384], xt[:, :384], xb)), cs.CE_LSE_KERNELS),
         # B8 at the bench shape, on config #3's 2,048 rows (its split
         # passes), at D = 32 on ragged N and V, and at D = 256, 192, 512
         # and 384.
         "ce_bwd": (lambda: (*ce_bwd(bq, bt, bb, bl, bg),
                             *ce_bwd(bq[:cs.CE_C3_SHAPE[0]], bt, bb, bl[:cs.CE_C3_SHAPE[0]], bg[:cs.CE_C3_SHAPE[0]]),
                             *ce_bwd(sq, st, sb, bl[:300], bg[:300]),
                             *ce_bwd(wq, wt, wb, bl[:cs.CE_C3_SHAPE[0]], bg[:cs.CE_C3_SHAPE[0]]),
                             *ce_bwd(wq[:, :192], wt[:, :192], wb, bl[:cs.CE_C3_SHAPE[0]], bg[:cs.CE_C3_SHAPE[0]]),
                             *ce_bwd(xq, xt, xb, bl[:cs.CE_C3_SHAPE[0]], bg[:cs.CE_C3_SHAPE[0]]),
                             *ce_bwd(xq[:, :384], xt[:, :384], xb, bl[:cs.CE_C3_SHAPE[0]], bg[:cs.CE_C3_SHAPE[0]])),
                    ("ce_bwd_pass", "sum_splits")),
         "gru_fwd": (lambda: (fused_gru_scan(xw, wh), fused_gru_scan(xw6, wh6), *(fused_gru_scan(a, w) for a, w in gw)),
                     cs.GRU_FWD_KERNELS),
         "rnn_fwd": (lambda: (fused_rnn_scan(x, mask, w), fused_rnn_scan(x6, mask6, w6)), cs.RNN_FWD_KERNELS),
         "rnn_bwd": (lambda: (*fused_rnn_bwd(x, mask, w, hs, dhs), *fused_rnn_bwd(x6, mask6, w6, hs6, dhs6)),
                     cs.RNN_BWD_KERNELS),
         "lstm_fwd": (lambda: (*fused_lstm_scan(lx, lmask, lw), *fused_lstm_scan(lx5, lmask5, lw5)),
                      cs.LSTM_FWD_KERNELS),
         "sampled_lse": (lambda: (sampled_lse(q, e, b, ids, tgt), sampled_lse(q5, e5, b5, ids5, tgt5)),
                         cs.SAMPLED_LSE_KERNELS),
         "sampled_bwd": (lambda: (*sampled_bwd(q, e, b, ids, tgt, lse_tot, g),
                                  *sampled_bwd(q5, e5, b5, ids5, tgt5, lse5, g5)), cs.SAMPLED_BWD_KERNELS),
         "gru_bwd": (lambda: (*fused_gru_bwd(xw, wh, gh, gdh), *fused_gru_bwd(xw6, wh6, gh6, gdh6),
                              *(o for (a, w), h, d in zip(gw, gwh, gwd) for o in fused_gru_bwd(a, w, h, d))),
                     cs.GRU_BWD_KERNELS),
         "lstm_bwd": (lambda: (*fused_lstm_bwd(lx, lmask, lw, *lst, ldh), *fused_lstm_bwd(lx5, lmask5, lw5, *lst5, ldh5)),
                      cs.LSTM_BWD_KERNELS)}
wanted = json.loads(sys.argv[2])
res = {k: {"events_ms": cs.time_ms(calls[k][0]), **cs.device_parts(*calls[k])} for k in wanted if k in calls}
torch.save({k: [t.cpu() for t in f()] for k, (f, _) in calls.items()}, sys.argv[1])
if sys.argv[3] in wanted:  # path 2: config #4's host-loader train(), both spc
    from poi_tpu_torch.configs.presets import get_config
    from poi_tpu_torch.data.dataset import load_dataset
    exec(sys.argv[5])  # this checkout's host_loader_timing
    cfg = get_config(cs.ATTN_CONFIG)
    ds = load_dataset(cfg.data)
    res[sys.argv[3]] = {spc: host_loader_timing(cfg, ds, spc, *json.loads(sys.argv[4])) for spc in (1, 10)}
print("AB " + json.dumps(res), flush=True)
"""


def ab_main(other: str) -> int:
    """``--ab``: ``AB_TIMED`` timed in ``other`` and in this checkout, in
    turns; ``AB_KEPT``'s outputs asserted to be the other checkout's bits,
    and every output the same bits on a second run here."""
    import torch

    if not torch.cuda.is_available():
        print("error: torch.cuda.is_available() is false: this smoke run needs a CUDA card", file=sys.stderr)
        return 2
    gpu = gpu_line()
    log(f"[ab] card: {gpu}")
    (REPO / "build").mkdir(exist_ok=True)
    out_dir = Path(tempfile.mkdtemp(prefix="ab_", dir=REPO / "build"))
    runs = [("other", Path(other).resolve()), ("this", REPO), ("this", REPO), ("other", Path(other).resolve())]
    times: dict = {}
    outs = {}
    for i, (tag, tree) in enumerate(runs):
        path = out_dir / f"{i}_{tag}.pt"
        proc = subprocess.run([sys.executable, "-c", AB_CHILD, str(path), json.dumps([*AB_TIMED, AB_HOST]), AB_HOST,
                               json.dumps([HOST_TIMING_STEPS, HOST_TIMING_WARMUP, HOST_TIMING_PROFILED]),
                               inspect.getsource(host_loader_timing)], cwd=tree, capture_output=True, text=True,
                              timeout=600)
        assert proc.returncode == 0, f"--ab run in {tree} failed:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}"
        line = [ln for ln in proc.stdout.splitlines() if ln.startswith("AB ")][-1]
        times.setdefault(tag, []).append(json.loads(line[3:]))
        outs.setdefault(tag, []).append(torch.load(path))
    for name in AB_TIMED:
        for tag in ("other", "this"):
            for i, t in enumerate(times[tag]):
                parts = ", ".join(f"{k[:-3]} {v:.4f}" for k, v in t[name].items() if k not in ("events_ms", "device_ms"))
                log(f"[ab] {name} {tag} run {i + 1}: CUDA events {t[name]['events_ms']:.4f} ms, device "
                    f"{t[name]['device_ms']:.4f} ms ({parts})  ({gpu})")
    for tag in ("other", "this"):
        for i, t in enumerate(times[tag]):
            log(f"[ab] {AB_HOST} {tag} run {i + 1}: config #4's host-loader train(), "
                + "; ".join(f"spc={spc}: {r['seq_per_s']:.1f} seq/s ({r['step_ms']:.3f} ms a step, device "
                            f"{r['device_ms']:.3f} ms, idle share {r['idle']:.3f})" for spc, r in t[AB_HOST].items())
                + f"  ({gpu})")
    for name in dict.fromkeys((*AB_TIMED, *AB_KEPT)):
        want = outs["other"][0][name]
        same = all(torch.equal(a, b) for a, b in zip(outs["this"][0][name], want))
        rerun = all(torch.equal(a, b) for a, b in zip(outs["this"][0][name], outs["this"][1][name]))
        diff = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30)) for a, b in zip(outs["this"][0][name], want))
        log(f"[ab] {name}: outputs {'the same bits as' if same else 'differ from'} the other checkout's (max "
            f"relative difference {diff:.3e}); a second run here gives {'the same' if rerun else 'other'} bits")
        assert rerun, f"{name}: run-to-run bits"
        assert same or name not in AB_KEPT, f"{name}: must keep the other checkout's bits"
    return 0


# ----------------------------------------------------------------- mesh
# The multi-GPU layer on this one card: MESH_WORLD ranks, each a process
# (``parallel.launch.spawn``), all on cuda:0, over gloo: NCCL refuses two
# ranks on one device. The kernels run on the card inside the sharded path
# on every rank, and gloo carries the collectives through host memory. A
# correctness and cost rig of ranks that share one card; it measures no
# scaling.
MESH_WORLD = 4
MESH_TIMEOUT = 600
# Config #5 on its preset's mesh (data=-1, model=4, a2a): C5_SETS without
# the one-card mesh. Held to one rank with the a2a capacity factor at M,
# where a bucket holds a whole chunk and no id can drop; then the preset's
# own factor, whose drops the overflow metric counts.
MESH_C5_SETS = {k: v for k, v in C5_SETS.items() if not k.startswith("mesh.")}
MESH_EXACT = {"mesh.a2a_capacity_factor": str(float(MESH_WORLD))}
MESH_C5_STEPS = 3  # 5 before the wider paths' phases came
# The bench workload on 2 x 2: psum lookups, the sharded CE, dense Adam with the clip.
MESH_BENCH_SETS = {**BENCH_OVERRIDES, "mesh.data": "2", "mesh.model": "2", "mesh.embedding_mode": "psum"}
MESH_BENCH_STEPS = 10
MESH_TOPK_ROWS = 512  # the val (test) rows whose top-k scores and ids the mesh and one rank compare
# The jobs whose table after step 1 is held entry by entry to the one-rank
# run's. Not the bench: one card takes the fused CE (B8's fp32 table
# gradient), 2 x 2 the sharded CE, whose table cotangent is rounded to bf16
# (as the reference's is); a row that is no target has a CE gradient that is
# a cancelling sum near Adam's eps, where the first step turns its last bits
# into up to lr (1% of the entries, 1.26e-3 at most, in my first run).
MESH_TABLE_JOBS = ("c5",)
# Sequence-parallel attention (parallel/sp_attention.py) on config #5's
# 1 x 4: a run of each impl at capacity factor M (no drops), held to the
# blockwise run on the same ranks and to the one-rank run. Ulysses puts 2
# of the 8 heads on a rank; ring's time blocks of 16 are the window.
MESH_SP_IMPLS = ("ring", "ulysses")
# job -> (config, sets, steps, split, the runs that follow from the init in
# the same processes on the same corpus: name -> sets): config #5 at the
# preset's own a2a capacity, and with ring and Ulysses attention.
MESH_JOBS = {"c5": (C5_CONFIG, {**MESH_C5_SETS, **MESH_EXACT}, MESH_C5_STEPS, "val",
                    {"preset": MESH_C5_SETS,
                     **{impl: {**MESH_C5_SETS, **MESH_EXACT, "model.attn_impl": impl} for impl in MESH_SP_IMPLS}}),
             "bench": ("smoke", MESH_BENCH_SETS, MESH_BENCH_STEPS, "test", {})}
# Config #4's tower (attention_gowalla: GRU 256-d, 4 heads, window 16, T =
# 128, batch 64) on the bench job's 2 x 2 with ring and with Ulysses, each
# data rank its 32 rows, against blockwise attention on one rank over the
# whole batch: the output and the gradients of the GRU and of wq..wo under
# one cotangent. In fp32 (the plain GRU) at tests/test_sp_attention.py's
# tolerances (|diff| <= atol + rtol |ref|: 1e-4 forward, 1e-3 gradients); in
# bf16 (B1 and B2 on every rank) to 2^-5 of each tensor's largest value:
# ring rounds its unnormalised probabilities to bf16 where blockwise rounds
# the normalised ones, and the attention output is rounded again before wo
# (2^-8 a rounding), so the two differ by a few bf16 steps, which the layer
# norm scales up.
TOWER_FP32_TOL = (1e-4, 1e-3)
TOWER_BF16_TOL = 2.0 ** -5
# Config #5 served on its 1 x 4 by the c5 job's ranks, through the serve
# CLI, from the checkpoint of its exact run: SERVE_SINGLES one-history
# requests, one of SERVE_BATCH histories twice (its first call pays the
# shapes' first allocations), one whose 128 fetched candidates
# are all visited (scored again by every rank), a malformed line and a k =
# 129 line (answered by rank 0 alone), then EOF. At capacity factor M: at
# the preset's 2.0 the a2a lookup may drop ids, the reference's semantics.
SERVE_SINGLES = 64
SERVE_BATCH = 256
SERVE_SETS = {**MESH_C5_SETS, **MESH_EXACT}


# The rank body that mesh_run spawns (module:function).
MESH_CHILD = "chip_smoke:mesh_child"


def mesh_cfg(name: str, sets: dict, one_rank: bool = False):
    """A mesh job's config (log every step), or its one-rank run's."""
    from poi_tpu_torch.configs.presets import get_config

    cfg = get_config(name).with_overrides({**sets, "train.log_every": "1"})
    return cfg.with_overrides({"mesh.data": "1", "mesh.model": "1"}) if one_rank else cfg


def split_topk(model, ds, cfg, split: str, mesh=None):
    """(vals, catalog ids) [MESH_TOPK_ROWS, k] of the first rows of
    ``split``: the one-card top-k (B11 over the popularity-ordered catalog)
    or, on a mesh, the sharded one (B11 on each shard, the k·M merge), each
    data rank its rows, gathered."""
    import numpy as np
    import torch

    from poi_tpu_torch.data.pipeline import Batch, eval_batches
    from poi_tpu_torch.eval.evaluate import prepare_catalog
    from poi_tpu_torch.models.base import batch_to
    from poi_tpu_torch.ops.topk import fused_topk, sharded_topk
    from poi_tpu_torch.parallel import collectives as cc
    from poi_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS

    k = max(cfg.eval.recall_ks)
    prep = prepare_catalog(model, cfg, ds.poi_counts, mesh)
    examples = getattr(ds, split).take(np.arange(MESH_TOPK_ROWS))
    batch, _, _ = next(eval_batches(examples, MESH_TOPK_ROWS))
    n_data = mesh.shape[DATA_AXIS] if mesh is not None else 1
    rows = mesh.rows(MESH_TOPK_ROWS, DATA_AXIS) if n_data > 1 else slice(None)
    with torch.inference_mode():
        ql = model.queries_last(batch_to(Batch(*(a[rows] for a in batch)), model.device))
        if mesh is not None and mesh.shape[MODEL_AXIS] > 1:
            vals, ids = sharded_topk(ql, prep.table, prep.bias, k, mesh, fused_topk)
        else:
            vals, ids = fused_topk(ql, prep.table, prep.bias, k)
        if n_data > 1:
            vals, ids = (cc.all_gather(t, mesh, DATA_AXIS) for t in (vals, ids))
    ids = ids.cpu().numpy()
    return vals.cpu(), torch.from_numpy(prep.id_map[ids] if prep.id_map is not None else ids).long()


def mesh_reference(job: str, ds, work: Path) -> dict:
    """The one-rank run a mesh job is held to: ``make_trainer`` on this
    card from the seed's init, the top-k of the split's first rows at that
    init, the same device-sampled batches and pools, ``steps`` steps
    through ``train()`` (the table after step 1 saved for the ranks) and
    ``evaluate()``."""
    import numpy as np
    import torch

    from poi_tpu_torch.eval.evaluate import evaluate
    from poi_tpu_torch.train.loop import make_trainer, train

    name, sets, steps, split, _ = MESH_JOBS[job]
    cfg = mesh_cfg(name, sets, one_rank=True)
    trainer = make_trainer(cfg, ds, DEV)
    state = trainer.init_state()
    vals, ids = split_topk(trainer.model, ds, cfg, split)
    _, state, hist = train(cfg, ds, num_steps=1, trainer=trainer, state=state)
    if job in MESH_TABLE_JOBS:
        np.save(work / f"{job}_table1.npy", state.params["embed.poi"].detach().cpu().numpy())
    _, state, more = train(cfg, ds, num_steps=steps - 1, trainer=trainer, state=state)
    out = {"losses": [r["loss"] for r in hist + more], "vals": vals, "ids": ids,
           "metrics": evaluate(trainer.model, ds, cfg, split)}
    del trainer, state
    torch.cuda.empty_cache()
    return out


def mesh_steps(trainer, state, cfg, ds, steps: int, table1: Path | None = None, lookup_ms: bool = True) -> tuple:
    """``steps`` device-sampled steps through ``train()``, timed one by one:
    the losses, step ms, ``a2a_overflow`` by step and the peak memory;
    given ``table1`` (the one-rank POI table after step 1, ``.npy``), this
    rank's rows against it after step 1; with ``lookup_ms``, the a2a
    lookup's time alone."""
    import numpy as np
    import torch

    from poi_tpu_torch.parallel.mesh import MODEL_AXIS
    from poi_tpu_torch.train.loop import train

    torch.cuda.reset_peak_memory_stats()
    res = {"losses": [], "step_ms": [], "overflow": []}
    for s in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, state, hist = train(cfg, ds, num_steps=1, trainer=trainer, state=state)
        torch.cuda.synchronize()
        res["step_ms"].append((time.perf_counter() - t0) * 1e3)
        res["losses"].append(hist[-1]["loss"])
        res["overflow"].append(hist[-1].get("a2a_overflow"))
        if s == 0 and table1 is not None and table1.exists():
            # This rank's rows of the one-rank table (its padded rows have none).
            ref = np.load(table1, mmap_mode="r")
            rows = trainer.model.embed["poi"].shape[0]
            lo = trainer.mesh.index[MODEL_AXIS] * rows
            mine = trainer.model.embed["poi"].detach()[:max(0, min(ref.shape[0] - lo, rows))]
            want = torch.from_numpy(np.ascontiguousarray(ref[lo:lo + mine.shape[0]])).to(mine.device)
            d = (mine - want).abs()
            res.update(table1_max_abs=float(d.max()), table1_off=int((d > 2e-6 + 2e-5 * want.abs()).sum()),
                       table1_n=int(d.numel()))
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    if trainer.a2a and lookup_ms:  # the a2a lookup of step 0's inputs alone, every rank in step
        batch = trainer.sampler.sample(0)
        table = trainer.model.embed["poi"].detach()

        def lookup():
            trainer.model.poi_lookup(table, batch.poi_in)
            torch.cuda.synchronize()

        with torch.no_grad():
            res["a2a_lookup_ms"] = host_ms(lookup, iters=10, warmup=2)
    return state, res


def mesh_child(job: str, out: str, config: str, sets: dict, steps: int, split: str, device: str,
               then: dict) -> None:
    """One rank of a mesh job (``spawn`` runs it ``MESH_WORLD`` times):
    the top-k of the split's first rows at the init; ``mesh_steps`` on the
    job's mesh; the launches; ``evaluate()``. Rank 0 also holds the B9,
    B10 and B11 calls it made (the first of each, at the path's shapes)
    against their plain versions. ``then``: the runs that follow from the
    init on the same corpus (``mesh_steps`` and their launches, under
    ``"then"``). The c5 job then serves (``serve_prepare``, ``mesh_serve``),
    the bench job checks config #4's tower (``tower_run``). Writes
    ``out/rank<r>.json`` (rank 0 also the top-k as ``topk.pt``). The job
    comes as arguments, ``device`` too (``cuda`` on the card)."""
    global DEV
    DEV = device
    os.environ.setdefault("POI_TPU_TORCH_DATA_CACHE", "off")
    import torch
    import torch.distributed as dist

    from poi_tpu_torch.data.dataset import load_dataset
    from poi_tpu_torch.eval import evaluate as evaluate_mod
    from poi_tpu_torch.ops import fused_gru, fused_sampled
    from poi_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, init_distributed
    from poi_tpu_torch.train.loop import make_trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed("gloo")
    rank = dist.get_rank()
    cfg = mesh_cfg(config, sets)
    ds = load_dataset(cfg.data)
    work = Path(out)
    # The first call of each kernel on this path, its arguments kept (rank
    # 0), under ``key(name, args)``. The wrapper stands in for the kernel's
    # wrapper under its module name, which the kernel's wrapper counts its
    # launches on.
    calls: dict = {}
    sites = {"sampled_lse": (fused_sampled, "sampled_lse"), "sampled_bwd": (fused_sampled, "sampled_bwd"),
             "topk": (evaluate_mod, "fused_topk"), "gru_fwd": (fused_gru, "fused_gru_scan"),
             "gru_bwd": (fused_gru, "fused_gru_bwd")}
    real = {name: getattr(*site) for name, site in sites.items()}

    def keep(*names, key=lambda name, args: name):
        for name in names:
            def wrapped(*args, name=name):
                k = key(name, args)
                if rank == 0 and k not in calls:
                    calls[k] = tuple(a.detach().clone() if torch.is_tensor(a) else a for a in args)
                return real[name](*args)
            wrapped.launches = wrapped.start = real[name].launches
            setattr(*sites[name], wrapped)

    def unkeep(*names):
        for name in names:
            wrapped = getattr(*sites[name])
            real[name].launches += wrapped.launches - wrapped.start
            setattr(*sites[name], real[name])

    trainer = make_trainer(cfg, ds, DEV)
    mesh = trainer.mesh
    state = trainer.init_state()
    reset_launches()
    vals, ids = split_topk(trainer.model, ds, cfg, split, mesh)
    topk_launches = read_launches()["topk"]
    reset_launches()
    keep("sampled_lse", "sampled_bwd")
    state, res = mesh_steps(trainer, state, cfg, ds, steps, work / f"{job}_table1.npy")
    unkeep("sampled_lse", "sampled_bwd")
    res.update(rank=rank, mesh=[mesh.shape[DATA_AXIS], mesh.shape[MODEL_AXIS]], launches=read_launches(),
               topk_launches=topk_launches)
    reset_launches()
    keep("topk")
    res["metrics"] = evaluate_mod.evaluate(trainer.model, ds, cfg, split, mesh=mesh)
    unkeep("topk")
    res["eval_launches"] = read_launches()
    if rank == 0:
        res["kernels"] = mesh_kernel_checks(calls)
        torch.save({"vals": vals, "ids": ids}, work / f"{job}_topk.pt")
    if job == "c5":
        res["serve_prep"] = serve_prepare(trainer, state, cfg, ds, work, rank)
    del trainer, state
    torch.cuda.empty_cache()
    res["then"] = {}
    for name, then_sets in then.items():
        c = mesh_cfg(config, then_sets)
        t = make_trainer(c, ds, DEV)
        reset_launches()
        res["then"][name] = mesh_steps(t, t.init_state(), c, ds, steps, lookup_ms=name == "preset")[1]
        res["then"][name]["launches"] = read_launches()
        del t
        torch.cuda.empty_cache()
    if job == "bench":  # config #4's tower with SP attention on this 2 x 2, against one rank
        inputs = tower_inputs()
        dtypes = ("float32", "bfloat16")
        refs = {d: tower_run(d, None, mesh, inputs) for d in dtypes} if rank == 0 else {}
        calls.clear()
        reset_launches()
        keep("gru_fwd", "gru_bwd")
        sp = {(d, impl): tower_run(d, impl, mesh, inputs) for d in dtypes for impl in MESH_SP_IMPLS}
        unkeep("gru_fwd", "gru_bwd")
        res["tower_launches"] = read_launches()
        if rank == 0:
            res["tower"] = tower_errors(sp, refs)
            res["tower_kernels"] = mesh_kernel_checks(calls)
    if job == "c5":  # last: the serve CLI ends the process group when it returns
        calls.clear()
        reset_launches()
        keep("topk", key=lambda name, args: f"{name}_b{args[0].shape[0]}")
        res["serve"] = mesh_serve(work, rank)
        unkeep("topk")
        res["serve"]["launches"] = read_launches()
        if rank == 0:
            res["serve_kernels"] = {f"b{b}": mesh_kernel_checks({"topk": calls[f"topk_b{b}"]})["topk"]
                                    for b in (1, SERVE_BATCH)}
    (work / f"rank{rank}.json").write_text(json.dumps(res))
    if dist.is_initialized():
        dist.barrier()  # every rank is done before any exits
        dist.destroy_process_group()


def tower_inputs() -> dict:
    """Config #4's tower inputs from the seed: x [B, T, E], a ragged
    validity-prefix mask, and a cotangent of the output."""
    import torch

    from poi_tpu_torch.configs.presets import get_config

    base = get_config(ATTN_CONFIG)
    B, T, E, H = base.train.batch_size, base.data.max_seq_len, base.model.embed_dim, base.model.hidden_dim
    gen = torch.Generator(device=DEV).manual_seed(SEED + 21)
    lengths = torch.randint(1, T + 1, (B,), generator=gen, device=DEV)
    return {"x": 0.5 * torch.randn(B, T, E, generator=gen, device=DEV),
            "mask": (torch.arange(T, device=DEV)[None, :] < lengths[:, None]).float(),
            "cot": torch.randn(B, T, H, generator=gen, device=DEV)}


def tower_run(dtype: str, impl: str | None, mesh, inputs: dict) -> tuple:
    """Config #4's tower (``AttentionTower`` from the seed, compute
    ``dtype``) forward and backward under the cotangent: with SP ``impl``
    on ``mesh``, each data rank its rows, the output gathered and the
    gradients summed over ``data`` (every rank calls); with None, blockwise
    on this rank over the whole batch. Returns (output, {name: gradient}) of
    the GRU's and the projections' parameters."""
    import types

    import torch

    from poi_tpu_torch.configs.presets import get_config
    from poi_tpu_torch.models.attention import AttentionTower
    from poi_tpu_torch.parallel import collectives as cc
    from poi_tpu_torch.parallel.mesh import DATA_AXIS
    from poi_tpu_torch.parallel.sp_attention import make_sp_attention

    model_cfg = get_config(ATTN_CONFIG).with_overrides({"model.compute_dtype": dtype}).model
    tower = AttentionTower(model_cfg, torch.Generator().manual_seed(SEED), DEV)
    r = slice(None)
    if impl is not None:
        r = mesh.rows(inputs["x"].shape[0], DATA_AXIS)
        tower.sp_mha = make_sp_attention(mesh, model_cfg.attn_heads, model_cfg.attn_window, impl,
                                         torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    o = tower(inputs["x"][r], types.SimpleNamespace(mask=inputs["mask"][r]))
    (o * inputs["cot"][r]).sum().backward()
    grads = {k: p.grad for k, p in tower.named_parameters() if k.startswith(("gru.", "mha."))}
    if impl is not None:
        o = cc.all_gather(o.detach(), mesh, DATA_AXIS)
        grads = {k: cc.all_reduce_(g.clone(), mesh, DATA_AXIS) for k, g in grads.items()}
    torch.cuda.synchronize()
    return o.detach(), grads


def tower_errors(sp: dict, refs: dict) -> dict:
    """Each SP run's output and gradients against the one-rank blockwise
    run: in fp32 the largest |diff| / (atol + rtol |ref|) (<= 1 within
    ``TOWER_FP32_TOL``), in bf16 ``rel_err`` (<= ``TOWER_BF16_TOL``)."""
    out = {}
    for (dtype, impl), (o, grads) in sp.items():
        ref_o, ref_g = refs[dtype]
        pairs = {"out": (o, ref_o), **{k: (g, ref_g[k]) for k, g in grads.items()}}
        if dtype == "float32":
            tol = {k: TOWER_FP32_TOL[0] if k == "out" else TOWER_FP32_TOL[1] for k in pairs}
            out[f"{impl}_{dtype}"] = {k: float(((a - w).abs() / (tol[k] + tol[k] * w.abs())).max())
                                      for k, (a, w) in pairs.items()}
        else:
            out[f"{impl}_{dtype}"] = {k: rel_err(a, w) for k, (a, w) in pairs.items()}
    return out


def serve_prepare(trainer, state, cfg, ds, work: Path, rank: int) -> dict:
    """Config #5's serving inputs from its exact run's state: the
    checkpoint (every rank calls ``save``; the tables gathered, rank 0
    writes one step file), and on rank 0 the serve session's stdin: the
    parent's histories (``serve_requests.json``), a malformed line and a k
    = 129 line among them, and a long row. The long row's model window is
    the parent's ``tail``; its earlier check-ins are that window's 128 best
    POIs (the mesh's Recommender on the trained params, every rank in
    step), so every candidate of the capped fetch is visited."""
    import torch

    from poi_tpu_torch.eval.serve import Checkin, Recommender
    from poi_tpu_torch.ops.topk import MAX_K
    from poi_tpu_torch.utils.checkpoint import CheckpointManager

    torch.cuda.synchronize()
    live = {**{f"params/{k}": v.detach().clone() for k, v in state.params.items()},
            **{f"opt/{k}": v.clone() for k, v in state.opt_state.items() if torch.is_tensor(v)}}
    mgr = CheckpointManager(str(work / "c5_ckpt"), async_save=True, mesh=trainer.mesh,
                            num_pois=trainer.dims.num_pois)
    t0 = time.perf_counter()
    mgr.save(state.step, state, config_json=cfg.to_json())
    returned_s = time.perf_counter() - t0
    mgr.wait()  # rank 0 joins its writer thread, then every rank passes the barrier
    save_s = time.perf_counter() - t0
    # Resume from the file the writer thread wrote: the state it restores
    # into the live tensors is the saved state, bit for bit.
    restored, _ = mgr.restore(state)
    mgr.close()
    got = {**{f"params/{k}": v for k, v in restored.params.items()},
           **{f"opt/{k}": v for k, v in restored.opt_state.items() if torch.is_tensor(v)}}
    same = restored.step == state.step and got.keys() == live.keys() and all(
        torch.equal(got[k], live[k]) for k in live)
    del live
    req = json.loads((work / "serve_requests.json").read_text())
    tail = [Checkin(**c) for c in req["tail"]]
    best = Recommender(trainer.model, cfg, ds, mesh=trainer.mesh).recommend([tail] if rank == 0 else None, k=MAX_K,
                                                                            exclude_visited=False)
    if rank == 0:
        long = [{"poi": int(p), "timestamp": 60.0 * i} for i, p in enumerate(best[0])] + req["tail"]
        singles = req["singles"]
        half = len(singles) // 2
        lines = ([json.dumps([h]) for h in singles[:half]]
                 + ["this is not json", json.dumps({"histories": singles[:1], "k": MAX_K + 1})]
                 + [json.dumps([h]) for h in singles[half:]] + [json.dumps(req["batch"])] * 2 + [json.dumps([long])])
        (work / "serve_stdin.txt").write_text("\n".join(lines) + "\n")
        (work / "serve_long.json").write_text(json.dumps(long))
    return {"ckpt_save_s": save_s, "ckpt_returned_s": returned_s, "resumed_same": same, "step": state.step}


def mesh_serve(work: Path, rank: int) -> dict:
    """``poi_tpu_torch.cli.main(["serve", ...])`` on this rank of the mesh,
    as a user runs it under a launcher (this rank's group is up, so the
    CLI's own NCCL call does nothing), from the c5 checkpoint at
    ``SERVE_SETS``; rank 0 reads ``serve_stdin.txt`` and writes its answers
    to ``serve_stdout.txt``. Every call of ``Recommender.recommend`` is
    counted, and timed on the host clock around a synchronised card: the
    rig's wall ms a request, with its rows."""
    import torch

    from poi_tpu_torch import cli
    from poi_tpu_torch.eval import serve as serve_mod

    real = serve_mod.Recommender.recommend
    times = []

    def timed(self, histories, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids = real(self, histories, *args, **kwargs)
        torch.cuda.synchronize()
        times.append([0 if histories is None else len(histories), (time.perf_counter() - t0) * 1e3])
        return ids

    argv = ["serve", "--config", C5_CONFIG, "--checkpoint-dir", str(work / "c5_ckpt"), "--device", DEV, "--set",
            *(f"{k}={v}" for k, v in SERVE_SETS.items())]
    serve_mod.Recommender.recommend = timed
    t0 = time.perf_counter()
    try:
        if rank == 0:
            with open(work / "serve_stdin.txt") as fin, open(work / "serve_stdout.txt", "w") as fout:
                stdio = sys.stdin, sys.stdout
                sys.stdin, sys.stdout = fin, fout
                try:
                    rc = cli.main(argv)
                finally:
                    sys.stdin, sys.stdout = stdio
        else:
            rc = cli.main(argv)
    finally:
        serve_mod.Recommender.recommend = real
    return {"rc": rc, "calls": len(times), "times": times if rank == 0 else [], "wall_s": time.perf_counter() - t0}


def mesh_kernel_checks(calls: dict) -> dict:
    """B1, B2, B9, B10 and B11 on the arguments the sharded path gave them
    (rank 0's first call of each) against their plain versions, at the
    earlier phases' tolerances; the shapes, the errors and the kernels'
    times."""
    import torch

    from poi_tpu_torch.ops.fused_gru import fused_gru_bwd, fused_gru_scan, gru_bwd_reference, gru_scan_reference
    from poi_tpu_torch.ops.fused_sampled import (sampled_bwd, sampled_bwd_reference, sampled_lse,
                                                 sampled_lse_reference)
    from poi_tpu_torch.ops.topk import fused_topk, topk_reference

    out = {}
    if "sampled_lse" in calls:
        args = calls["sampled_lse"]
        got, want = sampled_lse(*args), sampled_lse_reference(*args)
        err = float((got - want).abs().max())
        assert err < CE_LSE_TOL, f"mesh: sampled_lse on rank 0's rows: max |kernel - plain| {err}"
        (N, D), S = args[0].shape, args[1].shape[0]
        out["sampled_lse"] = {"shape": [list(a.shape) for a in args[:2]], "max_abs_err": err,
                              "ms": time_ms(lambda: sampled_lse(*args)),
                              "plain_ms": time_ms(lambda: sampled_lse_reference(*args)),
                              **bound(args, (got,), bf16_flop=2 * N * S * D)}
    if "sampled_bwd" in calls:
        args = calls["sampled_bwd"]
        got, want = sampled_bwd(*args), sampled_bwd_reference(*args)
        errs = [rel_err(a, w) for a, w in zip(got, want)]
        checked = b10_check(args, got, want, "mesh: sampled_bwd on rank 0's rows")
        (N, D), S = args[0].shape, args[1].shape[0]
        out["sampled_bwd"] = {"shape": [list(a.shape) for a in args[:2]], "rel_err": errs,
                              **({"bound_ratios": checked} if D in B10_BOUND_DIMS else {}),
                              "max_abs_err": max(float((a - w).abs().max()) for a, w in zip(got, want)),
                              "ms": time_ms(lambda: sampled_bwd(*args)),
                              "plain_ms": time_ms(lambda: sampled_bwd_reference(*args)),
                              **bound(args, got, bf16_flop=6 * N * S * D)}
    if "gru_fwd" in calls:
        xw, wh = calls["gru_fwd"]
        got, want = fused_gru_scan(xw, wh), gru_scan_reference(xw, wh)
        err = float((got - want).abs().max())
        assert err < GRU_TOL, f"mesh: gru_fwd on rank 0's rows: max |kernel - plain| {err}"
        B, T, H = got.shape
        out["gru_fwd"] = {"shape": [B, T, H], "max_abs_err": err, "ms": time_ms(lambda: fused_gru_scan(xw, wh)),
                          "plain_ms": time_ms(lambda: gru_scan_reference(xw, wh), 5),
                          "library_ms": cudnn_ms("gru", B, T, H, DEV),
                          **bound((xw, wh), (got,), bf16_flop=2 * B * T * H * 3 * H)}
    if "gru_bwd" in calls:
        args = calls["gru_bwd"]
        got, want = fused_gru_bwd(*args), gru_bwd_reference(*args)
        errs = [rel_err(a, w) for a, w in zip(got, want)]
        assert max(errs) < GRU_BWD_TOL, f"mesh: gru_bwd on rank 0's rows: rel err dxw/dwh {errs}"
        out["gru_bwd"] = {"shape": list(args[2].shape), "rel_err": errs,
                          "max_abs_err": max(float((a - w).abs().max()) for a, w in zip(got, want)),
                          "ms": time_ms(lambda: fused_gru_bwd(*args)),
                          "plain_ms": time_ms(lambda: gru_bwd_reference(*args), 5), "library_ms": None,
                          **gru_bwd_bound(*args, got)}
    if "topk" in calls:
        q, table, bias, k = calls["topk"]
        vals, ids = fused_topk(q, table, bias, k)
        want_v, want_i = topk_reference(q, table, bias, k)
        err = float((vals - want_v).abs().max())
        near = (vals - want_v).abs() < TOPK_TOL
        assert err < TOPK_TOL and bool(((ids == want_i) | near).all()), f"mesh: top-k on rank 0's shard: {err}"
        (B, D), V = q.shape, table.shape[0]
        logits = lambda: torch.nn.functional.linear(q.to(torch.bfloat16), table).float() + bias  # noqa: E731
        out["topk"] = {"shape": [list(q.shape), list(table.shape)], "k": k, "max_abs_err": err,
                       "ms": time_ms(lambda: fused_topk(q, table, bias, k)),
                       "plain_ms": time_ms(lambda: topk_reference(q, table, bias, k)),
                       "library_ms": time_ms(lambda: torch.topk(logits(), k)),
                       **bound((q, table, bias), (vals, ids), bf16_flop=2 * B * V * D)}
    return out


def mesh_nccl_child(out: str) -> None:
    """World size 1 over ``nccl`` on the card: each op of
    ``parallel/collectives.py`` once, forward and backward, on a one-rank
    mesh whose axis groups are the NCCL world and then a gloo group of the
    same rank; the two must agree."""
    import torch
    import torch.distributed as dist

    from poi_tpu_torch.parallel import collectives as cc
    from poi_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, init_distributed

    init_distributed("nccl")
    gloo = dist.new_group([0], backend="gloo")
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    x = torch.randn(4, 8, 16, generator=gen, device=DEV)
    g = torch.randn(4, 8, 16, generator=gen, device=DEV)
    ops = {"psum": lambda t, m: cc.psum(t, m, MODEL_AXIS), "grad_psum": lambda t, m: cc.grad_psum(t, m, MODEL_AXIS),
           "pmax": lambda t, m: cc.pmax(t, m, MODEL_AXIS) + t, "all_gather": lambda t, m: cc.all_gather(t, m, MODEL_AXIS, 1),
           "all_to_all": lambda t, m: cc.all_to_all(t, m, MODEL_AXIS),
           "split": lambda t, m: cc.split(t, m, MODEL_AXIS, 1),
           "ppermute_ring": lambda t, m: cc.ppermute_ring(t, m, MODEL_AXIS),
           "all_reduce_": lambda t, m: t * cc.all_reduce_(t.detach().sum().clone(), m, DATA_AXIS)}
    results = {}
    for backend, group in (("nccl", dist.group.WORLD), ("gloo", gloo)):
        mesh = Mesh(world_size=1)
        mesh.groups = {DATA_AXIS: group, MODEL_AXIS: group}
        for name, op in ops.items():
            t = x.clone().requires_grad_()
            y = op(t, mesh)
            y.backward(g)
            torch.cuda.synchronize()
            results[(backend, name)] = (y.detach(), t.grad)
    same = {name: all(torch.equal(a, b) for a, b in zip(results[("nccl", name)], results[("gloo", name)]))
            for name in ops}
    Path(out, "nccl.json").write_text(json.dumps({"same": same}))
    dist.destroy_process_group()


def mesh_run(job: str, work: Path) -> list[dict]:
    """Spawn the job's ranks and read their results."""
    from poi_tpu_torch.parallel.launch import spawn

    for f in work.glob("rank*.json"):
        f.unlink()
    name, sets, steps, split, then = MESH_JOBS[job]
    spawn(MESH_CHILD, MESH_WORLD, {"job": job, "out": str(work), "config": name, "sets": sets, "steps": steps,
                                   "split": split, "device": DEV, "then": then},
          timeout=MESH_TIMEOUT, cwd=str(REPO),
          env={"POI_TPU_TORCH_DATA_CACHE": str(work / "data") if job == "c5" else "off", "OMP_NUM_THREADS": "2"},
          log_dir=str(work))
    return [json.loads((work / f"rank{r}.json").read_text()) for r in range(MESH_WORLD)]


def mesh_line(job: str, ranks: list[dict], gpu: str, mesh: list) -> None:
    r0 = ranks[0]
    d, m = mesh
    a2a = ""
    if "a2a_lookup_ms" in r0:
        a2a = (f"; a2a lookup {statistics.median(r['a2a_lookup_ms'] for r in ranks):.3f} ms (median over ranks of "
               f"each one's median), a2a_overflow by step {r0['overflow']}")
    log(f"[mesh] {job}: mesh {d} x {m}, backend gloo, {MESH_WORLD} ranks share one card (cuda:0); step ms (median of "
        f"{len(r0['step_ms'])} steps) by rank "
        + ", ".join(f"{statistics.median(r['step_ms']):.1f}" for r in ranks)
        + "; peak GiB by rank " + ", ".join(f"{r['peak_gib']:.2f}" for r in ranks) + a2a
        + "; staged through the host by this code: none (gloo took every op on CUDA tensors); "
        + f"card: {gpu}. A rig of ranks sharing one card: no scaling figure")


def serve_inputs(ds, work: Path) -> None:
    """The c5 job's serving requests, test histories as JSON
    (``serve_requests.json``: ``SERVE_SINGLES`` singles, a batch of
    ``SERVE_BATCH``, and the longest one as the long row's ``tail``), and
    its corpus ``ds`` in a dataset cache under ``work`` (the ranks' env
    names it), so the ranks and their serve CLI load it instead of building
    it again."""
    import pickle

    from poi_tpu_torch.data import dataset as dataset_mod

    hist = histories_from_test(ds, SERVE_SINGLES + SERVE_BATCH + 1)
    tail = hist.pop(max(range(len(hist)), key=lambda i: len(hist[i])))
    as_json = lambda h: [{"poi": c.poi, "timestamp": c.timestamp} for c in h]  # noqa: E731
    (work / "serve_requests.json").write_text(json.dumps({
        "singles": [as_json(h) for h in hist[:SERVE_SINGLES]],
        "batch": [as_json(h) for h in hist[SERVE_SINGLES:SERVE_SINGLES + SERVE_BATCH]], "tail": as_json(tail)}))
    before = os.environ.get("POI_TPU_TORCH_DATA_CACHE")
    os.environ["POI_TPU_TORCH_DATA_CACHE"] = str(work / "data")
    try:
        path = dataset_mod._cache_path(mesh_cfg(*MESH_JOBS["c5"][:2]).data)
    finally:
        os.environ["POI_TPU_TORCH_DATA_CACHE"] = before if before is not None else "off"
    path.parent.mkdir(mode=0o700, parents=True, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(ds, f, protocol=pickle.HIGHEST_PROTOCOL)


def serve_check(work: Path, ranks: list[dict], ds, gpu: str) -> dict:
    """The c5 job's serve session against the one-process ``Recommender``
    on the checkpoint's params (each request as it was served, one call a
    request): the answers in order, the two bad lines answered by rank 0
    alone, every rank's CLI at exit code 0 after the same number of
    requests, the ids equal or differing only among equal scores, B1 and
    B11 launched on every rank; the rig's wall ms a request."""
    import numpy as np
    import torch

    from poi_tpu_torch.cli import model_with_params
    from poi_tpu_torch.eval.serve import Checkin, Recommender
    from poi_tpu_torch.models.base import batch_to, output_table
    from poi_tpu_torch.ops.topk import MAX_K
    from poi_tpu_torch.utils.checkpoint import CheckpointManager

    req = json.loads((work / "serve_requests.json").read_text())
    long = json.loads((work / "serve_long.json").read_text())
    answers = [json.loads(ln) for ln in (work / "serve_stdout.txt").read_text().splitlines() if ln.strip()]
    half = len(req["singles"]) // 2
    requests = [[h] for h in req["singles"]] + [req["batch"], req["batch"], [long]]
    assert len(answers) == len(requests) + 2, f"serve: {len(answers)} answers to {len(requests) + 2} lines"
    bad = answers[half:half + 2]
    assert "error" in bad[0] and bad[1] == {"error": f"ValueError: k={MAX_K + 1} > {MAX_K} not supported"}, bad
    served = answers[:half] + answers[half + 2:]
    for r in ranks:
        t = r["serve"]
        assert t["rc"] == 0 and t["calls"] == len(requests), f"serve rank {r['rank']}: {t['rc']}, {t['calls']} calls"
        assert t["launches"]["gru_fwd"] > 0 and t["launches"]["topk"] > 0, f"serve rank {r['rank']}: {t['launches']}"
    cfg = mesh_cfg(C5_CONFIG, SERVE_SETS, one_rank=True)
    saved = CheckpointManager(str(work / "c5_ckpt")).load()
    model = model_with_params(cfg, ds, saved["params"], torch.device(DEV))
    del saved
    rec = Recommender(model, cfg, ds)
    table, bias = output_table(model.embed, cfg.model)
    same = total = 0
    worst = 0.0
    with torch.inference_mode():
        for hist_json, ans in zip(requests, served):
            hs = [[Checkin(**c) for c in h] for h in hist_json]
            got, want = np.asarray(ans["ids"]), rec.recommend(hs, k=10)
            assert got.shape == want.shape and (got >= 0).all(), (got.shape, want.shape)
            for h, row in zip(hs, got):
                assert not set(row.tolist()) & {c.poi for c in h}, "a served id was visited"
            same += int((got == want).sum())
            total += got.size
            if not (got == want).all():  # differ only among equal scores
                q = model.queries_last(batch_to(rec.check(hs, 10), DEV)).to(torch.bfloat16).float()
                score = lambda ids: ((q[:, None, :] * table[torch.from_numpy(ids).to(DEV)].to(torch.bfloat16).float())  # noqa: E731
                                     .sum(-1) + bias[torch.from_numpy(ids).to(DEV)])
                d = (score(got) - score(want)).abs()[torch.from_numpy(got != want).to(DEV)]
                worst = max(worst, float(d.max()))
    assert worst < TOPK_TOL, f"serve: ids differ from the one-process ids at scores {worst} apart"
    prep = [r["serve_prep"] for r in ranks]
    log(f"[mesh] checkpoint: the c5 job's async_save on 1 x 4: save returned after {prep[0]['ckpt_returned_s']:.2f} s "
        f"(rank 0's host copy; the write on its writer thread), wait() after {prep[0]['ckpt_save_s']:.2f} s; restored "
        f"from that file, the same bits as the live state on ranks {[p['resumed_same'] for p in prep]}")
    assert all(p["resumed_same"] for p in prep), prep
    times = ranks[0]["serve"]["times"]
    b1 = [ms for rows, ms in times[:len(req["singles"])]]
    out = {"b1_ms": statistics.median(b1), "b256_first_ms": times[-3][1], "b256_ms": times[-2][1],
           "long_ms": times[-1][1],
           "ckpt_save_s": ranks[0]["serve_prep"]["ckpt_save_s"], "wall_s": ranks[0]["serve"]["wall_s"],
           "launches_by_rank": {k: [r["serve"]["launches"][k] for r in ranks] for k in ("gru_fwd", "topk")}}
    log(f"[mesh] serve: config #5 on 1 x 4 through `poi_tpu_torch serve` under the rig ({MESH_WORLD} gloo ranks, "
        f"one card), from the c5 job's checkpoint (step {ranks[0]['serve_prep']['step']}, saved in "
        f"{out['ckpt_save_s']:.1f} s): {len(requests)} requests answered ({len(req['singles'])} single histories, "
        f"one of {len(req['batch'])} twice, one whose {MAX_K} fetched candidates were all visited, scored again on every "
        f"rank), the malformed line and k = {MAX_K + 1} answered {{\"error\"}} by rank 0 alone, EOF: every rank's CLI "
        f"returned 0 after {len(requests)} requests; ids against the one-process Recommender: {same}/{total} equal, "
        f"the rest among equal scores (max |score diff| {worst:.2e}, tol {TOPK_TOL}); launches by rank B1 "
        f"{out['launches_by_rank']['gru_fwd']}, B11 {out['launches_by_rank']['topk']}")
    log(f"[mesh] serve: the rig's wall ms a request (host clock around a synchronised card, rank 0): batch 1 median "
        f"{out['b1_ms']:.2f} (min {min(b1):.2f}, max {max(b1):.2f}, {len(b1)} requests), batch {len(req['batch'])} "
        f"{out['b256_first_ms']:.2f} (its first call) and {out['b256_ms']:.2f} (the same request again), the "
        f"re-scored row {out['long_ms']:.2f}; the session {out['wall_s']:.1f} s with the "
        f"restore; card: {gpu}. Costs of {MESH_WORLD} ranks sharing one card over gloo: no scaling figure")
    return out


def mesh_phase(state, gpu: str) -> dict:
    """(a) config #5 on its preset's mesh (1 x 4, a2a) and (b) the bench
    workload on 2 x 2 (psum, sharded CE), each held to its one-rank run:
    losses at step 1 within ``LOSS_TOL_FIRST`` and after within
    ``LOSS_TOL_LAST``, config #5's table after step 1, the top-k scores
    equal and the ids equal but among equal scores; config #5 at the
    preset's own a2a capacity, its drops counted; (c) B1, B2, B9, B10 and
    B11 launched on every rank, and on rank 0 held against their plain
    versions; (d) NCCL at world size 1 against gloo; (e) config #5 with
    ring and Ulysses attention held to its blockwise run and to one rank,
    and config #4's tower with both on 2 x 2 against one rank; (f) config
    #5 served on its 1 x 4 from its mesh checkpoint (``serve_check``)."""
    import torch

    from poi_tpu_torch.configs.presets import get_config
    from poi_tpu_torch.data.dataset import load_dataset
    from poi_tpu_torch.parallel.launch import spawn

    out = {}
    with tempfile.TemporaryDirectory(prefix="mesh_") as tmp:
        work = Path(tmp)
        torch.cuda.empty_cache()
        refs = {}
        for job in ("c5", "bench"):
            ds = state["c5"]["ds"] if job == "c5" else load_dataset(mesh_cfg(*MESH_JOBS[job][:2]).data)
            if job == "c5":
                serve_inputs(ds, work)
            ref = refs[job] = mesh_reference(job, ds, work)
            t0 = time.perf_counter()
            ranks = mesh_run(job, work)
            wall = time.perf_counter() - t0
            r0 = ranks[0]
            assert all(r["losses"] == r0["losses"] for r in ranks), f"mesh {job}: ranks disagree on the loss"
            got, want = torch.tensor(r0["losses"], dtype=torch.float64), torch.tensor(ref["losses"], dtype=torch.float64)
            rel = (got - want).abs() / want.abs()
            log(f"[mesh] {job}: losses by step, mesh / one rank: "
                + ", ".join(f"{a:.6f}/{b:.6f}" for a, b in zip(got.tolist(), want.tolist()))
                + f"; rel diff {[f'{v:.1e}' for v in rel.tolist()]} (tol {LOSS_TOL_FIRST} at step 1, {LOSS_TOL_LAST} "
                f"after); {wall:.1f} s for the ranks' processes")
            assert float(rel[0]) < LOSS_TOL_FIRST and float(rel.max()) < LOSS_TOL_LAST, f"mesh {job}: {rel.tolist()}"
            if "table1_max_abs" in r0:
                off = sum(r["table1_off"] for r in ranks)
                n = sum(r["table1_n"] for r in ranks)
                worst = max(r["table1_max_abs"] for r in ranks)
                log(f"[mesh] {job}: POI table after step 1, each rank's rows against the one-rank table: max |diff| "
                    f"{worst:.3e}, {off} of {n} entries past 2e-6 + 2e-5 relative (the rows step's tolerance)")
                assert off == 0, f"mesh {job}: table after step 1, {off} entries off, max |diff| {worst}"
            topk = torch.load(work / f"{job}_topk.pt")
            eq_v = bool(torch.equal(topk["vals"], ref["vals"]))
            tied = ref["vals"][:, :, None] == ref["vals"][:, None, :]
            same_ids = (topk["ids"] == ref["ids"]) | (tied.sum(-1) > 1)
            log(f"[mesh] {job}: top-{topk['ids'].shape[1]} of {MESH_TOPK_ROWS} rows at the init, sharded B11 vs one-card B11: "
                f"scores equal {eq_v} (max |diff| {float((topk['vals'] - ref['vals']).abs().max()):.3e}), ids equal "
                f"{int((topk['ids'] == ref['ids']).sum())}/{topk['ids'].numel()}, the rest among equal scores "
                f"{bool(same_ids.all())}")
            assert eq_v and bool(same_ids.all()), f"mesh {job}: the sharded top-k differs from the one-card top-k"
            for r in ranks:
                for name in ("gru_fwd", "gru_bwd", *(("sampled_lse", "sampled_bwd") if job == "c5" else ())):
                    assert r["launches"][name] > 0, f"mesh {job} rank {r['rank']}: {name} not launched: {r['launches']}"
                assert r["eval_launches"]["topk"] > 0, f"mesh {job} rank {r['rank']}: no B11 launch in eval"
            km = {k: r0["metrics"][k] for k in ("recall@10", "ndcg@10")}
            log(f"[mesh] {job}: evaluate on {MESH_JOBS[job][3]} ({int(r0['metrics']['eval_examples'])} rows): mesh "
                f"recall@10 {km['recall@10']:.4f} ndcg@10 {km['ndcg@10']:.4f}; one rank recall@10 "
                f"{ref['metrics']['recall@10']:.4f} ndcg@10 {ref['metrics']['ndcg@10']:.4f}; launches by rank (train) "
                + "; ".join(str({k: v for k, v in r["launches"].items() if v}) for r in ranks)
                + "; B11 in eval by rank " + str([r["eval_launches"]["topk"] for r in ranks]))
            for name, t in r0.get("kernels", {}).items():
                log(f"[mesh] {job}: rank 0's {name} at {t['shape']}: max |kernel - plain| {t['max_abs_err']:.3e}, "
                    f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
                    f"({t['bound_pipe']})" + (f", torch.topk over the logits {t['library_ms']:.4f} ms"
                                              if "library_ms" in t else ""))
            mesh_line(job, ranks, gpu, r0["mesh"])
            out[job] = ranks
            (work / f"{job}_table1.npy").unlink(missing_ok=True)
            torch.cuda.empty_cache()

            if job == "c5":
                out["serve"] = serve_check(work, ranks, ds, gpu)
                shutil.rmtree(work / "c5_ckpt")

        # (e) Config #5 with SP attention, run next in the same ranks from the
        # init at capacity factor M: held to the blockwise run and to one rank.
        for impl in MESH_SP_IMPLS:
            runs = [r["then"][impl] for r in out["c5"]]
            assert all(x["losses"] == runs[0]["losses"] for x in runs), f"mesh c5 {impl}: ranks disagree on the loss"
            got = torch.tensor(runs[0]["losses"], dtype=torch.float64)
            for what, want in (("the blockwise run on the mesh", out["c5"][0]["losses"]),
                               ("the one-rank run", refs["c5"]["losses"])):
                want = torch.tensor(want, dtype=torch.float64)
                rel = (got - want).abs() / want.abs()
                log(f"[mesh] c5_{impl}: model.attn_impl={impl} on 1 x 4 (time split over model: {impl}), losses by "
                    f"step against {what}: " + ", ".join(f"{a:.6f}/{b:.6f}" for a, b in zip(got.tolist(), want.tolist()))
                    + f"; rel diff {[f'{v:.1e}' for v in rel.tolist()]} (tol {LOSS_TOL_FIRST} at step 1, "
                    f"{LOSS_TOL_LAST} after)")
                assert float(rel[0]) < LOSS_TOL_FIRST and float(rel.max()) < LOSS_TOL_LAST, \
                    f"mesh c5 {impl} against {what}: {rel.tolist()}"
            for r in out["c5"]:
                for name in ("gru_fwd", "gru_bwd", "sampled_lse", "sampled_bwd"):
                    assert r["then"][impl]["launches"][name] > 0, f"mesh c5 {impl} rank {r['rank']}: no {name} launch"
            log(f"[mesh] c5_{impl}: launches by rank " + "; ".join(
                str({k: v for k, v in r["then"][impl]["launches"].items() if v}) for r in out["c5"]))
            mesh_line(f"c5_{impl}", runs, gpu, out["c5"][0]["mesh"])
        # Config #4's tower with SP attention on the bench job's 2 x 2.
        tower = out["bench"][0]["tower"]
        for key, errs in tower.items():
            fp32 = key.endswith("float32")
            log(f"[mesh] c4_tower {key}: config #4's tower on 2 x 2 against blockwise on one rank, " + (
                "largest |diff| / (atol + rtol |ref|) (<= 1 within " + f"{TOWER_FP32_TOL[0]} forward, "
                f"{TOWER_FP32_TOL[1]} gradients): " if fp32 else f"rel err (tol {TOWER_BF16_TOL:.4g}): ")
                + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
            assert max(errs.values()) <= (1.0 if fp32 else TOWER_BF16_TOL), f"c4 tower {key}: {errs}"
        for r in out["bench"]:
            assert r["tower_launches"]["gru_fwd"] > 0 and r["tower_launches"]["gru_bwd"] > 0, \
                f"c4 tower rank {r['rank']}: {r['tower_launches']}"
        for name, t in out["bench"][0]["tower_kernels"].items():
            log(f"[mesh] c4_tower: rank 0's {name} at {t['shape']}: kernel {t['ms']:.4f} ms, plain "
                f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_pipe']})"
                + (f", cuDNN nn.GRU forward {t['library_ms']:.4f} ms" if t["library_ms"] is not None else "")
                + f"; launches by rank {[r['tower_launches'][name] for r in out['bench']]}  ({gpu})")
        for b, t in out["c5"][0]["serve_kernels"].items():
            log(f"[mesh] serve: rank 0's B11 at {b} {t['shape']} k={t['k']}: max |kernel - plain| "
                f"{t['max_abs_err']:.3e}, kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, torch.topk over the "
                f"logits {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_pipe']})  ({gpu})")

        # Config #5 at the preset's own a2a capacity, run next in the same
        # ranks: its drops, counted.
        then = [r["then"]["preset"] for r in out["c5"]]
        log(f"[mesh] c5_preset: mesh.a2a_capacity_factor={get_config(C5_CONFIG).mesh.a2a_capacity_factor} (the "
            f"preset's): a2a_overflow by step {then[0]['overflow']}, losses "
            f"{[round(v, 6) for v in then[0]['losses']]} (at capacity factor M, no drops: "
            f"{[round(v, 6) for v in out['c5'][0]['losses']]})")
        assert all(math.isfinite(v) for v in then[0]["losses"]), then[0]["losses"]
        mesh_line("c5_preset", then, gpu, out["c5"][0]["mesh"])

        # (d) NCCL at world size 1.
        spawn("chip_smoke:mesh_nccl_child", 1, {"out": tmp}, timeout=300, cwd=str(REPO), log_dir=tmp)
        nccl = json.loads((work / "nccl.json").read_text())
        log(f"[mesh] nccl: world size 1 on the card, each op of parallel/collectives.py forward and backward, NCCL "
            f"against gloo: {nccl['same']}; card: {gpu}")
        assert all(nccl["same"].values()), nccl
    return out


# The kernels line's keys of B7/B8 at D = 256, 512, 1024 and 768 and their
# timing keys.
D256_KEYS = {"config3_d256": "_c3_d256", "bench_d256": "_d256"}
D512_KEYS = {"config3_d512": "_c3_d512", "bench_d512": "_d512"}
D1024_KEYS = {"bench_d1024": "_d1024", "config3_d768": "_c3_d768"}
CE_KEYS = {**D256_KEYS, **D512_KEYS, **D1024_KEYS}


def record(name: str, source: str, replaces: str, launches: int, max_abs_err: float, t: dict, **extra) -> dict:
    """One kernel's entry in the JSON line: its launches on the main path,
    its parity and its times at the main path's shape, with the bound."""
    return {"name": name, "route": "cuda", "source": f"poi_tpu_torch/csrc/{source}", "replaces": replaces,
            "launches": launches, "max_abs_err": max_abs_err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "bound_pipe": t["bound_pipe"],
            "library_ms": t["library_ms"], **extra}


def main() -> int:
    # The dataset cache would live outside the checkout; each config builds in about two seconds.
    os.environ.setdefault("POI_TPU_TORCH_DATA_CACHE", "off")
    import torch

    if not torch.cuda.is_available():
        print("error: torch.cuda.is_available() is false: this smoke run needs a CUDA card", file=sys.stderr)
        return 2
    gpu = gpu_line()
    log(f"[setup] torch {torch.__version__} CUDA {torch.version.cuda}, card: {gpu}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    state: dict = {}
    t_run = time.perf_counter()

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        result = fn(*args)
        log(f"[phase] {name}: {time.perf_counter() - t0:.1f} s")
        return result

    phase("build", build_phase)
    gru_err = phase("gru", gru_phase)
    topk_err = phase("topk", topk_phase)
    gru_bwd_err = phase("gru_bwd", gru_bwd_phase)
    lse_err, ce_grad_err = phase("ce", ce_phase)
    variants = phase("ce_variants", ce_variants_phase)
    big = phase("gru_big", gru_big_phase)
    wide = phase("gru_wide", gru_wide_phase)
    ce_wide = phase("ce_wide", ce_wide_phase)
    ce_wider = phase("ce_wider", ce_wider_phase)
    sampled = phase("sampled", sampled_phase)
    lstm = phase("lstm", lstm_phase)
    rnn = phase("rnn", rnn_phase)
    lstm_wide = phase("lstm_wide", lstm_wide_phase)
    rnn_wide = phase("rnn_wide", rnn_wide_phase)
    phase("slice", slice_phase, state)
    phase("cli", cli_phase, state)
    phase("train", train_phase, state)
    phase("attn_train", attention_train_phase, state)
    phase("attn_serve", serve_both_paths, "attn serve", state["attn_cfg"], state["attn_ds"], state["attn_trained"])
    phase("lstm_config", recurrent_config_phase, state, "lstm")
    phase("strnn_config", recurrent_config_phase, state, "strnn")
    phase("config5", config5_phase, state, gpu)
    phase("strnn_d256", strnn_d256_phase, state)
    phase("gru_wide_path", gru_wide_path_phase, state)
    phase("lstm_wide_path", rec_wide_path_phase, state, "lstm")
    phase("strnn_wide_path", rec_wide_path_phase, state, "strnn")
    phase("wider_bench_path", wider_path_phase, state, "bench")
    phase("wider_c4_path", wider_path_phase, state, "c4")
    phase("host_loader", host_loader_phase, state)
    mesh = phase("mesh", mesh_phase, state, gpu)
    phase("cli_train", cli_train_phase, state)
    phase("checkpoint", checkpoint_phase, gpu)
    times = phase("timing", timing_phase, state, gpu)
    times.update(phase("train_timing", train_timing_phase, state, gpu))
    times.update(phase("config_timing", config_timing_phase, state, gpu))
    phase("recurrence_device", recurrence_device_phase, times, big, lstm, gpu, wide)
    phase("pool_recurrence_device", pool_recurrence_device_phase, sampled, lstm, rnn, gpu, lstm_wide, rnn_wide)
    phase("ce_variants_device", ce_variants_device_phase, variants, gpu)
    phase("host_loader_device", host_loader_device_phase, state, gpu)
    phase("config5_timing", config5_timing_phase, state, gpu)
    phase("scripts", scripts_phase, state)
    kept = dict(sorted(_timing.SPINS_SEEN.items()))
    log(f"[profiler] records by the spins each kept (of {_timing.HEAD_SPINS} at the head and {_timing.TAIL_SPINS} "
        f"at the tail): {kept}")
    assert any(kept.keys() - {0}), f"no profiler record kept a kernel named like {_timing.SPIN_KERNEL!r}: {kept}"
    loaded = sorted(m for m in sys.modules if m in ("jax", "poi_tpu") or m.startswith(("jax.", "poi_tpu.")))
    assert not loaded, f"JAX or the JAX package was imported: {loaded}"

    # Launches: gru_fwd and topk from the serving path's run (slice phase),
    # gru_bwd, ce_lse and ce_bwd from the bench workload's training run
    # (train phase), sampled_lse and sampled_bwd from config #4's (attn_train
    # phase), lstm_* from config #2's and rnn_* from config #3's (lstm_config,
    # strnn_config). The GRU rows also carry config #4's shape (B, T, H) =
    # (64, 128, 256), and gru_fwd the bench shape (with the bench workload's
    # launches) and request batch 1; ce_bwd also carries config #3's
    # shape and launches (strnn_config); topk its other serve and eval
    # shapes. ce_lse_variants: each
    # instantiation's launches and time in the sweep's timed runs
    # (ce_variants phase) and its device time by kernel (ce_variants_device),
    # the fastest one's at the top level.
    # Config #5's rows (config5: B1, B2 at B=512, T=64, H=512; B11 at
    # V=903,889, B=512, k=10; d512: B9 and B10 at D=512) carry the launches of
    # config #5's train() run (and of its evaluate on val, for top-k).
    from poi_tpu_torch.ops.fused_gru import MAX_HIDDEN as max_hidden
    from poi_tpu_torch.ops.fused_lstm import MAX_HIDDEN as lstm_max
    from poi_tpu_torch.ops.fused_rnn import MAX_HIDDEN as rnn_max

    served, trained, attn = state["launches"], state["train_launches"], state["attn_launches"]
    c5, c5_eval = state["c5"]["launches"], state["c5"]["eval_launches"]
    at5 = lambda t, n: {**{f: t[f] for f in ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms")},  # noqa: E731
                        "launches": n}
    swept = {k: t["launches"] for k, t in variants.items()}
    assert len(swept) == 6 and all(swept.values()), f"the sweep skipped an instantiation: {swept}"
    best = min(variants, key=lambda k: variants[k]["ms"])
    c2, c3 = state["lstm"]["launches"], state["strnn"]["launches"]
    # B7/B8 at D = 256: config #3's 256-d shape with path 1's launches (the
    # train CLI at 20 steps); the bench shape at D = 256 has no main path.
    d256 = {"config3_d256": state["c3_d256_launches"], "bench_d256": {"ce_lse": 0, "ce_bwd": 0}}
    # B7/B8 at D = 512: the bench shape with the wide path's launches (the
    # train CLI at 20 steps, GRU H = 1024); config #3's shape has no main
    # path there. B1/B2 on the grid (gru_fwd_grid, gru_bwd_grid): the wide
    # path's shape and launches.
    wl = state["wide"]["launches"]
    # B3/B4 and B5/B6 on the grid: the wide LSTM and ST-RNN paths' shapes
    # and launches (their train CLI at 20 steps); the ST-RNN path also gives
    # B7/B8 at config #3's shape at D = 512 its launches.
    c2w, c3w = state["lstm_wide"]["launches"], state["strnn_wide"]["launches"]
    d256.update({"config3_d512": c3w, "bench_d512": wl})
    # B7/B8 at D = 1024: the bench shape with the wider bench path's launches
    # (its train CLI at 10 steps, GRU H = 1024); config #3's shape at 768 has
    # no main path. B9/B10 at D = 1024: config #4's shape with the wider
    # config #4 path's launches; config #5's rows at 768 have no main path.
    wb, wc4 = state["wider_bench"]["launches"], state["wider_c4"]["launches"]
    d256.update({"bench_d1024": wb, "config3_d768": {"ce_lse": 0, "ce_bwd": 0}})
    h256 = lambda d: {f"{k}_h256": big[d][k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")}  # noqa: E731
    fwd_at = lambda t: {f: t[f] for f in ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms")}  # noqa: E731
    kernels = [
        record("gru_fwd", "gru_fwd.cu", "poi_tpu/ops/fused_gru.py:71", served["gru_fwd"], gru_err, times["gru_fwd"],
               device_ms=times["gru_fwd"]["device_ms"], max_abs_err_h256=big["fwd_err"], **h256("fwd"),
               device_ms_h256=big["fwd"]["device_ms"], b1=fwd_at(times["gru_fwd_b1"]),
               config5=at5(big["fwd_h512"], c5["gru_fwd"]),
               bench=fwd_at(times["gru_fwd_train"]), bench_launches=trained["gru_fwd"]),
        record("gru_bwd", "gru_bwd.cu", "poi_tpu/ops/fused_gru.py:86", trained["gru_bwd"], gru_bwd_err,
               times["gru_bwd"], max_abs_err_h256=big["bwd_err"], **h256("bwd"),
               **{f"{k}{h}": t[k] for h, t in (("", times["gru_bwd"]), ("_h256", big["bwd"]))
                  for k in ("device_ms", *(f"{n}_ms" for n in GRU_BWD_KERNELS))},
               config5={**at5(big["bwd_h512"], c5["gru_bwd"]),
                        **{f"{n}_ms": big["bwd_h512"][f"{n}_ms"] for n in GRU_BWD_KERNELS}}),
        record("gru_fwd_grid", "gru_fwd.cu", "poi_tpu/ops/fused_gru.py:71", wl["gru_fwd"], wide["fwd_err"], wide["fwd"],
               device_ms=wide["fwd"]["device_ms"], shape=list(GRU_WIDE_H1024), max_hidden=max_hidden),
        record("gru_bwd_grid", "gru_bwd.cu", "poi_tpu/ops/fused_gru.py:86", wl["gru_bwd"], wide["bwd_err"], wide["bwd"],
               **{k: wide["bwd"][k] for k in ("device_ms", *(f"{n}_ms" for n in GRU_BWD_GRID_KERNELS))},
               shape=list(GRU_WIDE_H1024)),
        record("lstm_fwd", "lstm.cu", "poi_tpu/ops/fused_lstm.py:59", c2["lstm_fwd"], lstm["fwd_err"], lstm["fwd"],
               device_ms=lstm["fwd"]["device_ms"], **{k: fwd_at(lstm[f"fwd_{k}"]) for k in LSTM_TIMED}),
        record("lstm_bwd", "lstm.cu", "poi_tpu/ops/fused_lstm.py:81", c2["lstm_bwd"], lstm["bwd_err"], lstm["bwd"],
               **{k: lstm["bwd"][k] for k in ("device_ms", *(f"{n}_ms" for n in LSTM_BWD_KERNELS))}),
        record("rnn_fwd", "rnn.cu", "poi_tpu/ops/fused_rnn.py:48", c3["rnn_fwd"], rnn["fwd_err"], rnn["fwd"],
               device_ms=rnn["fwd"]["device_ms"], **{k: fwd_at(rnn[f"fwd_{k}"]) for k in RNN_TIMED}),
        record("rnn_bwd", "rnn.cu", "poi_tpu/ops/fused_rnn.py:65", c3["rnn_bwd"], rnn["bwd_err"], rnn["bwd"],
               **{k: rnn["bwd"][k] for k in ("device_ms", *(f"{n}_ms" for n in RNN_BWD_KERNELS))},
               h512={k: rnn["bwd_h512"][k] for k in ("ms", "plain_ms", "bound_ms", "device_ms",
                                                    *(f"{n}_ms" for n in RNN_BWD_KERNELS))}),
        record("lstm_fwd_grid", "lstm.cu", "poi_tpu/ops/fused_lstm.py:59", c2w["lstm_fwd"], lstm_wide["fwd_err"],
               lstm_wide["fwd"], device_ms=lstm_wide["fwd"]["device_ms"], shape=list(LSTM_WIDE_H1024),
               max_hidden=lstm_max),
        record("lstm_bwd_grid", "lstm.cu", "poi_tpu/ops/fused_lstm.py:81", c2w["lstm_bwd"], lstm_wide["bwd_err"],
               lstm_wide["bwd"],
               **{k: lstm_wide["bwd"][k] for k in ("device_ms", *(f"{n}_ms" for n in LSTM_BWD_GRID_KERNELS))},
               shape=list(LSTM_WIDE_H1024)),
        record("rnn_fwd_grid", "rnn.cu", "poi_tpu/ops/fused_rnn.py:48", c3w["rnn_fwd"], rnn_wide["fwd_err"],
               rnn_wide["fwd"], device_ms=rnn_wide["fwd"]["device_ms"], shape=list(RNN_WIDE_H1024),
               max_hidden=rnn_max),
        record("rnn_bwd_grid", "rnn.cu", "poi_tpu/ops/fused_rnn.py:65", c3w["rnn_bwd"], rnn_wide["bwd_err"],
               rnn_wide["bwd"],
               **{k: rnn_wide["bwd"][k] for k in ("device_ms", *(f"{n}_ms" for n in RNN_BWD_GRID_KERNELS))},
               shape=list(RNN_WIDE_H1024)),
        record("ce_lse", "ce.cu", "poi_tpu/ops/fused_ce.py:181", trained["ce_lse"], lse_err, times["ce_lse"],
               device_ms=times["ce_lse"]["device_ms"],
               config3={f: times["ce_lse_c3"][f] for f in ("ms", "plain_ms", "bound_ms", "device_ms",
                                                           *(f"{n}_ms" for n in CE_LSE_KERNELS))},
               config3_launches=c3["ce_lse"],
               **{k: {**{f: times[f"ce_lse{key}"][f] for f in ("ms", "plain_ms", "bound_ms", "bound_kernel_ms",
                                                                "library_ms", "device_ms",
                                                                *(f"{n}_ms" for n in CE_LSE_KERNELS))},
                      "launches": d256[k]["ce_lse"]} for k, key in CE_KEYS.items()},
               max_abs_err_d512=ce_wide["lse_err"], max_abs_err_d1024=ce_wider["lse_err"]),
        record("ce_bwd", "ce_bwd.cu", "poi_tpu/ops/fused_ce.py:210", trained["ce_bwd"], ce_grad_err, times["ce_bwd"],
               dq_ms=times["ce_bwd"]["dq_ms"], dtable_ms=times["ce_bwd"]["dtable_ms"],
               config3={f: times["ce_bwd_c3"][f] for f in ("ms", "plain_ms", "bound_ms", "dq_ms", "dtable_ms",
                                                           "sum_splits_ms")},
               config3_launches=c3["ce_bwd"],
               **{k: {**{f: times[f"ce_bwd{key}"][f] for f in ("ms", "plain_ms", "bound_ms", "bound_kernel_ms",
                                                                "library_ms", "dq_ms", "dtable_ms", "sum_splits_ms")},
                      "launches": d256[k]["ce_bwd"]} for k, key in CE_KEYS.items()},
               max_abs_err_d512=ce_wide["grad_err"], rel_err_d512=list(ce_wide["rel"]),
               bound_ratios_d512=list(ce_wide["ratios"]), max_abs_err_d1024=ce_wider["grad_err"],
               rel_err_d1024=list(ce_wider["rel"]), bound_ratios_d1024=list(ce_wider["ratios"])),
        record("sampled_lse", "sampled.cu", "poi_tpu/ops/fused_sampled.py:76", attn["sampled_lse"],
               sampled["lse_err"], sampled["lse"],
               **{k: sampled["lse"][k] for k in ("device_ms", *(f"{n}_ms" for n in SAMPLED_LSE_KERNELS))},
               d512={**at5(sampled["lse_d512"], c5["sampled_lse"]), "max_abs_err": sampled["lse_err_d512"]},
               **{f"d{w}": {**at5(sampled[f"lse_d{w}"], n), "bound_kernel_ms": sampled[f"lse_d{w}"]["bound_kernel_ms"],
                            "max_abs_err": sampled[f"lse_err_d{w}"],
                            **{f"{k}_ms": sampled[f"lse_d{w}"][f"{k}_ms"] for k in SAMPLED_LSE_KC_KERNELS}}
                  for w, n in ((1024, wc4["sampled_lse"]), (768, 0))}),
        record("sampled_bwd", "sampled.cu", "poi_tpu/ops/fused_sampled.py:103", attn["sampled_bwd"],
               sampled["grad_err"], sampled["bwd"],
               **{k: sampled["bwd"][k] for k in ("device_ms", *(f"{n}_ms" for n in SAMPLED_BWD_KERNELS))},
               d512={**at5(sampled["bwd_d512"], c5["sampled_bwd"]), "max_abs_err": sampled["grad_err_d512"],
                     **{f"{n}_ms": sampled["bwd_d512"][f"{n}_ms"] for n in SAMPLED_BWD_KERNELS}},
               **{f"d{w}": {**at5(sampled[f"bwd_d{w}"], n), "bound_kernel_ms": sampled[f"bwd_d{w}"]["bound_kernel_ms"],
                            "max_abs_err": sampled[f"grad_err_d{w}"], "bound_ratios": sampled["b10_ratios_max"][w],
                            **{f"{k}_ms": sampled[f"bwd_d{w}"][f"{k}_ms"] for k in SAMPLED_BWD_KERNELS}}
                  for w, n in ((1024, wc4["sampled_bwd"]), (768, 0))}),
        record("topk", "topk.cu", "poi_tpu/ops/topk.py:58", served["topk"], topk_err, times["topk"],
               device_ms=times["topk"]["device_ms"], library_device_ms=times["topk"]["library_device_ms"],
               **{case: {f: times[case][f] for f in ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms",
                                                    "bound_ms")}
                  for case in ("topk_k10", "topk_b1", "topk_b1_k10", "topk_eval", "topk_eval256", "topk_c4",
                               "topk_serve70k", "topk_serve70k_b1", "topk_eval_d1024")},
               wider_launches={"bench": wb["topk"], "c4": wc4["topk"]},
               config5={**at5(times["topk_c5"], c5_eval["topk"]),
                        "library_device_ms": times["topk_c5"]["library_device_ms"]}),
        record("ce_lse_variants", "ce.cu", "scripts/sweep_ce_fwd.py:30,58", sum(swept.values()),
               max(t["max_abs_err"] for t in variants.values()), variants[best], best=best,
               variants={k: {**{f: t[f] for f in ("ms", "device_ms", *(f"{n}_ms" for n in CE_LSE_KERNELS),
                                                  "plain_ms", "max_abs_err", "bound_ms", "bound_pipe")},
                             "launches": swept[k]} for k, t in variants.items()}),
    ]
    # The mesh phase (ranks sharing this card): launches by rank on config
    # #5's 1 x 4 run and the bench workload's 2 x 2 run, and rank 0's parity
    # and times of B9, B10 (its data rows) and B11 (its shard) at the
    # shapes the sharded path gave them.
    def by_rank(job, name, key="launches"):
        return [r[key][name] for r in mesh[job]]

    # Also the launches by rank of config #5's ring and Ulysses
    # runs (sp_ring, sp_ulysses), of config #4's tower on 2 x 2 with rank
    # 0's B1 and B2 there (c4_tower), and of the serve session with rank 0's
    # B11 on its 1 x 4 shard at batch 1 and 256 (serve).
    def sp(name):
        return {f"sp_{impl}_launches_by_rank": [r["then"][impl]["launches"][name] for r in mesh["c5"]]
                for impl in MESH_SP_IMPLS}

    checked = mesh["c5"][0].get("kernels", {})
    tower = mesh["bench"][0]["tower_kernels"]
    for rec in kernels:
        name = rec["name"]
        if name in ("gru_fwd", "gru_bwd"):
            rec["mesh"] = {"c5_launches_by_rank": by_rank("c5", name), "bench_launches_by_rank": by_rank("bench", name),
                           **sp(name),
                           "c4_tower": {**tower[name], "launches_by_rank": by_rank("bench", name, "tower_launches")}}
        elif name in ("sampled_lse", "sampled_bwd", "topk"):
            rec["mesh"] = {"c5_launches_by_rank": by_rank("c5", name, "eval_launches" if name == "topk" else
                                                          "launches"), **checked.get(name, {})}
            if name == "topk":
                rec["mesh"]["serve"] = {**mesh["c5"][0]["serve_kernels"],
                                        "launches_by_rank": mesh["serve"]["launches_by_rank"]["topk"]}
            else:
                rec["mesh"].update(sp(name))
        if name == "gru_fwd":
            rec["mesh"]["serve_launches_by_rank"] = mesh["serve"]["launches_by_rank"]["gru_fwd"]
    log(f"[run] chip_smoke.py passed every phase in {time.perf_counter() - t_run:.1f} s  ({gpu})")
    print(gpu, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(ab_main(sys.argv[2]) if sys.argv[1:2] == ["--ab"] and len(sys.argv) == 3 else main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)
