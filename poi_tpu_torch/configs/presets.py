"""The five named benchmark configs (BASELINE.json:7-11).

1. gru_foursquare_nyc  — plain GRU next-POI, Foursquare-NYC subset
                         (~10k POIs, 64-d embeddings, batch 32, CPU-runnable)
2. lstm_bpr_foursquare — LSTM with user embedding + BPR loss, full Foursquare
                         (~50k POIs, 128-d)
3. strnn_gowalla       — ST-RNN-style time/distance transition interpolation,
                         Gowalla (~100k POIs)
4. attention_gowalla   — attention-augmented sequence model (last-k check-ins)
                         with sampled softmax, Gowalla, 256-d
5. multihost_1m        — multi-host scale-out: 1M-POI synthetic catalog,
                         sharded 512-d tables, all-to-all lookup + fused
                         top-k eval on N>=2 hosts
"""

from __future__ import annotations

from poi_tpu_torch.utils.config import (
    CheckpointConfig,
    Config,
    DataConfig,
    EvalConfig,
    LossConfig,
    MeshConfig,
    ModelConfig,
    TrainConfig,
)

_REGISTRY: dict[str, Config] = {}


def register(cfg: Config) -> Config:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> Config:
    if name not in _REGISTRY:
        raise KeyError(f"Unknown config {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list[str]:
    return sorted(_REGISTRY)


# All single-chip benchmark presets hold out a validation split
# (data.val_fraction=0.1, temporally preceding the test split) and the train
# CLI / scripts/quality_runs.py select best-on-val params for the final test
# eval (train/selection.py). This is the measured protocol behind every
# BASELINE.md quality row from 2026-08-21 on: the check-in corpora are small
# enough that every model passes its generalization peak mid-run (e.g.
# config #4 peaks at step ~1000-2000 of 5000).

# --- config #1: plain GRU, Foursquare-NYC subset (BASELINE.json:7) -----------
register(
    Config(
        name="gru_foursquare_nyc",
        data=DataConfig(
            dataset="foursquare",
            num_users=2_000,
            num_pois=10_000,
            mean_checkins_per_user=60,
            max_seq_len=64,
            val_fraction=0.1,
        ),
        model=ModelConfig(kind="gru", embed_dim=64, hidden_dim=64),
        loss=LossConfig(kind="ce"),
        train=TrainConfig(batch_size=32, num_steps=3_000),
        mesh=MeshConfig(data=-1, model=1),
    )
)

# --- config #2: LSTM + user embedding + BPR, full Foursquare (BASELINE.json:8)
# num_steps=10k (was 5k): the BPR objective is still improving at 5k — the
# post-fix full-budget runs (2026-08-21) measure test r@10 0.3440/ndcg 0.2283
# at 5k (best-on-val selected the FINAL step) vs 0.3541/0.2494 at 10k
# (selected step 8250, past the peak this time — budget now brackets it).
# num_negatives=32 promoted from the val-split sweep (4/8/16/32/64 → val
# r@10 0.3658/0.3740/0.3755/0.3837/0.3824 — peak at 32): BPR's gradient
# quality scales with negatives and the pairwise logits are so cheap that
# throughput barely moves. Other knobs held: cosine LR ties (val 0.3665),
# lr 2e-3 hurts (0.3581). r5 ceiling probe (full budget, val split): 256-d
# loses (val 0.3800), max_seq_len=128 loses (0.3816), and dropping time/geo
# features loses (0.3777) vs the preset's 0.3837 — the remaining gap to the
# other presets' floor multipliers is the BPR objective itself (pairwise
# ranking optimizes recall@k less directly than the softmax family), not an
# untuned knob; documented as the ceiling.
register(
    Config(
        name="lstm_bpr_foursquare",
        data=DataConfig(
            dataset="foursquare",
            num_users=8_000,
            num_pois=50_000,
            mean_checkins_per_user=80,
            max_seq_len=64,
            val_fraction=0.1,
        ),
        model=ModelConfig(
            kind="lstm", embed_dim=128, hidden_dim=128, use_user_embedding=True
        ),
        loss=LossConfig(kind="bpr", num_negatives=32),
        train=TrainConfig(batch_size=64, num_steps=10_000),
        mesh=MeshConfig(data=-1, model=1),
    )
)

# --- config #3: ST-RNN with time/distance interpolation, Gowalla (B:9) -------
# use_user_embedding=True is paper-faithful (the ST-RNN lineage scores with a
# permanent per-user vector alongside the recurrent state) and re-confirmed
# decisive under the FIXED eval (post-267dcee sweep 2026-08-21, val split:
# r@10 0.3858 with it vs 0.3637 without at 1500 steps). dropout=0.5 kept:
# at full 5k-step budget with best-on-val selection it still edges no-dropout
# on test (r@10 0.4164 vs 0.4125). Every pre-fix number this preset once
# cited was re-measured 2026-08-21.
register(
    Config(
        name="strnn_gowalla",
        data=DataConfig(
            dataset="gowalla",
            num_users=10_000,
            num_pois=100_000,
            mean_checkins_per_user=70,
            max_seq_len=32,  # ST-RNN windows recent check-ins
            time_gap_buckets=8,
            dist_buckets=8,
            val_fraction=0.1,
        ),
        model=ModelConfig(
            kind="strnn", embed_dim=128, hidden_dim=128,
            use_user_embedding=True, dropout=0.5,
        ),
        loss=LossConfig(kind="ce"),
        train=TrainConfig(batch_size=64, num_steps=5_000),
        mesh=MeshConfig(data=-1, model=1),
    )
)

# --- config #4: attention + sampled softmax, Gowalla 256-d (B:10) ------------
# dropout=0.3 promoted from the post-eval-fix sweep (2026-08-21, val split):
# at full 5k steps with best-on-val it wins r@10 0.4007 vs 0.3806 undropped
# (test; floor 0.1654) with ndcg a tie (0.2335 vs 0.2329). The user embedding
# adds nothing here (val r@10 0.3791 vs 0.3783 at 2k steps) — unlike ST-RNN,
# the windowed-attention tower already carries the personalization signal.
# lr_schedule=cosine promoted by val (0.4025 vs 0.3996 constant): the decay
# phase sharpens ranking dramatically — test ndcg 0.2743 vs 0.2335, r@1
# 0.1625 vs 0.0827 at the same r@10 — where on the other presets cosine ties
# (#2, #3) or hurts (#1: val 0.3747 vs 0.4145, the 3k budget is too short to
# pay for decay), so it stays per-config, not global. num_sampled held at
# 1024: val 0.4025 vs 0.3992 (S=2048) vs 0.3952 (S=4096) — unlike BPR's
# negatives, the logQ-corrected sampled-softmax estimator saturates.
register(
    Config(
        name="attention_gowalla",
        data=DataConfig(
            dataset="gowalla",
            num_users=10_000,
            num_pois=100_000,
            mean_checkins_per_user=70,
            max_seq_len=128,
            val_fraction=0.1,
        ),
        model=ModelConfig(
            kind="attention",
            embed_dim=256,
            hidden_dim=256,
            attn_window=16,
            attn_heads=4,
            attn_impl="blockwise",
            dropout=0.3,
        ),
        loss=LossConfig(kind="sampled_softmax", num_sampled=1024),
        # table_update="sparse" promoted by the r5 val probe: lazy Adam on
        # the POI table wins val r@10 0.4053 vs 0.4025 dense and test
        # 0.4075/0.2774 vs 0.4037/0.2743 (same protocol), consistent with
        # the config-#5 result — untouched-row moment decay hurts rare-POI
        # embeddings. (Config #2's BPR probe did NOT win — val 0.3809 vs
        # 0.3837 — so it stays dense.) At this vocab (37k) lazy Adam runs
        # as the MASKED-DENSE path (sparse_opt.DENSE_LAZY_MAX_BYTES):
        # same-window A/B 21.1k sparse vs 21.2k dense seq/s @ B=64, 23.9k
        # vs 25.4k @ B=256 (scripts/bench_attn_step.py) — the earlier
        # gather/scatter formulation lost 40% here, which is why the path
        # dispatches on table size; config #5 (V=1M) keeps rows+scatter and
        # wins both quality and speed.
        train=TrainConfig(
            batch_size=64, num_steps=5_000, lr_schedule="cosine",
            lr_min_frac=0.05, table_update="sparse",
        ),
        mesh=MeshConfig(data=-1, model=1),
    )
)

# --- config #5: multi-host 1M-POI scale-out (B:11) ---------------------------
register(
    Config(
        name="multihost_1m",
        data=DataConfig(
            dataset="synthetic",
            num_users=100_000,
            num_pois=1_000_000,
            mean_checkins_per_user=50,
            max_seq_len=64,
        ),
        # attn_impl="blockwise" (replicated time axis) is a MEASURED choice,
        # not a default: compiled-HLO wire traffic at these dims (T=64, W=16,
        # D=512 — scripts/compare_attention_modes.py, BASELINE.md r5 table)
        # is ~4-6 MB/device for blockwise vs 46-125 MB/device for ring/
        # ulysses across model={2,4,8} — the SP modes' seq<->head resharding
        # costs ~10-20x more ICI traffic than the whole attention block saves
        # at check-in sequence lengths. ring/ulysses remain the long-context
        # levers (per-device activation memory O(T/M)) for T >> 64.
        model=ModelConfig(
            kind="attention",
            embed_dim=512,
            hidden_dim=512,
            use_user_embedding=True,
            attn_window=16,
            attn_heads=8,
            attn_impl="blockwise",
        ),
        loss=LossConfig(kind="sampled_softmax", num_sampled=4096),
        # table_update="sparse": touched-rows-only lazy Adam. Only ~70k of the
        # 1M table rows (inputs ∪ targets ∪ negative pool) can carry gradient
        # per step; dense Adam's read-modify-write over every row was ~20-30%
        # of the step at this scale (VERDICT r4 Next #1; measured table in
        # BASELINE.md "Config #5 step attribution").
        train=TrainConfig(batch_size=512, num_steps=10_000, table_update="sparse"),
        mesh=MeshConfig(data=-1, model=4, embedding_mode="a2a"),
        eval=EvalConfig(topk_impl="pallas", batch_size=512),
        checkpoint=CheckpointConfig(directory="/tmp/poi_tpu_ckpt_1m"),
    )
)

# Small smoke config for tests / quick local runs (not a benchmark config).
register(
    Config(
        name="smoke",
        data=DataConfig(
            dataset="synthetic",
            num_users=64,
            num_pois=512,
            mean_checkins_per_user=30,
            max_seq_len=16,
            min_user_checkins=4,
            min_poi_checkins=1,
        ),
        model=ModelConfig(kind="gru", embed_dim=32, hidden_dim=32),
        loss=LossConfig(kind="ce"),
        train=TrainConfig(batch_size=16, num_steps=50, eval_every=25, log_every=10),
        eval=EvalConfig(batch_size=32, topk_impl="xla"),
    )
)
