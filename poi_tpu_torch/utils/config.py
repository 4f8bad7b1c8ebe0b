"""Typed configuration system.

The reference family uses argparse flags / module-level constants (SURVEY.md §5
"Config/flag system"). Here every run is described by a frozen dataclass tree:
one preset per named benchmark config (BASELINE.json:7-11), CLI overrides via
dotted ``--set section.key=value`` pairs, and the full config serialized as JSON
into every checkpoint directory for reproducibility.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class DataConfig:
    """Dataset selection and preprocessing knobs."""

    dataset: str = "synthetic"  # synthetic | foursquare | gowalla
    path: str | None = None  # raw check-in file (TSV); None => synthesize
    # Synthetic generator scale (matched to the named config's catalog size).
    num_users: int = 2_000
    num_pois: int = 10_000
    mean_checkins_per_user: int = 60
    # Filtering (mirrors the reference pipeline's sparse-user/POI filters).
    min_user_checkins: int = 10
    min_poi_checkins: int = 5
    # Sequence shaping.
    max_seq_len: int = 64  # timesteps per training window (T); targets are shifted
    # Validation split for model selection: fraction of each user's TRAIN
    # region (its temporal tail) held out as Dataset.val. 0 = no val split.
    # The test split is bit-identical either way (val comes out of train).
    val_fraction: float = 0.0
    # Feature discretization.
    time_buckets: int = 168  # hour-of-week buckets for the time embedding
    geo_grid: int = 64  # geo embedding = (lat, lon) quantized on a geo_grid² grid
    # ST-RNN continuous-feature bucketing (upper edges found from data quantiles).
    time_gap_buckets: int = 8
    dist_buckets: int = 8
    seed: int = 0
    loader_backend: str = "threaded"  # threaded | grain (data/pipeline.py)
    # "host": epoch-permutation loaders feed batches from CPU. "device":
    # upload examples to HBM once and sample batches in-graph (uniform with
    # replacement; zero per-step host payload — data/device_sampler.py).
    sampler: str = "host"  # host | device


@dataclass(frozen=True)
class ModelConfig:
    """Sequence-tower architecture."""

    kind: str = "gru"  # gru | lstm | strnn | attention
    embed_dim: int = 64  # POI/user/time/geo embedding width
    hidden_dim: int = 64  # recurrent state width
    num_layers: int = 1
    use_user_embedding: bool = False  # add user vector to the scoring query
    use_time_embedding: bool = True
    use_geo_embedding: bool = True
    tie_output_embedding: bool = True  # score against the input POI table
    dropout: float = 0.0
    # Attention model (config #4): attend over the last-k hidden states.
    attn_window: int = 16
    attn_heads: int = 4
    attn_impl: str = "blockwise"  # vanilla | blockwise | ring | ulysses
    attn_block_size: int = 128
    # Compute dtype for the tower (params stay fp32).
    compute_dtype: str = "bfloat16"
    # Recurrent cell implementation: "auto" picks the fused Pallas recurrence
    # kernel on TPU when shapes are lane-aligned, else lax.scan ("scan" and
    # "pallas" force a path; scan is the oracle).
    cell_impl: str = "auto"  # auto | pallas | scan
    # jax.checkpoint the recurrent cell: O(T) gate residuals -> recompute in
    # backward; enables long-T training in fixed memory (SURVEY.md §5).
    remat_cell: bool = False


@dataclass(frozen=True)
class LossConfig:
    kind: str = "ce"  # ce | bpr | sampled_softmax
    num_negatives: int = 1  # BPR negatives per positive
    num_sampled: int = 512  # sampled-softmax negatives per batch
    label_smoothing: float = 0.0
    # Kernel dispatch for ce/sampled_softmax (mirrors model.cell_impl):
    #   auto  — Pallas fused kernels on TPU when shapes qualify (the default)
    #   fused — force the fused path (still falls back off-TPU)
    #   xla   — force the plain XLA implementation (debug/bisection)
    impl: str = "auto"  # auto | fused | xla


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 32  # global batch (sequences), sharded over the data axis
    num_steps: int = 2_000
    eval_every: int = 500
    log_every: int = 50
    checkpoint_every: int = 500
    learning_rate: float = 1e-3
    weight_decay: float = 0.0
    warmup_steps: int = 100
    # LR schedule after warmup: "constant" holds learning_rate; "cosine"
    # decays to lr_min_frac * learning_rate by num_steps. Cosine is the
    # overfit guard for full-budget runs on small check-in corpora: the
    # config-#4 probes showed constant-LR runs peak early and decay back to
    # the popularity floor by the end of the budget.
    lr_schedule: str = "constant"  # constant | cosine
    lr_min_frac: float = 0.0
    grad_clip_norm: float = 1.0
    optimizer: str = "adam"  # adam | adagrad | sgd
    # Embedding-table update strategy. "sparse" = touched-rows-only lazy Adam
    # (train/sparse_opt.py): with a sampled objective, only inputs ∪ targets
    # ∪ negatives (~70k of 1M rows at config #5) can carry gradient, so the
    # dense Adam read-modify-write over every row is skipped. Requires
    # optimizer=adam, weight_decay=0, loss ∈ {bpr, sampled_softmax}.
    table_update: str = "dense"  # dense | sparse
    seed: int = 0
    # Train steps fused into one device dispatch (lax.scan over stacked
    # batches). Amortizes host dispatch latency; metrics stay per-step.
    steps_per_call: int = 1
    # Debug hook: raise at this step to exercise the resume path (SURVEY.md §5).
    fault_inject_step: int = -1


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh layout: ('data', 'model') axes.

    The 'model' axis carries vocab-sharded embedding tables (all-to-all / psum
    riding ICI); the 'data' axis carries batch sharding (grad psum, may span
    DCN on multi-host slices). -1 means "infer from available devices".
    """

    data: int = -1
    model: int = 1
    # Vocab-sharded embedding lookup strategy: 'psum' (mask+gather+psum) or
    # 'a2a' (bucket-by-owner all-to-all exchange, MoE-style fixed capacity).
    embedding_mode: str = "psum"
    a2a_capacity_factor: float = 2.0


@dataclass(frozen=True)
class EvalConfig:
    recall_ks: tuple[int, ...] = (1, 5, 10)
    batch_size: int = 256
    topk_impl: str = "pallas"  # pallas | xla  (xla path is the correctness oracle)
    max_eval_users: int = 10_000


@dataclass(frozen=True)
class CheckpointConfig:
    directory: str = "/tmp/poi_tpu_ckpt"
    max_to_keep: int = 3
    async_save: bool = False


@dataclass(frozen=True)
class Config:
    name: str = "default"
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)

    # ------------------------------------------------------------------ io
    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Config":
        kwargs: dict[str, Any] = {}
        for f in dataclasses.fields(cls):
            if f.name not in d:
                continue
            v = d[f.name]
            if dataclasses.is_dataclass(f.type) or f.name in _SECTIONS:
                section_cls = _SECTIONS[f.name]
                sv = dict(v)
                for sf in dataclasses.fields(section_cls):
                    if sf.name in sv and isinstance(sv[sf.name], list):
                        sv[sf.name] = tuple(sv[sf.name])
                kwargs[f.name] = section_cls(**sv)
            else:
                kwargs[f.name] = v
        return cls(**kwargs)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        return cls.from_dict(json.loads(s))

    # ------------------------------------------------------------ overrides
    def with_overrides(self, overrides: dict[str, Any]) -> "Config":
        """Apply dotted-path overrides, e.g. {'train.batch_size': 64}."""
        d = self.to_dict()
        for path, value in overrides.items():
            parts = path.split(".")
            node = d
            for p in parts[:-1]:
                if p not in node:
                    raise KeyError(f"Unknown config section {p!r} in {path!r}")
                node = node[p]
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"Unknown config key {leaf!r} in {path!r}")
            node[leaf] = _coerce(value, node[leaf])
        d["name"] = d.get("name", self.name)
        return Config.from_dict(d)


_SECTIONS = {
    "data": DataConfig,
    "model": ModelConfig,
    "loss": LossConfig,
    "train": TrainConfig,
    "mesh": MeshConfig,
    "eval": EvalConfig,
    "checkpoint": CheckpointConfig,
}


def _coerce(value: Any, like: Any) -> Any:
    """Coerce a CLI string to the type of the existing config value."""
    if not isinstance(value, str):
        return value
    if isinstance(like, bool):
        return value.lower() in ("1", "true", "yes", "on")
    if isinstance(like, int) and not isinstance(like, bool):
        return int(value)
    if isinstance(like, float):
        return float(value)
    if isinstance(like, (tuple, list)):
        return tuple(type(like[0])(x) for x in value.split(",")) if value else ()
    if like is None or isinstance(like, str):
        return None if value == "none" else value
    return value


def parse_set_flags(pairs: list[str]) -> dict[str, Any]:
    """Parse ['train.lr=3e-4', ...] CLI override pairs."""
    out: dict[str, Any] = {}
    for pair in pairs:
        if "=" not in pair:
            raise ValueError(f"--set expects key=value, got {pair!r}")
        k, v = pair.split("=", 1)
        out[k.strip()] = v.strip()
    return out
