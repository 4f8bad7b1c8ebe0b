"""Preprocessing: check-in table → padded training/eval example arrays.

Mirrors the reference pipeline's responsibilities (SURVEY.md §2.1 R2): filter
sparse users/POIs, build contiguous id maps, sort each user's check-ins by
time, split a held-out tail per user, and derive the features the models need —
hour-of-week buckets, geo grid cells, and (for ST-RNN) per-step time-gap /
haversine-distance bucket indices with linear-interpolation fractions
(SURVEY.md §2.1 R6, §7 "ST-RNN transition interpolation").

Everything is vectorized NumPy; the output is a set of fixed-shape arrays
ready for device transfer (static shapes are mandatory under jit).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np

from poi_tpu_torch.data.checkins import CheckinTable
from poi_tpu_torch.utils.config import DataConfig

EARTH_RADIUS_KM = 6371.0


DEG2RAD = np.pi / 180.0  # np.radians is ~60x slower than a multiply in this env


def haversine_km(lat1, lon1, lat2, lon2) -> np.ndarray:
    """Great-circle distance in km (vectorized, degrees in)."""
    lat1, lon1, lat2, lon2 = (np.asarray(x, np.float64) * DEG2RAD for x in (lat1, lon1, lat2, lon2))
    dlat = lat2 - lat1
    dlon = lon2 - lon1
    a = np.sin(dlat / 2) ** 2 + np.cos(lat1) * np.cos(lat2) * np.sin(dlon / 2) ** 2
    return 2 * EARTH_RADIUS_KM * np.arcsin(np.sqrt(np.clip(a, 0.0, 1.0)))


@dataclass
class Examples:
    """Fixed-shape example arrays. T = max_seq_len.

    For training, every valid position is a next-POI prediction:
    ``poi_tgt[i, t]`` is the check-in following ``poi_in[i, t]``.
    For eval, only the final valid position's target is scored (leave-out
    protocol); ``target`` holds it densely.
    """

    user: np.ndarray  # [N] int32
    poi_in: np.ndarray  # [N, T] int32
    poi_tgt: np.ndarray  # [N, T] int32 (0 where masked)
    mask: np.ndarray  # [N, T] bool — validity prefix: True at valid input
    #   positions. Train: every valid position has a target. Eval: only the
    #   LAST valid position (sum(mask)-1) is scored; its target is in ``target``.
    time_bucket: np.ndarray  # [N, T] int32 hour-of-week of the input check-in
    geo_bucket: np.ndarray  # [N, T] int32 grid cell of the input check-in
    tgap_idx: np.ndarray  # [N, T] int32 lower time-gap bucket (ST-RNN)
    tgap_frac: np.ndarray  # [N, T] float32 interpolation fraction in [0,1]
    dist_idx: np.ndarray  # [N, T] int32 lower distance bucket (ST-RNN)
    dist_frac: np.ndarray  # [N, T] float32
    target: np.ndarray  # [N] int32 final-position target (eval)

    def __len__(self) -> int:
        return int(self.user.shape[0])

    def take(self, idx: np.ndarray) -> "Examples":
        return Examples(**{k: getattr(self, k)[idx] for k in self.__dataclass_fields__})


@dataclass
class Dataset:
    """Fully preprocessed dataset."""

    num_users: int
    num_pois: int
    num_time_buckets: int
    num_geo_buckets: int
    num_tgap_buckets: int
    num_dist_buckets: int
    train: Examples
    test: Examples
    poi_counts: np.ndarray  # [num_pois] train-split popularity (for baselines/sampling)
    # Validation split for model selection (cfg.val_fraction > 0): the
    # temporal tail of each user's train region. None when not requested.
    val: Examples = field(default=None)
    tgap_edges: np.ndarray = field(default=None)  # quantile bucket edges (seconds)
    dist_edges: np.ndarray = field(default=None)  # quantile bucket edges (km)
    # Featurizer parameters needed to embed NEW histories at serving time
    # (eval/serve.py): geo grid bounds (lat_lo, lat_hi, lon_lo, lon_hi),
    # grid resolution, time bucket count, and max_seq_len.
    geo_bounds: tuple = field(default=None)
    geo_grid: int = 0
    time_buckets: int = 0
    max_seq_len: int = 0
    # Raw POI coordinates (for distance features on new histories).
    poi_latlon: np.ndarray = field(default=None)  # [num_pois, 2] float32


def build_dataset(table: CheckinTable, cfg: DataConfig, use_native: bool = True) -> Dataset:
    """Full preprocessing pipeline.

    ``use_native=True`` routes the windowing stage through the C++ fast path
    (poi_tpu_torch/native/preprocess.cc) when the toolchain is available; the
    Python loops below remain the oracle and fallback.
    """
    user, poi, ts, lat, lon = (
        table.user.copy(),
        table.poi.copy(),
        table.timestamp.copy(),
        table.lat.copy(),
        table.lon.copy(),
    )

    # --- iterative sparse-user/POI filtering (reference behavior) ---------- #
    for _ in range(5):
        keep = np.ones(len(user), dtype=bool)
        _, poi_inv, poi_cnt = np.unique(poi, return_inverse=True, return_counts=True)
        keep &= poi_cnt[poi_inv] >= cfg.min_poi_checkins
        _, usr_inv, usr_cnt = np.unique(user, return_inverse=True, return_counts=True)
        keep &= usr_cnt[usr_inv] >= cfg.min_user_checkins
        if keep.all():
            break
        user, poi, ts, lat, lon = user[keep], poi[keep], ts[keep], lat[keep], lon[keep]
    if len(user) == 0:
        raise ValueError("All check-ins filtered out; relax min_*_checkins")

    # --- contiguous id maps ------------------------------------------------ #
    uniq_users, user = np.unique(user, return_inverse=True)
    uniq_pois, poi = np.unique(poi, return_inverse=True)
    num_users, num_pois = len(uniq_users), len(uniq_pois)

    # --- per-user temporal sort -------------------------------------------- #
    order = np.lexsort((ts, user))
    user, poi, ts, lat, lon = user[order], poi[order], ts[order], lat[order], lon[order]

    # --- features: hour-of-week and geo grid cell -------------------------- #
    hour_of_week = ((ts // 3600) % (24 * 7)).astype(np.int64)
    time_bucket = (hour_of_week * cfg.time_buckets // (24 * 7)).astype(np.int32)
    geo_bounds = (float(lat.min()), float(lat.max()), float(lon.min()), float(lon.max()))
    lat_q = _quantize(lat, cfg.geo_grid)
    lon_q = _quantize(lon, cfg.geo_grid)
    geo_bucket = (lat_q * cfg.geo_grid + lon_q).astype(np.int32)

    # --- per-step gaps (within-user); first step of each user gets 0 ------- #
    boundaries = np.concatenate([[True], user[1:] != user[:-1]])
    tgap = np.where(boundaries, 0.0, np.concatenate([[0.0], np.diff(ts)]))
    prev_lat = np.concatenate([[0.0], lat[:-1].astype(np.float64)])
    prev_lon = np.concatenate([[0.0], lon[:-1].astype(np.float64)])
    dist = np.where(boundaries, 0.0, haversine_km(prev_lat, prev_lon, lat, lon))

    # --- quantile bucket edges + (idx, frac) for ST-RNN interpolation ------ #
    tgap_edges = _quantile_edges(tgap[~boundaries], cfg.time_gap_buckets)
    dist_edges = _quantile_edges(dist[~boundaries], cfg.dist_buckets)
    tgap_idx, tgap_frac = bucketize_interp(tgap, tgap_edges)
    dist_idx, dist_frac = bucketize_interp(dist, dist_edges)

    # --- per-user split: hold out the last ~20% (>=1) check-ins ------------ #
    starts = np.flatnonzero(boundaries)
    lengths = np.diff(np.concatenate([starts, [len(user)]]))
    n_test = np.maximum(1, (lengths * 0.2).astype(int))
    n_test = np.minimum(n_test, lengths - 1)  # keep >=1 train item per user
    pos_in_user = np.arange(len(user)) - np.repeat(starts, lengths)
    is_test = pos_in_user >= np.repeat(lengths - n_test, lengths)

    # Optional validation split for model selection (cfg.val_fraction > 0):
    # carved from the temporal TAIL of each user's train region, so the test
    # set is bit-identical to the val_fraction=0 split (rows keep historical
    # comparability) and val strictly precedes test in time (no leakage).
    is_val = np.zeros_like(is_test)
    if cfg.val_fraction > 0.0:
        train_len = lengths - n_test
        n_val = np.minimum(
            np.maximum(1, (train_len * cfg.val_fraction).astype(int)), train_len - 1
        )
        is_val = (~is_test) & (
            pos_in_user >= np.repeat(train_len - n_val, lengths)
        )

    feats = dict(
        poi=poi.astype(np.int32),
        time_bucket=time_bucket,
        geo_bucket=geo_bucket,
        tgap_idx=tgap_idx.astype(np.int32),
        tgap_frac=tgap_frac.astype(np.float32),
        dist_idx=dist_idx.astype(np.int32),
        dist_frac=dist_frac.astype(np.float32),
    )

    train_keep = ~is_test & ~is_val
    train_ex = _build_train(user, feats, train_keep, starts, lengths, cfg.max_seq_len, use_native)
    test_ex = _build_eval(user, feats, is_test, starts, lengths, cfg.max_seq_len, use_native)
    val_ex = None
    if cfg.val_fraction > 0.0:
        val_ex = _build_eval(user, feats, is_val, starts, lengths, cfg.max_seq_len, use_native)

    poi_counts = np.bincount(poi[train_keep], minlength=num_pois).astype(np.int64)

    return Dataset(
        num_users=num_users,
        num_pois=num_pois,
        num_time_buckets=cfg.time_buckets,
        num_geo_buckets=cfg.geo_grid * cfg.geo_grid,
        num_tgap_buckets=cfg.time_gap_buckets,
        num_dist_buckets=cfg.dist_buckets,
        train=train_ex,
        test=test_ex,
        val=val_ex,
        poi_counts=poi_counts,
        tgap_edges=tgap_edges,
        dist_edges=dist_edges,
        geo_bounds=geo_bounds,
        geo_grid=cfg.geo_grid,
        time_buckets=cfg.time_buckets,
        max_seq_len=cfg.max_seq_len,
        poi_latlon=_poi_coords(poi, lat, lon, num_pois),
    )


def _poi_coords(poi, lat, lon, num_pois) -> np.ndarray:
    """Representative (lat, lon) per POI id (last observed check-in wins)."""
    out = np.zeros((num_pois, 2), np.float32)
    out[poi, 0] = lat
    out[poi, 1] = lon
    return out


def bucketize_interp(x: np.ndarray, edges: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Map continuous values to (lower bucket index, interpolation fraction).

    ``edges`` are K+1 monotonically increasing bucket endpoints. A value
    landing between edges[i] and edges[i+1] gets index i and fraction
    (x - edges[i]) / (edges[i+1] - edges[i]). Values outside are clamped.
    The ST-RNN transition matrix at x is then
    ``(1-frac) * M[idx] + frac * M[idx+1]`` (SURVEY.md §2.1 R6).
    """
    edges = np.asarray(edges, dtype=np.float64)
    k = len(edges) - 1
    idx = np.clip(np.searchsorted(edges, x, side="right") - 1, 0, k - 1)
    lo, hi = edges[idx], edges[idx + 1]
    frac = np.clip((x - lo) / np.maximum(hi - lo, 1e-9), 0.0, 1.0)
    return idx.astype(np.int32), frac.astype(np.float32)


def _quantize(x: np.ndarray, n: int) -> np.ndarray:
    lo, hi = np.min(x), np.max(x)
    return np.clip(((x - lo) / max(hi - lo, 1e-9) * n).astype(np.int64), 0, n - 1)


def _quantile_edges(x: np.ndarray, k: int) -> np.ndarray:
    """K+1 bucket endpoints at data quantiles (deduplicated, strictly increasing)."""
    if len(x) == 0:
        return np.linspace(0.0, 1.0, k + 1)
    qs = np.quantile(x, np.linspace(0.0, 1.0, k + 1))
    # Force strict monotonicity so interpolation fractions are well-defined.
    eps = max(1e-6, float(qs[-1] - qs[0]) * 1e-6)
    return np.maximum.accumulate(qs + np.arange(k + 1) * eps)


def _examples_from_native(out: dict) -> Examples:
    return Examples(
        user=out["user"],
        poi_in=out["poi_in"],
        poi_tgt=out["poi_tgt"],
        mask=out["mask"].astype(bool),
        time_bucket=out["time_bucket"],
        geo_bucket=out["geo_bucket"],
        tgap_idx=out["tgap_idx"],
        tgap_frac=out["tgap_frac"],
        dist_idx=out["dist_idx"],
        dist_frac=out["dist_frac"],
        target=out["target"],
    )


def _build_train(user, feats, keep, starts, lengths, T, use_native) -> Examples:
    if use_native:
        from poi_tpu_torch import native

        out = native.build_train_windows(starts, lengths, user[starts], keep, feats, T)
        if out is not None:
            return _examples_from_native(out)
    return _window_examples(user, feats, keep, starts, lengths, T, for_eval=False)


def _build_eval(user, feats, is_test, starts, lengths, T, use_native) -> Examples:
    if use_native:
        from poi_tpu_torch import native

        out = native.build_eval_examples(starts, lengths, user[starts], is_test, feats, T)
        if out is not None:
            return _examples_from_native(out)
    return _eval_examples(user, feats, is_test, starts, lengths, T)


def _window_examples(user, feats, keep, starts, lengths, T, for_eval) -> Examples:
    """Cut each user's kept check-ins into non-overlapping windows of T+1.

    A window of T+1 consecutive check-ins yields T (input → target) pairs.
    The final (ragged) window of each user is emitted right-padded.
    """
    rows = {k: [] for k in feats}
    users_out, masks = [], []
    poi = feats["poi"]
    n_users = len(starts)
    for u in range(n_users):
        s, e = starts[u], starts[u] + lengths[u]
        idx = np.arange(s, e)[keep[s:e]]
        L = len(idx)
        if L < 2:
            continue
        # Windows: [0:T+1], [T:2T+1], ... — each target needs its predecessor.
        w = 0
        while w < L - 1:
            win = idx[w : w + T + 1]
            n_in = len(win) - 1
            users_out.append(user[s])
            masks.append(_pad_bool(np.ones(n_in, bool), T))
            for k in feats:
                rows[k].append(_pad(feats[k][win[:-1]], T))
            rows.setdefault("poi_tgt", [])
            rows["poi_tgt"].append(_pad(poi[win[1:]], T))
            w += T
    return _stack_examples(users_out, rows, masks, T)


def _eval_examples(user, feats, is_test, starts, lengths, T) -> Examples:
    """One eval example per held-out check-in: context = all preceding
    check-ins (train + earlier test), truncated to the last T."""
    rows = {k: [] for k in feats}
    users_out, masks, targets = [], [], []
    poi = feats["poi"]
    for u in range(len(starts)):
        s, e = starts[u], starts[u] + lengths[u]
        test_pos = np.arange(s, e)[is_test[s:e]]
        for p in test_pos:
            ctx = np.arange(max(s, p - T), p)
            n_in = len(ctx)
            if n_in == 0:
                continue
            users_out.append(user[s])
            # Validity-prefix mask: the recurrent cells freeze their carry at
            # mask == 0, so a one-hot "scored position" mask would zero the
            # entire context out of the recurrence (measured: eval queries
            # collapsed to the position-0 state — the fused cells, whose
            # masked steps emit the carry exactly, scored at the popularity
            # floor). The scored position is recovered as sum(mask) - 1 ==
            # n_in - 1 (eval/evaluate.py last_valid_queries).
            m = np.zeros(T, bool)
            m[:n_in] = True
            masks.append(m)
            for k in feats:
                rows[k].append(_pad(feats[k][ctx], T))
            rows.setdefault("poi_tgt", [])
            tgt = np.zeros(T, feats["poi"].dtype)
            tgt[n_in - 1] = poi[p]
            rows["poi_tgt"].append(tgt)
            targets.append(poi[p])
    ex = _stack_examples(users_out, rows, masks, T)
    ex.target = np.asarray(targets, dtype=np.int32) if targets else np.zeros(0, np.int32)
    return ex


def _pad(a: np.ndarray, T: int) -> np.ndarray:
    out = np.zeros(T, dtype=a.dtype)
    out[: len(a)] = a[:T]
    return out


def _pad_bool(a: np.ndarray, T: int) -> np.ndarray:
    out = np.zeros(T, dtype=bool)
    out[: len(a)] = a[:T]
    return out


def _stack_examples(users_out, rows, masks, T) -> Examples:
    n = len(users_out)
    if n == 0:
        z = lambda dt: np.zeros((0, T), dtype=dt)  # noqa: E731
        return Examples(
            user=np.zeros(0, np.int32),
            poi_in=z(np.int32), poi_tgt=z(np.int32), mask=np.zeros((0, T), bool),
            time_bucket=z(np.int32), geo_bucket=z(np.int32),
            tgap_idx=z(np.int32), tgap_frac=z(np.float32),
            dist_idx=z(np.int32), dist_frac=z(np.float32),
            target=np.zeros(0, np.int32),
        )
    return Examples(
        user=np.asarray(users_out, dtype=np.int32),
        poi_in=np.stack(rows["poi"]).astype(np.int32),
        poi_tgt=np.stack(rows["poi_tgt"]).astype(np.int32),
        mask=np.stack(masks),
        time_bucket=np.stack(rows["time_bucket"]).astype(np.int32),
        geo_bucket=np.stack(rows["geo_bucket"]).astype(np.int32),
        tgap_idx=np.stack(rows["tgap_idx"]).astype(np.int32),
        tgap_frac=np.stack(rows["tgap_frac"]).astype(np.float32),
        dist_idx=np.stack(rows["dist_idx"]).astype(np.int32),
        dist_frac=np.stack(rows["dist_frac"]).astype(np.float32),
        target=np.zeros(n, np.int32),
    )


def _cache_path(cfg: DataConfig) -> "pathlib.Path | None":
    """Disk-cache location for a synthetic dataset build, or None when
    caching is off. Key = the full DataConfig + a hash of EVERY preprocessing
    source that shapes the built arrays — including the C++ windowing fast
    path (native/preprocess.cc + its FFI wrapper), so a .cc-only semantic
    change invalidates the cache just like a .py change would.
    Real-file datasets (cfg.path set) are never cached: the file can change
    under us and parse time is not the bottleneck.

    The directory and its environment variable are this package's own
    (``POI_TPU_TORCH_DATA_CACHE``, default ``poi_tpu_torch_datasets_<uid>``
    under the temp directory): a pickled ``Dataset`` names the package that
    built it, so neither package ever loads the other's."""
    import hashlib
    import os
    import pathlib
    import tempfile

    cache_dir = os.environ.get(
        "POI_TPU_TORCH_DATA_CACHE",
        os.path.join(tempfile.gettempdir(), f"poi_tpu_torch_datasets_{os.getuid()}"),
    )
    if cfg.path is not None or cache_dir.lower() in ("", "0", "off"):
        return None
    h = hashlib.sha256(repr(sorted(dataclasses.asdict(cfg).items())).encode())
    pkg = pathlib.Path(__file__).resolve().parents[1]
    for src in (
        pkg / "data" / "dataset.py",
        pkg / "data" / "checkins.py",
        pkg / "native" / "preprocess.cc",
        pkg / "native" / "__init__.py",
    ):
        h.update(src.read_bytes())
    return pathlib.Path(cache_dir) / f"{h.hexdigest()[:24]}.pkl"


def _cache_dir_is_trusted(path: "pathlib.Path") -> bool:
    """Only read pickles from a directory this uid owns with no group/other
    write access: the cache deserializes with pickle, so a world-writable
    shared dir would let another local user plant arbitrary-code payloads
    under a predictable key."""
    import os
    import stat

    try:
        st = os.stat(path.parent)
    except OSError:
        return False
    return st.st_uid == os.getuid() and not (st.st_mode & (stat.S_IWGRP | stat.S_IWOTH))


def load_dataset(cfg: DataConfig) -> Dataset:
    """Build (or load from the disk cache) the fully preprocessed dataset.

    The synthetic corpora behind the named configs take minutes to window at
    Gowalla scale; every script/CLI invocation was paying that again. The
    pickle cache makes repeat invocations O(read) while staying exactly
    bit-identical to a fresh build (the cache stores the built arrays)."""
    import os
    import pickle
    import tempfile

    from poi_tpu_torch.data.checkins import load_checkins

    cpath = _cache_path(cfg)
    if cpath is not None and cpath.exists() and _cache_dir_is_trusted(cpath):
        try:
            with open(cpath, "rb") as f:
                return pickle.load(f)
        except Exception:  # corrupt/partial file: rebuild below
            pass
    table = load_checkins(
        cfg.dataset,
        cfg.path,
        num_users=cfg.num_users,
        num_pois=cfg.num_pois,
        mean_checkins_per_user=cfg.mean_checkins_per_user,
        seed=cfg.seed,
    )
    ds = build_dataset(table, cfg)
    if cpath is not None:
        cpath.parent.mkdir(parents=True, exist_ok=True, mode=0o700)
        if not _cache_dir_is_trusted(cpath):
            return ds  # pre-existing dir owned by someone else: don't publish
        # Atomic publish so concurrent builders never read a partial pickle.
        fd, tmp = tempfile.mkstemp(dir=cpath.parent, suffix=".tmp")
        with os.fdopen(fd, "wb") as f:
            pickle.dump(ds, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, cpath)
    return ds
