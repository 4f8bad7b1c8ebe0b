"""Check-in sources: real-file parsers and a statistics-matched synthesizer.

The reference consumes raw Foursquare / Gowalla check-in dumps of
``(user, poi, timestamp, lat, lon)`` rows (SURVEY.md §2.1 R1/R2). This
environment has no network and no bundled datasets, so the default source is a
synthetic generator whose marginals mimic real check-in data:

- POI popularity is Zipf-distributed (power-law catalog).
- POIs live in spatial clusters ("neighborhoods") on a city-scale map.
- Each user has a home cluster and mostly checks in near home, with occasional
  excursions; per-user POI preference is itself power-law.
- Inter-check-in times are log-normal with a day/night rhythm.

Both parsers accept the common public file layouts:

- Gowalla (SNAP ``loc-gowalla_totalCheckins.txt``):
  ``user \\t ISO8601-time \\t lat \\t lon \\t location_id``
- Foursquare (TSMC2014 NYC/TKY dumps):
  ``user \\t venue_id \\t venue_cat_id \\t venue_cat_name \\t lat \\t lon \\t
  tz_offset_min \\t UTC-time``

All sources produce the same flat NumPy "check-in table" consumed by
``poi_tpu_torch.data.dataset``.
"""

from __future__ import annotations

import calendar
import time
from dataclasses import dataclass

import numpy as np


@dataclass
class CheckinTable:
    """Flat check-in log. Rows are NOT yet sorted or filtered."""

    user: np.ndarray  # [N] int64 raw user ids
    poi: np.ndarray  # [N] int64 raw POI ids (contiguity not assumed)
    timestamp: np.ndarray  # [N] float64 unix seconds
    lat: np.ndarray  # [N] float32 degrees
    lon: np.ndarray  # [N] float32 degrees

    def __len__(self) -> int:
        return int(self.user.shape[0])


# --------------------------------------------------------------------------- #
# Synthetic generator
# --------------------------------------------------------------------------- #


def synthesize_checkins(
    num_users: int,
    num_pois: int,
    mean_checkins_per_user: int,
    seed: int = 0,
    num_clusters: int | None = None,
    zipf_a: float = 1.2,
) -> CheckinTable:
    """Generate a check-in log with realistic marginal statistics.

    The generator is vectorized NumPy end-to-end (no Python-per-check-in
    loops) so the 1M-POI config (BASELINE.json:11) synthesizes in seconds.
    """
    rng = np.random.default_rng(seed)
    if num_clusters is None:
        num_clusters = max(4, int(np.sqrt(num_pois) / 4))

    # --- POI geography: clusters on a ~city-scale grid (degrees). ---------- #
    cluster_lat = rng.uniform(40.55, 40.95, size=num_clusters)
    cluster_lon = rng.uniform(-74.15, -73.65, size=num_clusters)
    poi_cluster = rng.integers(0, num_clusters, size=num_pois)
    poi_lat = cluster_lat[poi_cluster] + rng.normal(0, 0.01, num_pois)
    poi_lon = cluster_lon[poi_cluster] + rng.normal(0, 0.01, num_pois)

    # --- POI popularity: Zipf + uniform floor over a permuted catalog. ----- #
    # The uniform floor keeps catalog coverage realistic: pure Zipf at a=1.2
    # leaves most of a 10k+ catalog unvisited, which the min_poi_checkins
    # filter would then silently shrink far below the advertised scale.
    pop = (1.0 + np.arange(num_pois)) ** (-zipf_a)
    pop = pop / pop.sum() * 0.7 + 0.3 / num_pois
    pop = pop[rng.permutation(num_pois)]

    # --- Per-user sequence lengths (heavy-tailed, >= 2). ------------------- #
    lengths = rng.poisson(mean_checkins_per_user, size=num_users)
    lengths = np.maximum(2, (lengths * rng.lognormal(0.0, 0.4, num_users)).astype(int))
    total = int(lengths.sum())
    user_col = np.repeat(np.arange(num_users, dtype=np.int64), lengths)

    # --- Each user: home cluster + mixture of local/global POI choice. ----- #
    home = rng.integers(0, num_clusters, size=num_users)
    # Sample, per check-in, whether the user stays local (80%) or roams.
    local = rng.random(total) < 0.8
    # Global draws follow catalog popularity.
    global_choice = rng.choice(num_pois, size=total, p=pop / pop.sum())
    # Local draws: pick a POI from the user's home cluster, popularity-biased.
    # Vectorized via per-cluster cumulative tables.
    order = np.argsort(poi_cluster, kind="stable")
    sorted_pop = pop[order]
    cluster_starts = np.searchsorted(poi_cluster[order], np.arange(num_clusters + 1))
    # Per-cluster popularity CDF in one flat pass.
    cum = np.cumsum(sorted_pop)
    base = np.concatenate([[0.0], cum])[cluster_starts[:-1]]
    totals = np.concatenate([[0.0], cum])[cluster_starts[1:]] - base
    totals = np.maximum(totals, 1e-12)
    u_home = home[user_col]
    r = rng.random(total) * totals[u_home] + base[u_home]
    local_choice = order[np.minimum(np.searchsorted(cum, r), num_pois - 1)]
    poi_col = np.where(local, local_choice, global_choice).astype(np.int64)

    # --- Timestamps: per-user log-normal gaps with a diurnal rhythm. ------- #
    start = rng.uniform(0, 90 * 86400, size=num_users)  # spread over ~3 months
    gaps = rng.lognormal(mean=9.2, sigma=1.1, size=total)  # median ~ 10h
    # Cumulative sum per user without a Python loop: reset at user boundaries.
    seq_pos = np.arange(total) - np.repeat(np.cumsum(lengths) - lengths, lengths)
    cumgaps = np.cumsum(gaps)
    user_first = np.repeat(cumgaps[np.cumsum(lengths) - lengths], lengths)
    t = start[user_col] + (cumgaps - user_first) + seq_pos * 0.0
    # Nudge check-ins toward daytime: fold each time toward 10:00-22:00.
    tod = t % 86400
    night = (tod < 8 * 3600) | (tod > 23 * 3600)
    t = np.where(night, t + (12 * 3600 - tod) % 86400, t)

    base_epoch = calendar.timegm(time.strptime("2012-01-01", "%Y-%m-%d"))
    return CheckinTable(
        user=user_col,
        poi=poi_col,
        timestamp=(base_epoch + t).astype(np.float64),
        lat=poi_lat[poi_col].astype(np.float32),
        lon=poi_lon[poi_col].astype(np.float32),
    )


# --------------------------------------------------------------------------- #
# Real-file parsers
# --------------------------------------------------------------------------- #


def _open_text(path: str):
    """Open plain or gzip-compressed text (the public dumps ship as .gz)."""
    if path.endswith(".gz"):
        import gzip

        return gzip.open(path, "rt", encoding="utf-8", errors="replace")
    return open(path, "r", encoding="utf-8", errors="replace")


def parse_gowalla(path: str, max_rows: int | None = None) -> CheckinTable:
    """Parse the SNAP Gowalla ``totalCheckins`` TSV layout."""
    users, pois, ts, lats, lons = [], [], [], [], []
    with _open_text(path) as f:
        for i, line in enumerate(f):
            if max_rows is not None and i >= max_rows:
                break
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 5:
                continue
            u, t_str, lat, lon, loc = parts[:5]
            users.append(int(u))
            ts.append(_parse_iso8601(t_str))
            lats.append(float(lat))
            lons.append(float(lon))
            pois.append(int(loc))
    return _table(users, pois, ts, lats, lons)


def parse_foursquare(path: str, max_rows: int | None = None) -> CheckinTable:
    """Parse the TSMC2014 Foursquare TSV layout (NYC/TKY dumps)."""
    users, pois, ts, lats, lons = [], [], [], [], []
    venue_ids: dict[str, int] = {}
    with _open_text(path) as f:
        for i, line in enumerate(f):
            if max_rows is not None and i >= max_rows:
                break
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 8:
                continue
            u, venue, _cat_id, _cat_name, lat, lon, tz_off, utc = parts[:8]
            users.append(int(u))
            pois.append(venue_ids.setdefault(venue, len(venue_ids)))
            lats.append(float(lat))
            lons.append(float(lon))
            ts.append(_parse_foursquare_time(utc) + 60.0 * float(tz_off))
    return _table(users, pois, ts, lats, lons)


def load_checkins(dataset: str, path: str | None, **synth_kwargs) -> CheckinTable:
    """Dispatch: real file if a path is given, else the synthesizer."""
    if path is not None:
        if dataset == "gowalla":
            return parse_gowalla(path)
        if dataset == "foursquare":
            return parse_foursquare(path)
        raise ValueError(f"No parser for dataset {dataset!r}")
    return synthesize_checkins(**synth_kwargs)


def _table(users, pois, ts, lats, lons) -> CheckinTable:
    return CheckinTable(
        user=np.asarray(users, dtype=np.int64),
        poi=np.asarray(pois, dtype=np.int64),
        timestamp=np.asarray(ts, dtype=np.float64),
        lat=np.asarray(lats, dtype=np.float32),
        lon=np.asarray(lons, dtype=np.float32),
    )


def _parse_iso8601(s: str) -> float:
    # e.g. "2010-10-19T23:55:27Z"
    return float(calendar.timegm(time.strptime(s[:19], "%Y-%m-%dT%H:%M:%S")))


def _parse_foursquare_time(s: str) -> float:
    # e.g. "Tue Apr 03 18:00:09 +0000 2012"
    return float(calendar.timegm(time.strptime(s, "%a %b %d %H:%M:%S %z %Y")))
