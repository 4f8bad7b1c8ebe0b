"""Online serving: raw check-in histories → top-k POI recommendations.

Counterpart of ``poi_tpu/eval/serve.py`` in one process. ``Recommender``
holds a model whose parameters live on one device, featurizes new histories
exactly as the JAX package does (one flat numpy pass), runs the scoring
query and the full-catalog top-k on that device, and filters already
visited POIs on the host by over-fetching.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import torch

from poi_tpu.data.dataset import Dataset, bucketize_interp, haversine_km
from poi_tpu.data.pipeline import Batch
from poi_tpu.utils.config import Config
from poi_tpu_torch.eval.evaluate import make_topk_fn, prepare_catalog
from poi_tpu_torch.models.base import batch_to

log = logging.getLogger(__name__)


@dataclass
class Checkin:
    poi: int
    timestamp: float
    lat: float | None = None  # None → use the catalog's POI coordinates
    lon: float | None = None


class Recommender:
    def __init__(self, model, cfg: Config, dataset: Dataset):
        # fp32 products stay fp32 on the card (no TF32), as the reference's.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.model = model
        self.cfg = cfg
        self.ds = dataset
        self.T = dataset.max_seq_len
        self._prep = prepare_catalog(model, cfg, dataset.poi_counts)

    @property
    def device(self) -> torch.device:
        return self.model.device

    def _featurize(self, histories: list[list[Checkin]]) -> Batch:
        """Vectorized request featurization: numpy arrays equal to
        ``poi_tpu.eval.serve.Recommender._featurize``'s."""
        ds, T = self.ds, self.T
        B = len(histories)
        lat_lo, lat_hi, lon_lo, lon_hi = ds.geo_bounds
        g = ds.geo_grid

        trimmed = [h[-T:] for h in histories]
        lens = np.fromiter((len(h) for h in trimmed), np.int64, B)
        if B and lens.min() == 0:
            raise ValueError("empty history")
        poi = np.fromiter((c.poi for h in trimmed for c in h), np.int64, lens.sum())
        ts = np.fromiter((c.timestamp for h in trimmed for c in h), np.float64, lens.sum())
        lat = np.fromiter(
            (np.nan if c.lat is None else c.lat for h in trimmed for c in h),
            np.float64, lens.sum(),
        )
        lon = np.fromiter(
            (np.nan if c.lon is None else c.lon for h in trimmed for c in h),
            np.float64, lens.sum(),
        )
        m_lat, m_lon = np.isnan(lat), np.isnan(lon)
        lat[m_lat] = ds.poi_latlon[poi[m_lat], 0]
        lon[m_lon] = ds.poi_latlon[poi[m_lon], 1]

        rows = np.repeat(np.arange(B), lens)
        cols = np.arange(len(poi)) - np.repeat(np.cumsum(lens) - lens, lens)

        poi_in = np.zeros((B, T), np.int32)
        poi_in[rows, cols] = poi
        # Validity-prefix mask; the scored position is sum(mask)-1 == n-1.
        mask = np.zeros((B, T), np.float32)
        mask[rows, cols] = 1.0
        how = (ts // 3600) % (24 * 7)
        timeb = np.zeros((B, T), np.int32)
        timeb[rows, cols] = (how * ds.time_buckets // (24 * 7)).astype(np.int64)
        lq = np.clip((lat - lat_lo) / max(lat_hi - lat_lo, 1e-9) * g, 0, g - 1).astype(np.int64)
        oq = np.clip((lon - lon_lo) / max(lon_hi - lon_lo, 1e-9) * g, 0, g - 1).astype(np.int64)
        geob = np.zeros((B, T), np.int32)
        geob[rows, cols] = lq * g + oq
        # Consecutive-checkin gaps: flat position-1 is the same row's previous
        # checkin exactly where cols > 0 (row-major concatenation).
        tgap = np.zeros((B, T), np.float64)
        dist = np.zeros((B, T), np.float64)
        inner = cols > 0
        pv = np.flatnonzero(inner) - 1
        tgap[rows[inner], cols[inner]] = ts[inner] - ts[pv]
        dist[rows[inner], cols[inner]] = haversine_km(lat[pv], lon[pv], lat[inner], lon[inner])

        ti, tf = bucketize_interp(tgap, ds.tgap_edges)
        di, df = bucketize_interp(dist, ds.dist_edges)
        return Batch(
            user=np.zeros(B, np.int32),
            poi_in=poi_in,
            poi_tgt=np.zeros((B, T), np.int32),
            mask=mask,
            time_bucket=timeb,
            geo_bucket=geob,
            tgap_idx=ti.astype(np.int32),
            tgap_frac=tf.astype(np.float32),
            dist_idx=di.astype(np.int32),
            dist_frac=df.astype(np.float32),
        )

    @torch.inference_mode()
    def recommend(
        self,
        histories: list[list[Checkin]],
        k: int = 10,
        user_ids: list[int] | None = None,
        exclude_visited: bool = True,
    ) -> np.ndarray:
        """[B, k] recommended POI ids, best first; -1 where a row has fewer
        than k unvisited POIs in the catalog."""
        batch = self._featurize(histories)
        if user_ids is not None:
            batch = batch._replace(user=np.asarray(user_ids, np.int32))
        max_hist = max(len(h) for h in histories)
        needed = k + (max_hist if exclude_visited else 0)
        # Over-fetch to the next power of two (capped at the catalog): the
        # visited filter below needs k + max_hist candidates at most.
        fetch = min(1 << (needed - 1).bit_length(), int(self._prep.table.shape[0]))
        topk_fn = make_topk_fn(self.model, self.cfg, fetch)
        ids = topk_fn(self._prep.table, self._prep.bias, batch_to(batch, self.device)).cpu().numpy()
        if self._prep.id_map is not None:
            ids = self._prep.id_map[ids]
        return self._finalize(ids, histories, k, exclude_visited)

    @staticmethod
    def _finalize(ids: np.ndarray, histories: list[list[Checkin]], k: int, exclude_visited: bool) -> np.ndarray:
        """Per-row visited filter. The over-fetch guarantees >= k unvisited
        survivors whenever the catalog has them; otherwise the short row's
        remaining slots are -1, never a repeated or visited POI."""
        if not exclude_visited:
            return ids[:, :k]
        out = np.full((len(histories), k), -1, np.int32)
        short = 0
        for b, hist in enumerate(histories):
            visited = {c.poi for c in hist}
            picked = [i for i in ids[b] if i not in visited][:k]
            short += len(picked) < k
            out[b, : len(picked)] = picked
        if short:
            log.warning(
                "%d/%d request rows have fewer than k=%d unvisited POIs in the "
                "catalog; short rows are padded with -1", short, len(histories), k,
            )
        return out
