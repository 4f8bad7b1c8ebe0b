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

from poi_tpu_torch.data.dataset import Dataset, bucketize_interp, haversine_km
from poi_tpu_torch.data.pipeline import Batch
from poi_tpu_torch.eval.evaluate import make_topk_fn, prepare_catalog
from poi_tpu_torch.models.base import batch_to
from poi_tpu_torch.ops.topk import MAX_K, NEG
from poi_tpu_torch.utils.config import Config

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
        if self._prep.id_map is not None:  # catalog id -> row of the prepared table
            self._kernel_row = np.empty_like(self._prep.id_map)
            self._kernel_row[self._prep.id_map] = np.arange(len(self._prep.id_map))

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
        # visited filter below needs k + max_hist candidates at most. The
        # top-k kernel takes k <= 128, so with T = 128 histories (config #4)
        # the fetch is capped there and rows left short are scored again.
        fetch = min(1 << (needed - 1).bit_length(), int(self._prep.table.shape[0]))
        if self.cfg.eval.topk_impl == "pallas":
            fetch = min(fetch, MAX_K)
        out = self._finalize(self._top_ids(batch, self._prep.bias, fetch), histories, k, exclude_visited)
        if fetch < needed:
            for b in np.flatnonzero((out == -1).any(axis=1)):
                out[b] = self._rescore_unvisited(batch, histories[b], b, k)
        short = int((out == -1).any(axis=1).sum())
        if short:
            log.warning(
                "%d/%d request rows have fewer than k=%d unvisited POIs in the "
                "catalog; short rows are padded with -1", short, len(histories), k,
            )
        return out

    def _top_ids(self, batch: Batch, bias: torch.Tensor, k: int) -> np.ndarray:
        """[B, k] catalog ids of the best-scoring POIs under ``bias``."""
        ids = make_topk_fn(self.model, self.cfg, k)(self._prep.table, bias, batch_to(batch, self.device)).cpu().numpy()
        return ids if self._prep.id_map is None else self._prep.id_map[ids]

    def _rescore_unvisited(self, batch: Batch, history: list[Checkin], b: int, k: int) -> np.ndarray:
        """Row ``b`` scored alone with its visited POIs masked out of the
        bias: the exact top-k of its unvisited POIs."""
        visited = np.fromiter({c.poi for c in history}, np.int64)
        rows = visited if self._prep.id_map is None else self._kernel_row[visited]
        bias = self._prep.bias.clone()
        bias[torch.from_numpy(rows).to(bias.device)] = NEG
        ids = self._top_ids(Batch(*(a[b:b + 1] for a in batch)), bias, k)
        return self._finalize(ids, [history], k, True)[0]

    @staticmethod
    def _finalize(ids: np.ndarray, histories: list[list[Checkin]], k: int, exclude_visited: bool) -> np.ndarray:
        """Per-row visited filter: the first k unvisited ids of each row, -1
        in the slots of a row that has fewer; never a repeated or visited
        POI."""
        if not exclude_visited:
            return ids[:, :k]
        out = np.full((len(histories), k), -1, np.int32)
        for b, hist in enumerate(histories):
            visited = {c.poi for c in hist}
            picked = [i for i in ids[b] if i not in visited][:k]
            out[b, : len(picked)] = picked
        return out
