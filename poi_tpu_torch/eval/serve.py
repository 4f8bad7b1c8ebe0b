"""Online serving: raw check-in histories → top-k POI recommendations.

Counterpart of ``poi_tpu/eval/serve.py``. ``Recommender`` featurizes new
histories exactly as the JAX package does (one flat numpy pass), runs the
scoring query and the full-catalog top-k on the model's device, and filters
already visited POIs on the host by over-fetching.

On a mesh of several ranks (``Recommender(..., mesh=...)``, every rank
makes one), the catalog stays vocab-sharded: each rank prepares its shard
(``eval.evaluate.prepare_catalog``) and the top-k is ``sharded_topk``'s.
The requests live on rank 0, the serving front end; the other ranks call
``recommend(None)`` as compute shards. Rank 0 featurizes and broadcasts the
batch, every rank scores its data rows against its shard, the candidate ids
are all-gathered over ``data``, and rank 0 filters and returns them (the
others get None). A row the capped fetch leaves short is scored again by
every rank, each masking the visited POIs of its own shard: rank 0 names
the rows and their visited ids in a broadcast.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from poi_tpu_torch.data.dataset import Dataset, bucketize_interp, haversine_km
from poi_tpu_torch.data.pipeline import Batch
from poi_tpu_torch.eval.evaluate import make_topk_fn, prepare_catalog
from poi_tpu_torch.models.base import batch_to, output_table
from poi_tpu_torch.ops.topk import MAX_K, NEG
from poi_tpu_torch.parallel import collectives as cc
from poi_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS
from poi_tpu_torch.utils.config import Config

log = logging.getLogger(__name__)


@dataclass
class Checkin:
    poi: int
    timestamp: float
    lat: float | None = None  # None → use the catalog's POI coordinates
    lon: float | None = None


class Recommender:
    def __init__(self, model, cfg: Config, dataset: Dataset, mesh=None):
        # fp32 products stay fp32 on the card (no TF32), as the reference's.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.model = model
        self.cfg = cfg
        self.ds = dataset
        self.T = dataset.max_seq_len
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self._prep = prepare_catalog(model, cfg, dataset.poi_counts, self.mesh)
        # This rank's block of the prepared catalog's id space (its shard's,
        # on a vocab-sharded mesh), and the map from catalog ids into that space.
        rows_p = self._prep.table.shape[0]
        self._local = (0 if self.mesh is None else self.mesh.index[MODEL_AXIS]) * rows_p, rows_p
        self._kernel_row = None
        if self._prep.id_map is not None:
            # Tile padding past a shard's rows maps to nothing.
            real = np.arange(len(self._prep.id_map)) % rows_p < output_table(model.embed, cfg.model)[0].shape[0]
            self._kernel_row = np.empty(int(self._prep.id_map.max()) + 1, np.int64)
            self._kernel_row[self._prep.id_map[real]] = np.flatnonzero(real)

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

    def check(self, histories: list[list[Checkin]], k: int, user_ids=None) -> Batch:
        """The request featurized, after every check that ``recommend``
        makes before any work: the top-k kernel's k, a non-empty list of
        non-empty histories, POI and user ids in the catalog, one user id a
        history. Raises ValueError. On a mesh the front end calls it before
        it announces a request, so nothing fails once the ranks have joined."""
        if self.cfg.eval.topk_impl == "pallas" and k > MAX_K:
            # The reference's top-k kernel refuses such k (poi_tpu/ops/topk.py).
            raise ValueError(f"k={k} > {MAX_K} not supported")
        if k < 0:
            raise ValueError(f"k={k} < 0")
        if not histories:
            raise ValueError("empty request: no histories")
        pois = np.fromiter((c.poi for h in histories for c in h), np.int64)
        if pois.size and (pois.min() < 0 or pois.max() >= self.ds.num_pois):
            raise ValueError(f"a POI id is outside the catalog [0, {self.ds.num_pois})")
        batch = self._featurize(histories)
        if user_ids is not None:
            user = np.asarray(user_ids, np.int32)
            if user.shape != (len(histories),):
                raise ValueError(f"user_ids length {user.size} != {len(histories)} histories")
            if self.cfg.model.use_user_embedding and (user.min() < 0 or user.max() >= self.ds.num_users):
                raise ValueError(f"a user id is outside [0, {self.ds.num_users})")
            batch = batch._replace(user=user)
        return batch

    def _fetch(self, histories: list[list[Checkin]], k: int, exclude_visited: bool) -> tuple[int, int]:
        """(fetch, needed): the visited filter needs k + the longest history
        candidates at most; fetch over-fetches to the next power of two,
        capped at the (shard's) catalog and, on the kernel path, at the
        top-k kernel's 128, so with long histories rows can come up short."""
        needed = k + (max(len(h) for h in histories) if exclude_visited else 0)
        fetch = min(1 << (needed - 1).bit_length(), int(self._prep.table.shape[0]))
        if self.cfg.eval.topk_impl == "pallas":
            fetch = min(fetch, MAX_K)
        return fetch, needed

    @torch.inference_mode()
    def recommend(
        self,
        histories: list[list[Checkin]] | None,
        k: int = 10,
        user_ids: list[int] | None = None,
        exclude_visited: bool = True,
        batch: Batch | None = None,
    ) -> np.ndarray | None:
        """[B, k] recommended POI ids, best first; -1 where a row has fewer
        than k unvisited POIs in the catalog. ``batch``: the request as
        ``check`` featurized it, when the caller has it. On a mesh, rank 0
        passes the request and gets the ids; the other ranks pass None and
        get None."""
        if self.mesh is not None:
            return self._recommend_multiproc(histories, k, user_ids, exclude_visited, batch)
        if batch is None:
            batch = self.check(histories, k, user_ids)
        fetch, needed = self._fetch(histories, k, exclude_visited)
        dev = batch_to(batch, self.device)
        out = self._finalize(self._top_ids(dev, self._prep.bias, fetch), histories, k, exclude_visited)
        if fetch < needed:
            self._rescore_short(out, dev, histories, k)
        return self._warn_short(out, k)

    def _recommend_multiproc(self, histories, k, user_ids, exclude_visited, batch) -> np.ndarray | None:
        """``recommend`` on the mesh (reference ``_recommend_multiproc``):
        rank 0 checks and featurizes the request and broadcasts its shape
        and batch; each rank scores its data rows against its shard; the
        ids are gathered over ``data``; rank 0 filters them. The short rows
        (only when the fetch was capped) are named by rank 0 and scored
        again by every rank."""
        mesh, dev = self.mesh, self.device
        primary = mesh.rank == 0
        meta = None
        if primary:
            if histories is None:
                raise ValueError("rank 0 must supply the request histories")
            if batch is None:
                batch = self.check(histories, k, user_ids)
            fetch, needed = self._fetch(histories, k, exclude_visited)
            n_req = len(histories)
            d = mesh.shape[DATA_AXIS]
            pad_to = -(-(1 << (n_req - 1).bit_length()) // d) * d
            batch = Batch(*(np.concatenate([a, np.repeat(a[:1], pad_to - n_req, axis=0)]) for a in batch))
            meta = np.array([n_req, pad_to, fetch, k, fetch < needed])
        n_req, pad_to, fetch, k, may_be_short = (int(v) for v in self._broadcast_ids(meta))
        dev_batch = self._broadcast_batch(batch_to(batch if primary else self._zero_batch(pad_to), dev))
        rows = mesh.rows(pad_to, DATA_AXIS)
        ids = self._top_ids(Batch(*(t[rows] for t in dev_batch)), self._prep.bias, fetch)
        out = self._finalize(ids[:n_req], histories, k, exclude_visited) if primary else None
        if may_be_short:
            self._rescore_short(out, dev_batch, histories, k)
        return self._warn_short(out, k) if primary else None

    def _broadcast_ids(self, a: np.ndarray | None) -> np.ndarray:
        """Rank 0's 1-D integer array ``a`` (the others pass None) on every
        rank."""
        n = torch.tensor([0 if a is None else len(a)], device=self.device)
        dist.broadcast(n, 0)
        t = (torch.from_numpy(np.asarray(a, np.int64)).to(self.device) if self.mesh.rank == 0
             else torch.empty(int(n), dtype=torch.int64, device=self.device))
        if t.numel():
            dist.broadcast(t, 0)
        return t.cpu().numpy()

    @staticmethod
    def _broadcast_batch(batch: Batch) -> Batch:
        """Rank 0's batch into every rank's tensors of its shapes, in one
        broadcast a dtype (in one order on every rank)."""
        for dtype in sorted({t.dtype for t in batch}, key=str):
            part = [t for t in batch if t.dtype == dtype]
            flat = torch.cat([t.reshape(-1) for t in part])
            dist.broadcast(flat, 0)
            at = 0
            for t in part:
                t.copy_(flat[at:at + t.numel()].view_as(t))
                at += t.numel()
        return batch

    def _zero_batch(self, B: int) -> Batch:
        """A batch of ``B`` rows of zeros with the featurized dtypes: a
        compute shard's buffers for rank 0's broadcast."""
        floats = ("mask", "tgap_frac", "dist_frac")
        return Batch(user=np.zeros(B, np.int32), **{f: np.zeros((B, self.T), np.float32 if f in floats else np.int32)
                                                    for f in Batch._fields[1:]})

    def _top_ids(self, batch: Batch, bias: torch.Tensor, k: int) -> np.ndarray:
        """[B, k] catalog ids of the best-scoring POIs under ``bias`` for the
        rows of ``batch`` (tensors on the device); on a mesh this data
        rank's rows, and the ids of every data rank's rows come back."""
        ids = make_topk_fn(self.model, self.cfg, k, self.mesh)(self._prep.table, bias, batch)
        if self.mesh is not None and self.mesh.shape[DATA_AXIS] > 1:
            ids = cc.all_gather(ids, self.mesh, DATA_AXIS)
        ids = ids.cpu().numpy()
        return ids if self._prep.id_map is None else self._prep.id_map[ids]

    def _rescore_short(self, out: np.ndarray | None, batch: Batch, histories, k: int) -> None:
        """Each row of ``out`` that the capped fetch left short, scored again
        alone with its visited POIs masked out of the bias: the exact top-k
        of its unvisited POIs, in place. On a mesh every rank joins each
        row's scoring: rank 0 names the rows and their visited ids (the
        others pass ``out`` and ``histories`` None)."""
        short = None if out is None else np.flatnonzero((out == -1).any(axis=1))
        if self.mesh is not None:
            short = self._broadcast_ids(short)
        for b in short:
            visited = None if histories is None else _visited(histories[b])
            if self.mesh is not None:
                visited = self._broadcast_ids(visited)
            row = self._rescore_unvisited(batch, int(b), visited, k)
            if out is not None:
                out[b] = self._finalize(row[None], [histories[b]], k, True)[0]

    def _rescore_unvisited(self, batch: Batch, b: int, visited: np.ndarray, k: int) -> np.ndarray:
        """``[k]`` catalog ids of row ``b`` of ``batch`` (device tensors)
        under the bias with the ``visited`` catalog ids masked, each rank
        masking those its shard holds."""
        rows = visited if self._kernel_row is None else self._kernel_row[visited]
        lo, n = self._local
        rows = rows[(rows >= lo) & (rows < lo + n)] - lo
        bias = self._prep.bias.clone()
        bias[torch.from_numpy(rows).to(bias.device)] = NEG
        return self._top_ids(Batch(*(t[b:b + 1] for t in batch)), bias, k)[0]  # every data rank: the same row

    @staticmethod
    def _warn_short(out: np.ndarray, k: int) -> np.ndarray:
        short = int((out == -1).any(axis=1).sum())
        if short:
            log.warning(
                "%d/%d request rows have fewer than k=%d unvisited POIs in the "
                "catalog; short rows are padded with -1", short, len(out), k,
            )
        return out

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


def _visited(history: list[Checkin]) -> np.ndarray:
    """The distinct POI ids of a history."""
    return np.fromiter({c.poi for c in history}, np.int64)
