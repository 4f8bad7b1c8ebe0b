// Full-catalog score + top-k for Hopper (sm_90a).
//
// Replaces the TPU kernel poi_tpu/ops/topk.py:_fused_topk_kernel (driven by
// fused_topk): score bf16 queries against a bf16 [V, D] table plus an fp32
// bias with fp32 accumulation, and keep each row's k best (k <= 128), values
// descending, ties to the lower id. The [B, V] score matrix never goes to
// device memory.
//
// The TPU kernel walks the vocab tiles in order on one core and carries its
// running top-k in scratch from one grid step to the next. Blocks on this card
// run in parallel in no order, so the work is split into two passes:
//   1. topk_slice_kernel, grid (slices, row groups): a block holds a group of
//      query rows (64 at D <= 256) and walks one vocab slice tile by tile;
//      it writes each row's k best (value, id) pairs of the slice to scratch
//      [B, slices, k] that the wrapper allocates;
//   2. topk_merge_kernel, one warp a row: merges a row's slices * k
//      candidates into the final k. With one slice, pass 1 writes the result
//      and pass 2 is not launched.
//
// What bounds it on this card: the scoring is B*V*D*2 FLOP and the table V*D*2
// bytes, both negligible (0.27 GFLOP and 1 MB at config #1's serve shape);
// the time goes to selection and to latency. The first version scored one
// query row a block on the CUDA cores, so it read the table from L2 once per
// query row (268 MB at B=256), and it selected with block-wide bitonic sorts,
// a __syncthreads() at each stage. This design:
// - scores a group of query rows against each streamed table tile on the
//   tensor cores: warp-level mma.sync m16n8k16 (bf16 products, fp32 sums),
//   each warp owning 16 query rows, the tile double-buffered with cp.async
//   in the padded smem layout of mma_tiles.cuh (rows padded by 8 bf16 so a
//   warp's fragment loads hit 32 banks). The table is read B/64 times, not B
//   times. The query fragments are read from smem at each k-step, so any
//   D % 8 == 0 up to 1024 fits (K is zero-padded to a multiple of 16); wider
//   rows take smaller tiles and fewer rows a block (block_shape below);
// - past D = 1024 (any multiple of kKc = 256, the wrapper's padding) a block
//   of 16 query rows and 2 stages of 32 table rows at full width would pass
//   the 227 KB a block may hold (330 KB at 2048), so topk_slice_kc_kernel
//   streams each 64-row table tile as K-chunks of 256 columns through a
//   cp.async ring: the tile's scores accumulate in the mma.sync accumulators
//   over its chunks, in the same k order as at full width, and then go
//   through the same filter and warp_sort. The query rows stay resident
//   while they fit beside a 3-stage ring (to D = 2,816), and past that
//   stream chunk by chunk with the tile on 4 stages;
// - selects per row, not per block: each row keeps its running k-th (value,
//   id); a tile's scores are filtered against it in registers, and only the
//   survivors are appended to the row's own smem buffer. When the buffer
//   could overflow, and at the end, the warp that owns the row sorts it with
//   register compare-exchanges and __shfl_xor_sync (warp_sort), with no block
//   barrier, and keeps the first k;
// - sizes the slices so that (row groups x slices) fills the 132 SMs at
//   batch 1 and 256 alike, with at most kMaxSlices so that the merge pass,
//   one warp a row with the same filter and sort, stays short.
// The order is total, (value desc, id asc), and ids are distinct, so the
// result does not depend on how the vocab is cut into slices, tiles and
// buffers: it equals a stable descending sort. Empty slots hold (-inf,
// INT_MAX) and lose to every real row, including rows padded with a -1e30
// bias. The mma sums a score in the same order wherever its table row lies
// in a tile, so two identical rows score bit for bit alike.
//
// The entry points launch on the given stream, do not synchronise and
// allocate nothing; they return cudaGetLastError() after the launch.

#include <climits>

#include "mma_tiles.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxD = 1024;         // the widest row held whole; wider ones are K-chunked
constexpr int kKc = 256;             // columns a K-chunk past kMaxD
constexpr int kSmemOptIn = 232448;   // the dynamic smem a block may opt into on an H100
constexpr int kSms = 132;            // H100 SXM
constexpr int kMaxSlices = 64;       // slices a row group, at most (32 at k > 32)
constexpr int kMinTilesPerSlice = 4;
constexpr int kSurv = 128;           // a row's buffer of survivors (pairs) between merges
constexpr int kMergeWarps = 4;

__host__ __device__ constexpr int pad16(int D) { return (D + 15) & ~15; }

// Block shape by width: query rows, warps, table rows a tile and cp.async
// stages. Every warp selects for 4 rows; 64 rows at D <= 256, the tile and
// the rows shrinking with D so that the query rows, the stages, the score
// tile and the rows' buffers fit in the 227 KB of shared memory.
struct BlockShape {
  int rows, warps, tile, stages;
};
// Past kMaxD (K-chunked): 16 rows, 4 warps, tiles of 64 rows; the stages
// are run_width's (kc_qres).
__host__ __device__ constexpr BlockShape block_shape(int D) {
  return pad16(D) <= 128    ? BlockShape{64, 16, 64, 3}
         : pad16(D) <= 256  ? BlockShape{64, 16, 32, 3}
         : pad16(D) <= 512  ? BlockShape{32, 8, 32, 2}
         : pad16(D) <= kMaxD ? BlockShape{16, 4, 32, 2}
                             : BlockShape{16, 4, 64, 0};
}

// The length of a row's sorted list: k rounded up to 32 or 128.
__host__ __device__ constexpr int list_len(int k) { return k <= 32 ? 32 : 128; }

__device__ __forceinline__ bool before(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// One compare-exchange stage of a bitonic network over the warp's 32 * E
// pairs, element i = e * 32 + lane: stride 2^lt inside blocks of 2^ls, a
// block sorted into "before" order where (i & 2^ls) == 0 (all of them when
// 2^ls spans the warp's pairs), the other way elsewhere.
template <int E>
__device__ __forceinline__ void bitonic_stage(float (&v)[E], int (&id)[E], int lane, int ls, int lt) {
  const int sz = 1 << ls, s = 1 << lt;
  if (s >= 32) {
    const int m = s / 32;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (e & m) continue;
      const int f = e | m;
      const bool fwd = ((e * 32) & sz) == 0;
      const bool sw = fwd ? before(v[f], id[f], v[e], id[e]) : before(v[e], id[e], v[f], id[f]);
      if (sw) {
        const float tv = v[e];
        const int ti = id[e];
        v[e] = v[f];
        id[e] = id[f];
        v[f] = tv;
        id[f] = ti;
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float pv = __shfl_xor_sync(kFull, v[e], s);
      const int pi = __shfl_xor_sync(kFull, id[e], s);
      const int idx = e * 32 + lane;
      const bool keep_better = ((idx & s) == 0) == ((idx & sz) == 0);
      if (before(pv, pi, v[e], id[e]) == keep_better) {
        v[e] = pv;
        id[e] = pi;
      }
    }
  }
}

template <int E>
__host__ __device__ constexpr int log2_pairs() {
  return E == 4 ? 7 : E == 2 ? 6 : 5;  // log2(32 * E)
}

// Sorts the warp's 32 * E pairs into "before" order (a bitonic sort; the
// loop counters are additive so that both loops unroll and every register
// index is a constant).
template <int E>
__device__ __forceinline__ void warp_sort(float (&v)[E], int (&id)[E], int lane) {
  constexpr int kLog = log2_pairs<E>();
#pragma unroll
  for (int ls = 1; ls <= kLog; ++ls) {
#pragma unroll
    for (int lt = ls - 1; lt >= 0; --lt) bitonic_stage<E>(v, id, lane, ls, lt);
  }
}

// A bitonic sequence of 32 * E pairs into "before" order.
template <int E>
__device__ __forceinline__ void warp_bitonic_merge(float (&v)[E], int (&id)[E], int lane) {
  constexpr int kLog = log2_pairs<E>();
#pragma unroll
  for (int lt = kLog - 1; lt >= 0; --lt) bitonic_stage<E>(v, id, lane, kLog, lt);
}

// A row's buffer: its sorted list in [0, KP), then `cnt` appended survivors.
// The warp sorts the survivors, keeps the KP best of both sorted lists (the
// better of list[i] and survivors[KP - 1 - i] is a bitonic sequence holding
// them) and sorts that back into [0, KP). Called by the whole warp.
template <int KP>
__device__ __forceinline__ void merge_row(float* bv, int* bi, int cnt, int lane) {
  constexpr int ES = kSurv / 32, EK = KP / 32;
  float sv[ES], tv[EK];
  int si[ES], ti[EK];
#pragma unroll
  for (int e = 0; e < ES; ++e) {
    const int i = e * 32 + lane;
    const bool ok = i < cnt;
    sv[e] = ok ? bv[KP + i] : -INFINITY;
    si[e] = ok ? bi[KP + i] : INT_MAX;
  }
#pragma unroll
  for (int e = 0; e < EK; ++e) {
    tv[e] = bv[e * 32 + lane];
    ti[e] = bi[e * 32 + lane];
  }
  warp_sort<ES>(sv, si, lane);
#pragma unroll
  for (int e = 0; e < EK; ++e) {
    const float pv = __shfl_sync(kFull, sv[EK - 1 - e], 31 - lane);
    const int pi = __shfl_sync(kFull, si[EK - 1 - e], 31 - lane);
    if (before(pv, pi, tv[e], ti[e])) {
      tv[e] = pv;
      ti[e] = pi;
    }
  }
  warp_bitonic_merge<EK>(tv, ti, lane);
  __syncwarp();
#pragma unroll
  for (int e = 0; e < EK; ++e) {
    bv[e * 32 + lane] = tv[e];
    bi[e * 32 + lane] = ti[e];
  }
  __syncwarp();
}

// Rows [r0, r0 + n) of a row-major [R, D] bf16 matrix into smem rows of
// stride LD, columns zero-filled from D to pad16(D) and rows past R zeroed.
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int r0, int n, int R, int D, int LD,
                                          int threads) {
  const int vec = pad16(D) / 8;
  for (int i = threadIdx.x; i < n * vec; i += threads) {
    const int r = i / vec;
    const int c = (i % vec) * 8;
    const bool ok = r0 + r < R && c < D;
    cp_async16(dst + r * LD + c, src + (ok ? (size_t)(r0 + r) * D + c : 0), ok);
  }
}

// A table tile and its bias into one cp.async stage.
__device__ __forceinline__ void load_tile_stage(bf16* t_dst, float* b_dst, const bf16* table, const float* bias,
                                                int v0, int TR, int V, int D, int LD, int threads) {
  load_rows(t_dst, table, v0, TR, V, D, LD, threads);
  for (int i = threadIdx.x; i < TR; i += threads) cp_async4(b_dst + i, bias + (v0 + i < V ? v0 + i : 0), v0 + i < V);
}

__host__ __device__ constexpr int smem_bytes(BlockShape s, int LD, int KP) {
  return (s.rows + s.stages * s.tile) * LD * 2 + s.stages * s.tile * 4 + s.rows * (s.tile + 4) * 4 +
         s.rows * (KP + kSurv) * 8;
}

// Selection of one tile's scores sc [R][SLD] (columns v0..): a score enters
// its row's buffer only if it beats the row's k-th. Each warp takes its RPW
// rows; a row's survivors are merged when the next tile might not fit.
template <int RPW, int TR, int SLD, int KP>
__device__ __forceinline__ void select_tile(const float* sc, float* buf_v, int* buf_i, float (&thr_v)[RPW],
                                            int (&thr_i)[RPW], int (&cnt)[RPW], int warp, int lane, int r0, int B,
                                            int v0, int end, int k) {
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = warp * RPW + r;
    if (r0 + row >= B) continue;  // warp-uniform
    float* bv = buf_v + row * (KP + kSurv);
    int* bi = buf_i + row * (KP + kSurv);
#pragma unroll
    for (int u = 0; u < TR / 32; ++u) {
      const int c = u * 32 + lane;
      const float s = sc[row * SLD + c];
      const bool pass = v0 + c < end && before(s, v0 + c, thr_v[r], thr_i[r]);
      const unsigned m = __ballot_sync(kFull, pass);
      if (pass) {
        const int p = KP + cnt[r] + __popc(m & ((1u << lane) - 1u));
        bv[p] = s;
        bi[p] = v0 + c;
      }
      cnt[r] += __popc(m);
    }
    if (cnt[r] > kSurv - TR) {  // the next tile might not fit
      __syncwarp();
      merge_row<KP>(bv, bi, cnt[r], lane);
      thr_v[r] = bv[k - 1];
      thr_i[r] = bi[k - 1];
      cnt[r] = 0;
    }
  }
}

// The warp's rows' last merge, and their k best of the slice to
// cand [B, slices, k].
template <int RPW, int KP>
__device__ __forceinline__ void finish_rows(float* buf_v, int* buf_i, const int (&cnt)[RPW], float* cand_v,
                                            int* cand_i, int warp, int lane, int r0, int B, int slices, int sl,
                                            int k) {
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = warp * RPW + r;
    if (r0 + row >= B) continue;
    float* bv = buf_v + row * (KP + kSurv);
    int* bi = buf_i + row * (KP + kSurv);
    if (cnt[r] > 0) {
      __syncwarp();
      merge_row<KP>(bv, bi, cnt[r], lane);
    }
    const size_t base = ((size_t)(r0 + row) * slices + sl) * k;
    for (int i = lane; i < k; i += 32) {
      cand_v[base + i] = bv[i];
      cand_i[base + i] = bi[i];
    }
  }
}

// The warp's rows' sorted lists start empty, (-inf, INT_MAX).
template <int RPW, int KP>
__device__ __forceinline__ void init_rows(float* buf_v, int* buf_i, float (&thr_v)[RPW], int (&thr_i)[RPW],
                                          int (&cnt)[RPW], int warp, int lane) {
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = warp * RPW + r;
    for (int i = lane; i < KP; i += 32) {
      buf_v[row * (KP + kSurv) + i] = -INFINITY;
      buf_i[row * (KP + kSurv) + i] = INT_MAX;
    }
    thr_v[r] = -INFINITY;
    thr_i[r] = INT_MAX;
    cnt[r] = 0;
  }
}

template <int R, int W, int TR, int ST, int KP>
__global__ void __launch_bounds__(W * 32)
    topk_slice_kernel(const bf16* __restrict__ q, const bf16* __restrict__ table, const float* __restrict__ bias,
                      float* __restrict__ cand_v, int* __restrict__ cand_i, int B, int V, int D, int k,
                      int slice_len) {
  constexpr int kThr = W * 32, RG = R / 16, CG = W / RG, CW = TR / CG, NJ = CW / 8, SLD = TR + 4;
  constexpr int RPW = R / W;  // rows each warp selects for
  static_assert(CW % 8 == 0 && RPW == 4 && TR % 32 == 0 && kSurv >= TR && kSurv >= KP, "block shape");
  const int Dp = pad16(D), LD = Dp + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);                   // [R][LD]
  bf16* t_s = q_s + R * LD;                                     // [ST][TR][LD]
  float* b_s = reinterpret_cast<float*>(t_s + ST * TR * LD);    // [ST][TR]
  float* sc = b_s + ST * TR;                                    // [R][SLD] scores of the tile
  float* buf_v = sc + R * SLD;                                  // [R][KP + kSurv]
  int* buf_i = reinterpret_cast<int*>(buf_v + R * (KP + kSurv));

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int rg = warp % RG, cg = warp / RG;
  const int sl = blockIdx.x, slices = gridDim.x;
  const int r0 = blockIdx.y * R;
  const int start = sl * slice_len, end = min(V, start + slice_len);
  const int tiles = (end - start + TR - 1) / TR;

  load_rows(q_s, q, r0, R, B, D, LD, kThr);
#pragma unroll
  for (int p = 0; p < ST - 1; ++p) {
    if (p < tiles) load_tile_stage(t_s + p * TR * LD, b_s + p * TR, table, bias, start + p * TR, TR, V, D, LD, kThr);
    cp_async_commit();
  }
  float thr_v[RPW];
  int thr_i[RPW], cnt[RPW];
  init_rows<RPW, KP>(buf_v, buf_i, thr_v, thr_i, cnt, warp, lane);

  for (int it = 0; it < tiles; ++it) {
    const int nx = it + ST - 1;
    if (nx < tiles) {
      load_tile_stage(t_s + (nx % ST) * TR * LD, b_s + (nx % ST) * TR, table, bias, start + nx * TR, TR, V, D, LD,
                      kThr);
    }
    cp_async_commit();
    cp_async_wait<ST - 1>();
    __syncthreads();  // tile it has landed; the previous tile's selection is done with sc
    const bf16* tile = t_s + (it % ST) * TR * LD;
    const float* bt = b_s + (it % ST) * TR;
    // Scores: warp (rg, cg) computes rows rg*16.. x columns cg*CW.. on the tensor cores.
    float acc[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int ks = 0; ks < Dp / 16; ++ks) {
      const bf16* pa = q_s + (rg * 16 + g) * LD + ks * 16 + 2 * t;
      const uint32_t a[4] = {ld32(pa), ld32(pa + 8 * LD), ld32(pa + 8), ld32(pa + 8 * LD + 8)};
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const bf16* pb = tile + (cg * CW + j * 8 + g) * LD + ks * 16 + 2 * t;
        mma_bf16(acc[j], a, ld32(pb), ld32(pb + 8));
      }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = cg * CW + j * 8 + 2 * t;
      float* d0 = sc + (rg * 16 + g) * SLD + c;
      float* d1 = d0 + 8 * SLD;
      d0[0] = acc[j][0] + bt[c];
      d0[1] = acc[j][1] + bt[c + 1];
      d1[0] = acc[j][2] + bt[c];
      d1[1] = acc[j][3] + bt[c + 1];
    }
    __syncthreads();  // the tile's scores are in sc; stage it % ST may be refilled

    select_tile<RPW, TR, SLD, KP>(sc, buf_v, buf_i, thr_v, thr_i, cnt, warp, lane, r0, B, start + it * TR, end, k);
  }
  finish_rows<RPW, KP>(buf_v, buf_i, cnt, cand_v, cand_i, warp, lane, r0, B, slices, sl, k);
}

// Columns [c0, c0 + kKc) of rows [r0, r0 + n) of a row-major [R, D] bf16
// matrix into smem rows of stride LDC; rows past R zeroed.
__device__ __forceinline__ void load_chunk(bf16* dst, const bf16* src, int r0, int n, int R, int D, int c0, int LDC,
                                           int threads) {
  constexpr int vec = kKc / 8;
  for (int i = threadIdx.x; i < n * vec; i += threads) {
    const int r = i / vec;
    const int c = (i % vec) * 8;
    const bool ok = r0 + r < R;
    cp_async16(dst + r * LDC + c, src + (ok ? (size_t)(r0 + r) * D + c0 + c : 0), ok);
  }
}

// The K-chunked pass 1's shared memory: the query rows (whole when qres,
// else a chunk a stage), the stages of table chunks and their tiles' bias,
// the score tile and the rows' buffers.
__host__ __device__ constexpr int kc_smem_bytes(BlockShape s, int D, int KP, bool qres) {
  return (qres ? s.rows * (D + kPad) * 2 : 0) +
         s.stages * ((s.tile + (qres ? 0 : s.rows)) * (kKc + kPad) * 2 + s.tile * 4) + s.rows * (s.tile + 4) * 4 +
         s.rows * (KP + kSurv) * 8;
}

// Past kMaxD: whether the query rows stay resident beside a ring of 3
// stages (to D = 2,816); past that they stream with the tiles on 4.
__host__ __device__ constexpr bool kc_qres(int D) {
  return kc_smem_bytes(BlockShape{16, 4, 64, 3}, D, 128, true) <= kSmemOptIn;
}

// Pass 1 past kMaxD (D a multiple of kKc): topk_slice_kernel's blocks and
// selection, each table tile arriving as D / kKc chunks of kKc columns. A
// unit is one chunk of one tile; the ring holds ST units, loaded ST - 1
// ahead. A tile's scores accumulate across its chunks, k16 steps in order
// over the whole D, then take the bias and go through select_tile.
template <int R, int W, int TR, int ST, int KP, bool QRes>
__global__ void __launch_bounds__(W * 32)
    topk_slice_kc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ table, const float* __restrict__ bias,
                         float* __restrict__ cand_v, int* __restrict__ cand_i, int B, int V, int D, int k,
                         int slice_len) {
  constexpr int kThr = W * 32, RG = R / 16, CG = W / RG, CW = TR / CG, NJ = CW / 8, SLD = TR + 4;
  constexpr int RPW = R / W, LDC = kKc + kPad;
  constexpr int QST = QRes ? 0 : R * LDC;  // a stage's query chunk
  static_assert(CW % 8 == 0 && RPW == 4 && TR % 32 == 0 && kSurv >= TR && kSurv >= KP, "block shape");
  const int LDQ = QRes ? D + kPad : LDC, nc = D / kKc;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);                          // [R][LDQ] when QRes
  bf16* t_s = q_s + (QRes ? R * LDQ : 0);                              // [ST][TR * LDC + QST]
  float* b_s = reinterpret_cast<float*>(t_s + ST * (QST + TR * LDC));  // [ST][TR]
  float* sc = b_s + ST * TR;                                           // [R][SLD] scores of the tile
  float* buf_v = sc + R * SLD;                                         // [R][KP + kSurv]
  int* buf_i = reinterpret_cast<int*>(buf_v + R * (KP + kSurv));

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int rg = warp % RG, cg = warp / RG;
  const int sl = blockIdx.x, slices = gridDim.x;
  const int r0 = blockIdx.y * R;
  const int start = sl * slice_len, end = min(V, start + slice_len);
  const int tiles = (end - start + TR - 1) / TR;
  const int units = tiles * nc;

  // Unit u into stage u % ST: the table chunk, the query chunk where the
  // rows stream, and the tile's bias with its last chunk.
  auto load_unit = [&](int u) {
    const int it = u / nc, c = u % nc, v0 = start + it * TR;
    bf16* dst = t_s + (u % ST) * (QST + TR * LDC);
    load_chunk(dst, table, v0, TR, V, D, c * kKc, LDC, kThr);
    if constexpr (!QRes) load_chunk(dst + TR * LDC, q, r0, R, B, D, c * kKc, LDC, kThr);
    if (c == nc - 1) {
      float* bd = b_s + (u % ST) * TR;
      for (int i = threadIdx.x; i < TR; i += kThr) cp_async4(bd + i, bias + (v0 + i < V ? v0 + i : 0), v0 + i < V);
    }
  };
  if constexpr (QRes) load_rows(q_s, q, r0, R, B, D, LDQ, kThr);
#pragma unroll
  for (int p = 0; p < ST - 1; ++p) {
    if (p < units) load_unit(p);
    cp_async_commit();
  }
  float thr_v[RPW];
  int thr_i[RPW], cnt[RPW];
  init_rows<RPW, KP>(buf_v, buf_i, thr_v, thr_i, cnt, warp, lane);

  float acc[NJ][4];
  for (int u = 0; u < units; ++u) {
    cp_async_wait<ST - 2>();
    __syncthreads();  // unit u has landed; every warp is done with unit u - 1's stage and with sc
    if (u + ST - 1 < units) load_unit(u + ST - 1);
    cp_async_commit();
    const int it = u / nc, c = u % nc;
    const bf16* tile = t_s + (u % ST) * (QST + TR * LDC);
    const bf16* qc = QRes ? q_s + c * kKc : tile + TR * LDC;  // this chunk's query columns
    if (c == 0) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < kKc / 16; ++ks) {
      const bf16* pa = qc + (rg * 16 + g) * LDQ + ks * 16 + 2 * t;
      const uint32_t a[4] = {ld32(pa), ld32(pa + 8 * LDQ), ld32(pa + 8), ld32(pa + 8 * LDQ + 8)};
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const bf16* pb = tile + (cg * CW + j * 8 + g) * LDC + ks * 16 + 2 * t;
        mma_bf16(acc[j], a, ld32(pb), ld32(pb + 8));
      }
    }
    if (c < nc - 1) continue;
    const float* bt = b_s + (u % ST) * TR;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = cg * CW + j * 8 + 2 * t;
      float* d0 = sc + (rg * 16 + g) * SLD + col;
      float* d1 = d0 + 8 * SLD;
      d0[0] = acc[j][0] + bt[col];
      d0[1] = acc[j][1] + bt[col + 1];
      d1[0] = acc[j][2] + bt[col];
      d1[1] = acc[j][3] + bt[col + 1];
    }
    __syncthreads();  // the tile's scores are in sc
    select_tile<RPW, TR, SLD, KP>(sc, buf_v, buf_i, thr_v, thr_i, cnt, warp, lane, r0, B, start + it * TR, end, k);
  }
  finish_rows<RPW, KP>(buf_v, buf_i, cnt, cand_v, cand_i, warp, lane, r0, B, slices, sl, k);
}

// Pass 2, one warp a row: the row's slices * k candidates, each slice's k
// sorted, through the same filter and merge. A slice's list is left at the
// first chunk of 32 whose last pair fails the row's k-th: the rest of the
// list is worse still.
template <int KP>
__global__ void __launch_bounds__(kMergeWarps * 32)
    topk_merge_kernel(const float* __restrict__ cand_v, const int* __restrict__ cand_i, float* __restrict__ out_v,
                      int* __restrict__ out_i, int B, int slices, int k) {
  __shared__ float sv[kMergeWarps][KP + kSurv];
  __shared__ int si[kMergeWarps][KP + kSurv];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * kMergeWarps + warp;
  if (b >= B) return;  // the whole warp: nothing below waits on the block
  float* bv = sv[warp];
  int* bi = si[warp];
  for (int i = lane; i < KP; i += 32) {
    bv[i] = -INFINITY;
    bi[i] = INT_MAX;
  }
  float tv = -INFINITY;
  int ti = INT_MAX, cnt = 0;
  const float* rv = cand_v + (size_t)b * slices * k;
  const int* ri = cand_i + (size_t)b * slices * k;
  // The first chunk of the next slice is loaded while this one is filtered.
  float nv = lane < k ? rv[lane] : -INFINITY;
  int ni = lane < k ? ri[lane] : INT_MAX;
  for (int sl = 0; sl < slices; ++sl) {
    const float* lv = rv + (size_t)sl * k;
    const int* li = ri + (size_t)sl * k;
    float v = nv;
    int id = ni;
    const bool more = sl + 1 < slices && lane < k;
    nv = more ? lv[k + lane] : -INFINITY;
    ni = more ? li[k + lane] : INT_MAX;
    for (int c0 = 0; c0 < k; c0 += 32) {
      if (c0 > 0) {
        const bool ok = c0 + lane < k;
        v = ok ? lv[c0 + lane] : -INFINITY;
        id = ok ? li[c0 + lane] : INT_MAX;
      }
      const bool pass = before(v, id, tv, ti);
      const unsigned m = __ballot_sync(kFull, pass);
      if (pass) {
        const int p = KP + cnt + __popc(m & ((1u << lane) - 1u));
        bv[p] = v;
        bi[p] = id;
      }
      cnt += __popc(m);
      if (cnt > kSurv - 32) {
        __syncwarp();
        merge_row<KP>(bv, bi, cnt, lane);
        tv = bv[k - 1];
        ti = bi[k - 1];
        cnt = 0;
      }
      const int last = min(32, k - c0) - 1;
      if (!((m >> last) & 1u)) break;
    }
  }
  if (cnt > 0) {
    __syncwarp();
    merge_row<KP>(bv, bi, cnt, lane);
  }
  for (int i = lane; i < k; i += 32) {
    out_v[(size_t)b * k + i] = bv[i];
    out_i[(size_t)b * k + i] = bi[i];
  }
}

template <int R, int W, int TR, int ST, int KP>
cudaError_t run(const void* q, const void* table, const void* bias, void* cand_v, void* cand_i, void* out_v,
                void* out_i, int B, int V, int D, int k, int slices, int slice_len, cudaStream_t st) {
  const int smem = smem_bytes(BlockShape{R, W, TR, ST}, pad16(D) + kPad, KP);
  auto kernel = topk_slice_kernel<R, W, TR, ST, KP>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const bool one = slices == 1;
  kernel<<<dim3(slices, (B + R - 1) / R), W * 32, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(table), static_cast<const float*>(bias),
      static_cast<float*>(one ? out_v : cand_v), static_cast<int*>(one ? out_i : cand_i), B, V, D, k, slice_len);
  e = cudaGetLastError();
  if (e != cudaSuccess || one) return e;
  topk_merge_kernel<KP><<<(B + kMergeWarps - 1) / kMergeWarps, kMergeWarps * 32, 0, st>>>(
      static_cast<const float*>(cand_v), static_cast<const int*>(cand_i), static_cast<float*>(out_v),
      static_cast<int*>(out_i), B, slices, k);
  return cudaGetLastError();
}

// Pass 1 past kMaxD (topk_slice_kc_kernel) and the merge, as run's.
template <int ST, int KP, bool QRes>
cudaError_t run_kc(const void* q, const void* table, const void* bias, void* cand_v, void* cand_i, void* out_v,
                   void* out_i, int B, int V, int D, int k, int slices, int slice_len, cudaStream_t st) {
  constexpr int R = 16, W = 4, TR = 64;
  const int smem = kc_smem_bytes(BlockShape{R, W, TR, ST}, D, KP, QRes);
  auto kernel = topk_slice_kc_kernel<R, W, TR, ST, KP, QRes>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const bool one = slices == 1;
  kernel<<<dim3(slices, (B + R - 1) / R), W * 32, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(table), static_cast<const float*>(bias),
      static_cast<float*>(one ? out_v : cand_v), static_cast<int*>(one ? out_i : cand_i), B, V, D, k, slice_len);
  e = cudaGetLastError();
  if (e != cudaSuccess || one) return e;
  topk_merge_kernel<KP><<<(B + kMergeWarps - 1) / kMergeWarps, kMergeWarps * 32, 0, st>>>(
      static_cast<const float*>(cand_v), static_cast<const int*>(cand_i), static_cast<float*>(out_v),
      static_cast<int*>(out_i), B, slices, k);
  return cudaGetLastError();
}

template <int KP>
cudaError_t run_width(const void* q, const void* table, const void* bias, void* cand_v, void* cand_i, void* out_v,
                      void* out_i, int B, int V, int D, int k, int slices, int slice_len, cudaStream_t st) {
  const BlockShape s = block_shape(D);
  if (D > kMaxD) {
    if (kc_qres(D)) return run_kc<3, KP, true>(q, table, bias, cand_v, cand_i, out_v, out_i, B, V, D, k, slices, slice_len, st);
    return run_kc<4, KP, false>(q, table, bias, cand_v, cand_i, out_v, out_i, B, V, D, k, slices, slice_len, st);
  }
  if (s.tile == 64) return run<64, 16, 64, 3, KP>(q, table, bias, cand_v, cand_i, out_v, out_i, B, V, D, k, slices, slice_len, st);
  if (s.rows == 64) return run<64, 16, 32, 3, KP>(q, table, bias, cand_v, cand_i, out_v, out_i, B, V, D, k, slices, slice_len, st);
  if (s.rows == 32) return run<32, 8, 32, 2, KP>(q, table, bias, cand_v, cand_i, out_v, out_i, B, V, D, k, slices, slice_len, st);
  return run<16, 4, 32, 2, KP>(q, table, bias, cand_v, cand_i, out_v, out_i, B, V, D, k, slices, slice_len, st);
}

}  // namespace

// How pass 1 cuts the vocab for B query rows of width D: returns the number
// of slices per row group and writes their length, a whole number of tiles.
// There are as many slices as it takes for (row groups x slices) to reach
// the SM count, with at least kMinTilesPerSlice tiles each, and at most
// kMaxSlices, or half that at k > 32: the merge warp walks every slice's
// list, and a list of 128 costs it more than a slice saves (measured on the
// H100 at batch 1: 32 slices beat 64 at k = 128, 64 beat 32 at k <= 32 over
// catalogs of 45,056 and 71,680).
extern "C" int topk_plan(int V, int k, int B, int D, int* slice_len) {
  const BlockShape s = block_shape(D);
  const int groups = B > 0 ? (B + s.rows - 1) / s.rows : 1;
  const int tiles = (V + s.tile - 1) / s.tile;
  const int most = list_len(k) == 32 ? kMaxSlices : kMaxSlices / 2;
  int want = (kSms + groups - 1) / groups;
  int cap = tiles / kMinTilesPerSlice;
  cap = cap < 1 ? 1 : (cap > most ? most : cap);
  want = want < 1 ? 1 : (want > cap ? cap : want);
  const int per_slice = (tiles + want - 1) / want;
  *slice_len = s.tile * per_slice;
  return (V + *slice_len - 1) / *slice_len;
}

// cand_v/cand_i: scratch [B, slices, k] (unused when slices == 1);
// out_v/out_i: [B, k].
extern "C" int topk_fwd(const void* q, const void* table, const void* bias, void* cand_v, void* cand_i,
                        void* out_v, void* out_i, int B, int V, int D, int k, int slices, int slice_len,
                        int device, void* stream) {
  const BlockShape s = block_shape(D);
  if (k < 1 || k > 128 || D % 8 != 0 || D <= 0 || (D > kMaxD && D % kKc != 0) || slices < 1 || slices > kMaxSlices ||
      slice_len % s.tile != 0 || (long long)slices * slice_len < V || (long long)(slices - 1) * slice_len >= V ||
      B > 65535)
    return cudaErrorInvalidValue;
  if (B <= 0) return cudaSuccess;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (list_len(k) == 32) return run_width<32>(q, table, bias, cand_v, cand_i, out_v, out_i, B, V, D, k, slices, slice_len, st);
  return run_width<128>(q, table, bias, cand_v, cand_i, out_v, out_i, B, V, D, k, slices, slice_len, st);
}
