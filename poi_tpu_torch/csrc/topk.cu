// Full-catalog score + top-k for Hopper (sm_90a): B11's mma.sync design,
// and the rule that picks between it and the wgmma design of topk_wg.cu.
//
// Replaces the TPU kernel poi_tpu/ops/topk.py:_fused_topk_kernel (driven by
// fused_topk): score bf16 queries against a bf16 [V, D] table plus an fp32
// bias with fp32 accumulation, and keep each row's k best (k <= 128), values
// descending, ties to the lower id. The [B, V] score matrix never goes to
// device memory.
//
// The TPU kernel walks the vocab tiles in order on one core and carries its
// running top-k in scratch from one grid step to the next. Blocks on this card
// run in parallel in no order, so both designs split the work into two passes:
// pass 1 cuts the catalog into slices, a block a (slice, group of query rows),
// and writes each row's best of its slice to scratch; pass 2 merges a row's
// slices. ops/topk.py's plan (topk_plan) picks the design and its launch
// shape; the C entry points (topk_fwd here, topk_wg there) only check it.
//
// The two designs, and the rule (measured on the H100 at every B11 shape
// PERF.md lists, both designs on the same inputs):
// - topk_wg.cu: wgmma m64n64k16 fed by TMA, 64 or 128 query rows a
//   block, the selection in registers, as many slices as fill the card in
//   one wave, pass 2 a block a row. It takes D >= 128, and D = 64 to 120 at
//   B <= 8: config #5's eval (512 rows, 905,216 rows of D = 512, k = 10),
//   and every batch-1 request, whose table it streams on all 132 SMs.
// - This file: mma.sync tiles, small blocks, at most 64 slices, D <= 128.
//   It keeps D < 64, and D = 64 to 120 at B > 8: config #1's serving at
//   batch 256 (a catalog of 8,192 rows), where the wgmma design's many
//   slices and merges cost more than such a catalog's products.
// Both designs sum a score's k16 steps in the same order over the same
// zero-padded width, and wgmma and mma.sync give the same bits for the same
// operands (chip_smoke.py's topk phase holds the two designs to each other's
// bits where both take a shape; they were held at 22 shapes to D = 4,096
// while this design still took every width), so a score's bits do not
// depend on the design: a mesh shard and its catalog agree whichever design
// takes each.
//
// This design (one block, for D <= 128; its narrower blocks for wider rows
// and a K-chunked pass past 1024 went, the wgmma design being faster at
// every such shape PERF.md lists):
// - scores a group of 64 query rows against each streamed table tile of 64
//   rows on the tensor cores: warp-level mma.sync m16n8k16 (bf16 products,
//   fp32 sums), each warp owning 16 query rows, the tile triple-buffered
//   with cp.async in the padded smem layout of mma_tiles.cuh (rows padded
//   by 8 bf16 so a warp's fragment loads hit 32 banks). The table is read
//   B/64 times, not B times. K is zero-padded to a multiple of 16;
// - selects per row, not per block: each row keeps its running k-th (value,
//   id); a tile's scores (written to smem) are filtered against it, and only
//   the survivors are appended to the row's own smem buffer. When the buffer
//   could overflow, and at the end, the warp that owns the row sorts it with
//   register compare-exchanges and __shfl_xor_sync (warp_sort), with no block
//   barrier, and keeps the first k;
// - cuts the catalog into as many slices as bring (row groups x slices) to
//   the SM count, with at most 64 (32 at k > 32) so that the merge pass, one
//   warp a row with the same filter and sort, stays short.
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
#include "topk_select.cuh"

namespace {

constexpr int kMaxSlices = 64;       // slices a row group, at most (ops/topk.py SLICE_MAX_SLICES)
constexpr int kMergeWarps = 4;

__host__ __device__ constexpr int pad16(int D) { return (D + 15) & ~15; }

// The block: query rows, warps, table rows a tile and cp.async stages. Every
// warp selects for 4 rows. The design takes D <= 128 (ops/topk.py's rule
// gives it D < 128 at B > 8): past 128 the wgmma design is faster at every
// width that PERF.md lists.
struct BlockShape {
  int rows, warps, tile, stages;
};
constexpr int kMaxD = 128;
constexpr BlockShape kShape{64, 16, 64, 3};

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

template <int KP>
cudaError_t run_kp(const void* q, const void* table, const void* bias, void* cand_v, void* cand_i, void* out_v,
                   void* out_i, int B, int V, int D, int k, int slices, int slice_len, cudaStream_t st) {
  return run<kShape.rows, kShape.warps, kShape.tile, kShape.stages, KP>(q, table, bias, cand_v, cand_i, out_v, out_i,
                                                                       B, V, D, k, slices, slice_len, st);
}

}  // namespace

// cand_v/cand_i: scratch [B, slices, k] (unused when slices == 1);
// out_v/out_i: [B, k]. The slices are ops/topk.py's plan (topk_plan, its
// "slice" design); this checks them.
extern "C" int topk_fwd(const void* q, const void* table, const void* bias, void* cand_v, void* cand_i,
                        void* out_v, void* out_i, int B, int V, int D, int k, int slices, int slice_len,
                        int device, void* stream) {
  if (k < 1 || k > 128 || D % 8 != 0 || D <= 0 || D > kMaxD || slices < 1 || slices > kMaxSlices ||
      slice_len % kShape.tile != 0 || (long long)slices * slice_len < V || (long long)(slices - 1) * slice_len >= V ||
      B > 65535)
    return cudaErrorInvalidValue;
  if (B <= 0) return cudaSuccess;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (list_len(k) == 32) return run_kp<32>(q, table, bias, cand_v, cand_i, out_v, out_i, B, V, D, k, slices, slice_len, st);
  return run_kp<128>(q, table, bias, cand_v, cand_i, out_v, out_i, B, V, D, k, slices, slice_len, st);
}
