// Sampled softmax over one negative pool shared by every row, for Hopper
// (sm_90a): the pool log-sum-exp (B9) and its backward (B10).
//
// Replaces the TPU kernels poi_tpu/ops/fused_sampled.py:_lse_kernel (driven
// by _forward) and :_bwd_kernel (driven by _bwd).
//
// Contract (the same arithmetic as the TPU kernels):
//   q    [N, D] bf16   queries, already rounded
//   e    [S, D] bf16   the pool's embeddings, already rounded
//   b    [S]    fp32   the pool's biases, logQ correction applied
//   ids  [S]    int32  the pool's POI ids;  tgt [N] int32 the rows' targets
//   z[n, s] = q[n] . e[s] + b[s] (exact bf16 products, fp32 sums), replaced
//   by -1e30 where ids[s] == tgt[n] (an accidental hit)
//   sampled_lse: lse [N] fp32 = log sum_s exp(z[n, s])
//   sampled_bwd: given lse_tot [N] (the total LSE, positive column included)
//     and g [N]: gp = exp(z - lse_tot[n]) * g[n] in fp32, gpb = bf16(gp)
//     dq [N, D] = gpb . e;  de [S, D] = gpb^T . q;  db [S] = colsum(gp)
//     (the unrounded gp). A hit gets gp = 0 exactly, and so does a padded
//     pool entry (bias -1e30, id -1).
//   The positive column and its gradient stay outside, as on the TPU.
//   D is 64, 128 or 256.
//
// B9, sampled_lse_kernel (tile code shared with ce.cu through
// mma_tiles.cuh): row blocks of 64 stream the pool in double-buffered tiles
// of 64 (cp.async) on warp-level mma.sync, the resident rows' A fragments
// read from shared memory at every tile, with a running max and sum a row.
//
// B10, the backward. What bounds it on this card: its products, 6*N*S*D
// FLOPs for the function (at config #4's N = 8,192, S = 1,024, D = 256:
// 12.9 GFLOP, 13 us at the tensor cores' 989 TFLOP/s), far above its bytes.
// The first design recomputed the logits for every 128 output columns
// (~12*N*S*D in all), on mma.sync with A re-read from shared memory and B as
// scalar loads, four warps that each loaded and computed, and wrote 16 MB of
// dE partials for a separate reduce.
//
// Design: csrc/ce_bwd.cu's two warp-specialised passes (B8, the same
// function but for the hit mask), copied here rather than shared, because
// the mask's extra streamed vectors, the logits' A operand (from shared
// memory here, in registers there) and D = 256 change every function of
// ce_bwd_pass; B8 keeps its code, its arithmetic and its times:
// - the dq pass (sampled_dq_pass): resident blocks of 128 query rows (with
//   their lse, g and target) stream the pool, each tile with its bias and ids;
// - the dE pass (sampled_de_pass): resident blocks of 128 pool rows (with
//   their bias and id) stream the queries, each tile with their lse, g and
//   targets, and also sum db.
// The logits are computed once a pass: 8*N*S*D operations in all.
// A block is two consumer warpgroups, each owning 64 resident rows, and one
// producer warpgroup, whose registers go to the consumers (setmaxnreg). One
// producer thread starts TMA loads of the resident rows once, then of the
// 64-row streamed tiles and their vectors into a ring of kStages smem stages
// on mbarriers (full: the bytes arrived; empty: all 256 consumer threads are
// done with the stage). Rows arrive as D * 2 / 128 boxes of 128 bytes a row,
// 128-byte swizzled as wgmma's descriptors read them. For each tile a
// consumer warpgroup
//   1. computes its 64 x 64 logits with wgmma m64n64k16, A (its resident
//      rows) and B (the tile) both K-major in shared memory: at D = 256 a
//      thread's [64, 256] fp32 output sums take 128 registers, and the
//      resident rows' fragments (64 more, where B8 keeps them) would not fit
//      beside them;
//   2. forms gp in registers: __expf, and a select to 0 for a hit, a ragged
//      row or column (no branch);
//   3. rounds gp to bf16 straight into wgmma A fragments (the fp32
//      accumulator layout of m64nN is the A layout of the next k16 step) and
//      multiplies them by the SAME smem tile read MN-major (the transpose
//      bit), in products of at most 128 columns, into its [64, D] fp32 sums.
// One logits buffer a warpgroup: the other warpgroup's products run while
// this one forms gp.
// Where the resident blocks cannot fill the card (config #4: 64 row blocks
// in the dq pass, 8 pool blocks in the dE pass), the streamed dimension is
// split S ways (fill_splits, wgmma_tiles.cuh) into fp32 partials [S, rows,
// D] (and [S, rows] for db) in the caller's scratch, and sum_splits adds
// them in split order. No atomics: every output element is summed by one
// thread in one fixed order, so a run gives the same bits every time.
// chip_smoke.py times the rule's splits against others by device time
// (`sampled_bwd splits`; the C entry takes the splits to force). At config
// #4's shape the rule's (dq 2, dE 16) took 0.0766 ms: dq pass 0.0235, dE
// pass 0.0232, the sums 0.0181 (H100, 700 W). One dq range tied it (0.0763:
// its pass 0.0337 on 64 blocks, half the sums); 4 dq ranges took 0.1030,
// and dE in 4, 8 or 32 ranges 0.1115, 0.0858, 0.0924.
// ptxas serialises the wgmma of the D = 64 and 128 instantiations (C7515:
// non-wgmma instructions define accumulator registers inside a stage), not
// of D = 256, the one config #4 runs.
//
// The entry points launch on the given stream, do not synchronise and
// allocate nothing; each returns cudaGetLastError() after its launches.

#include "mma_tiles.cuh"
#include "wgmma_tiles.cuh"

namespace {

template <int D>
constexpr int smem_bytes() {
  return 3 * kTile * (D + kPad) * 2;  // the resident tile and two streamed ones
}

// tile_logits with the resident rows' A fragments read from a smem tile.
template <int D>
__device__ __forceinline__ void tile_logits_smem(float (&acc)[8][4], const bf16* res, int row0, const bf16* tile,
                                                 int g, int t) {
  constexpr int LD = D + kPad;
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll 4
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t a[4];
    load_a<LD>(a, res, row0, ks * 16, g, t);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bf16* p = tile + (j * 8 + g) * LD + ks * 16 + 2 * t;
      mma_bf16(acc[j], a, ld32(p), ld32(p + 8));
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    sampled_lse_kernel(const bf16* __restrict__ q, const bf16* __restrict__ e, const float* __restrict__ b,
                       const int* __restrict__ ids, const int* __restrict__ tgt, float* __restrict__ lse, int N,
                       int S) {
  constexpr int LD = D + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* res_s = reinterpret_cast<bf16*>(smem);  // [kTile][LD] query rows
  bf16* str_s = res_s + kTile * LD;             // [2][kTile][LD] pool tiles
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * kTile;
  const int row0 = n0 + warp * 16 + g;

  load_tile<D>(res_s, q, n0, N);
  load_tile<D>(str_s, e, 0, S);
  cp_async_commit();
  int row_tgt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) row_tgt[r] = row0 + 8 * r < N ? tgt[row0 + 8 * r] : -1;

  float m[2] = {kNegInit, kNegInit}, l[2] = {0.f, 0.f};
  const int tiles = (S + kTile - 1) / kTile;
  for (int it = 0; it < tiles; ++it) {
    if (it + 1 < tiles) load_tile<D>(str_s + ((it + 1) & 1) * kTile * LD, e, (it + 1) * kTile, S);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    float acc[8][4];
    tile_logits_smem<D>(acc, res_s, warp * 16, str_s + (it & 1) * kTile * LD, g, t);
    const int s0 = it * kTile;
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = s0 + j * 8 + 2 * t + c;
        const bool ok = col < S;
        const float bb = ok ? __ldg(b + col) : 0.f;
        const int id = ok ? __ldg(ids + col) : -1;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float x = ok ? (id == row_tgt[r] ? kNegInit : acc[j][2 * r + c] + bb) : -INFINITY;
          acc[j][2 * r + c] = x;
          tmax[r] = fmaxf(tmax[r], x);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], tmax[r]);
      float s = l[r] * __expf(m[r] - mn);
#pragma unroll
      for (int j = 0; j < 8; ++j) s += __expf(acc[j][2 * r] - mn) + __expf(acc[j][2 * r + 1] - mn);
      m[r] = mn;
      l[r] = s;
    }
    __syncthreads();  // every warp is done with this buffer before the next load overwrites it
  }
  // The four threads of a quad hold the same two rows over disjoint columns.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], off);
      const float mn = fmaxf(m[r], mo);
      l[r] = l[r] * __expf(m[r] - mn) + lo * __expf(mo - mn);
      m[r] = mn;
    }
  }
  if (t == 0) {
    if (row0 < N) lse[row0] = m[0] + logf(l[0]);
    if (row0 + 8 < N) lse[row0 + 8] = m[1] + logf(l[1]);
  }
}

template <int D>
cudaError_t run_lse(const void* q, const void* e, const void* b, const void* ids, const void* tgt, void* lse, int N,
                    int S, cudaStream_t s) {
  constexpr int smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(sampled_lse_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  sampled_lse_kernel<D><<<(N + kTile - 1) / kTile, kThreads, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(e), static_cast<const float*>(b),
      static_cast<const int*>(ids), static_cast<const int*>(tgt), static_cast<float*>(lse), N, S);
  return cudaGetLastError();
}


// ---------------------------------------------------------------- backward

constexpr int kRes = 128;          // resident rows a block: two consumer warpgroups of 64
constexpr int kStr = 64;           // rows of a streamed tile
constexpr int kStages = 4;         // smem ring of streamed tiles
constexpr int kBwdThreads = 384;   // 2 consumer warpgroups + 1 producer warpgroup
constexpr int kSw = 128;           // bytes a swizzled smem row: every width takes the 128-byte swizzle
constexpr int kSwCols = kSw / 2;   // bf16 columns a box (a "chunk")
constexpr int kKPerChunk = kSw / 32;  // k16 steps a chunk

// Streamed 4-byte vectors that arrive with each tile: the dq pass needs the
// pool rows' bias and ids, the dE pass the queries' lse, g and targets.
template <bool kDe>
__host__ __device__ constexpr int stream_vecs() {
  return kDe ? 3 : 2;
}

template <int D, bool kDe>
constexpr int pass_smem_bytes() {
  // 1024: room to align the base; the stages' vectors; the barriers.
  return 1024 + (kRes + kStages * kStr) * D * 2 + kStages * stream_vecs<kDe>() * kStr * 4 + (2 * kStages + 1) * 8;
}

// wgmma_ss<64> that overwrites d (scale-d false) and takes no input from
// it, so the previous tile's gp in those registers is dead once it is
// rounded into A fragments: no copies of it around the loop, which ptxas
// would have to place inside the next product's stage (and then serialise
// every wgmma of the kernel).
__device__ __forceinline__ void wgmma_ss64_first(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "n"(0));
}

// The 64 x 64 logits of the warpgroup's resident rows (at `res`, their
// first row) against a streamed tile, A and B K-major in smem. Starts and
// commits; the caller waits.
template <int D>
__device__ __forceinline__ void pool_logits(float (&s)[32], uint32_t res, uint32_t tile) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const uint32_t k_off = (ks % kKPerChunk) * 32;
    const uint64_t da = smem_desc(res + (ks / kKPerChunk) * kRes * kSw + k_off, 16, 8 * kSw, kSw);
    const uint64_t db = smem_desc(tile + (ks / kKPerChunk) * kStr * kSw + k_off, 16, 8 * kSw, kSw);
    if (ks == 0) {
      wgmma_ss64_first(s, da, db);
    } else {
      wgmma_ss<64>(s, da, db, 1);
    }
  }
  wgmma_commit();
}

// gp of the tile from its logits `s` (waited for), in place: (row r of the
// thread, column c of the tile) is s[4 (c / 8) + 2 r + c % 2]. dq pass: vec =
// the pool rows' bias, ids; ra, rb, rid = the resident queries' lse, g,
// target. dE pass: vec = the queries' lse, g, target; ra, rid = the resident
// pool rows' bias, id; db sums gp a resident row. keep: the column is below
// n_str, the row is below n_res, and the two ids differ.
template <bool kDe>
__device__ __forceinline__ void tile_gp(float (&s)[32], float (&db)[2], const float* vec, int c0, int n_str,
                                        const bool (&ok)[2], const float (&ra)[2], const float (&rb)[2],
                                        const int (&rid)[2], int t) {
  const int* vid = reinterpret_cast<const int*>(vec + (kDe ? 2 : 1) * kStr);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = j * 8 + 2 * t + e;
      const bool okc = c0 + c < n_str;
      const int id = vid[c];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float& x = s[j * 4 + 2 * r + e];
        const bool keep = okc & ok[r] & (id != rid[r]);
        if constexpr (kDe) {
          const float gp = __expf(x + ra[r] - vec[c]) * vec[kStr + c];
          x = keep ? gp : 0.f;
          db[r] += x;
        } else {
          const float gp = __expf(x + vec[c] - ra[r]) * rb[r];
          x = keep ? gp : 0.f;
        }
      }
    }
  }
}

// acc[64 x D] += bf16(gp)[64 x 64] . tile[64 x D]: gp rounded into A
// fragments, the tile read MN-major, in products of NP <= 128 columns (the
// chunks of 64 columns lie kStr * kSw bytes apart). Starts and commits.
template <int D>
__device__ __forceinline__ void gp_product(float (&acc)[D > 128 ? 2 : 1][(D > 128 ? 128 : D) / 2],
                                           const float (&s)[32], uint32_t tile) {
  constexpr int NP = D > 128 ? 128 : D, NH = D / NP;
  uint32_t a[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    a[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    a[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    a[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
#pragma unroll
  for (int h = 0; h < NH; ++h) fence_regs(acc[h]);
  wgmma_fence();
#pragma unroll
  for (int h = 0; h < NH; ++h) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs<NP, 1>(acc[h], a[kk],
                      smem_desc(tile + h * (NP / kSwCols) * kStr * kSw + kk * 16 * kSw, kStr * kSw, 8 * kSw, kSw), 1);
    }
  }
  wgmma_commit();
}

// One pass. kDe false: the dq pass (resident = queries, streamed = pool,
// out = dq); true: the dE pass (resident = pool rows, streamed = queries,
// out = de, and db). With S splits (gridDim.y), split s writes its partial
// sums at out + s * n_res * D and db + s * n_res. row_a / row_b / row_id:
// per resident row, the dq pass's lse, g and target, the dE pass's bias,
// (unused) and id.
template <int D, bool kDe>
__device__ __forceinline__ void bwd_pass(const CUtensorMap* res_map, const CUtensorMap* str_map,
                                         const CUtensorMap* vec_maps, const float* __restrict__ row_a,
                                         const float* __restrict__ row_b, const int* __restrict__ row_id,
                                         float* __restrict__ out, float* __restrict__ db_out, int n_res, int n_str,
                                         int tiles_per_split) {
  constexpr int NCH = D / kSwCols, NV = stream_vecs<kDe>();
  constexpr int NP = D > 128 ? 128 : D, NH = D / NP;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* res_s = base;                                     // [NCH][kRes][kSw bytes]
  unsigned char* str_s = base + kRes * D * 2;                      // [kStages][NCH][kStr][kSw bytes]
  float* vec_s = reinterpret_cast<float*>(str_s + kStages * kStr * D * 2);  // [kStages][NV][kStr]
  uint64_t* full = reinterpret_cast<uint64_t*>(vec_s + kStages * NV * kStr);
  uint64_t* empty = full + kStages;
  uint64_t* res_full = empty + kStages;

  const int r0 = blockIdx.x * kRes;
  const int split = blockIdx.y;
  const int n_tiles = (n_str + kStr - 1) / kStr;
  const int t0 = split * tiles_per_split, t1 = min(n_tiles, t0 + tiles_per_split);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);  // every consumer thread
    }
    mbar_init(res_full, 1);
    mbar_init_fence();
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp >= 8) {  // the producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 8 && lane == 0) {
      mbar_arrive_expect_tx(res_full, kRes * D * 2);
      for (int c = 0; c < NCH; ++c) tma_load_2d(res_s + c * kRes * kSw, res_map, c * kSwCols, r0, res_full);
      int st = 0;
      uint32_t ph = 0;
      for (int it = t0; it < t1; ++it) {
        mbar_wait(&empty[st], ph ^ 1);
        mbar_arrive_expect_tx(&full[st], kStr * D * 2 + NV * kStr * 4);
        for (int c = 0; c < NCH; ++c) {
          tma_load_2d(str_s + (st * NCH + c) * kStr * kSw, str_map, c * kSwCols, it * kStr, &full[st]);
        }
        for (int v = 0; v < NV; ++v) tma_load_1d(vec_s + (st * NV + v) * kStr, &vec_maps[v], it * kStr, &full[st]);
        if (++st == kStages) {
          st = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // 232 registers a consumer thread (the launch gives 168): at D = 256 the
  // [64, 256] output sums, the logits and gp's A fragments.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  // Consumers: warpgroup wg owns resident rows [wg * 64, wg * 64 + 64); each
  // thread holds rows g and g + 8 of its warp's 16 in the accumulators.
  const int wg = warp / 4, wi = warp % 4, g = lane / 4, t = lane % 4;
  int row[2], rid[2];
  bool ok[2];
  float ra[2], rb[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row[r] = r0 + wg * 64 + wi * 16 + g + 8 * r;
    ok[r] = row[r] < n_res;
    ra[r] = ok[r] ? row_a[row[r]] : 0.f;
    rb[r] = ok[r] && !kDe ? row_b[row[r]] : 0.f;
    rid[r] = ok[r] ? row_id[row[r]] : -1;
  }
  float acc[NH][NP / 2];
#pragma unroll
  for (int h = 0; h < NH; ++h) {
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) acc[h][i] = 0.f;
  }
  float db[2] = {0.f, 0.f};
  float s[32];
  const uint32_t res_addr = smem_u32(res_s) + wg * 64 * kSw, str_addr = smem_u32(str_s);
  mbar_wait(res_full, 0);

  // A tile: its logits on the tensor cores, then (once they and the previous
  // tile's product are done) the previous tile's stage released, gp, and
  // this tile's product started; it runs while the next tile's logits are
  // started behind it.
  for (int it = t0; it < t1; ++it) {
    const int k = it - t0, st = k % kStages;
    const uint32_t tile = str_addr + st * NCH * kStr * kSw;
    mbar_wait(&full[st], (k / kStages) & 1);
    pool_logits<D>(s, res_addr, tile);
    wgmma_wait<0>();
    fence_regs(s);
#pragma unroll
    for (int h = 0; h < NH; ++h) fence_regs(acc[h]);
    if (k > 0) {
      // The previous tile's vectors, read by generic loads, before the next bulk write into its stage.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(&empty[(st + kStages - 1) % kStages]);
    }
    tile_gp<kDe>(s, db, vec_s + st * NV * kStr, it * kStr, n_str, ok, ra, rb, rid, t);
    gp_product<D>(acc, s, tile);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int h = 0; h < NH; ++h) fence_regs(acc[h]);

  float* dst0 = out + (size_t)split * n_res * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if constexpr (kDe) {
      db[r] += __shfl_xor_sync(0xffffffffu, db[r], 1);
      db[r] += __shfl_xor_sync(0xffffffffu, db[r], 2);
      if (ok[r] && t == 0) db_out[(size_t)split * n_res + row[r]] = db[r];
    }
    if (!ok[r]) continue;
    float* dst = dst0 + (size_t)row[r] * D + 2 * t;
#pragma unroll
    for (int h = 0; h < NH; ++h) {
#pragma unroll
      for (int j = 0; j < NP / 8; ++j) {
        const float2 v = make_float2(acc[h][j * 4 + 2 * r], acc[h][j * 4 + 2 * r + 1]);
        *reinterpret_cast<float2*>(dst + h * NP + j * 8) = v;
      }
    }
  }
}

// The two passes as kernels of their own names (the profiler tells them
// apart). vec_maps: the streamed vectors' tensor maps, in stream_vecs' order.
struct VecMaps {
  CUtensorMap m[3];
};

template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
    sampled_dq_pass(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap e_map,
                    const __grid_constant__ VecMaps vecs, const float* __restrict__ lse, const float* __restrict__ g,
                    const int* __restrict__ tgt, float* __restrict__ dq, int N, int S, int tiles_per_split) {
  bwd_pass<D, false>(&q_map, &e_map, vecs.m, lse, g, tgt, dq, nullptr, N, S, tiles_per_split);
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
    sampled_de_pass(const __grid_constant__ CUtensorMap e_map, const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ VecMaps vecs, const float* __restrict__ b, const int* __restrict__ ids,
                    float* __restrict__ de, float* __restrict__ db, int S, int N, int tiles_per_split) {
  bwd_pass<D, true>(&e_map, &q_map, vecs.m, b, nullptr, ids, de, db, S, N, tiles_per_split);
}

// The ranges a pass splits its streamed tiles into: the rule (fill_splits)
// when forced <= 0, else `forced` as far as the tiles allow; *per is the
// tiles a range.
int pass_splits(int n_res, int n_str, int forced, int* per) {
  const int tiles = (n_str + kStr - 1) / kStr;
  if (forced <= 0) return fill_splits((n_res + kRes - 1) / kRes, tiles, per);
  const int S = forced < tiles ? forced : tiles;
  *per = (tiles + S - 1) / S;
  return (tiles + *per - 1) / *per;
}

// Scratch floats a pass needs for its partials (0 when it does not split).
long long pass_scratch(int n_res, int n_str, int D, bool de, int forced) {
  int per = 0;
  const int S = pass_splits(n_res, n_str, forced, &per);
  return S > 1 ? (long long)S * n_res * (D + (de ? 1 : 0)) : 0;
}

template <int D>
cudaError_t run_bwd(const void* q, const void* e, const void* b, const void* ids, const void* tgt, const void* lse,
                    const void* g, void* dq, void* de, void* db, void* scratch, int N, int S, int dq_forced,
                    int de_forced, cudaStream_t s) {
  CUtensorMap q_res, q_str, e_res, e_str;
  VecMaps pool_vecs, query_vecs;  // the dq pass's streamed bias, ids; the dE pass's lse, g, tgt
  // The int32 ids and targets travel as 4-byte elements under an fp32 map (TMA copies bits).
  if (!make_map(&q_res, q, N, D, kRes) || !make_map(&q_str, q, N, D, kStr) || !make_map(&e_res, e, S, D, kRes) ||
      !make_map(&e_str, e, S, D, kStr) || !make_vec_map(&pool_vecs.m[0], static_cast<const float*>(b), S, kStr) ||
      !make_vec_map(&pool_vecs.m[1], static_cast<const float*>(ids), S, kStr) ||
      !make_vec_map(&query_vecs.m[0], static_cast<const float*>(lse), N, kStr) ||
      !make_vec_map(&query_vecs.m[1], static_cast<const float*>(g), N, kStr) ||
      !make_vec_map(&query_vecs.m[2], static_cast<const float*>(tgt), N, kStr)) {
    return cudaErrorInvalidValue;
  }
  pool_vecs.m[2] = pool_vecs.m[1];  // unused by the dq pass
  float* sc = static_cast<float*>(scratch);
  const float* l = static_cast<const float*>(lse);
  const float* gg = static_cast<const float*>(g);
  const int* ti = static_cast<const int*>(tgt);
  const float* bb = static_cast<const float*>(b);
  const int* ii = static_cast<const int*>(ids);

  // dq: resident queries, streamed pool.
  int per = 0;
  int splits = pass_splits(N, S, dq_forced, &per);
  constexpr int dq_smem = pass_smem_bytes<D, false>();
  cudaError_t err = cudaFuncSetAttribute(sampled_dq_pass<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem);
  if (err != cudaSuccess) return err;
  float* o = splits > 1 ? sc : static_cast<float*>(dq);
  sampled_dq_pass<D><<<dim3((N + kRes - 1) / kRes, splits), kBwdThreads, dq_smem, s>>>(q_res, e_str, pool_vecs, l, gg,
                                                                                        ti, o, N, S, per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (splits > 1) {
    sum_splits<<<2 * kSms, 256, 0, s>>>(o, static_cast<float*>(dq), (long long)N * D, splits);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  sc += pass_scratch(N, S, D, false, dq_forced);

  // dE and db: resident pool rows, streamed queries.
  splits = pass_splits(S, N, de_forced, &per);
  constexpr int de_smem = pass_smem_bytes<D, true>();
  err = cudaFuncSetAttribute(sampled_de_pass<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, de_smem);
  if (err != cudaSuccess) return err;
  o = splits > 1 ? sc : static_cast<float*>(de);
  float* ob = splits > 1 ? sc + (size_t)splits * S * D : static_cast<float*>(db);
  sampled_de_pass<D><<<dim3((S + kRes - 1) / kRes, splits), kBwdThreads, de_smem, s>>>(e_res, q_str, query_vecs, bb,
                                                                                        ii, o, ob, S, N, per);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  sum_splits<<<2 * kSms, 256, 0, s>>>(o, static_cast<float*>(de), (long long)S * D, splits);
  sum_splits<<<2 * kSms, 256, 0, s>>>(ob, static_cast<float*>(db), S, splits);
  return cudaGetLastError();
}

}  // namespace

// The widths the kernels are built for; the wrapper checks D against it.
extern "C" int sampled_supports_dim(int D) { return D == 64 || D == 128 || D == 256; }

// Floats of scratch sampled_bwd needs for split partials (0: pass any
// pointer). dq_splits / de_splits: as for sampled_bwd.
extern "C" int sampled_bwd_scratch(int N, int S, int D, int dq_splits, int de_splits) {
  if (N <= 0 || S <= 0 || !sampled_supports_dim(D)) return 0;
  return static_cast<int>(pass_scratch(N, S, D, false, dq_splits) + pass_scratch(S, N, D, true, de_splits));
}

extern "C" int sampled_lse(const void* q, const void* e, const void* b, const void* ids, const void* tgt, void* lse,
                           int N, int S, int D, int device, void* stream) {
  if (!sampled_supports_dim(D) || S <= 0) return cudaErrorInvalidValue;
  if (N <= 0) return cudaSuccess;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return run_lse<64>(q, e, b, ids, tgt, lse, N, S, s);
    case 128: return run_lse<128>(q, e, b, ids, tgt, lse, N, S, s);
    default: return run_lse<256>(q, e, b, ids, tgt, lse, N, S, s);
  }
}

// dq_splits / de_splits: 0 runs each pass's own split rule (the wrapper's);
// n > 0 forces n ranges of the streamed tiles, as far as there are tiles
// (chip_smoke.py times them to measure the rule). scratch: at least
// sampled_bwd_scratch(N, S, D, dq_splits, de_splits) floats.
extern "C" int sampled_bwd(const void* q, const void* e, const void* b, const void* ids, const void* tgt,
                           const void* lse, const void* g, void* dq, void* de, void* db, void* scratch, int N, int S,
                           int D, int dq_splits, int de_splits, int device, void* stream) {
  if (!sampled_supports_dim(D) || S <= 0 || N <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return run_bwd<64>(q, e, b, ids, tgt, lse, g, dq, de, db, scratch, N, S, dq_splits, de_splits, s);
    case 128: return run_bwd<128>(q, e, b, ids, tgt, lse, g, dq, de, db, scratch, N, S, dq_splits, de_splits, s);
    default: return run_bwd<256>(q, e, b, ids, tgt, lse, g, dq, de, db, scratch, N, S, dq_splits, de_splits, s);
  }
}
