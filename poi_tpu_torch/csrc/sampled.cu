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
//   D is 64, 128, 256, 512, 768 or 1024.
//
// B9, the pool LSE. What bounds it on this card: its product, 2*N*S*D
// FLOPs (4.3 GFLOP at config #4's N = 8,192, S = 1,024, D = 256: 4.3 us at
// the tensor cores' 989 TFLOP/s), and the N*S exponentials (2.0 us on the
// special-function units). The first design (row blocks of 64 on 4 warps of
// mma.sync, the resident rows' fragments re-read from shared memory at
// every tile, cp.async double buffering) ran 16x its bound, latency-bound.
// Design: csrc/ce.cu's ce_lse_wg_kernel (B7) with the hit mask
// (sampled_lse_wg_kernel<D, Cons>):
// - a block holds 64 Cons query rows, loaded once by TMA, and their
//   targets; a producer warpgroup keeps a ring of 64-row pool tiles in
//   flight by TMA, each tile's biases and ids riding the ring beside it;
// - Cons consumer warpgroups run wgmma m64n64k16 (A and B from smem by
//   descriptor) into two logit buffers each, ping-ponged on named barriers
//   so some warpgroups' exponentials overlap others' products;
// - each logit is folded in base 2 (B7's t = fmaf(x, log2e, b log2e)), a hit replaced by the reference's -1e30 first (in base 2),
//   a ragged column by -inf; the running max starts finite, so a row or a
//   range whose every entry is a hit or padding keeps a finite max and
//   gives -1e30, never NaN or -inf;
// - where the row blocks cannot fill the card (config #4: 64 blocks of
//   128 rows), the pool's tiles are cut into contiguous ranges
//   (fill_splits: 2 of 8 tiles there), each range's partial (max, sum) to
//   scratch (sampled_lse_scratch), and sampled_lse_merge combines them in
//   range order. No atomics: the same bits every run.
// Cons is 4 (256 rows, B7's) for D = 64 and 128 and 2 (128 rows) at
// D = 256, where 256 rows fit only with a 3-stage ring (timed once: no
// faster, PERF.md). At D = 512 (config #5: N = 32,768, S = 4,096; 2*N*S*D =
// 137.4 GFLOP, 0.139 ms at 989 TFLOP/s) a warpgroup's 64 rows take 64 KB and
// so does a 64-row tile: of the three shapes that fit 227 KB (2 warpgroups
// on a 1-stage ring, which the one-tile-ahead pipeline below cannot run;
// 1 warpgroup on 2 stages; 2 warpgroups on 3 stages of 32-row tiles, which
// needs m64n32 products and another fold), this is the second, 192 KB: the
// same code, 64 rows a block, every streamed byte used by 64 rows only (half
// of D = 256's), so it leans on L2 more than the others: 0.5114 ms of device
// time at config #5's shape (kernel 0.4716), 3.7x its bound (H100, 700 W). The C entry takes the splits to force (chip_smoke.py's
// `sampled_lse splits` times them); the wrapper passes 0, the rule. At
// config #4's shape the rule took 0.0148 ms (kernel) + 0.0020 (merge) of
// device time; one range took 0.0247 (no merge), 4 and 8 ranges 0.0183 and
// 0.0247 (H100, 700 W).
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
// 64-row streamed tiles and their vectors into a ring of 4 smem stages
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
// D = 512 (config #5: N = 32,768, S = 4,096). A consumer thread's sums of
// all 512 output columns would take 256 registers, so a block sums one half
// (256 columns, gridDim.z = 2) and both halves compute the logits: 12*N*S*D
// operations in all (each pass's logits twice, 4*N*S*D, and its product,
// 2*N*S*D: 824.6 GFLOP at config #5, 0.834 ms at 989 TFLOP/s) where the
// passes above do 8*N*S*D (549.8 GFLOP) and the function needs 6*N*S*D
// (412.3 GFLOP, 0.417 ms). A block holds 64 resident rows (one
// consumer warpgroup, 64 KB) and a ring of 2 streamed 64-row tiles (64 KB
// each): 192 KB; the thread holds its [64, 256] half in 128 registers, as at
// D = 256, under the launch's limit of 255 (no setmaxnreg). Rows arrive as 8
// boxes of 128 bytes. db is the same in both halves; half 0 writes it. At
// config #5's shape: 2.6411 ms of device time (dq pass 1.2787, dE pass
// 1.3214), 6.3x the function's bound, 3.2x the 12*N*S*D one (H100, 700 W).
// ptxas serialises both passes' wgmma here (C7515), as at D = 64 and 128; a
// compile-time column half (the column offset a template constant, which
// ended it at D = 256) did not end it at D = 512 and ran no faster.
//
// D = 768 and 1024 (config #4 at D = 1024: N = 8,192, S = 1,024). A tile
// no longer fits beside 64 resident rows: both kernels stream it in chunks
// of 256 columns (kchunk.cuh). B9 (sampled_lse_kc_kernel): 64 query rows a
// block, pool tiles chunked through a ring of 3 stages, the tile's biases
// and ids riding with its last chunk, folded by pool_fold; split-S and the
// ordered merge as above. B10 (kc_bwd_pass, in both passes' kernels): a
// block sums the 256 output columns of one range (gridDim.z = 3 or 4),
// every range recomputing the logits, 16*N*S*D operations at 768 and
// 20*N*S*D at 1024 for the function's 6*N*S*D; gp and its product as
// bwd_pass's; db, the same in every range, written by range 0.
//
// The entry points launch on the given stream, do not synchronise and
// allocate nothing; each returns cudaGetLastError() after its launches.

#include "kchunk.cuh"
#include "mma_tiles.cuh"
#include "wgmma_tiles.cuh"

namespace {

// ---------------------------------------------------------------- B9: the pool LSE
//
// csrc/ce.cu's ce_lse_wg_kernel (B7) with the hit mask, copied rather than
// shared: D = 256 needs half of B7's resident rows (below), the pool's ids
// ride the ring beside the biases, and B7 keeps its code and bits.
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// Logits are folded in base 2 (t = fmaf(logit, log2e, bias log2e)); a hit
// is the reference's -1e30 in base 2. The running max starts below every t
// but finite, so no -inf - -inf arises.
constexpr float kHit2 = kNegInit * kLog2e;
constexpr float kLseInit = -3.0e38f;
constexpr int kLseStr = 64;  // pool rows a streamed tile, the wgmma's N

// Consumer warpgroups (64 query rows each) a block: 4 as B7 where D <= 128;
// at D = 256 the 4-stage ring of 64 x 256 tiles (128 KB) beside 256
// resident rows (128 KB) exceeds 227 KB, so 2 (128 rows); at D = 512 a
// warpgroup's rows and a tile take 64 KB each, so 1 warpgroup and a ring of
// 2 (192 KB).
__host__ __device__ constexpr int lse_cons(int D) { return D >= 512 ? 1 : D == 256 ? 2 : 4; }
// Pool tiles in flight.
__host__ __device__ constexpr int lse_stages(int D) { return D == 512 ? 2 : 4; }

template <int D, int Cons>
constexpr int lse_smem_bytes() {
  // 1024: room to align the base; the stages' biases and ids; the barriers.
  constexpr int ST = lse_stages(D);
  return 1024 + (64 * Cons + ST * kLseStr) * D * 2 + ST * 2 * kLseStr * 4 + (2 * ST + 1) * 8;
}

__device__ __forceinline__ void named_sync(int id) { asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory"); }
__device__ __forceinline__ void named_arrive(int id) { asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory"); }

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The logits of a warpgroup's 64 resident rows against a pool tile, both
// K-major in smem. Starts and commits. The consumer warpgroups take turns
// in a ring (B7's ping-pong): group wg waits on named barrier 1 + wg (but
// for group 0's first product), starts its product, then lets group wg + 1
// go (but for the last group's last product); `n` and `of` count this
// group's products.
template <int D, int Cons>
__device__ __forceinline__ void pool_logits_wg(float (&s)[kLseStr / 2], uint32_t res, uint32_t tile, int wg, int n,
                                               int of) {
  constexpr int SW = swizzle_bytes(D), KPC = SW / 32;
  if (Cons > 1 && (wg > 0 || n > 0)) named_sync(1 + wg);
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    wgmma_ss<kLseStr>(s, smem_desc(res + (ks / KPC) * 64 * Cons * SW + (ks % KPC) * 32, 16, 8 * SW, SW),
                      smem_desc(tile + (ks / KPC) * kLseStr * SW + (ks % KPC) * 32, 16, 8 * SW, SW), ks > 0);
  }
  wgmma_commit();
  if (Cons > 1 && (wg < Cons - 1 || n < of - 1)) named_arrive(1 + (wg + 1) % Cons);
}

// Folds a tile's logits s (columns c0 + 8j + 2t + e of rows g and g + 8)
// into the running base-2 max m and sum l of the two rows, from the
// stage's biases and ids (vec: [bias | ids] of the tile's 64 columns): a
// column whose id is the row's target (rid) is a hit, kHit2; kMask: columns
// at or past n_valid are -inf.
template <bool kMask>
__device__ __forceinline__ void pool_fold(float (&s)[kLseStr / 2], float (&m)[2], float (&l)[2], const float* vec,
                                          const int (&rid)[2], int c0, int n_valid, int t) {
  const int* ids = reinterpret_cast<const int*>(vec + kLseStr);
  float tmax[2][2] = {{kLseInit, kLseInit}, {kLseInit, kLseInit}};
#pragma unroll
  for (int j = 0; j < kLseStr / 8; ++j) {
    const float2 b = *reinterpret_cast<const float2*>(vec + j * 8 + 2 * t);
    const int2 id = *reinterpret_cast<const int2*>(ids + j * 8 + 2 * t);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool ok = !kMask || c0 + j * 8 + 2 * t + e < n_valid;
      const float b2 = (e ? b.y : b.x) * kLog2e;
      const int idv = e ? id.y : id.x;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // A hit is x 0 + kHit2: the mask picks the FMA's operands, so the
        // logit takes one FMA as in B7 (a select of kHit2 into the
        // accumulator registers had ptxas serialise the wgmma, C7515).
        const bool hit = idv == rid[r];
        float& x = s[4 * j + 2 * r + e];
        x = ok ? fmaf(x, hit ? 0.f : kLog2e, hit ? kHit2 : b2) : -INFINITY;
        tmax[r][e] = fmaxf(tmax[r][e], x);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mn = fmaxf(m[r], fmaxf(tmax[r][0], tmax[r][1]));
    float acc[2] = {l[r] * ex2(m[r] - mn), 0.f};
#pragma unroll
    for (int j = 0; j < kLseStr / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) acc[e] += ex2(s[4 * j + 2 * r + e] - mn);
    }
    m[r] = mn;
    l[r] = acc[0] + acc[1];
  }
}

// The end of a block: the four threads of a quad hold the same two rows
// (row0 and row0 + 8) over disjoint columns; their partials are merged, and
// thread t == 0 writes lse or, with n_split ranges, the rows' partial
// base-2 max and sum to part[split * N + row] and part[(n_split + split) * N
// + row].
__device__ __forceinline__ void pool_lse_store(float (&m)[2], float (&l)[2], float* __restrict__ lse,
                                               float* __restrict__ part, int row0, int N, int split, int n_split,
                                               int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], off);
      const float mn = fmaxf(m[r], mo);
      l[r] = l[r] * ex2(m[r] - mn) + lo * ex2(mo - mn);
      m[r] = mn;
    }
  }
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= N) continue;
      if (n_split == 1) {
        lse[row] = (m[r] + log2f(l[r])) * kLn2;
      } else {
        part[(size_t)split * N + row] = m[r];
        part[(size_t)(n_split + split) * N + row] = l[r];
      }
    }
  }
}

// Blocks: (row block of 64 Cons, pool range). With one range it writes
// lse; with S ranges (gridDim.y) it writes its rows' partial base-2 max and
// sum to part[split * N + row] and part[(S + split) * N + row].
template <int D, int Cons>
__global__ void __launch_bounds__(128 * (Cons + 1), 1)
    sampled_lse_wg_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap e_map,
                          const __grid_constant__ CUtensorMap b_map, const __grid_constant__ CUtensorMap id_map,
                          const int* __restrict__ tgt, float* __restrict__ lse, float* __restrict__ part, int N,
                          int S, int tiles_per_split) {
  constexpr int SW = swizzle_bytes(D), CC = SW / 2, NCH = D / CC, Rows = 64 * Cons, ST = lse_stages(D);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* res_s = base;                                     // [NCH][Rows][SW bytes]
  unsigned char* str_s = base + Rows * D * 2;                      // [ST][NCH][kLseStr][SW bytes]
  float* vec_s = reinterpret_cast<float*>(str_s + ST * kLseStr * D * 2);  // [ST][bias | ids][kLseStr]
  uint64_t* full = reinterpret_cast<uint64_t*>(vec_s + ST * 2 * kLseStr);
  uint64_t* empty = full + ST;
  uint64_t* res_full = empty + ST;

  const int r0 = blockIdx.x * Rows;
  const int split = blockIdx.y, n_split = gridDim.y;
  const int n_tiles = (S + kLseStr - 1) / kLseStr;
  const int t0 = split * tiles_per_split, t1 = min(n_tiles, t0 + tiles_per_split);
  if (threadIdx.x == 0) {
    for (int st = 0; st < ST; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 4 * Cons);  // every consumer warp
    }
    mbar_init(res_full, 1);
    mbar_init_fence();
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp >= 4 * Cons) {  // the producer warpgroup: one thread keeps the ring full
    // With four consumer warpgroups it hands its registers to them
    // (setmaxnreg works per warpgroup, hence a whole producer warpgroup).
    if constexpr (Cons == 4) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == 4 * Cons && lane == 0) {
      mbar_arrive_expect_tx(res_full, Rows * D * 2);
      for (int c = 0; c < NCH; ++c) tma_load_2d(res_s + c * Rows * SW, &q_map, c * CC, r0, res_full);
      int st = 0;
      uint32_t ph = 0;
      for (int it = t0; it < t1; ++it) {
        mbar_wait(&empty[st], ph ^ 1);
        mbar_arrive_expect_tx(&full[st], kLseStr * D * 2 + 2 * kLseStr * 4);
        for (int c = 0; c < NCH; ++c) {
          tma_load_2d(str_s + (st * NCH + c) * kLseStr * SW, &e_map, c * CC, it * kLseStr, &full[st]);
        }
        tma_load_1d(vec_s + st * 2 * kLseStr, &b_map, it * kLseStr, &full[st]);
        tma_load_1d(vec_s + (st * 2 + 1) * kLseStr, &id_map, it * kLseStr, &full[st]);
        if (++st == ST) {
          st = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // 112 registers a consumer thread where four warpgroups share the file
  // (the launch gives 96): two logit tiles and the running sums, no spills.
  if constexpr (Cons == 4) asm volatile("setmaxnreg.inc.sync.aligned.u32 112;\n" ::: "memory");
  const int wg = warp / 4, wi = warp % 4, g = lane / 4, t = lane % 4;
  int rid[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + wg * 64 + wi * 16 + g + 8 * r;
    rid[r] = row < N ? tgt[row] : -1;
  }
  mbar_wait(res_full, 0);
  const uint32_t res_addr = smem_u32(res_s) + wg * 64 * SW;  // the warpgroup's 64 resident rows

  // Software pipeline: tile it + 1's logits are on the tensor cores while
  // tile it is folded (s0 for the even tiles of the range, s1 for the odd).
  // Past the range's last tile a step re-runs on that tile's stage (landed,
  // never refilled) with every column masked, so every wgmma is started on
  // the one path all steps take.
  const uint32_t str_addr = smem_u32(str_s);
  const int of = 1 + (t1 - t0 + 1) / 2 * 2;  // products a warpgroup starts
  int n = 0;
  float m[2] = {kLseInit, kLseInit}, l[2] = {0.f, 0.f};
  float s0[kLseStr / 2], s1[kLseStr / 2];
  mbar_wait(&full[0], 0);  // every range has a tile
  pool_logits_wg<D, Cons>(s0, res_addr, str_addr, wg, n++, of);
  auto step = [&](float (&sc)[kLseStr / 2], float (&sn)[kLseStr / 2], int cur) {
    const int st = (min(cur, t1 - 1) - t0) % ST;
    wgmma_wait<0>();
    fence_regs(sc);
    if (cur > t0 && cur < t1) {
      // The warp is done with the previous stage (its ids and biases read by
      // generic loads, before the next bulk write into it): lane 0 says so.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(st + ST - 1) % ST]);
    }
    const int k = min(cur + 1, t1 - 1) - t0;
    mbar_wait(&full[k % ST], (k / ST) & 1);
    pool_logits_wg<D, Cons>(sn, res_addr, str_addr + (k % ST) * NCH * kLseStr * SW, wg, n++, of);
    const float* v = vec_s + st * 2 * kLseStr;
    if (cur >= t1 || (cur + 1) * kLseStr > S) {
      pool_fold<true>(sc, m, l, v, rid, cur * kLseStr, cur < t1 ? S : 0, t);
    } else {
      pool_fold<false>(sc, m, l, v, rid, 0, 0, t);
    }
  };
  for (int it = t0; it < t1; it += 2) {
    step(s0, s1, it);
    step(s1, s0, it + 1);
  }
  wgmma_wait<0>();
  fence_regs(s0);
  pool_lse_store(m, l, lse, part, r0 + wg * 64 + wi * 16 + g, N, split, n_split, t);
}

// D = 768 and 1024 (see the top of the file): 64 query rows a block,
// kchunk.cuh's K-chunked stream of pool tiles.
template <int D>
__global__ void __launch_bounds__(256, 1)
    sampled_lse_kc_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap e_map,
                          const __grid_constant__ CUtensorMap b_map, const __grid_constant__ CUtensorMap id_map,
                          const int* __restrict__ tgt, float* __restrict__ lse, float* __restrict__ part, int N,
                          int S, int tiles_per_split) {
  const int split = blockIdx.y, n_split = gridDim.y;
  const int n_tiles = (S + kLseStr - 1) / kLseStr;
  const int t0 = split * tiles_per_split, t1 = min(n_tiles, t0 + tiles_per_split);
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int row0 = blockIdx.x * kKcRows + threadIdx.x / 32 % 4 * 16 + g;
  int rid[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) rid[r] = row0 + 8 * r < N ? tgt[row0 + 8 * r] : -1;
  const CUtensorMap* const vecs[2] = {&b_map, &id_map};
  float m[2] = {kLseInit, kLseInit}, l[2] = {0.f, 0.f};
  const bool consumer = kc_fwd_run<D, 2>(m, l, &q_map, &e_map, vecs, t0, t1,
                                         [&](float (&s)[32], float (&mm)[2], float (&ll)[2], const float* v, int it) {
                                           if ((it + 1) * kLseStr > S) {
                                             pool_fold<true>(s, mm, ll, v, rid, it * kLseStr, S, t);
                                           } else {
                                             pool_fold<false>(s, mm, ll, v, rid, 0, 0, t);
                                           }
                                         });
  if (consumer) pool_lse_store(m, l, lse, part, row0, N, split, n_split, t);
}

// The ranges' partials of row i, in base 2, in range order:
// lse[i] = (M + log2(sum over s of l_s 2^(m_s - M))) ln 2, M = max_s m_s.
// A row whose every pool entry is a hit or padding has M = kHit2 and gives
// -1e30, as the reference does.
__global__ void sampled_lse_merge(const float* __restrict__ part, float* __restrict__ lse, int N, int n_split) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  float M = part[i];
  for (int s = 1; s < n_split; ++s) M = fmaxf(M, part[(size_t)s * N + i]);
  float L = 0.f;
  for (int s = 0; s < n_split; ++s) L += part[(size_t)(n_split + s) * N + i] * exp2f(part[(size_t)s * N + i] - M);
  lse[i] = (M + log2f(L)) * kLn2;
}

// The ranges a kernel whose `blocks` resident blocks each stream `tiles`
// tiles cuts them into: the rule (fill_splits) when forced <= 0, else
// `forced` as far as the tiles allow; *per is the tiles a range.
int stream_splits(int blocks, int tiles, int forced, int* per) {
  if (forced <= 0) return fill_splits(blocks, tiles, per);
  const int n = forced < tiles ? forced : tiles;
  *per = (tiles + n - 1) / n;
  return (tiles + *per - 1) / *per;
}

// The pool ranges of B9 with `cons` consumer warpgroups a block.
int lse_splits(int N, int S, int cons, int forced, int* per) {
  return stream_splits((N + 64 * cons - 1) / (64 * cons), (S + kLseStr - 1) / kLseStr, forced, per);
}

// sampled_lse_kc_kernel at D = 768 or 1024; ranges and merge as run_lse's.
template <int D>
cudaError_t run_lse_kc(const void* q, const void* e, const void* b, const void* ids, const void* tgt, void* lse,
                       void* scratch, int N, int S, int forced, cudaStream_t s) {
  CUtensorMap q_map, e_map, b_map, id_map;
  if (!make_map(&q_map, q, N, D, kKcRows) || !make_map(&e_map, e, S, D, kLseStr) ||
      !make_vec_map(&b_map, static_cast<const float*>(b), S, kLseStr) ||
      !make_vec_map(&id_map, static_cast<const float*>(ids), S, kLseStr)) {
    return cudaErrorInvalidValue;
  }
  int per = 0;
  const int n_split = lse_splits(N, S, 1, forced, &per);
  constexpr int smem = KcFwd<D, 2>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(sampled_lse_kc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  float* part = static_cast<float*>(scratch);
  sampled_lse_kc_kernel<D><<<dim3((N + kKcRows - 1) / kKcRows, n_split), 256, smem, s>>>(
      q_map, e_map, b_map, id_map, static_cast<const int*>(tgt), static_cast<float*>(lse), part, N, S, per);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  sampled_lse_merge<<<(N + 255) / 256, 256, 0, s>>>(part, static_cast<float*>(lse), N, n_split);
  return cudaGetLastError();
}

template <int D, int Cons>
cudaError_t run_lse(const void* q, const void* e, const void* b, const void* ids, const void* tgt, void* lse,
                    void* scratch, int N, int S, int forced, cudaStream_t s) {
  CUtensorMap q_map, e_map, b_map, id_map;
  // The int32 ids travel as 4-byte elements under an fp32 map (TMA copies bits).
  if (!make_map(&q_map, q, N, D, 64 * Cons) || !make_map(&e_map, e, S, D, kLseStr) ||
      !make_vec_map(&b_map, static_cast<const float*>(b), S, kLseStr) ||
      !make_vec_map(&id_map, static_cast<const float*>(ids), S, kLseStr)) {
    return cudaErrorInvalidValue;
  }
  int per = 0;
  const int n_split = lse_splits(N, S, Cons, forced, &per);
  constexpr int smem = lse_smem_bytes<D, Cons>();
  auto kernel = sampled_lse_wg_kernel<D, Cons>;
  // Once an instantiation and device: the shared-memory opt-in (host time on every call otherwise).
  static uint64_t attribute_set = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 64 || !(attribute_set >> device & 1)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (device < 64) attribute_set |= uint64_t{1} << device;
  }
  float* part = static_cast<float*>(scratch);
  kernel<<<dim3((N + 64 * Cons - 1) / (64 * Cons), n_split), 128 * (Cons + 1), smem, s>>>(
      q_map, e_map, b_map, id_map, static_cast<const int*>(tgt), static_cast<float*>(lse), part, N, S, per);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  sampled_lse_merge<<<(N + 255) / 256, 256, 0, s>>>(part, static_cast<float*>(lse), N, n_split);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- backward

constexpr int kStr = 64;           // rows of a streamed tile
constexpr int kSw = 128;           // bytes a swizzled smem row: every width takes the 128-byte swizzle
constexpr int kSwCols = kSw / 2;   // bf16 columns a box (a "chunk")
constexpr int kKPerChunk = kSw / 32;  // k16 steps a chunk

// The shape of a block, by D. Up to D = 256: two consumer warpgroups (128
// resident rows), a ring of 4 streamed tiles, every output column in one
// block. At D = 512 a consumer thread's sums of all 512 columns would take
// 256 registers, so a block sums one half of the columns (gridDim.z = 2,
// each half recomputing the logits), and the resident rows (64 KB a
// warpgroup) and the tiles (64 KB each) leave room for one consumer
// warpgroup (64 rows) and a ring of 2.
__host__ __device__ constexpr int bwd_cons(int D) { return D >= 512 ? 1 : 2; }
__host__ __device__ constexpr int bwd_res(int D) { return 64 * bwd_cons(D); }  // resident rows a block
__host__ __device__ constexpr int bwd_stages(int D) { return D == 512 ? 2 : 4; }
__host__ __device__ constexpr int bwd_threads(int D) { return 128 * (bwd_cons(D) + 1); }  // + 1 producer warpgroup
// Output column ranges: halves at 512, ranges of 256 past it (kc_bwd_pass).
__host__ __device__ constexpr int bwd_halves(int D) { return D > 512 ? D / kKc : D == 512 ? 2 : 1; }

// Streamed 4-byte vectors that arrive with each tile: the dq pass needs the
// pool rows' bias and ids, the dE pass the queries' lse, g and targets.
template <bool kDe>
__host__ __device__ constexpr int stream_vecs() {
  return kDe ? 3 : 2;
}

template <int D, bool kDe>
constexpr int pass_smem_bytes() {
  if constexpr (D > 512) return KcBwd<D, stream_vecs<kDe>()>::kSmem;
  // 1024: room to align the base; the stages' vectors; the barriers.
  constexpr int ST = bwd_stages(D);
  return 1024 + (bwd_res(D) + ST * kStr) * D * 2 + ST * stream_vecs<kDe>() * kStr * 4 + (2 * ST + 1) * 8;
}

// The 64 x 64 logits of the warpgroup's resident rows (at `res`, their
// first row, of the block's Res) against a streamed tile, A and B K-major
// in smem. Starts and commits; the caller waits.
template <int D, int Res>
__device__ __forceinline__ void pool_logits(float (&s)[32], uint32_t res, uint32_t tile) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const uint32_t k_off = (ks % kKPerChunk) * 32;
    const uint64_t da = smem_desc(res + (ks / kKPerChunk) * Res * kSw + k_off, 16, 8 * kSw, kSw);
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

// acc[64 x DO] += bf16(gp)[64 x 64] . tile[64 x DO]: gp rounded into A
// fragments, the tile (at its first output column) read MN-major, in
// products of NP <= 128 columns (the chunks of 64 columns lie kStr * kSw
// bytes apart). Starts and commits.
template <int DO>
__device__ __forceinline__ void gp_product(float (&acc)[DO > 128 ? DO / 128 : 1][(DO > 128 ? 128 : DO) / 2],
                                           const float (&s)[32], uint32_t tile) {
  constexpr int NP = DO > 128 ? 128 : DO, NH = DO / NP;
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
// sums at out + s * n_res * D and db + s * n_res. A block sums the output
// columns of its half (gridDim.z; one half but at D = 512); db, the same in
// every half, is written by half 0. row_a / row_b / row_id: per resident
// row, the dq pass's lse, g and target, the dE pass's bias, (unused) and id.
template <int D, bool kDe>
__device__ __forceinline__ void bwd_pass(const CUtensorMap* res_map, const CUtensorMap* str_map,
                                         const CUtensorMap* vec_maps, const float* __restrict__ row_a,
                                         const float* __restrict__ row_b, const int* __restrict__ row_id,
                                         float* __restrict__ out, float* __restrict__ db_out, int n_res, int n_str,
                                         int tiles_per_split) {
  constexpr int NCH = D / kSwCols, NV = stream_vecs<kDe>();
  constexpr int Cons = bwd_cons(D), Res = bwd_res(D), ST = bwd_stages(D), DO = D / bwd_halves(D);
  constexpr int NP = DO > 128 ? 128 : DO, NH = DO / NP;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* res_s = base;                                     // [NCH][Res][kSw bytes]
  unsigned char* str_s = base + Res * D * 2;                       // [ST][NCH][kStr][kSw bytes]
  float* vec_s = reinterpret_cast<float*>(str_s + ST * kStr * D * 2);  // [ST][NV][kStr]
  uint64_t* full = reinterpret_cast<uint64_t*>(vec_s + ST * NV * kStr);
  uint64_t* empty = full + ST;
  uint64_t* res_full = empty + ST;

  const int r0 = blockIdx.x * Res;
  // A compile-time 0 where one block sums every column: a column offset in
  // registers had ptxas serialise the D = 256 passes' wgmma (C7515).
  const int split = blockIdx.y, col0 = bwd_halves(D) > 1 ? blockIdx.z * DO : 0;
  const int n_tiles = (n_str + kStr - 1) / kStr;
  const int t0 = split * tiles_per_split, t1 = min(n_tiles, t0 + tiles_per_split);
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * Cons);  // every consumer thread
    }
    mbar_init(res_full, 1);
    mbar_init_fence();
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp >= 4 * Cons) {  // the producer warpgroup: one thread keeps the ring full
    if constexpr (Cons == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 4 * Cons && lane == 0) {
      mbar_arrive_expect_tx(res_full, Res * D * 2);
      for (int c = 0; c < NCH; ++c) tma_load_2d(res_s + c * Res * kSw, res_map, c * kSwCols, r0, res_full);
      int st = 0;
      uint32_t ph = 0;
      for (int it = t0; it < t1; ++it) {
        mbar_wait(&empty[st], ph ^ 1);
        mbar_arrive_expect_tx(&full[st], kStr * D * 2 + NV * kStr * 4);
        for (int c = 0; c < NCH; ++c) {
          tma_load_2d(str_s + (st * NCH + c) * kStr * kSw, str_map, c * kSwCols, it * kStr, &full[st]);
        }
        for (int v = 0; v < NV; ++v) tma_load_1d(vec_s + (st * NV + v) * kStr, &vec_maps[v], it * kStr, &full[st]);
        if (++st == ST) {
          st = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // 232 registers a consumer thread (the launch gives 168) with two
  // consumer warpgroups: at D = 256 the [64, 256] output sums, the logits
  // and gp's A fragments. With one (D = 512, 256 threads) the launch's
  // limit of 255 holds its [64, 256] half.
  if constexpr (Cons == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
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
  const uint32_t out_off = (col0 / kSwCols) * kStr * kSw;  // the tile's chunk of the block's first output column
  mbar_wait(res_full, 0);

  // A tile: its logits on the tensor cores, then (once they and the previous
  // tile's product are done) the previous tile's stage released, gp, and
  // this tile's product started; it runs while the next tile's logits are
  // started behind it.
  for (int it = t0; it < t1; ++it) {
    const int k = it - t0, st = k % ST;
    const uint32_t tile = str_addr + st * NCH * kStr * kSw;
    mbar_wait(&full[st], (k / ST) & 1);
    pool_logits<D, Res>(s, res_addr, tile);
    wgmma_wait<0>();
    fence_regs(s);
#pragma unroll
    for (int h = 0; h < NH; ++h) fence_regs(acc[h]);
    if (k > 0) {
      // The previous tile's vectors, read by generic loads, before the next bulk write into its stage.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(&empty[(st + ST - 1) % ST]);
    }
    tile_gp<kDe>(s, db, vec_s + st * NV * kStr, it * kStr, n_str, ok, ra, rb, rid, t);
    gp_product<DO>(acc, s, tile + out_off);
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
      if (ok[r] && t == 0 && col0 == 0) db_out[(size_t)split * n_res + row[r]] = db[r];
    }
    if (!ok[r]) continue;
    float* dst = dst0 + (size_t)row[r] * D + col0 + 2 * t;
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

// One pass at D = 768 or 1024 (kchunk.cuh's K-chunked backward): a block
// sums the 256 output columns of range blockIdx.z, gp and its product as
// bwd_pass's; arguments as bwd_pass's. db, the same in every range, is
// written by range 0.
template <int D, bool kDe>
__device__ __forceinline__ void kc_bwd_pass(const CUtensorMap* res_map, const CUtensorMap* str_map,
                                            const CUtensorMap* vec_maps, const float* __restrict__ row_a,
                                            const float* __restrict__ row_b, const int* __restrict__ row_id,
                                            float* __restrict__ out, float* __restrict__ db_out, int n_res, int n_str,
                                            int tiles_per_split) {
  const int split = blockIdx.y, col0 = blockIdx.z * kKc;
  const int n_tiles = (n_str + kStr - 1) / kStr;
  const int t0 = split * tiles_per_split, t1 = min(n_tiles, t0 + tiles_per_split);
  const int lane = threadIdx.x % 32, wi = threadIdx.x / 32 % 4, g = lane / 4, t = lane % 4;
  int row[2], rid[2];
  bool ok[2];
  float ra[2], rb[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row[r] = blockIdx.x * kKcRows + wi * 16 + g + 8 * r;
    ok[r] = row[r] < n_res;
    ra[r] = ok[r] ? row_a[row[r]] : 0.f;
    rb[r] = ok[r] && !kDe ? row_b[row[r]] : 0.f;
    rid[r] = ok[r] ? row_id[row[r]] : -1;
  }
  const CUtensorMap* const vecs[3] = {&vec_maps[0], &vec_maps[1], &vec_maps[2]};
  float acc[2][64];
  float db[2] = {0.f, 0.f};
  const bool consumer = kc_bwd_run<D, stream_vecs<kDe>()>(
      acc, res_map, str_map, vecs, t0, t1, [&](float (&s)[32], const float* vec, int it, uint32_t hold) {
        tile_gp<kDe>(s, db, vec, it * kStr, n_str, ok, ra, rb, rid, t);
        gp_product<kKc>(acc, s, hold);
      });
  if (!consumer) return;

  float* dst0 = out + (size_t)split * n_res * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if constexpr (kDe) {
      db[r] += __shfl_xor_sync(0xffffffffu, db[r], 1);
      db[r] += __shfl_xor_sync(0xffffffffu, db[r], 2);
      if (ok[r] && t == 0 && col0 == 0) db_out[(size_t)split * n_res + row[r]] = db[r];
    }
    if (!ok[r]) continue;
    float* dst = dst0 + (size_t)row[r] * D + col0 + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        *reinterpret_cast<float2*>(dst + h * 128 + j * 8) = make_float2(acc[h][j * 4 + 2 * r], acc[h][j * 4 + 2 * r + 1]);
      }
    }
  }
}

// The two passes as kernels of their own names (the profiler tells them
// apart): bwd_pass up to D = 512, kc_bwd_pass above. vec_maps: the streamed
// vectors' tensor maps, in stream_vecs' order.
struct VecMaps {
  CUtensorMap m[3];
};

template <int D>
__global__ void __launch_bounds__(bwd_threads(D), 1)
    sampled_dq_pass(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap e_map,
                    const __grid_constant__ VecMaps vecs, const float* __restrict__ lse, const float* __restrict__ g,
                    const int* __restrict__ tgt, float* __restrict__ dq, int N, int S, int tiles_per_split) {
  if constexpr (D > 512) {
    kc_bwd_pass<D, false>(&q_map, &e_map, vecs.m, lse, g, tgt, dq, nullptr, N, S, tiles_per_split);
  } else {
    bwd_pass<D, false>(&q_map, &e_map, vecs.m, lse, g, tgt, dq, nullptr, N, S, tiles_per_split);
  }
}

template <int D>
__global__ void __launch_bounds__(bwd_threads(D), 1)
    sampled_de_pass(const __grid_constant__ CUtensorMap e_map, const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ VecMaps vecs, const float* __restrict__ b, const int* __restrict__ ids,
                    float* __restrict__ de, float* __restrict__ db, int S, int N, int tiles_per_split) {
  if constexpr (D > 512) {
    kc_bwd_pass<D, true>(&e_map, &q_map, vecs.m, b, nullptr, ids, de, db, S, N, tiles_per_split);
  } else {
    bwd_pass<D, true>(&e_map, &q_map, vecs.m, b, nullptr, ids, de, db, S, N, tiles_per_split);
  }
}

// The ranges a backward pass splits its streamed tiles into: its blocks are
// the resident row blocks times the column halves.
int pass_splits(int n_res, int n_str, int D, int forced, int* per) {
  const int res = bwd_res(D);
  return stream_splits((n_res + res - 1) / res * bwd_halves(D), (n_str + kStr - 1) / kStr, forced, per);
}

// Scratch floats a pass needs for its partials (0 when it does not split).
long long pass_scratch(int n_res, int n_str, int D, bool de, int forced) {
  int per = 0;
  const int S = pass_splits(n_res, n_str, D, forced, &per);
  return S > 1 ? (long long)S * n_res * (D + (de ? 1 : 0)) : 0;
}

template <int D>
cudaError_t run_bwd(const void* q, const void* e, const void* b, const void* ids, const void* tgt, const void* lse,
                    const void* g, void* dq, void* de, void* db, void* scratch, int N, int S, int dq_forced,
                    int de_forced, cudaStream_t s) {
  CUtensorMap q_res, q_str, e_res, e_str;
  VecMaps pool_vecs, query_vecs;  // the dq pass's streamed bias, ids; the dE pass's lse, g, tgt
  // The int32 ids and targets travel as 4-byte elements under an fp32 map (TMA copies bits).
  constexpr int Res = bwd_res(D), H = bwd_halves(D);
  if (!make_map(&q_res, q, N, D, Res) || !make_map(&q_str, q, N, D, kStr) || !make_map(&e_res, e, S, D, Res) ||
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
  int splits = pass_splits(N, S, D, dq_forced, &per);
  constexpr int dq_smem = pass_smem_bytes<D, false>();
  cudaError_t err = cudaFuncSetAttribute(sampled_dq_pass<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem);
  if (err != cudaSuccess) return err;
  float* o = splits > 1 ? sc : static_cast<float*>(dq);
  sampled_dq_pass<D><<<dim3((N + Res - 1) / Res, splits, H), bwd_threads(D), dq_smem, s>>>(q_res, e_str, pool_vecs, l,
                                                                                             gg, ti, o, N, S, per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (splits > 1) {
    sum_splits<<<2 * kSms, 256, 0, s>>>(o, static_cast<float*>(dq), (long long)N * D, splits);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  sc += pass_scratch(N, S, D, false, dq_forced);

  // dE and db: resident pool rows, streamed queries.
  splits = pass_splits(S, N, D, de_forced, &per);
  constexpr int de_smem = pass_smem_bytes<D, true>();
  err = cudaFuncSetAttribute(sampled_de_pass<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, de_smem);
  if (err != cudaSuccess) return err;
  o = splits > 1 ? sc : static_cast<float*>(de);
  float* ob = splits > 1 ? sc + (size_t)splits * S * D : static_cast<float*>(db);
  sampled_de_pass<D><<<dim3((S + Res - 1) / Res, splits, H), bwd_threads(D), de_smem, s>>>(e_res, q_str, query_vecs,
                                                                                             bb, ii, o, ob, S, N, per);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  sum_splits<<<2 * kSms, 256, 0, s>>>(o, static_cast<float*>(de), (long long)S * D, splits);
  sum_splits<<<2 * kSms, 256, 0, s>>>(ob, static_cast<float*>(db), S, splits);
  return cudaGetLastError();
}

}  // namespace

// The widths the kernels are built for; the wrapper checks D against it.
extern "C" int sampled_supports_dim(int D) {
  return D == 64 || D == 128 || D == 256 || D == 512 || D == 768 || D == 1024;
}

// The shape of the kernels' blocks at a width they are built for, as
// out[0..6]: B9's query rows a block, its ring's stages and the columns a
// streamed chunk (D itself up to 512, where a tile arrives whole); B10's
// resident rows a block, its ring's stages (the dE pass's), its output
// column ranges (gridDim.z) and the columns a chunk. ops/fused_sampled.py's
// plan mirrors it. Returns 0 for a width they are not built for.
extern "C" int sampled_plan(int D, int* out) {
  if (!sampled_supports_dim(D)) return 0;
  out[0] = 64 * lse_cons(D);
  out[1] = D == 768 ? KcFwd<768, 2>::kStages : D == 1024 ? KcFwd<1024, 2>::kStages : lse_stages(D);
  out[2] = D > 512 ? kKc : D;
  out[3] = bwd_res(D);
  out[4] = D == 768 ? KcBwd<768, 3>::kStages : D == 1024 ? KcBwd<1024, 3>::kStages : bwd_stages(D);
  out[5] = bwd_halves(D);
  out[6] = out[2];
  return 1;
}

// Floats of scratch sampled_bwd needs for split partials (0: pass any
// pointer). dq_splits / de_splits: as for sampled_bwd.
extern "C" int sampled_bwd_scratch(int N, int S, int D, int dq_splits, int de_splits) {
  if (N <= 0 || S <= 0 || !sampled_supports_dim(D)) return 0;
  return static_cast<int>(pass_scratch(N, S, D, false, dq_splits) + pass_scratch(S, N, D, true, de_splits));
}

// Floats of scratch sampled_lse needs for its ranges' partial sums (0 when
// it does not split: pass any pointer). splits: as for sampled_lse.
extern "C" int sampled_lse_scratch(int N, int S, int D, int splits) {
  if (N <= 0 || S <= 0 || !sampled_supports_dim(D)) return 0;
  int per = 0;
  const int n_split = lse_splits(N, S, lse_cons(D), splits, &per);
  return n_split > 1 ? 2 * n_split * N : 0;
}

// splits: 0 runs the split rule (the wrapper's), n > 0 forces n ranges of
// the pool's tiles, as far as there are tiles (chip_smoke.py times them to
// measure the rule). scratch: at least sampled_lse_scratch(N, S, D, splits)
// floats.
extern "C" int sampled_lse(const void* q, const void* e, const void* b, const void* ids, const void* tgt, void* lse,
                           void* scratch, int N, int S, int D, int splits, int device, void* stream) {
  if (!sampled_supports_dim(D) || S <= 0) return cudaErrorInvalidValue;
  if (N <= 0) return cudaSuccess;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return run_lse<64, lse_cons(64)>(q, e, b, ids, tgt, lse, scratch, N, S, splits, s);
    case 128: return run_lse<128, lse_cons(128)>(q, e, b, ids, tgt, lse, scratch, N, S, splits, s);
    case 256: return run_lse<256, lse_cons(256)>(q, e, b, ids, tgt, lse, scratch, N, S, splits, s);
    case 768: return run_lse_kc<768>(q, e, b, ids, tgt, lse, scratch, N, S, splits, s);
    case 1024: return run_lse_kc<1024>(q, e, b, ids, tgt, lse, scratch, N, S, splits, s);
    default: return run_lse<512, lse_cons(512)>(q, e, b, ids, tgt, lse, scratch, N, S, splits, s);
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
    case 256: return run_bwd<256>(q, e, b, ids, tgt, lse, g, dq, de, db, scratch, N, S, dq_splits, de_splits, s);
    case 768: return run_bwd<768>(q, e, b, ids, tgt, lse, g, dq, de, db, scratch, N, S, dq_splits, de_splits, s);
    case 1024: return run_bwd<1024>(q, e, b, ids, tgt, lse, g, dq, de, db, scratch, N, S, dq_splits, de_splits, s);
    default: return run_bwd<512>(q, e, b, ids, tgt, lse, g, dq, de, db, scratch, N, S, dq_splits, de_splits, s);
  }
}
