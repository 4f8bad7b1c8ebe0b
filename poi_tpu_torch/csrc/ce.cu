// Full-catalog softmax cross-entropy for Hopper (sm_90a): the forward
// log-sum-exp. The backward is ce_bwd.cu.
//
// Replaces the TPU kernel poi_tpu/ops/fused_ce.py:_lse_kernel (driven by
// _pallas_lse), and the forward's tuning variants of scripts/sweep_ce_fwd.py
// (_lse_kernel_exp2, _lse_kernel_nomax, driven by build). One kernel,
// ce_lse_wg_kernel<D, Var, Cons>, serves both: ce_lse (the train path) is
// its base variant at 256 rows a block, and ce_lse_variant (B12) takes any
// variant at 128 or 256 rows.
//
// Contract (the same arithmetic as the TPU kernel):
//   q     [N, D] bf16   queries, already rounded
//   table [V, D] bf16   output table, already rounded
//   bias  [V]    fp32   (-1e30 on padded catalog rows)
//   logits l = q . table^T + bias: exact bf16 products, fp32 sums
//   lse [N] fp32 = log sum_v exp(l[n, v])
//
// What bounds it on this card: the catalog product, 2*N*V*D FLOPs (0.37
// TFLOP at N=32768, V=44170, D=128: 0.37 ms at the tensor cores' 989
// TFLOP/s), and the N*V exponentials on the special-function units (1.45e9:
// 0.35 ms at 16 a clock an SM), about equal, so it is fast only where the two
// overlap, and with them the few fp32 operations of each logit.
//
// Design: warp-specialised, on wgmma and TMA (wgmma_tiles.cuh, as
// ce_bwd.cu's passes).
// - A block holds 64 Cons query rows (Cons consumer warpgroups of 64 rows),
//   loaded once by TMA into a swizzled smem tile. A producer warpgroup keeps
//   a ring of 4 stages of 64 catalog rows and their bias in flight by TMA,
//   guarded by mbarriers (full: the bytes arrived; empty: every consumer
//   warp is done with the stage). ce_lse takes Cons = 4: 256 rows make the
//   bench shape's 32,768 rows 128 blocks, one wave on 132 SMs, and halve the
//   catalog's re-reads from L2 against 128 rows (1.45 GB a call). There the
//   producer hands its registers to the consumers (setmaxnreg: 112 a
//   consumer thread, 24 a producer thread); with Cons = 2 the launch gives
//   every thread up to 168 and no hand-over is needed.
// - Each consumer warpgroup runs wgmma m64n64k16 over a tile, A and B both
//   read from smem by descriptor, into one of two logit buffers, starts the
//   next tile's product, and folds this tile into a running max and sum per
//   row while the tensor cores work. The warpgroups take turns to issue
//   their products (a ring of Cons named barriers, FlashAttention-3's
//   ping-pong), so some warpgroups' exponentials overlap others' products.
//   The max and sum per row stay in base 2 (lse_fold).
// - Why four warpgroups for ce_lse: in development builds with two, a
//   variant that started no wgmma took as long as the kernel, and one
//   without the exponentials most of it: the fold's latency, not a pipe's
//   rate, set the time. Four warpgroups hide more of it.
// - The variants (Var), the TPU sweep's kernels:
//     base   each logit costs one FMA that scales it to base 2 with its bias
//            (t = fmaf(x, log2e, bias log2e)), a max, ex2(t - m) and an add;
//     exp2   q (before its bf16 rounding) and bias arrive scaled by log2(e),
//            so the logit is already in base 2: t = x + bias, an add in
//            place of the FMA; the max, the sum and the merge are base's;
//     nomax  no running max: l += ex2(fmaf(x, log2e, bias log2e)) into two
//            independent sums a row; the max stays 0, so a range's partial
//            max is 0 and lse_merge takes it unchanged. Unsafe (fp32
//            overflows) past logits of about 88; it measures what the
//            running max costs base.
//   Cons is the counterpart of the sweep's row-block axis (rb); its catalog
//   chunk (cv) has none: the streamed tile is 64 rows, the wgmma's N.
// - Split-V: where the row blocks cannot fill the card (config #3's N = 2,048
//   is 8 blocks of 256), the catalog's tiles are cut into S contiguous ranges
//   (fill_splits), one block a (row block, range). Each writes its rows'
//   partial base-2 (max, sum) to scratch the wrapper allocates
//   (ce_lse_scratch), and lse_merge combines the S pairs of a row in range
//   order. No atomics: the same bits every run.
// - Widths: 32, 64, 128 (every variant, 128 or 256 rows), 192 (ce_lse's
//   base at 256 rows: 198,728 bytes of smem), 256 (base at 128 rows), 384
//   (base at 128 rows on a 2-stage ring) and 512 (base at 64 rows, one
//   consumer warpgroup taking no turns, on a 2-stage ring: B9's D = 512
//   shape without the hit mask); lse_rows_for, as ops/fused_ce.py's
//   lse_rows. The wrapper pads any other D <= 1024 with zero columns, which
//   add nothing to q . table^T.
// - D = 768 and 1024: ce_lse_kc_kernel, kchunk.cuh's K-chunked forward. A
//   block holds 64 query rows (96 or 128 KB) and streams each 64-row catalog
//   tile as 256-column chunks (32 KB) through a ring of 4 stages at 768, 3 at
//   1024; the tile's logits accumulate across its chunks and are folded as
//   above (lse_fold, base variant), and split-V and lse_merge are as above.
//   Every streamed byte is used by 64 rows only, so it leans on L2 as D =
//   512 does: at the bench shape (N = 32,768) each block reads the whole
//   catalog, 90 MB at D = 1024, from L2.
// - Past D = 1024, any multiple of 256 (the wrapper pads any wider D to
//   one): ce_lse_kc_kernel<0>, kchunk.cuh's streamed forward. A block's 64
//   query rows (160 KB at 1280, 256 KB at 2048) no longer fit, so they
//   arrive chunk by chunk with each catalog tile's chunk, 64 KB a stage on
//   3 stages; the width is a run-time loop bound, the fold, split-V and
//   merge as above. The query rows are re-read from L2 for every tile: at
//   the bench shape at D = 2048 a block reads 180 MB of catalog and as much
//   of its own rows.
// - Any N and V: TMA zero-fills rows past N and V, ragged columns are masked
//   to -inf (they add 0); a range wholly in the -1e30 tail keeps a finite max
//   (-1e30 in base 2) and a sum that the merge scales by 2^(-1e30 - max) = 0.
//
// The entry point launches on the given stream, does not synchronise and
// allocates nothing; it returns cudaGetLastError() after its launches.

#include "kchunk.cuh"
#include "wgmma_tiles.cuh"

namespace {

// The forward's variants (see the top of the file); the C entry's numbering.
enum LseVariant { kBase = 0, kExp2 = 1, kNoMax = 2 };
constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit, with no scaling multiply in front.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------- the kernel

constexpr int kLseStr = 64;     // catalog rows a streamed tile, the wgmma's N
constexpr int kLseRows = 256;   // ce_lse's query rows a block: Cons = 4

// The smem ring of streamed tiles: 4 stages up to D = 256; 2 at D = 384
// and 512, where a 64-row tile is 48 or 64 KB (B9's D = 512 ring, sampled.cu).
__host__ __device__ constexpr int lse_stages(int D) { return D >= 384 ? 2 : 4; }

// Query rows a block: 64 a consumer warpgroup. Threads: the consumers and
// one producer warpgroup.
template <int Cons>
__host__ __device__ constexpr int lse_rows() {
  return 64 * Cons;
}

template <int D, int Cons>
constexpr int lse_wg_smem_bytes() {
  // 1024: room to align the base; the stages' biases; the barriers.
  constexpr int ST = lse_stages(D);
  return 1024 + (lse_rows<Cons>() + ST * kLseStr) * D * 2 + ST * kLseStr * 4 + (2 * ST + 1) * 8;
}

__device__ __forceinline__ void named_sync(int id) { asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory"); }
__device__ __forceinline__ void named_arrive(int id) { asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory"); }

// The logits of a warpgroup's 64 resident rows against a catalog tile, both
// K-major in smem (swizzled chunks of sw bytes a row, `rows` rows a chunk).
// Starts and commits. The consumer warpgroups take turns in a ring: group
// wg waits on named barrier 1 + wg (but for group 0's first product),
// starts its product, then lets group wg + 1 go on barrier 1 + (wg + 1) %
// Cons (but for the last group's last product); `n` and `of` count this
// group's products. One warpgroup (D = 512) takes no turns.
template <int D, int Cons>
__device__ __forceinline__ void lse_logits(float (&s)[kLseStr / 2], uint32_t res, uint32_t tile, int wg, int n, int of) {
  constexpr int SW = swizzle_bytes(D), KPC = SW / 32;
  if (Cons > 1 && (wg > 0 || n > 0)) named_sync(1 + wg);
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    wgmma_ss<kLseStr>(s, smem_desc(res + (ks / KPC) * lse_rows<Cons>() * SW + (ks % KPC) * 32, 16, 8 * SW, SW),
                      smem_desc(tile + (ks / KPC) * kLseStr * SW + (ks % KPC) * 32, 16, 8 * SW, SW), ks > 0);
  }
  wgmma_commit();
  if (Cons > 1 && (wg < Cons - 1 || n < of - 1)) named_arrive(1 + (wg + 1) % Cons);
}

// Logits are folded in base 2: t = fmaf(logit, log2e, bias * log2e), one FMA
// with the bias, then ex2(t - m). (Subtracting m * log2e inside the FMA,
// ex2(fmaf(x, log2e, -m log2e)), would leave the rounding error of
// m * log2e, up to 2^76 at a max of -1e30, in the exponent of a range that
// lies wholly in the -1e30 tail.) The running max starts below every t,
// -1e30 * log2e included, but finite, so no -inf - -inf arises; nomax keeps
// it at 0.
constexpr float kLseInit = -3.0e38f;
constexpr float kLn2 = 0.6931471805599453f;

// Folds a tile's logits s (columns c0 + 8j + 2t + e of rows g and g + 8) and
// the stage's biases into the running base-2 max m and sum l of the two
// rows, the variant's way (see the top of the file); kMask: columns at or
// past n_valid are -inf, and add 0.
template <int Var, bool kMask>
__device__ __forceinline__ void lse_fold(float (&s)[kLseStr / 2], float (&m)[2], float (&l)[2], const float* bias, int c0,
                                         int n_valid, int t) {
  float tmax[2][2] = {{kLseInit, kLseInit}, {kLseInit, kLseInit}};
#pragma unroll
  for (int j = 0; j < kLseStr / 8; ++j) {
    const float2 b = *reinterpret_cast<const float2*>(bias + j * 8 + 2 * t);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool ok = !kMask || c0 + j * 8 + 2 * t + e < n_valid;
      const float bv = e ? b.y : b.x, b2 = Var == kExp2 ? bv : bv * kLog2e;  // exp2's bias arrives scaled
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float& x = s[4 * j + 2 * r + e];
        if constexpr (Var == kExp2) {
          x = ok ? x + b2 : -INFINITY;
        } else {
          x = ok ? fmaf(x, kLog2e, b2) : -INFINITY;
        }
        if constexpr (Var != kNoMax) tmax[r][e] = fmaxf(tmax[r][e], x);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if constexpr (Var == kNoMax) {
      float acc[2] = {l[r], 0.f};
#pragma unroll
      for (int j = 0; j < kLseStr / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) acc[e] += ex2(s[4 * j + 2 * r + e]);
      }
      l[r] = acc[0] + acc[1];
    } else {
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
}

// The end of a block: the four threads of a quad hold the same two rows
// (row0 and row0 + 8) over disjoint columns; their partials are merged,
// and thread t == 0 writes lse or, with S ranges, the rows' partial base-2
// max and sum to part[split * N + row] and part[(S + split) * N + row].
template <int Var>
__device__ __forceinline__ void lse_store(float (&m)[2], float (&l)[2], float* __restrict__ lse,
                                          float* __restrict__ part, int row0, int N, int split, int S, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], off);
      if constexpr (Var == kNoMax) {
        l[r] += lo;
      } else {
        const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
        const float mn = fmaxf(m[r], mo);
        l[r] = l[r] * ex2(m[r] - mn) + lo * ex2(mo - mn);
        m[r] = mn;
      }
    }
  }
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= N) continue;
      if (S == 1) {
        lse[row] = (m[r] + log2f(l[r])) * kLn2;
      } else {
        part[(size_t)split * N + row] = m[r];
        part[(size_t)(S + split) * N + row] = l[r];
      }
    }
  }
}

// Blocks: (row block of 64 Cons, catalog range). With one range it writes
// lse; with S ranges (gridDim.y) it writes its rows' partial base-2 max and
// sum to part[split * N + row] and part[(S + split) * N + row].
template <int D, int Var, int Cons>
__global__ void __launch_bounds__(128 * (Cons + 1), 1)
    ce_lse_wg_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap t_map,
                     const __grid_constant__ CUtensorMap b_map, float* __restrict__ lse, float* __restrict__ part,
                     int N, int V, int tiles_per_split) {
  constexpr int SW = swizzle_bytes(D), CC = SW / 2, NCH = D / CC, Rows = lse_rows<Cons>();
  constexpr int kLseStages = lse_stages(D);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* res_s = base;                                            // [NCH][Rows][SW bytes]
  unsigned char* str_s = base + Rows * D * 2;                             // [kLseStages][NCH][kLseStr][SW bytes]
  float* bias_s = reinterpret_cast<float*>(str_s + kLseStages * kLseStr * D * 2);  // [kLseStages][kLseStr]
  uint64_t* full = reinterpret_cast<uint64_t*>(bias_s + kLseStages * kLseStr);
  uint64_t* empty = full + kLseStages;
  uint64_t* res_full = empty + kLseStages;

  const int r0 = blockIdx.x * Rows;
  const int split = blockIdx.y, S = gridDim.y;
  const int n_tiles = (V + kLseStr - 1) / kLseStr;
  const int t0 = split * tiles_per_split, t1 = min(n_tiles, t0 + tiles_per_split);
  if (threadIdx.x == 0) {
    for (int st = 0; st < kLseStages; ++st) {
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
        mbar_arrive_expect_tx(&full[st], kLseStr * D * 2 + kLseStr * 4);
        for (int c = 0; c < NCH; ++c) {
          tma_load_2d(str_s + (st * NCH + c) * kLseStr * SW, &t_map, c * CC, it * kLseStr, &full[st]);
        }
        tma_load_1d(bias_s + st * kLseStr, &b_map, it * kLseStr, &full[st]);
        if (++st == kLseStages) {
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
  constexpr float kMaxInit = Var == kNoMax ? 0.f : kLseInit;
  float m[2] = {kMaxInit, kMaxInit}, l[2] = {0.f, 0.f};
  float s0[kLseStr / 2], s1[kLseStr / 2];
  mbar_wait(&full[0], 0);  // every range has a tile
  lse_logits<D, Cons>(s0, res_addr, str_addr, wg, n++, of);
  auto step = [&](float (&sc)[kLseStr / 2], float (&sn)[kLseStr / 2], int cur) {
    const int st = (min(cur, t1 - 1) - t0) % kLseStages;
    wgmma_wait<0>();
    fence_regs(sc);
    if (cur > t0 && cur < t1) {  // the warp is done with the previous stage: lane 0 says so
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(st + kLseStages - 1) % kLseStages]);
    }
    const int k = min(cur + 1, t1 - 1) - t0;
    mbar_wait(&full[k % kLseStages], (k / kLseStages) & 1);
    lse_logits<D, Cons>(sn, res_addr, str_addr + (k % kLseStages) * NCH * kLseStr * SW, wg, n++, of);
    const float* b = bias_s + st * kLseStr;
    if (cur >= t1 || (cur + 1) * kLseStr > V) {
      lse_fold<Var, true>(sc, m, l, b, cur * kLseStr, cur < t1 ? V : 0, t);
    } else {
      lse_fold<Var, false>(sc, m, l, b, 0, 0, t);
    }
  };
  for (int it = t0; it < t1; it += 2) {
    step(s0, s1, it);
    step(s1, s0, it + 1);
  }
  wgmma_wait<0>();
  fence_regs(s0);
  lse_store<Var>(m, l, lse, part, r0 + wg * 64 + wi * 16 + g, N, split, S, t);
}

// D = 768 and 1024 (see the top of the file): 64 query rows a block, the
// base variant, kchunk.cuh's K-chunked stream of catalog tiles. D = 0: any
// width past 1024, `width` columns (a multiple of 256), the query rows
// streamed with the tiles (kcs_fwd_run).
template <int D>
__global__ void __launch_bounds__(256, 1)
    ce_lse_kc_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap t_map,
                     const __grid_constant__ CUtensorMap b_map, float* __restrict__ lse, float* __restrict__ part,
                     int N, int V, int tiles_per_split, int width) {
  const int split = blockIdx.y, S = gridDim.y;
  const int n_tiles = (V + kLseStr - 1) / kLseStr;
  const int t0 = split * tiles_per_split, t1 = min(n_tiles, t0 + tiles_per_split);
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const CUtensorMap* const vecs[1] = {&b_map};
  float m[2] = {kLseInit, kLseInit}, l[2] = {0.f, 0.f};
  auto fold = [&](float (&s)[32], float (&mm)[2], float (&ll)[2], const float* b, int it) {
    if ((it + 1) * kLseStr > V) {
      lse_fold<kBase, true>(s, mm, ll, b, it * kLseStr, V, t);
    } else {
      lse_fold<kBase, false>(s, mm, ll, b, 0, 0, t);
    }
  };
  bool consumer;
  if constexpr (D == 0) {
    consumer = kcs_fwd_run<1>(m, l, &q_map, &t_map, vecs, t0, t1, width / kKc, fold);
  } else {
    consumer = kc_fwd_run<D, 1>(m, l, &q_map, &t_map, vecs, t0, t1, fold);
  }
  if (consumer) lse_store<kBase>(m, l, lse, part, blockIdx.x * kKcRows + threadIdx.x / 32 * 16 + g, N, split, S, t);
}

// The S ranges' partials of row i, in base 2, in range order:
// lse[i] = (M + log2(sum over s of l_s 2^(m_s - M))) ln 2, M = max_s m_s
// (nomax's partial maxima are all 0: lse[i] = log2(sum over s of l_s) ln 2).
__global__ void lse_merge(const float* __restrict__ part, float* __restrict__ lse, int N, int S) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  float M = part[i];
  for (int s = 1; s < S; ++s) M = fmaxf(M, part[(size_t)s * N + i]);
  float L = 0.f;
  for (int s = 0; s < S; ++s) L += part[(size_t)(S + s) * N + i] * exp2f(part[(size_t)s * N + i] - M);
  lse[i] = (M + log2f(L)) * kLn2;
}

// The catalog ranges of a launch with `rows` query rows a block.
int lse_splits(int N, int V, int rows, int* per) {
  return fill_splits((N + rows - 1) / rows, (V + kLseStr - 1) / kLseStr, per);
}

template <int D, int Var, int Cons>
cudaError_t run_lse_wg(const void* q, const void* table, const void* bias, void* lse, void* scratch, int N, int V,
                       cudaStream_t s) {
  constexpr int Rows = lse_rows<Cons>();
  CUtensorMap q_map, t_map, b_map;
  if (!make_map(&q_map, q, N, D, Rows) || !make_map(&t_map, table, V, D, kLseStr) ||
      !make_vec_map(&b_map, static_cast<const float*>(bias), V, kLseStr)) {
    return cudaErrorInvalidValue;
  }
  int per = 0;
  const int S = lse_splits(N, V, Rows, &per);
  constexpr int smem = lse_wg_smem_bytes<D, Cons>();
  auto kernel = ce_lse_wg_kernel<D, Var, Cons>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  float* part = static_cast<float*>(scratch);
  kernel<<<dim3((N + Rows - 1) / Rows, S), 128 * (Cons + 1), smem, s>>>(q_map, t_map, b_map,
                                                                         static_cast<float*>(lse), part, N, V, per);
  e = cudaGetLastError();
  if (e != cudaSuccess || S == 1) return e;
  lse_merge<<<(N + 255) / 256, 256, 0, s>>>(part, static_cast<float*>(lse), N, S);
  return cudaGetLastError();
}

// The shared memory of ce_lse_kc_kernel<D>.
template <int D>
constexpr int lse_kc_smem() {
  if constexpr (D == 0) {
    return KcsFwd<1>::kSmem;
  } else {
    return KcFwd<D, 1>::kSmem;
  }
}

// ce_lse_kc_kernel at D = 768 or 1024, or at D = 0 with `width` columns
// past 1024; splits and merge as run_lse_wg's.
template <int D>
cudaError_t run_lse_kc(const void* q, const void* table, const void* bias, void* lse, void* scratch, int N, int V,
                       int width, cudaStream_t s) {
  CUtensorMap q_map, t_map, b_map;
  if (!make_map(&q_map, q, N, width, kKcRows) || !make_map(&t_map, table, V, width, kLseStr) ||
      !make_vec_map(&b_map, static_cast<const float*>(bias), V, kLseStr)) {
    return cudaErrorInvalidValue;
  }
  int per = 0;
  const int S = lse_splits(N, V, kKcRows, &per);
  constexpr int smem = lse_kc_smem<D>();
  cudaError_t e = cudaFuncSetAttribute(ce_lse_kc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  float* part = static_cast<float*>(scratch);
  ce_lse_kc_kernel<D><<<dim3((N + kKcRows - 1) / kKcRows, S), 256, smem, s>>>(
      q_map, t_map, b_map, static_cast<float*>(lse), part, N, V, per, width);
  e = cudaGetLastError();
  if (e != cudaSuccess || S == 1) return e;
  lse_merge<<<(N + 255) / 256, 256, 0, s>>>(part, static_cast<float*>(lse), N, S);
  return cudaGetLastError();
}

template <int D, int Var>
cudaError_t run_lse_rows(const void* q, const void* table, const void* bias, void* lse, void* scratch, int N, int V,
                         int rows, cudaStream_t s) {
  if (rows == 128) return run_lse_wg<D, Var, 2>(q, table, bias, lse, scratch, N, V, s);
  return run_lse_wg<D, Var, 4>(q, table, bias, lse, scratch, N, V, s);
}

template <int D>
cudaError_t run_lse_variant(const void* q, const void* table, const void* bias, void* lse, void* scratch, int N, int V,
                            int variant, int rows, cudaStream_t s) {
  switch (variant) {
    case kExp2: return run_lse_rows<D, kExp2>(q, table, bias, lse, scratch, N, V, rows, s);
    case kNoMax: return run_lse_rows<D, kNoMax>(q, table, bias, lse, scratch, N, V, rows, s);
    default: return run_lse_rows<D, kBase>(q, table, bias, lse, scratch, N, V, rows, s);
  }
}

// The rows a block of ce_lse at width D: 256 (Cons = 4) up to D = 192,
// 128 (Cons = 2) at D = 256, where 256 resident rows (128 KB) beside the
// 4-stage ring (128 KB) would pass the 227 KB a block may opt into; two
// warpgroups keep B9's D = 256 shape (sampled.cu), whose 256 rows on a
// 3-stage ring timed no faster. At D = 384, 128 rows (96 KB) on a 2-stage
// ring (96 KB); at D = 512, B9's D = 512 shape: 64 rows (64 KB) on a
// 2-stage ring (128 KB). Both take 198,184 bytes of smem. From D = 768, 64
// rows (ce_lse_kc_kernel).
__host__ __device__ constexpr int lse_rows_for(int D) {
  return D >= 512 ? 64 : D == 256 || D == 384 ? 128 : kLseRows;
}

// B12's variants and both row counts up to D = 128; above it only
// ce_lse's own instantiation (the base variant at lse_rows_for(D)).
bool lse_takes(int D, int variant, int rows) {
  if (D <= 128) return rows == 128 || rows == kLseRows;
  return variant == kBase && rows == lse_rows_for(D);
}

}  // namespace

// The widths the kernels are built for, the forward's here and the backward's
// in ce_bwd.cu: a list up to 1024, then every multiple of 256 (the streamed
// kernels, D = 0 in their templates). The wrapper pads any D <= 1024 with
// zero columns to the next of the list, and any wider D to the next multiple
// of 256 (ops/widths.py padded_dim).
extern "C" int ce_supports_dim(int D) {
  return D == 32 || D == 64 || D == 128 || D == 192 || D == 256 || D == 384 || D == 512 || D == 768 || D == 1024 ||
         (D > 1024 && D % kKc == 0);
}

// The shape of ce_lse's block at a width it is built for, as out[0..2]: the
// query rows a block, the ring's stages and the columns a streamed chunk
// (D itself up to 512, where a tile arrives whole); ops/fused_ce.py's
// lse_plan mirrors it. Returns 0 for a width it is not built for.
extern "C" int ce_lse_plan(int D, int* out) {
  if (!ce_supports_dim(D)) return 0;
  out[0] = lse_rows_for(D);
  out[1] = D > 1024  ? KcsFwd<1>::kStages
           : D == 768 ? KcFwd<768, 1>::kStages
           : D == 1024 ? KcFwd<1024, 1>::kStages
                       : lse_stages(D);
  out[2] = D > 512 ? kKc : D;
  return 1;
}

// Floats of scratch a launch with `rows` query rows a block needs for its
// ranges' partial sums (0 when the row blocks fill the card: pass any
// pointer).
extern "C" int ce_lse_scratch(int N, int V, int D, int rows) {
  if (N <= 0 || V <= 0 || !ce_supports_dim(D) || !lse_takes(D, kBase, rows)) return 0;
  int per = 0;
  const int S = lse_splits(N, V, rows, &per);
  return S > 1 ? 2 * S * N : 0;
}

// The forward: variant is a LseVariant (0 base, 1 exp2: q and bias already
// scaled by log2(e), 2 nomax), rows 128 or 256 (2 or 4 consumer
// warpgroups); ce_lse is base at lse_rows_for(D). D = 192 to 1024 take
// only that.
extern "C" int ce_lse_variant(const void* q, const void* table, const void* bias, void* lse, void* scratch, int N,
                              int V, int D, int variant, int rows, int device, void* stream) {
  if (!ce_supports_dim(D) || V <= 0 || variant < kBase || variant > kNoMax || !lse_takes(D, variant, rows)) {
    return cudaErrorInvalidValue;
  }
  if (N <= 0) return cudaSuccess;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return run_lse_variant<32>(q, table, bias, lse, scratch, N, V, variant, rows, s);
    case 64: return run_lse_variant<64>(q, table, bias, lse, scratch, N, V, variant, rows, s);
    case 192: return run_lse_wg<192, kBase, lse_rows_for(192) / 64>(q, table, bias, lse, scratch, N, V, s);
    case 256: return run_lse_wg<256, kBase, lse_rows_for(256) / 64>(q, table, bias, lse, scratch, N, V, s);
    case 384: return run_lse_wg<384, kBase, lse_rows_for(384) / 64>(q, table, bias, lse, scratch, N, V, s);
    case 512: return run_lse_wg<512, kBase, lse_rows_for(512) / 64>(q, table, bias, lse, scratch, N, V, s);
    case 768: return run_lse_kc<768>(q, table, bias, lse, scratch, N, V, D, s);
    case 1024: return run_lse_kc<1024>(q, table, bias, lse, scratch, N, V, D, s);
    case 128: return run_lse_variant<128>(q, table, bias, lse, scratch, N, V, variant, rows, s);
    default: return run_lse_kc<0>(q, table, bias, lse, scratch, N, V, D, s);
  }
}
