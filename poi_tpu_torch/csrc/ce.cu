// Full-catalog softmax cross-entropy for Hopper (sm_90a): the forward
// log-sum-exp. The backward is ce_bwd.cu.
//
// Replaces the TPU kernel poi_tpu/ops/fused_ce.py:_lse_kernel (driven by
// _pallas_lse), entry point ce_lse, and the forward's tuning variants of
// scripts/sweep_ce_fwd.py (_lse_kernel_exp2, _lse_kernel_nomax, driven by
// build), entry point ce_lse_variant.
//
// Contract (the same arithmetic as the TPU kernel):
//   q     [N, D] bf16   queries, already rounded
//   table [V, D] bf16   output table, already rounded
//   bias  [V]    fp32   (-1e30 on padded catalog rows)
//   logits l = q . table^T + bias: exact bf16 products, fp32 sums
//   ce_lse:  lse [N] fp32 = log sum_v exp(l[n, v])
//
// What bounds ce_lse on this card: the catalog product, 2*N*V*D FLOPs
// (0.37 TFLOP at N=32768, V=44170, D=128: 0.37 ms at the tensor cores' 989
// TFLOP/s), and the N*V exponentials on the special-function units (1.45e9:
// 0.35 ms at 16 a clock an SM), about equal, so it is fast only where the two
// overlap, and with them the few fp32 operations of each logit.
//
// ce_lse's design (ce_lse_wg_kernel): warp-specialised, on wgmma and TMA
// (wgmma_tiles.cuh, as ce_bwd.cu's passes).
// - A block holds 256 query rows, loaded once by TMA into a swizzled smem
//   tile: four consumer warpgroups of 64 rows each. A producer warpgroup
//   (its registers handed to the consumers with setmaxnreg) keeps a ring of
//   4 stages of 64 catalog rows and their bias in flight by TMA, guarded by
//   mbarriers (full: the bytes arrived; empty: every consumer warp is done
//   with the stage). 256 rows make the bench shape's 32,768 rows 128 blocks,
//   one wave on 132 SMs, and halve the catalog's re-reads from L2 against
//   128 rows (1.45 GB a call).
// - Each consumer warpgroup runs wgmma m64n64k16 over a tile, A and B both
//   read from smem by descriptor, into one of two logit buffers, starts the
//   next tile's product, and folds this tile into a running max and sum per
//   row while the tensor cores work. The warpgroups take turns to issue
//   their products (a ring of named barriers, FlashAttention-3's
//   ping-pong), so some warpgroups' exponentials overlap others' products.
//   Each logit costs one FMA that scales it to base 2 with its bias
//   (t = fmaf(x, log2e, bias log2e)), a max, ex2(t - m) and an add; the max
//   and sum per row stay in base 2 (lse_fold).
// - Why four warpgroups: in development builds with two, a variant that
//   started no wgmma took as long as the kernel, and one without the
//   exponentials most of it: the fold's latency, not a pipe's rate, set the
//   time. Four warpgroups hide more of it.
// - Split-V: where the row blocks cannot fill the card (config #3's N = 2,048
//   is 8 blocks), the catalog's tiles are cut into S contiguous ranges
//   (fill_splits), one block a (row block, range). Each writes its rows'
//   partial base-2 (max, sum) to scratch the wrapper allocates
//   (ce_lse_scratch), and lse_merge combines the S pairs of a row in range
//   order. No atomics: the same bits every run.
// - Any N and V: TMA zero-fills rows past N and V, ragged columns are masked
//   to -inf; a range wholly in the -1e30 tail keeps a finite max (-1e30 in
//   base 2) and a sum that the merge scales by 2^(-1e30 - max) = 0.
//
// ce_lse_variant (B12) keeps the first, warp-level design: mma.sync m16n8k16
// (mma_tiles.cuh), 4 warps (8 in the 128-row variants), each owning 16 query
// rows whose fragments stay in registers, the catalog streamed through smem
// in tiles of 64 rows double-buffered with cp.async (rows padded by 8 bf16),
// an ordinary running max and sum per row, ragged tiles zero-filled and
// masked. Its variants:
//   base   the online max and sum, exponentials by __expf;
//   exp2   q and bias arrive scaled by log2(e) (q before its bf16 rounding),
//          so the logits are in base 2: the max and sum stay in base 2 with
//          ex2.approx (inline PTX: no log2(e) multiply per logit), and
//          lse = (log2(l) + m) / log2(e);
//   nomax  no running max: l += ex2.approx(x * log2(e)), lse = log(l). Unsafe
//          (fp32 overflows) past logits of about 88; it measures what the max
//          loop costs.
// each with 64 rows a block (4 warps) or 128 (8 warps), the counterpart of the
// TPU sweep's row-block axis.
//
// The entry points launch on the given stream, do not synchronise and
// allocate nothing; each returns cudaGetLastError() after its launches.

#include "mma_tiles.cuh"
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

// exp in the variant's base: e^x for base (__expf: a log2(e) multiply, then
// ex2.approx), 2^x for exp2, whose logits are already in base 2.
template <int Var>
__device__ __forceinline__ float exp_v(float x) {
  if constexpr (Var == kExp2) return ex2(x);
  return __expf(x);
}

// Resident query rows: 64 (4 warps) or 128 (8 warps, each streamed tile
// feeding twice the rows). The streamed catalog tile stays at kTile = 64
// rows: tile_logits produces a warp's 16 x 64 logits in registers (32 fp32 a
// thread) from it.
template <int Rows>
__host__ __device__ constexpr int lse_threads() {
  return Rows * 2;  // Rows / 16 warps
}

template <int D, int Rows>
constexpr int lse_smem_bytes() {
  return (Rows + 2 * kTile) * (D + kPad) * 2;  // the resident rows, two streamed tiles
}

template <int D, int Var = kBase, int Rows = kTile>
__global__ void __launch_bounds__(lse_threads<Rows>())
    ce_lse_kernel(const bf16* __restrict__ q, const bf16* __restrict__ table, const float* __restrict__ bias,
                  float* __restrict__ lse, int N, int V) {
  constexpr int LD = D + kPad;
  constexpr int kBlockThreads = lse_threads<Rows>();
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* res_s = reinterpret_cast<bf16*>(smem);  // [Rows][LD]
  bf16* str_s = res_s + Rows * LD;              // [2][kTile][LD]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * Rows;

#pragma unroll
  for (int rt = 0; rt < Rows / kTile; ++rt) {
    load_tile<D, kBlockThreads>(res_s + rt * kTile * LD, q, n0 + rt * kTile, N);
  }
  load_tile<D, kBlockThreads>(str_s, table, 0, V);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) load_a<LD>(qa[ks], res_s, warp * 16, ks * 16, g, t);

  float m[2] = {kNegInit, kNegInit}, l[2] = {0.f, 0.f};
  const int tiles = (V + kTile - 1) / kTile;
  for (int it = 0; it < tiles; ++it) {
    if (it + 1 < tiles) load_tile<D, kBlockThreads>(str_s + ((it + 1) & 1) * kTile * LD, table, (it + 1) * kTile, V);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    float acc[8][4];
    tile_logits<D>(acc, qa, str_s + (it & 1) * kTile * LD, g, t);
    const int v0 = it * kTile;
    if constexpr (Var == kNoMax) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = v0 + j * 8 + 2 * t + e;
          const bool ok = col < V;
          const float b = ok ? __ldg(bias + col) : 0.f;
#pragma unroll
          for (int r = 0; r < 2; ++r) l[r] += ok ? ex2((acc[j][2 * r + e] + b) * kLog2e) : 0.f;
        }
      }
    } else {
      float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = v0 + j * 8 + 2 * t + e;
          const bool ok = col < V;
          const float b = ok ? __ldg(bias + col) : 0.f;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float x = ok ? acc[j][2 * r + e] + b : -INFINITY;
            acc[j][2 * r + e] = x;
            tmax[r] = fmaxf(tmax[r], x);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mn = fmaxf(m[r], tmax[r]);
        float s = l[r] * exp_v<Var>(m[r] - mn);
#pragma unroll
        for (int j = 0; j < 8; ++j) s += exp_v<Var>(acc[j][2 * r]  - mn) + exp_v<Var>(acc[j][2 * r + 1] - mn);
        m[r] = mn;
        l[r] = s;
      }
    }
    __syncthreads();  // every warp is done with this buffer before the next load overwrites it
  }
  // The four threads of a quad hold the same two rows over disjoint columns.
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
        l[r] = l[r] * exp_v<Var>(m[r] - mn) + lo * exp_v<Var>(mo - mn);
        m[r] = mn;
      }
    }
  }
  if (t == 0) {
    const int row = n0 + warp * 16 + g;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row + 8 * r >= N) continue;
      float out;
      if constexpr (Var == kBase) out = m[r] + logf(l[r]);
      else if constexpr (Var == kExp2) out = (log2f(l[r]) + m[r]) / kLog2e;
      else out = logf(l[r]);
      lse[row + 8 * r] = out;
    }
  }
}

template <int D, int Var = kBase, int Rows = kTile>
cudaError_t run_lse(const void* q, const void* table, const void* bias, void* lse, int N, int V, cudaStream_t s) {
  constexpr int smem = lse_smem_bytes<D, Rows>();
  auto kernel = ce_lse_kernel<D, Var, Rows>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<(N + Rows - 1) / Rows, lse_threads<Rows>(), smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(table), static_cast<const float*>(bias),
      static_cast<float*>(lse), N, V);
  return cudaGetLastError();
}

template <int D, int Var>
cudaError_t run_lse_rows(const void* q, const void* table, const void* bias, void* lse, int N, int V, int rows,
                         cudaStream_t s) {
  if (rows == 128) return run_lse<D, Var, 128>(q, table, bias, lse, N, V, s);
  return run_lse<D, Var, 64>(q, table, bias, lse, N, V, s);
}

template <int D>
cudaError_t run_lse_variant(const void* q, const void* table, const void* bias, void* lse, int N, int V, int variant,
                            int rows, cudaStream_t s) {
  switch (variant) {
    case kExp2: return run_lse_rows<D, kExp2>(q, table, bias, lse, N, V, rows, s);
    case kNoMax: return run_lse_rows<D, kNoMax>(q, table, bias, lse, N, V, rows, s);
    default: return run_lse_rows<D, kBase>(q, table, bias, lse, N, V, rows, s);
  }
}

// ---------------------------------------------------------------- ce_lse

constexpr int kLseCons = 4;                // consumer warpgroups a block, 64 query rows each
constexpr int kLseRes = 64 * kLseCons;     // query rows a block
constexpr int kLseStr = 64;                // catalog rows a streamed tile, the wgmma's N
constexpr int kLseStages = 4;              // smem ring of streamed tiles
constexpr int kLseThreads = 128 * (kLseCons + 1);  // the consumers + 1 producer warpgroup

template <int D>
constexpr int lse_wg_smem_bytes() {
  // 1024: room to align the base; the stages' biases; the barriers.
  return 1024 + (kLseRes + kLseStages * kLseStr) * D * 2 + kLseStages * kLseStr * 4 + (2 * kLseStages + 1) * 8;
}

__device__ __forceinline__ void named_sync(int id) { asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory"); }
__device__ __forceinline__ void named_arrive(int id) { asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory"); }

// The logits of a warpgroup's 64 resident rows against a catalog tile, both
// K-major in smem (swizzled chunks of sw bytes a row, `rows` rows a chunk).
// Starts and commits. The consumer warpgroups take turns in a ring: group
// wg waits on named barrier 1 + wg (but for group 0's first product),
// starts its product, then lets group wg + 1 go on barrier 1 + (wg + 1) %
// kLseCons (but for the last group's last product); `n` and `of` count this
// group's products.
template <int D>
__device__ __forceinline__ void lse_logits(float (&s)[kLseStr / 2], uint32_t res, uint32_t tile, int wg, int n, int of) {
  constexpr int SW = swizzle_bytes(D), KPC = SW / 32;
  if (wg > 0 || n > 0) named_sync(1 + wg);
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    wgmma_ss<kLseStr>(s, smem_desc(res + (ks / KPC) * kLseRes * SW + (ks % KPC) * 32, 16, 8 * SW, SW),
                      smem_desc(tile + (ks / KPC) * kLseStr * SW + (ks % KPC) * 32, 16, 8 * SW, SW), ks > 0);
  }
  wgmma_commit();
  if (wg < kLseCons - 1 || n < of - 1) named_arrive(1 + (wg + 1) % kLseCons);
}

// Logits are folded in base 2: t = fmaf(logit, log2e, bias * log2e), one FMA
// with the bias, then ex2(t - m). (Subtracting m * log2e inside the FMA,
// ex2(fmaf(x, log2e, -m log2e)), would leave the rounding error of
// m * log2e, up to 2^76 at a max of -1e30, in the exponent of a range that
// lies wholly in the -1e30 tail.) The running max starts below every t,
// -1e30 * log2e included, but finite, so no -inf - -inf arises.
constexpr float kLseInit = -3.0e38f;
constexpr float kLn2 = 0.6931471805599453f;

// Folds a tile's logits s (columns c0 + 8j + 2t + e of rows g and g + 8) and
// the stage's biases into the running base-2 max m and sum l of the two
// rows; kMask: columns at or past n_valid are -inf.
template <bool kMask>
__device__ __forceinline__ void lse_fold(float (&s)[kLseStr / 2], float (&m)[2], float (&l)[2], const float* bias, int c0,
                                         int n_valid, int t) {
  float tmax[2][2] = {{kLseInit, kLseInit}, {kLseInit, kLseInit}};
#pragma unroll
  for (int j = 0; j < kLseStr / 8; ++j) {
    const float2 b = *reinterpret_cast<const float2*>(bias + j * 8 + 2 * t);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool ok = !kMask || c0 + j * 8 + 2 * t + e < n_valid;
      const float b2 = (e ? b.y : b.x) * kLog2e;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float& x = s[4 * j + 2 * r + e];
        x = ok ? fmaf(x, kLog2e, b2) : -INFINITY;
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

// Blocks: (row block of 128, catalog range). With one range it writes lse;
// with S ranges (gridDim.y) it writes its rows' partial base-2 max and sum
// to part[split * N + row] and part[(S + split) * N + row].
template <int D>
__global__ void __launch_bounds__(kLseThreads, 1)
    ce_lse_wg_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap t_map,
                     const __grid_constant__ CUtensorMap b_map, float* __restrict__ lse, float* __restrict__ part,
                     int N, int V, int tiles_per_split) {
  constexpr int SW = swizzle_bytes(D), CC = SW / 2, NCH = D / CC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* res_s = base;                                            // [NCH][kLseRes][SW bytes]
  unsigned char* str_s = base + kLseRes * D * 2;                          // [kLseStages][NCH][kLseStr][SW bytes]
  float* bias_s = reinterpret_cast<float*>(str_s + kLseStages * kLseStr * D * 2);  // [kLseStages][kLseStr]
  uint64_t* full = reinterpret_cast<uint64_t*>(bias_s + kLseStages * kLseStr);
  uint64_t* empty = full + kLseStages;
  uint64_t* res_full = empty + kLseStages;

  const int r0 = blockIdx.x * kLseRes;
  const int split = blockIdx.y, S = gridDim.y;
  const int n_tiles = (V + kLseStr - 1) / kLseStr;
  const int t0 = split * tiles_per_split, t1 = min(n_tiles, t0 + tiles_per_split);
  if (threadIdx.x == 0) {
    for (int st = 0; st < kLseStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 4 * kLseCons);  // every consumer warp
    }
    mbar_init(res_full, 1);
    mbar_init_fence();
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp >= 4 * kLseCons) {  // the producer warpgroup: one thread keeps the ring full
    // It needs few registers: hand them to the consumers (setmaxnreg works
    // per warpgroup, hence a whole producer warpgroup).
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == 4 * kLseCons && lane == 0) {
      mbar_arrive_expect_tx(res_full, kLseRes * D * 2);
      for (int c = 0; c < NCH; ++c) tma_load_2d(res_s + c * kLseRes * SW, &q_map, c * CC, r0, res_full);
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

  // 112 registers a consumer thread (the launch gives 96): two logit tiles
  // and the running sums with no spills.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 112;\n" ::: "memory");
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
  float m[2] = {kLseInit, kLseInit}, l[2] = {0.f, 0.f};
  float s0[kLseStr / 2], s1[kLseStr / 2];
  mbar_wait(&full[0], 0);  // every range has a tile
  lse_logits<D>(s0, res_addr, str_addr, wg, n++, of);
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
    lse_logits<D>(sn, res_addr, str_addr + (k % kLseStages) * NCH * kLseStr * SW, wg, n++, of);
    const float* b = bias_s + st * kLseStr;
    if (cur >= t1 || (cur + 1) * kLseStr > V) {
      lse_fold<true>(sc, m, l, b, cur * kLseStr, cur < t1 ? V : 0, t);
    } else {
      lse_fold<false>(sc, m, l, b, 0, 0, t);
    }
  };
  for (int it = t0; it < t1; it += 2) {
    step(s0, s1, it);
    step(s1, s0, it + 1);
  }
  wgmma_wait<0>();
  fence_regs(s0);

  // The four threads of a quad hold the same two rows over disjoint columns.
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
      const int row = r0 + wg * 64 + wi * 16 + g + 8 * r;
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

// The S ranges' partials of row i, in base 2, in range order:
// lse[i] = (M + log2(sum over s of l_s 2^(m_s - M))) ln 2, M = max_s m_s.
__global__ void lse_merge(const float* __restrict__ part, float* __restrict__ lse, int N, int S) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  float M = part[i];
  for (int s = 1; s < S; ++s) M = fmaxf(M, part[(size_t)s * N + i]);
  float L = 0.f;
  for (int s = 0; s < S; ++s) L += part[(size_t)(S + s) * N + i] * exp2f(part[(size_t)s * N + i] - M);
  lse[i] = (M + log2f(L)) * kLn2;
}

int lse_splits(int N, int V, int* per) {
  return fill_splits((N + kLseRes - 1) / kLseRes, (V + kLseStr - 1) / kLseStr, per);
}

template <int D>
cudaError_t run_lse_wg(const void* q, const void* table, const void* bias, void* lse, void* scratch, int N, int V,
                       cudaStream_t s) {
  CUtensorMap q_map, t_map, b_map;
  if (!make_map(&q_map, q, N, D, kLseRes) || !make_map(&t_map, table, V, D, kLseStr) ||
      !make_vec_map(&b_map, static_cast<const float*>(bias), V, kLseStr)) {
    return cudaErrorInvalidValue;
  }
  int per = 0;
  const int S = lse_splits(N, V, &per);
  constexpr int smem = lse_wg_smem_bytes<D>();
  auto kernel = ce_lse_wg_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  float* part = static_cast<float*>(scratch);
  kernel<<<dim3((N + kLseRes - 1) / kLseRes, S), kLseThreads, smem, s>>>(q_map, t_map, b_map, static_cast<float*>(lse),
                                                                        part, N, V, per);
  e = cudaGetLastError();
  if (e != cudaSuccess || S == 1) return e;
  lse_merge<<<(N + 255) / 256, 256, 0, s>>>(part, static_cast<float*>(lse), N, S);
  return cudaGetLastError();
}

}  // namespace

// The widths the kernels are built for, the forward's here and the backward's
// in ce_bwd.cu; the wrapper checks D against it.
extern "C" int ce_supports_dim(int D) { return D == 32 || D == 64 || D == 128; }

// Floats of scratch ce_lse needs for its ranges' partial sums (0 when the
// row blocks fill the card: pass any pointer).
extern "C" int ce_lse_scratch(int N, int V, int D) {
  if (N <= 0 || V <= 0 || !ce_supports_dim(D)) return 0;
  int per = 0;
  const int S = lse_splits(N, V, &per);
  return S > 1 ? 2 * S * N : 0;
}

extern "C" int ce_lse(const void* q, const void* table, const void* bias, void* lse, void* scratch, int N, int V, int D,
                      int device, void* stream) {
  if (!ce_supports_dim(D) || V <= 0) return cudaErrorInvalidValue;
  if (N <= 0) return cudaSuccess;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return run_lse_wg<32>(q, table, bias, lse, scratch, N, V, s);
    case 64: return run_lse_wg<64>(q, table, bias, lse, scratch, N, V, s);
    default: return run_lse_wg<128>(q, table, bias, lse, scratch, N, V, s);
  }
}

// B12: the forward's tuning variants. variant is a LseVariant (0 base, 1 exp2:
// q and bias already scaled by log2(e), 2 nomax); rows is 64 or 128.
extern "C" int ce_lse_variant(const void* q, const void* table, const void* bias, void* lse, int N, int V, int D,
                              int variant, int rows, int device, void* stream) {
  if (!ce_supports_dim(D) || V <= 0 || variant < kBase || variant > kNoMax || (rows != 64 && rows != 128)) {
    return cudaErrorInvalidValue;
  }
  if (N <= 0) return cudaSuccess;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return run_lse_variant<32>(q, table, bias, lse, N, V, variant, rows, s);
    case 64: return run_lse_variant<64>(q, table, bias, lse, N, V, variant, rows, s);
    default: return run_lse_variant<128>(q, table, bias, lse, N, V, variant, rows, s);
  }
}
