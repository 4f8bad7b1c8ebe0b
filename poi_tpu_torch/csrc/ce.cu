// Full-catalog softmax cross-entropy for Hopper (sm_90a): the forward
// log-sum-exp and the two backward passes.
//
// Replaces the TPU kernels poi_tpu/ops/fused_ce.py:_lse_kernel (driven by
// _pallas_lse) and :_bwd_kernel (driven by _bwd_slab / _pallas_bwd), and the
// forward's tuning variants of scripts/sweep_ce_fwd.py (_lse_kernel_exp2,
// _lse_kernel_nomax, driven by build), entry point ce_lse_variant:
//   base   the online max and sum of ce_lse, exponentials by __expf;
//   exp2   q and bias arrive scaled by log2(e) (q before its bf16 rounding),
//          so the logits are in base 2: the max and sum stay in base 2 with
//          ex2.approx (inline PTX: no log2(e) multiply per logit), and
//          lse = (log2(l) + m) / log2(e);
//   nomax  no running max: l += ex2.approx(x * log2(e)), lse = log(l). Unsafe
//          (fp32 overflows) past logits of about 88; it measures what the max
//          loop costs.
// each with 64 rows a block (4 warps, ce_lse's) or 128 (8 warps), the
// counterpart of the TPU sweep's row-block axis. base at 64 rows is the very
// kernel ce_lse launches.
//
// Contract (the same arithmetic as the TPU kernels):
//   q     [N, D] bf16   queries, already rounded
//   table [V, D] bf16   output table, already rounded
//   bias  [V]    fp32   (-1e30 on padded catalog rows)
//   logits l = q . table^T + bias: exact bf16 products, fp32 sums
//   ce_lse:  lse [N] fp32 = log sum_v exp(l[n, v])
//   ce_bwd:  gp = exp(l - lse[n]) * g[n] in fp32, gpb = bf16(gp)
//            dq     [N, D] fp32 = gpb   . table
//            dtable [V, D] fp32 = gpb^T . q
//            dbias  [V]    fp32 = colsum(gp)        (the unrounded gp)
//   The one-hot target terms are left to the caller, as on the TPU.
//
// What bounds it on this card: each catalog product is 2*N*V*D FLOPs
// (0.37 TFLOP at N=32768, V=44170, D=128), far above what the CUDA cores do
// in the step's budget, so every product runs on the tensor cores:
// warp-level mma.sync m16n8k16, bf16 operands, fp32 accumulators. Next come
// the N*V exponentials of each pass, and the re-reads of the streamed
// operand from L2 (once per block of 64 rows).
//
// Design:
// - A block is 4 warps (8 in the 128-row forward variants); each warp owns
//   16 rows of the resident operand (queries in ce_lse / ce_bwd_dq, catalog
//   rows in ce_bwd_dtable), whose bf16 fragments stay in registers for the
//   whole kernel. The other operand streams through shared memory in tiles
//   of 64 rows, double-buffered with cp.async so the next tile loads while
//   this one is multiplied. Smem rows are padded by 8 bf16 so the fragment
//   loads of a warp hit 32 banks.
// - Logit tiles never leave registers. In the backward, the fp32 accumulator
//   fragment of the logits is exactly the A-operand fragment of the next
//   product, so gp is rounded to bf16 and multiplied in place.
// - ce_lse keeps an ordinary running max and sum per row (the TPU kernel's
//   per-lane accumulators exist for its vector lanes), merged across the
//   four threads that share a row at the end.
// - The backward is two kernels: ce_bwd_dq (row blocks loop over the
//   catalog) and ce_bwd_dtable (catalog blocks loop over the rows). Each
//   recomputes the logits, so the backward does four catalog products where
//   the TPU kernel, which keeps dq resident in VMEM, does three. In exchange
//   neither needs atomics: every output element is summed by one thread in
//   a fixed order, and a run gives the same bits every time. A one-pass
//   design is later work.
// - Any N and V: ragged tiles are zero-filled by cp.async and masked out of
//   the sums (exp of a masked logit is never taken).
//
// The entry points launch on the given stream, do not synchronise and
// allocate nothing; each returns cudaGetLastError() after its launches.

#include "mma_tiles.cuh"

namespace {

// lse and g of rows [r0, r0 + kTile) into smem; rows past N read as 0.
__device__ __forceinline__ void load_rows(float* lse_s, float* g_s, const float* lse, const float* g, int r0, int N) {
  const int i = threadIdx.x % kTile;
  const bool ok = r0 + i < N;
  const float* src = threadIdx.x < kTile ? lse : g;
  float* dst = threadIdx.x < kTile ? lse_s : g_s;
  cp_async4(dst + i, src + (ok ? r0 + i : 0), ok);
}

template <int D>
constexpr int smem_bytes() {
  return 3 * kTile * (D + kPad) * 2 + 4 * kTile * 4;  // resident tile + two streamed tiles + 2x(lse, g)
}

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
// rows: mma_tiles.cuh's kTile is shared with sampled.cu, and tile_logits
// produces a warp's 16 x 64 logits in registers (32 fp32 a thread) from it.
template <int Rows>
__host__ __device__ constexpr int lse_threads() {
  return Rows * 2;  // Rows / 16 warps
}

template <int D, int Rows>
constexpr int lse_smem_bytes() {
  return (Rows + 2 * kTile) * (D + kPad) * 2 + 4 * kTile * 4;  // smem_bytes<D>() at 64 rows
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

template <int D>
__global__ void __launch_bounds__(kThreads)
    ce_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ table, const float* __restrict__ bias,
                     const float* __restrict__ lse, const float* __restrict__ gin, float* __restrict__ dq, int N,
                     int V) {
  constexpr int LD = D + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* res_s = reinterpret_cast<bf16*>(smem);
  bf16* str_s = res_s + kTile * LD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * kTile;

  load_tile<D>(res_s, q, n0, N);
  load_tile<D>(str_s, table, 0, V);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) load_a<LD>(qa[ks], res_s, warp * 16, ks * 16, g, t);
  const int row0 = n0 + warp * 16 + g;
  bool row_ok[2];
  float row_lse[2], row_g[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row_ok[r] = row0 + 8 * r < N;
    row_lse[r] = row_ok[r] ? lse[row0 + 8 * r] : 0.f;
    row_g[r] = row_ok[r] ? gin[row0 + 8 * r] : 0.f;
  }

  float out[D / 8][4];
#pragma unroll
  for (int jn = 0; jn < D / 8; ++jn) out[jn][0] = out[jn][1] = out[jn][2] = out[jn][3] = 0.f;
  const int tiles = (V + kTile - 1) / kTile;
  for (int it = 0; it < tiles; ++it) {
    if (it + 1 < tiles) load_tile<D>(str_s + ((it + 1) & 1) * kTile * LD, table, (it + 1) * kTile, V);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* tile = str_s + (it & 1) * kTile * LD;
    float acc[8][4];
    tile_logits<D>(acc, qa, tile, g, t);
    const int v0 = it * kTile;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = v0 + j * 8 + 2 * t + e;
        const bool ok = col < V;
        const float b = ok ? __ldg(bias + col) : 0.f;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          acc[j][2 * r + e] = ok && row_ok[r] ? __expf(acc[j][2 * r + e] + b - row_lse[r]) * row_g[r] : 0.f;
        }
      }
    }
    accumulate_product<D>(out, acc, tile, g, t);
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!row_ok[r]) continue;
    float* dst = dq + (size_t)(row0 + 8 * r) * D + 2 * t;
#pragma unroll
    for (int jn = 0; jn < D / 8; ++jn) {
      *reinterpret_cast<float2*>(dst + jn * 8) = make_float2(out[jn][2 * r], out[jn][2 * r + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    ce_bwd_dtable_kernel(const bf16* __restrict__ q, const bf16* __restrict__ table, const float* __restrict__ bias,
                         const float* __restrict__ lse, const float* __restrict__ gin, float* __restrict__ dtable,
                         float* __restrict__ dbias, int N, int V) {
  constexpr int LD = D + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* res_s = reinterpret_cast<bf16*>(smem);
  bf16* str_s = res_s + kTile * LD;
  float* lse_s = reinterpret_cast<float*>(str_s + 2 * kTile * LD);  // [2][kTile]
  float* g_s = lse_s + 2 * kTile;                                   // [2][kTile]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int v0 = blockIdx.x * kTile;

  load_tile<D>(res_s, table, v0, V);
  load_tile<D>(str_s, q, 0, N);
  load_rows(lse_s, g_s, lse, gin, 0, N);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t ea[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) load_a<LD>(ea[ks], res_s, warp * 16, ks * 16, g, t);
  const int vrow0 = v0 + warp * 16 + g;
  bool row_ok[2];
  float row_b[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row_ok[r] = vrow0 + 8 * r < V;
    row_b[r] = row_ok[r] ? bias[vrow0 + 8 * r] : 0.f;
  }

  float out[D / 8][4];
#pragma unroll
  for (int jn = 0; jn < D / 8; ++jn) out[jn][0] = out[jn][1] = out[jn][2] = out[jn][3] = 0.f;
  float db[2] = {0.f, 0.f};
  const int tiles = (N + kTile - 1) / kTile;
  for (int it = 0; it < tiles; ++it) {
    if (it + 1 < tiles) {
      const int nb = (it + 1) & 1;
      load_tile<D>(str_s + nb * kTile * LD, q, (it + 1) * kTile, N);
      load_rows(lse_s + nb * kTile, g_s + nb * kTile, lse, gin, (it + 1) * kTile, N);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int cb = it & 1;
    const bf16* tile = str_s + cb * kTile * LD;
    const float* tl = lse_s + cb * kTile;
    const float* tg = g_s + cb * kTile;
    float acc[8][4];
    tile_logits<D>(acc, ea, tile, g, t);  // [catalog row][query row] of this tile
    const int n0 = it * kTile;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = j * 8 + 2 * t + e;
        const bool ok = n0 + c < N;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float gp = ok && row_ok[r] ? __expf(acc[j][2 * r + e] + row_b[r] - tl[c]) * tg[c] : 0.f;
          acc[j][2 * r + e] = gp;
          db[r] += gp;
        }
      }
    }
    accumulate_product<D>(out, acc, tile, g, t);
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    db[r] += __shfl_xor_sync(0xffffffffu, db[r], 1);
    db[r] += __shfl_xor_sync(0xffffffffu, db[r], 2);
    if (!row_ok[r]) continue;
    if (t == 0) dbias[vrow0 + 8 * r] = db[r];
    float* dst = dtable + (size_t)(vrow0 + 8 * r) * D + 2 * t;
#pragma unroll
    for (int jn = 0; jn < D / 8; ++jn) {
      *reinterpret_cast<float2*>(dst + jn * 8) = make_float2(out[jn][2 * r], out[jn][2 * r + 1]);
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

template <int D>
cudaError_t run_bwd(const void* q, const void* table, const void* bias, const void* lse, const void* g, void* dq,
                    void* dtable, void* dbias, int N, int V, cudaStream_t s) {
  constexpr int smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(ce_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(ce_bwd_dtable_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* tb = static_cast<const bf16*>(table);
  const float* bb = static_cast<const float*>(bias);
  const float* lb = static_cast<const float*>(lse);
  const float* gb = static_cast<const float*>(g);
  ce_bwd_dq_kernel<D><<<(N + kTile - 1) / kTile, kThreads, smem, s>>>(qb, tb, bb, lb, gb, static_cast<float*>(dq),
                                                                      N, V);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ce_bwd_dtable_kernel<D><<<(V + kTile - 1) / kTile, kThreads, smem, s>>>(
      qb, tb, bb, lb, gb, static_cast<float*>(dtable), static_cast<float*>(dbias), N, V);
  return cudaGetLastError();
}

}  // namespace

// The widths the kernels are built for; the wrapper checks D against it.
extern "C" int ce_supports_dim(int D) { return D == 32 || D == 64 || D == 128; }

extern "C" int ce_lse(const void* q, const void* table, const void* bias, void* lse, int N, int V, int D, int device,
                      void* stream) {
  if (!ce_supports_dim(D) || V <= 0) return cudaErrorInvalidValue;
  if (N <= 0) return cudaSuccess;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return run_lse<32>(q, table, bias, lse, N, V, s);
    case 64: return run_lse<64>(q, table, bias, lse, N, V, s);
    default: return run_lse<128>(q, table, bias, lse, N, V, s);
  }
}

// B12: the forward's tuning variants. variant is a LseVariant (0 base, 1 exp2:
// q and bias already scaled by log2(e), 2 nomax); rows is 64 or 128.
// Variant 0 at 64 rows is ce_lse.
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

extern "C" int ce_bwd(const void* q, const void* table, const void* bias, const void* lse, const void* g, void* dq,
                      void* dtable, void* dbias, int N, int V, int D, int device, void* stream) {
  if (!ce_supports_dim(D) || V <= 0 || N <= 0) return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return run_bwd<32>(q, table, bias, lse, g, dq, dtable, dbias, N, V, s);
    case 64: return run_bwd<64>(q, table, bias, lse, g, dq, dtable, dbias, N, V, s);
    default: return run_bwd<128>(q, table, bias, lse, g, dq, dtable, dbias, N, V, s);
  }
}
