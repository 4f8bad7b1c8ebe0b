// Full-catalog softmax cross-entropy for Hopper (sm_90a): the forward
// log-sum-exp. The backward is ce_bwd.cu.
//
// Replaces the TPU kernel poi_tpu/ops/fused_ce.py:_lse_kernel (driven by
// _pallas_lse), and the forward's tuning variants of scripts/sweep_ce_fwd.py
// (_lse_kernel_exp2, _lse_kernel_nomax, driven by build), entry point
// ce_lse_variant:
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
// Contract (the same arithmetic as the TPU kernel):
//   q     [N, D] bf16   queries, already rounded
//   table [V, D] bf16   output table, already rounded
//   bias  [V]    fp32   (-1e30 on padded catalog rows)
//   logits l = q . table^T + bias: exact bf16 products, fp32 sums
//   ce_lse:  lse [N] fp32 = log sum_v exp(l[n, v])
//
// What bounds it on this card: the catalog product is 2*N*V*D FLOPs
// (0.37 TFLOP at N=32768, V=44170, D=128), far above what the CUDA cores do
// in the step's budget, so it runs on the tensor cores: warp-level mma.sync
// m16n8k16, bf16 operands, fp32 accumulators. Next come the N*V
// exponentials, and the re-reads of the catalog from L2 (once per block of
// rows).
//
// Design:
// - A block is 4 warps (8 in the 128-row variants); each warp owns 16 query
//   rows, whose bf16 fragments stay in registers for the whole kernel. The
//   catalog streams through shared memory in tiles of 64 rows,
//   double-buffered with cp.async so the next tile loads while this one is
//   multiplied. Smem rows are padded by 8 bf16 so the fragment loads of a
//   warp hit 32 banks.
// - Logit tiles never leave registers. ce_lse keeps an ordinary running max
//   and sum per row (the TPU kernel's per-lane accumulators exist for its
//   vector lanes), merged across the four threads that share a row at the
//   end.
// - Any N and V: ragged tiles are zero-filled by cp.async and masked out of
//   the sums (exp of a masked logit is never taken).
//
// The entry points launch on the given stream, do not synchronise and
// allocate nothing; each returns cudaGetLastError() after its launches.

#include "mma_tiles.cuh"

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
// rows: mma_tiles.cuh's kTile is shared with sampled.cu, and tile_logits
// produces a warp's 16 x 64 logits in registers (32 fp32 a thread) from it.
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

}  // namespace

// The widths the kernels are built for, the forward's here and the backward's
// in ce_bwd.cu; the wrapper checks D against it.
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
