// Full-catalog softmax cross-entropy for Hopper (sm_90a): the forward
// log-sum-exp and the two backward passes.
//
// Replaces the TPU kernels poi_tpu/ops/fused_ce.py:_lse_kernel (driven by
// _pallas_lse) and :_bwd_kernel (driven by _bwd_slab / _pallas_bwd).
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
// - A block is 4 warps; each warp owns 16 rows of the resident operand
//   (queries in ce_lse / ce_bwd_dq, catalog rows in ce_bwd_dtable), whose
//   bf16 fragments stay in registers for the whole kernel. The other operand
//   streams through shared memory in tiles of 64 rows, double-buffered with
//   cp.async so the next tile loads while this one is multiplied. Smem rows
//   are padded by 8 bf16 so the fragment loads of a warp hit 32 banks.
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

template <int D>
__global__ void __launch_bounds__(kThreads) ce_lse_kernel(const bf16* __restrict__ q, const bf16* __restrict__ table,
                                                          const float* __restrict__ bias, float* __restrict__ lse,
                                                          int N, int V) {
  constexpr int LD = D + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* res_s = reinterpret_cast<bf16*>(smem);  // [kTile][LD]
  bf16* str_s = res_s + kTile * LD;             // [2][kTile][LD]
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

  float m[2] = {kNegInit, kNegInit}, l[2] = {0.f, 0.f};
  const int tiles = (V + kTile - 1) / kTile;
  for (int it = 0; it < tiles; ++it) {
    if (it + 1 < tiles) load_tile<D>(str_s + ((it + 1) & 1) * kTile * LD, table, (it + 1) * kTile, V);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    float acc[8][4];
    tile_logits<D>(acc, qa, str_s + (it & 1) * kTile * LD, g, t);
    const int v0 = it * kTile;
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
      float s = l[r] * __expf(m[r] - mn);
#pragma unroll
      for (int j = 0; j < 8; ++j) s += __expf(acc[j][2 * r]  - mn) + __expf(acc[j][2 * r + 1] - mn);
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
    const int row = n0 + warp * 16 + g;
    if (row < N) lse[row] = m[0] + logf(l[0]);
    if (row + 8 < N) lse[row + 8] = m[1] + logf(l[1]);
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

template <int D>
cudaError_t run_lse(const void* q, const void* table, const void* bias, void* lse, int N, int V, cudaStream_t s) {
  constexpr int smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(ce_lse_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  ce_lse_kernel<D><<<(N + kTile - 1) / kTile, kThreads, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(table), static_cast<const float*>(bias),
      static_cast<float*>(lse), N, V);
  return cudaGetLastError();
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
