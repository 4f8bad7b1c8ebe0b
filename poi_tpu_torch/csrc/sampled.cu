// Sampled softmax over one negative pool shared by every row, for Hopper
// (sm_90a): the pool log-sum-exp and its backward.
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
//     (the unrounded gp). A hit gets gp = 0 exactly.
//   The positive column and its gradient stay outside, as on the TPU.
//
// What bounds it on this card: at config #4's shape (N = 8,192 = B*T,
// S = 1,024, D = 256) each pool product is 4.3 GFLOP, a few tens of
// microseconds on the tensor cores, so the kernels are bound by how well
// they fill the card: 128 row blocks in the forward, and dE reduces 8,192
// rows into only 16 pool blocks of 64.
//
// Design (tile code shared with ce.cu through mma_tiles.cuh):
// - The resident operand's A fragments are read from shared memory at every
//   tile, not kept in registers as ce.cu keeps them: at D = 256 a thread
//   could not hold them beside its fp32 output sums. Each block sums at
//   most DO = min(D, 128) output columns, so blocks split D in column slices
//   and recompute the logits for each.
// - sampled_lse_kernel: row blocks of 64 stream the pool in double-buffered
//   tiles of 64 (cp.async), with a running max and sum per row.
// - sampled_dq_kernel: (row block, column slice) blocks stream the pool.
// - sampled_de_kernel: (pool block, column slice, row chunk) blocks: each
//   recomputes its 64 pool rows' logits against one chunk of the rows and
//   writes partial dE and db sums; sampled_reduce_kernel adds the chunks in
//   chunk order. The chunks are sized to put ~4 blocks on each SM. No
//   atomics anywhere: a run gives the same bits every time.
// - Any N and S: ragged tiles are zero-filled and masked out of the sums.
//
// The entry points launch on the given stream, do not synchronise and
// allocate nothing; each returns cudaGetLastError() after its launches.

#include "mma_tiles.cuh"

namespace {

constexpr int kTargetBlocks = 528;  // ~4 blocks on each of the H100's 132 SMs

template <int D>
__host__ __device__ constexpr int slice_cols() {
  return D < 128 ? D : 128;
}

template <int D>
constexpr int smem_bytes() {
  return 3 * kTile * (D + kPad) * 2 + 2 * 3 * kTile * 4;  // resident + two streamed tiles + 2x(lse, g, tgt)
}

// lse, g and tgt of rows [r0, r0 + kTile) into smem; rows at or past R read as 0.
__device__ __forceinline__ void load_rows(float* lse_s, float* g_s, int* tgt_s, const float* lse, const float* g,
                                          const int* tgt, int r0, int R) {
  const int i = threadIdx.x % kTile;
  const bool ok = r0 + i < R;
  const int src = ok ? r0 + i : 0;
  if (threadIdx.x < kTile) {
    cp_async4(lse_s + i, lse + src, ok);
    cp_async4(tgt_s + i, tgt + src, ok);
  } else {
    cp_async4(g_s + i, g + src, ok);
  }
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
__global__ void __launch_bounds__(kThreads)
    sampled_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ e, const float* __restrict__ b,
                      const int* __restrict__ ids, const int* __restrict__ tgt, const float* __restrict__ lse,
                      const float* __restrict__ gin, float* __restrict__ dq, int N, int S) {
  constexpr int LD = D + kPad;
  constexpr int DO = slice_cols<D>();
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* res_s = reinterpret_cast<bf16*>(smem);
  bf16* str_s = res_s + kTile * LD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * kTile;
  const int d0 = blockIdx.y * DO;
  const int row0 = n0 + warp * 16 + g;

  load_tile<D>(res_s, q, n0, N);
  load_tile<D>(str_s, e, 0, S);
  cp_async_commit();
  bool row_ok[2];
  float row_lse[2], row_g[2];
  int row_tgt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row_ok[r] = row0 + 8 * r < N;
    row_lse[r] = row_ok[r] ? lse[row0 + 8 * r] : 0.f;
    row_g[r] = row_ok[r] ? gin[row0 + 8 * r] : 0.f;
    row_tgt[r] = row_ok[r] ? tgt[row0 + 8 * r] : -1;
  }

  float out[DO / 8][4];
#pragma unroll
  for (int jn = 0; jn < DO / 8; ++jn) out[jn][0] = out[jn][1] = out[jn][2] = out[jn][3] = 0.f;
  const int tiles = (S + kTile - 1) / kTile;
  for (int it = 0; it < tiles; ++it) {
    if (it + 1 < tiles) load_tile<D>(str_s + ((it + 1) & 1) * kTile * LD, e, (it + 1) * kTile, S);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* tile = str_s + (it & 1) * kTile * LD;
    float acc[8][4];
    tile_logits_smem<D>(acc, res_s, warp * 16, tile, g, t);
    const int s0 = it * kTile;
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
          const bool live = ok && row_ok[r] && id != row_tgt[r];
          acc[j][2 * r + c] = live ? __expf(acc[j][2 * r + c] + bb - row_lse[r]) * row_g[r] : 0.f;
        }
      }
    }
    accumulate_product<DO, LD>(out, acc, tile + d0, g, t);
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!row_ok[r]) continue;
    float* dst = dq + (size_t)(row0 + 8 * r) * D + d0 + 2 * t;
#pragma unroll
    for (int jn = 0; jn < DO / 8; ++jn) {
      *reinterpret_cast<float2*>(dst + jn * 8) = make_float2(out[jn][2 * r], out[jn][2 * r + 1]);
    }
  }
}

// Partial sums over rows [z*chunk, (z+1)*chunk) of dE and db for pool rows
// [blockIdx.x*64, +64), output columns [blockIdx.y*DO, +DO).
template <int D>
__global__ void __launch_bounds__(kThreads)
    sampled_de_kernel(const bf16* __restrict__ q, const bf16* __restrict__ e, const float* __restrict__ b,
                      const int* __restrict__ ids, const int* __restrict__ tgt, const float* __restrict__ lse,
                      const float* __restrict__ gin, float* __restrict__ de_part, float* __restrict__ db_part, int N,
                      int S, int chunk) {
  constexpr int LD = D + kPad;
  constexpr int DO = slice_cols<D>();
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* res_s = reinterpret_cast<bf16*>(smem);                      // [kTile][LD] pool rows
  bf16* str_s = res_s + kTile * LD;                                 // [2][kTile][LD] query rows
  float* lse_s = reinterpret_cast<float*>(str_s + 2 * kTile * LD);  // [2][kTile]
  float* g_s = lse_s + 2 * kTile;                                   // [2][kTile]
  int* tgt_s = reinterpret_cast<int*>(g_s + 2 * kTile);             // [2][kTile]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int s0 = blockIdx.x * kTile;
  const int d0 = blockIdx.y * DO;
  const int n_begin = blockIdx.z * chunk;
  const int n_end = min(N, n_begin + chunk);

  load_tile<D>(res_s, e, s0, S);
  load_tile<D>(str_s, q, n_begin, n_end);
  load_rows(lse_s, g_s, tgt_s, lse, gin, tgt, n_begin, n_end);
  cp_async_commit();
  const int prow0 = s0 + warp * 16 + g;
  bool row_ok[2];
  float row_b[2];
  int row_id[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row_ok[r] = prow0 + 8 * r < S;
    row_b[r] = row_ok[r] ? b[prow0 + 8 * r] : 0.f;
    row_id[r] = row_ok[r] ? ids[prow0 + 8 * r] : -1;
  }

  float out[DO / 8][4];
#pragma unroll
  for (int jn = 0; jn < DO / 8; ++jn) out[jn][0] = out[jn][1] = out[jn][2] = out[jn][3] = 0.f;
  float db[2] = {0.f, 0.f};
  const int tiles = (n_end - n_begin + kTile - 1) / kTile;
  for (int it = 0; it < tiles; ++it) {
    if (it + 1 < tiles) {
      const int nb = (it + 1) & 1;
      const int r0 = n_begin + (it + 1) * kTile;
      load_tile<D>(str_s + nb * kTile * LD, q, r0, n_end);
      load_rows(lse_s + nb * kTile, g_s + nb * kTile, tgt_s + nb * kTile, lse, gin, tgt, r0, n_end);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int cb = it & 1;
    const bf16* tile = str_s + cb * kTile * LD;
    const float* tl = lse_s + cb * kTile;
    const float* tg = g_s + cb * kTile;
    const int* tt = tgt_s + cb * kTile;
    float acc[8][4];
    tile_logits_smem<D>(acc, res_s, warp * 16, tile, g, t);  // [pool row][query row] of this tile
    const int nn0 = n_begin + it * kTile;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = j * 8 + 2 * t + c;
        const bool ok = nn0 + col < n_end;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const bool live = ok && row_ok[r] && row_id[r] != tt[col];
          const float gp = live ? __expf(acc[j][2 * r + c] + row_b[r] - tl[col]) * tg[col] : 0.f;
          acc[j][2 * r + c] = gp;
          db[r] += gp;
        }
      }
    }
    accumulate_product<DO, LD>(out, acc, tile + d0, g, t);
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    db[r] += __shfl_xor_sync(0xffffffffu, db[r], 1);
    db[r] += __shfl_xor_sync(0xffffffffu, db[r], 2);
    if (!row_ok[r]) continue;
    const size_t prow = (size_t)blockIdx.z * S + prow0 + 8 * r;
    if (t == 0 && blockIdx.y == 0) db_part[prow] = db[r];
    float* dst = de_part + prow * D + d0 + 2 * t;
#pragma unroll
    for (int jn = 0; jn < DO / 8; ++jn) {
      *reinterpret_cast<float2*>(dst + jn * 8) = make_float2(out[jn][2 * r], out[jn][2 * r + 1]);
    }
  }
}

__global__ void sampled_reduce_kernel(const float* __restrict__ part, float* __restrict__ out, int n, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += part[(size_t)z * n + i];
  out[i] = s;
}

// Rows of N per chunk of the dE pass: enough chunks for ~kTargetBlocks
// blocks, each a multiple of kTile rows.
int de_chunk(int N, int S, int D) {
  const int slices = D / (D < 128 ? D : 128);
  const int blocks = ((S + kTile - 1) / kTile) * slices;
  int splits = (kTargetBlocks + blocks - 1) / blocks;
  const int max_splits = (N + kTile - 1) / kTile;
  if (splits > max_splits) splits = max_splits;
  if (splits < 1) splits = 1;
  const int per = (N + splits - 1) / splits;
  return (per + kTile - 1) / kTile * kTile;
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

template <int D>
cudaError_t run_bwd(const void* q, const void* e, const void* b, const void* ids, const void* tgt, const void* lse,
                    const void* g, void* dq, void* de_part, void* db_part, void* de, void* db, int N, int S,
                    cudaStream_t s) {
  constexpr int smem = smem_bytes<D>();
  constexpr int slices = D / slice_cols<D>();
  cudaError_t err = cudaFuncSetAttribute(sampled_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(sampled_de_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* eb = static_cast<const bf16*>(e);
  const float* bb = static_cast<const float*>(b);
  const int* ib = static_cast<const int*>(ids);
  const int* tb = static_cast<const int*>(tgt);
  const float* lb = static_cast<const float*>(lse);
  const float* gb = static_cast<const float*>(g);
  sampled_dq_kernel<D><<<dim3((N + kTile - 1) / kTile, slices), kThreads, smem, s>>>(
      qb, eb, bb, ib, tb, lb, gb, static_cast<float*>(dq), N, S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int chunk = de_chunk(N, S, D);
  const int splits = (N + chunk - 1) / chunk;
  sampled_de_kernel<D><<<dim3((S + kTile - 1) / kTile, slices, splits), kThreads, smem, s>>>(
      qb, eb, bb, ib, tb, lb, gb, static_cast<float*>(de_part), static_cast<float*>(db_part), N, S, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = S * D;
  sampled_reduce_kernel<<<(n + 255) / 256, 256, 0, s>>>(static_cast<const float*>(de_part), static_cast<float*>(de),
                                                        n, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sampled_reduce_kernel<<<(S + 255) / 256, 256, 0, s>>>(static_cast<const float*>(db_part), static_cast<float*>(db),
                                                        S, splits);
  return cudaGetLastError();
}

}  // namespace

// The widths the kernels are built for; the wrapper checks D against it.
extern "C" int sampled_supports_dim(int D) { return D == 64 || D == 128 || D == 256; }

// Row chunks of the dE pass: the wrapper allocates [splits, S, D] and
// [splits, S] fp32 partial sums.
extern "C" int sampled_bwd_splits(int N, int S, int D) {
  if (N <= 0 || S <= 0 || !sampled_supports_dim(D)) return 1;
  const int chunk = de_chunk(N, S, D);
  return (N + chunk - 1) / chunk;
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

extern "C" int sampled_bwd(const void* q, const void* e, const void* b, const void* ids, const void* tgt,
                           const void* lse, const void* g, void* dq, void* de_part, void* db_part, void* de, void* db,
                           int N, int S, int D, int device, void* stream) {
  if (!sampled_supports_dim(D) || S <= 0 || N <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return run_bwd<64>(q, e, b, ids, tgt, lse, g, dq, de_part, db_part, de, db, N, S, s);
    case 128: return run_bwd<128>(q, e, b, ids, tgt, lse, g, dq, de_part, db_part, de, db, N, S, s);
    default: return run_bwd<256>(q, e, b, ids, tgt, lse, g, dq, de_part, db_part, de, db, N, S, s);
  }
}
