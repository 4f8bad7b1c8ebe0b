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
//   1. topk_slice_kernel, grid (slices, B): a block walks one vocab slice of
//      one query row chunk by chunk and writes the slice's k best (value, id)
//      pairs to scratch [B, slices, k] that the wrapper allocates;
//   2. topk_merge_kernel, grid (B): a block merges a row's slices * k
//      candidates into the final k. With one slice, pass 1 writes the result
//      and pass 2 is not launched.
// Both passes run the same loop over chunks of kBuf - k pairs. A shared
// buffer holds the running k best in slots [0, k); each chunk appends only
// the pairs that beat the current k-th (the counterpart of the TPU kernel's
// skipped merge) behind them, and a bitonic sort of the smallest power of two
// that holds them, under the total order (value desc, id asc), leaves the new
// k best in front. Ids are distinct, so that order is total and the result
// does not depend on how the vocab is cut into slices and chunks: it equals a
// stable descending sort. Empty slots hold (-inf, INT_MAX) and lose to every
// real row, including rows padded with a -1e30 bias.
//
// What bounds it on this card: the scoring is B*V*D*2 FLOP, negligible, but
// each block scores one query row, so the table (V*D*2 bytes, 1 MB at config
// #1) is read once per query row: B*V*D*2 bytes from the 50 MB L2, 268 MB at
// B=256. Measured on an H100 at B=256, V=8192, D=64, k=128, that scoring
// took ~90 of the first pass's ~150 us and the sorts the rest. The
// sorts are shared-memory compare-swaps between block barriers, so the
// design sorts as few pairs as it can (only those that beat the k-th, in the
// smallest power of two) and cuts the vocab into only as many slices as it
// takes to fill the card. A later version can score several query rows per
// block (with wgmma) so that a table tile is read once for all of them, and
// select with a radix threshold instead of a sort.
//
// The entry points launch on the given stream, do not synchronise and
// allocate nothing; they return cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBuf = 1024;          // pairs in the sort buffer; k <= 128 leaves >= 896 new pairs a chunk
constexpr int kMaxD = 1024;
constexpr int kMaxSlices = 64;      // per query row, so pass 2 merges at most 64 * k candidates
constexpr int kTargetBlocks = 264;  // two blocks for each of the H100's 132 SMs

__device__ __forceinline__ bool before(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// Sorts the first n pairs (n a power of two, 2 <= n <= kBuf) into "before"
// order. Called by all threads.
__device__ void bitonic_sort(float* v, int* id, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int t = threadIdx.x; t < n / 2; t += kThreads) {
        const int lo = ((t & ~(stride - 1)) << 1) | (t & (stride - 1));
        const int hi = lo + stride;
        const float lv = v[lo], hv = v[hi];
        const int li = id[lo], hi_id = id[hi];
        const bool forward = (lo & size) == 0;
        const bool swap = forward ? before(hv, hi_id, lv, li) : before(lv, li, hv, hi_id);
        if (swap) {
          v[lo] = hv;
          v[hi] = lv;
          id[lo] = hi_id;
          id[hi] = li;
        }
      }
    }
  }
  __syncthreads();
}

struct Running {
  float kth_v;
  int kth_i;
};

struct TopkSmem {
  float v[kBuf];
  int id[kBuf];
  int count;  // pairs appended behind the running k this chunk
};

__device__ void init_running(TopkSmem& s, int k) {
  for (int i = threadIdx.x; i < k; i += kThreads) {
    s.v[i] = -INFINITY;
    s.id[i] = INT_MAX;
  }
  if (threadIdx.x == 0) s.count = 0;
  __syncthreads();
}

// Appends (value, id) if it beats the current k-th. Called by every thread
// of the block the same number of times (warp-wide ballot, one shared
// atomic per warp).
__device__ __forceinline__ void offer(TopkSmem& s, int k, const Running& cur, bool valid, float value, int id) {
  const bool beats = valid && before(value, id, cur.kth_v, cur.kth_i);
  const unsigned m = __ballot_sync(0xffffffffu, beats);
  const int lane = threadIdx.x & 31;
  int base = 0;
  if (lane == 0 && m) base = atomicAdd(&s.count, __popc(m));
  base = __shfl_sync(0xffffffffu, base, 0);
  if (beats) {
    const int p = k + base + __popc(m & ((1u << lane) - 1u));
    s.v[p] = value;
    s.id[p] = id;
  }
}

// After a chunk's offers: sort the running k and the appended pairs, return
// the new k-th, and reset the count for the next chunk.
__device__ Running absorb(TopkSmem& s, int k, Running cur) {
  __syncthreads();
  const int filled = k + s.count;  // <= kBuf: a chunk offers at most kBuf - k pairs
  if (filled > k) {
    int n = 2;
    while (n < filled) n <<= 1;
    for (int i = filled + threadIdx.x; i < n; i += kThreads) {
      s.v[i] = -INFINITY;
      s.id[i] = INT_MAX;
    }
    bitonic_sort(s.v, s.id, n);
    cur.kth_v = s.v[k - 1];
    cur.kth_i = s.id[k - 1];
  }
  __syncthreads();  // every thread has read count and the k-th
  if (threadIdx.x == 0) s.count = 0;
  __syncthreads();
  return cur;
}

__global__ void __launch_bounds__(kThreads) topk_slice_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ table,
    const float* __restrict__ bias, float* __restrict__ cand_v, int* __restrict__ cand_i, int V, int D,
    int k, int slice_len) {
  __shared__ TopkSmem s;
  __shared__ __align__(16) float qs[kMaxD];

  const int sl = blockIdx.x;
  const int b = blockIdx.y;
  const int slices = gridDim.x;
  for (int d = threadIdx.x; d < D; d += kThreads) qs[d] = __bfloat162float(q[(size_t)b * D + d]);
  init_running(s, k);

  const int start = sl * slice_len;
  const int end = min(V, start + slice_len);
  const int chunk = kBuf - k;
  Running cur{-INFINITY, INT_MAX};
  for (int c0 = start; c0 < end; c0 += chunk) {
    const int c1 = min(end, c0 + chunk);
    for (int r0 = c0; r0 < c1; r0 += kThreads) {
      const int row = r0 + threadIdx.x;
      const bool valid = row < c1;
      float score = 0.0f;
      if (valid) {
        const uint4* src = reinterpret_cast<const uint4*>(table + (size_t)row * D);
        const float4* q4 = reinterpret_cast<const float4*>(qs);
        float acc = 0.0f;
        // Unrolled so that a row's 16-byte loads (8 at D=64) are in flight
        // together: ~8% off pass 1 at config #1's shapes.
#pragma unroll 8
        for (int d8 = 0; d8 < D / 8; ++d8) {
          const uint4 raw = src[d8];
          const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw);
          const float4 qa = q4[2 * d8], qb = q4[2 * d8 + 1];
          const float2 e0 = __bfloat1622float2(e[0]), e1 = __bfloat1622float2(e[1]);
          const float2 e2 = __bfloat1622float2(e[2]), e3 = __bfloat1622float2(e[3]);
          acc = fmaf(qa.x, e0.x, acc);
          acc = fmaf(qa.y, e0.y, acc);
          acc = fmaf(qa.z, e1.x, acc);
          acc = fmaf(qa.w, e1.y, acc);
          acc = fmaf(qb.x, e2.x, acc);
          acc = fmaf(qb.y, e2.y, acc);
          acc = fmaf(qb.z, e3.x, acc);
          acc = fmaf(qb.w, e3.y, acc);
        }
        score = acc + bias[row];
      }
      offer(s, k, cur, valid, score, row);
    }
    cur = absorb(s, k, cur);
  }
  const size_t base = ((size_t)b * slices + sl) * k;
  for (int i = threadIdx.x; i < k; i += kThreads) {
    cand_v[base + i] = s.v[i];
    cand_i[base + i] = s.id[i];
  }
}

__global__ void __launch_bounds__(kThreads) topk_merge_kernel(const float* __restrict__ cand_v,
                                                              const int* __restrict__ cand_i,
                                                              float* __restrict__ out_v, int* __restrict__ out_i,
                                                              int n_cand, int k) {
  __shared__ TopkSmem s;

  const int b = blockIdx.x;
  init_running(s, k);
  const int chunk = kBuf - k;
  const float* rv = cand_v + (size_t)b * n_cand;
  const int* ri = cand_i + (size_t)b * n_cand;
  Running cur{-INFINITY, INT_MAX};
  for (int c0 = 0; c0 < n_cand; c0 += chunk) {
    const int c1 = min(n_cand, c0 + chunk);
    for (int r0 = c0; r0 < c1; r0 += kThreads) {
      const int j = r0 + threadIdx.x;
      const bool valid = j < c1;
      offer(s, k, cur, valid, valid ? rv[j] : 0.0f, valid ? ri[j] : 0);
    }
    cur = absorb(s, k, cur);
  }
  for (int i = threadIdx.x; i < k; i += kThreads) {
    out_v[(size_t)b * k + i] = s.v[i];
    out_i[(size_t)b * k + i] = s.id[i];
  }
}

}  // namespace

// How pass 1 cuts the vocab for B query rows: returns the number of slices
// per row and writes their length. A slice is a whole number of chunks; there
// are as many slices as it takes for B * slices to reach ~kTargetBlocks, at
// most kMaxSlices and at most one per chunk.
extern "C" int topk_plan(int V, int k, int B, int* slice_len) {
  const int chunk = kBuf - k;
  const int n_chunks = (V + chunk - 1) / chunk;
  int want = (kTargetBlocks + B - 1) / (B > 0 ? B : 1);
  want = want < 1 ? 1 : (want > kMaxSlices ? kMaxSlices : want);
  const int slices = want < n_chunks ? want : n_chunks;
  const int per_slice = (n_chunks + slices - 1) / slices;
  *slice_len = chunk * per_slice;
  return (V + *slice_len - 1) / *slice_len;
}

// cand_v/cand_i: scratch [B, slices, k] (unused when slices == 1);
// out_v/out_i: [B, k].
extern "C" int topk_fwd(const void* q, const void* table, const void* bias, void* cand_v, void* cand_i,
                        void* out_v, void* out_i, int B, int V, int D, int k, int slices, int slice_len,
                        int device, void* stream) {
  if (k < 1 || k > 128 || D % 8 != 0 || D > kMaxD || slices < 1 || slices > kMaxSlices ||
      (long long)slices * slice_len < V || B > 65535)
    return cudaErrorInvalidValue;
  if (B <= 0) return cudaSuccess;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool one = slices == 1;
  topk_slice_kernel<<<dim3(slices, B), kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(table),
      static_cast<const float*>(bias), static_cast<float*>(one ? out_v : cand_v),
      static_cast<int*>(one ? out_i : cand_i), V, D, k, slice_len);
  e = cudaGetLastError();
  if (e != cudaSuccess || one) return e;
  topk_merge_kernel<<<B, kThreads, 0, st>>>(static_cast<const float*>(cand_v), static_cast<const int*>(cand_i),
                                            static_cast<float*>(out_v), static_cast<int*>(out_i), slices * k, k);
  return cudaGetLastError();
}
