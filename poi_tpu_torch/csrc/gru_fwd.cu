// GRU forward recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel poi_tpu/ops/fused_gru.py:_fwd_kernel (driven by
// fused_gru_scan/_fwd): the whole T-step recurrence in one launch, h0 = 0,
// with the padding mask already folded into the z block of xw as -1e9.
//
// Contract (same as the TPU kernel):
//   xw [B, T, 3H] fp32, gate blocks ordered z | r | n, one bias already added
//   wh [H, 3H]    bf16
//   hs [B, T, H]  fp32 out
//   per step: hw = bf16(h) @ wh with fp32 accumulation,
//             z = sigmoid(xz + hz), r = sigmoid(xr + hr),
//             n = tanh(xn + r * hn), h = (1 - z) * h + z * n.
//
// What bounds it on this card: the T steps are a serial chain, and each step
// is a tiny [B, H] x [H, 3H] product (B=256, H=64: 6.3 MFLOP a step). The
// card is latency-bound, not FLOP- or byte-bound: per step the cost is one
// block barrier plus an H-long loop of three FMAs on shared-memory operands
// per thread. At B=256, H=64 the launch has 128 blocks of 4 warps, under one
// block per SM; measured on an H100 that is ~2.3 us a step. A later version
// can split each column's dot product across threads to put more warps on
// each step.
//
// Design:
// - Each block owns `rows` = 128 / H batch rows (one at H >= 128); thread
//   (row, j) owns hidden column j of
//   its row. Its fp32 carry h[row][j] lives in a register of that thread for
//   the whole sequence; only the bf16-rounded copy other threads need for the
//   recurrent product goes to shared memory.
// - wh is loaded once per block into shared memory (6*H*H bytes: 24 KB at
//   H=64, 96 KB at H=128) and read from there at every step.
// - The bf16 copy of h is double-buffered, so each step needs one barrier:
//   step t reads buffer t&1 and writes buffer (t+1)&1.
// - xw for step t+1 is loaded while step t computes, hiding global latency.
// - Rows past B (the ragged last block) compute on zeros and store nothing;
//   any B is accepted.
// - That path holds bf16 wh (6*H*H bytes) in one block, so it takes H <= 196.
//
// H > 196 (config #4's H = 256, config #5's H = 512): gru_fwd_cluster_kernel.
// - wh's columns are split by hidden unit across a thread-block cluster of C
//   CTAs (C = 2 at H = 256, 8 at H = 512): CTA p owns units
//   [p*H/C, (p+1)*H/C) and keeps their z, r and n columns of wh, [H, 3H/C]
//   bf16, in its shared memory (192 KB at both widths).
// - One cluster owns one batch row; thread u of CTA p owns hidden unit
//   p*H/C + u, its fp32 carry in a register, as in the one-block kernel.
// - Each step every thread writes bf16(h) of its unit into the next h buffer
//   of every CTA of the cluster (distributed shared memory), then one
//   cluster barrier (release/acquire) makes the whole row visible to all.
//   The h buffer is double-buffered, so one barrier a step suffices.
// - The recurrent dot product walks k = 0 .. H-1 with the same fmaf chain as
//   the one-block kernel, so every path gives the same gates bit for bit,
//   and the backward's recompute (csrc/gru_bwd.cu) reproduces them.
// - B = 64 rows at H = 256 launch 128 CTAs of 128 threads, one per SM.
//   Streaming wh from L2 instead would re-read 384 KB per row per step
//   (3.2 GB a sequence at B = 64, T = 128); the cluster reads it once.
//
// An H that neither path takes is refused (cudaErrorInvalidValue); the
// Python wrapper raises a clear error first (gru_fwd_cluster_size == 0).
//
// The entry point launches on the given stream, does not synchronise and
// allocates nothing; it returns cudaGetLastError() after the launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxSmem = 232448;  // 227 KB: the most a block may opt into

__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / (1.0f + expf(-x)); }

__global__ void gru_fwd_kernel(const float* __restrict__ xw, const __nv_bfloat16* __restrict__ wh,
                               float* __restrict__ hs, int B, int T, int H, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* wh_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [H, 3H]
  __nv_bfloat16* hb = wh_s + 3 * H * H;                           // [2, rows, H]

  const int H3 = 3 * H;
  const int r = threadIdx.x / H;
  const int j = threadIdx.x % H;
  const int b = blockIdx.x * rows + r;
  const bool valid = b < B;

  for (int i = threadIdx.x; i < H * H3; i += blockDim.x) wh_s[i] = wh[i];
  hb[r * H + j] = __float2bfloat16(0.0f);

  const float* xrow = xw + (size_t)(valid ? b : 0) * T * H3;
  float* hrow = hs + (size_t)(valid ? b : 0) * T * H;
  float xz = 0.f, xr = 0.f, xn = 0.f;
  if (valid && T > 0) {
    xz = xrow[j];
    xr = xrow[H + j];
    xn = xrow[2 * H + j];
  }
  float h = 0.0f;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    float nz = 0.f, nr = 0.f, nn = 0.f;
    if (valid && t + 1 < T) {
      const float* nx = xrow + (size_t)(t + 1) * H3;
      nz = nx[j];
      nr = nx[H + j];
      nn = nx[2 * H + j];
    }
    const __nv_bfloat16* hcur = hb + (t & 1) * rows * H + r * H;
    float hz = 0.f, hr = 0.f, hn = 0.f;
#pragma unroll 8
    for (int k = 0; k < H; ++k) {
      const float hk = __bfloat162float(hcur[k]);
      const __nv_bfloat16* w = wh_s + k * H3 + j;
      hz = fmaf(hk, __bfloat162float(w[0]), hz);
      hr = fmaf(hk, __bfloat162float(w[H]), hr);
      hn = fmaf(hk, __bfloat162float(w[2 * H]), hn);
    }
    const float z = sigmoidf(xz + hz);
    const float rg = sigmoidf(xr + hr);
    const float n = tanhf(xn + rg * hn);
    h = (1.0f - z) * h + z * n;
    if (valid) hrow[(size_t)t * H + j] = h;
    hb[((t + 1) & 1) * rows * H + r * H + j] = __float2bfloat16(h);
    xz = nz;
    xr = nr;
    xn = nn;
    __syncthreads();
  }
}

// One batch row per cluster of C CTAs; CTA p owns hidden units [p*U, (p+1)*U).
template <int C>
__global__ void gru_fwd_cluster_kernel(const float* __restrict__ xw, const __nv_bfloat16* __restrict__ wh,
                                       float* __restrict__ hs, int T, int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int U = H / C;
  const int U3 = 3 * U;
  const int H3 = 3 * H;
  const int p = static_cast<int>(cluster.block_rank());
  __nv_bfloat16* wh_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [H, 3U]: wh[k][g*H + p*U + u] at [k][g*U + u]
  __nv_bfloat16* hb = wh_s + H * U3;                              // [2, H]

  const int u = threadIdx.x;
  const int j = p * U + u;
  const int b = blockIdx.x / C;

  for (int i = threadIdx.x; i < H * U3; i += blockDim.x) {
    const int k = i / U3, lc = i % U3;
    wh_s[i] = wh[(size_t)k * H3 + (lc / U) * H + p * U + lc % U];
  }
  for (int k = threadIdx.x; k < H; k += blockDim.x) hb[k] = __float2bfloat16(0.0f);

  const float* xrow = xw + (size_t)b * T * H3;
  float* hrow = hs + (size_t)b * T * H;
  float xz = xrow[j], xr = xrow[H + j], xn = xrow[2 * H + j];
  float h = 0.0f;
  cluster.sync();  // wh and h0 staged, and every CTA of the cluster runs before the first remote write

  for (int t = 0; t < T; ++t) {
    float nz = 0.f, nr = 0.f, nn = 0.f;
    if (t + 1 < T) {
      const float* nx = xrow + (size_t)(t + 1) * H3;
      nz = nx[j];
      nr = nx[H + j];
      nn = nx[2 * H + j];
    }
    const __nv_bfloat16* hcur = hb + (t & 1) * H;
    float hz = 0.f, hr = 0.f, hn = 0.f;
#pragma unroll 8
    for (int k = 0; k < H; ++k) {
      const float hk = __bfloat162float(hcur[k]);
      const __nv_bfloat16* w = wh_s + k * U3 + u;
      hz = fmaf(hk, __bfloat162float(w[0]), hz);
      hr = fmaf(hk, __bfloat162float(w[U]), hr);
      hn = fmaf(hk, __bfloat162float(w[2 * U]), hn);
    }
    const float z = sigmoidf(xz + hz);
    const float rg = sigmoidf(xr + hr);
    const float n = tanhf(xn + rg * hn);
    h = (1.0f - z) * h + z * n;
    hrow[(size_t)t * H + j] = h;
    const __nv_bfloat16 hv = __float2bfloat16(h);
    __nv_bfloat16* next = hb + ((t + 1) & 1) * H + j;
#pragma unroll
    for (int q = 0; q < C; ++q) *cluster.map_shared_rank(next, q) = hv;
    xz = nz;
    xr = nr;
    xn = nn;
    cluster.sync();  // the row's next h is in every CTA; this step's reads of hcur are done
  }
}

int cluster_smem_bytes(int H, int C) { return 6 * H * H / C + 2 * H * 2; }

template <int C>
cudaError_t launch_cluster(const void* xw, const void* wh, void* hs, int B, int T, int H, cudaStream_t s) {
  const int smem = cluster_smem_bytes(H, C);
  cudaError_t e =
      cudaFuncSetAttribute(gru_fwd_cluster_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * C);
  cfg.blockDim = dim3(H / C);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, gru_fwd_cluster_kernel<C>, static_cast<const float*>(xw),
                         static_cast<const __nv_bfloat16*>(wh), static_cast<float*>(hs), T, H);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" int gru_fwd_rows_per_block(int H) { return H >= 128 ? 1 : 128 / H; }

extern "C" int gru_fwd_smem_bytes(int H) {
  const int rows = gru_fwd_rows_per_block(H);
  return 6 * H * H + 2 * rows * H * 2;
}

// CTAs that hold wh for H: 1 (one block, H <= 196), the smallest of 2, 4, 8
// that divides H and whose slices fit, or 0 when no path takes H.
extern "C" int gru_fwd_cluster_size(int H) {
  if (H <= 0) return 0;
  if (gru_fwd_rows_per_block(H) * H <= 1024 && gru_fwd_smem_bytes(H) <= kMaxSmem) return 1;
  for (int c = 2; c <= 8; c *= 2) {
    if (H % c == 0 && H / c <= 1024 && cluster_smem_bytes(H, c) <= kMaxSmem) return c;
  }
  return 0;
}

extern "C" int gru_fwd(const void* xw, const void* wh, void* hs, int B, int T, int H, int device,
                       void* stream) {
  const int c = gru_fwd_cluster_size(H);
  if (c == 0) return cudaErrorInvalidValue;
  if (B <= 0 || T <= 0) return cudaSuccess;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 2: return launch_cluster<2>(xw, wh, hs, B, T, H, s);
    case 4: return launch_cluster<4>(xw, wh, hs, B, T, H, s);
    case 8: return launch_cluster<8>(xw, wh, hs, B, T, H, s);
    default: break;
  }
  const int rows = gru_fwd_rows_per_block(H);
  const int threads = rows * H;
  const int smem = gru_fwd_smem_bytes(H);
  if (threads > 1024 || smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(gru_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const int blocks = (B + rows - 1) / rows;
  gru_fwd_kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xw), static_cast<const __nv_bfloat16*>(wh), static_cast<float*>(hs), B, T, H,
      rows);
  return cudaGetLastError();
}

extern "C" const char* poi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
