// GRU backward (BPTT) for Hopper (sm_90a).
//
// Replaces the TPU kernel poi_tpu/ops/fused_gru.py:_bwd_kernel (driven by
// _bwd_vjp): reverse-time BPTT through the recurrence of csrc/gru_fwd.cu,
// recomputing the gates from the stored hidden states.
//
// Contract (the same as the TPU kernel's):
//   xw  [B, T, 3H] fp32  folded gate inputs of the forward (z | r | n)
//   wh  [H, 3H]    bf16
//   hs  [B, T, H]  fp32  the forward's hidden states; h_prev = hs[t-1], 0 at t = 0
//   dhs [B, T, H]  fp32  cotangent of hs
//   per step, t = T-1 .. 0:
//     hw = bf16(h_prev) @ wh (fp32 sums); z, r, n, hn as in the forward
//     dh += dhs[t]
//     dn = dh z (1 - n^2);  da = dh (n - h_prev) z (1 - z)
//     dr_pre = dn hn r (1 - r);  dhn = dn r
//     dxw[t] = [da, dr_pre, dn];  dhw[t] = [da, dr_pre, dhn]
//     dh = dh (1 - z) + dhw[t] @ wh^T      (fp32, wh widened from bf16)
//   dwh [H, 3H] fp32 = sum over b, t of h_prev^T dhw
//
// No cotangent is ever rounded to bf16: a bf16-cotangent backward trains
// config #2 to a much worse recall (fused_gru.py:113-120).
//
// What bounds it on this card: like the forward, the recurrence is a serial
// chain of T tiny steps (per step and row: 6H^2 FMAs, H=128 -> 98k), so it is
// latency-bound; dwh is a separate fp32 reduction product
// [H, B*T] x [B*T, 3H] (3.2 GFLOP at B=512, T=64, H=128), bound by the CUDA
// cores' fp32 rate.
//
// Design:
// - gru_bwd_kernel: like the forward, a block owns `rows` whole batch rows
//   and thread (row, j) owns hidden column j; dh[j] lives in a register for
//   the whole reverse loop. wh (bf16, 6H^2 bytes) sits in shared memory. Each
//   step stages bf16(h_prev) and then the row's fp32 dhw in shared memory,
//   one barrier each. The gate recompute walks k in the forward kernel's
//   order, so it reproduces the forward's gates bit for bit. For dh @ wh^T
//   thread j reads row j of wh; each thread starts its walk at a different
//   column so a warp's reads spread over the banks. The next step's inputs
//   are loaded while this one computes.
// - dhw goes to an fp32 scratch [B, T, 3H] that the wrapper allocates.
// - dwh: the split-chunk product and ordered reduce of csrc/recurrent_dwh.cuh
//   (shared with the LSTM and RNN backward). No atomics: the result is the
//   same bits every run.
// - Padded steps (z = 0 exactly from the folded -1e9) give exactly zero
//   da, dn, dr_pre and dhn, and dh passes through unchanged.
// - gru_bwd_kernel holds bf16 wh in one block, so it takes H <= 196.
//
// H > 196: gru_bwd_cluster_kernel, the layout of the forward's cluster
// kernel (csrc/gru_fwd.cu): one batch row per cluster of C CTAs, CTA p owns
// hidden units [p*U, (p+1)*U), U = H/C, and keeps their z, r, n columns of
// wh ([H, 3U] bf16) in shared memory.
// - Each CTA stages the whole bf16(h_prev) row from hs (global, L2) and
//   recomputes its units' gates walking k in the forward's order.
// - dh @ wh^T needs every column of wh: each CTA computes the partial sums
//   over its own 3U columns for all H units and writes unit m*U + u's
//   partial into CTA m's reduce buffer (distributed shared memory), slot p.
//   After one cluster barrier, each thread adds the C partials of its unit in
//   rank order: fp32 throughout, and the same bits every run. The reduce
//   buffer is double-buffered, so one cluster barrier a step suffices.
//
// The entry point launches on the given stream, does not synchronise and
// allocates nothing; it returns cudaGetLastError() after the launches.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "recurrent_dwh.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxSmem = 232448;  // 227 KB: the most a block may opt into

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / (1.0f + expf(-x)); }

int rows_per_block(int H) { return H >= 128 ? 1 : 128 / H; }

int bwd_smem_bytes(int H) {
  const int rows = rows_per_block(H);
  return rows * 3 * H * 4 + 6 * H * H + rows * H * 2;  // dhw (fp32) + wh (bf16) + h_prev (bf16)
}

__global__ void gru_bwd_kernel(const float* __restrict__ xw, const bf16* __restrict__ wh,
                               const float* __restrict__ hs, const float* __restrict__ dhs, float* __restrict__ dxw,
                               float* __restrict__ dhw, int B, int T, int H, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H3 = 3 * H;
  float* dhw_s = reinterpret_cast<float*>(smem);                 // [rows, 3H]
  bf16* wh_s = reinterpret_cast<bf16*>(dhw_s + rows * H3);       // [H, 3H]
  bf16* hb = wh_s + H * H3;                                      // [rows, H]

  const int r = threadIdx.x / H;
  const int j = threadIdx.x % H;
  const int b = blockIdx.x * rows + r;
  const bool valid = b < B;

  for (int i = threadIdx.x; i < H * H3; i += blockDim.x) wh_s[i] = wh[i];

  const size_t row = valid ? b : 0;
  const float* xrow = xw + row * T * H3;
  const float* hrow = hs + row * T * H;
  const float* dyrow = dhs + row * T * H;
  float* dxrow = dxw + row * T * H3;
  float* dhwrow = dhw + row * T * H3;
  float* dhw_mine = dhw_s + r * H3;
  const bf16* hb_mine = hb + r * H;

  // Inputs of step t: xw[t] (three gates), h_prev = hs[t-1] and dhs[t].
  auto load = [&](int t, float& xz, float& xr, float& xn, float& hp, float& dy) {
    xz = xr = xn = hp = dy = 0.f;
    if (!valid || t < 0) return;
    const float* x = xrow + (size_t)t * H3;
    xz = x[j];
    xr = x[H + j];
    xn = x[2 * H + j];
    hp = t > 0 ? hrow[(size_t)(t - 1) * H + j] : 0.f;
    dy = dyrow[(size_t)t * H + j];
  };
  float xz, xr, xn, hp, dy;
  load(T - 1, xz, xr, xn, hp, dy);
  float dh = 0.f;

  for (int t = T - 1; t >= 0; --t) {
    float nxz, nxr, nxn, nhp, ndy;
    load(t - 1, nxz, nxr, nxn, nhp, ndy);

    hb[r * H + j] = __float2bfloat16(hp);
    __syncthreads();  // h_prev staged; last step's reads of dhw_s are done
    float hz = 0.f, hr = 0.f, hn = 0.f;
#pragma unroll 8
    for (int k = 0; k < H; ++k) {
      const float hk = __bfloat162float(hb_mine[k]);
      const bf16* w = wh_s + k * H3 + j;
      hz = fmaf(hk, __bfloat162float(w[0]), hz);
      hr = fmaf(hk, __bfloat162float(w[H]), hr);
      hn = fmaf(hk, __bfloat162float(w[2 * H]), hn);
    }
    const float z = sigmoidf(xz + hz);
    const float rg = sigmoidf(xr + hr);
    const float n = tanhf(xn + rg * hn);

    dh += dy;
    const float dn = dh * z * (1.0f - n * n);
    const float da = dh * (n - hp) * z * (1.0f - z);
    const float dr = dn * hn * rg * (1.0f - rg);
    const float dhn = dn * rg;
    if (valid) {
      float* o = dxrow + (size_t)t * H3;
      o[j] = da;
      o[H + j] = dr;
      o[2 * H + j] = dn;
      float* s = dhwrow + (size_t)t * H3;
      s[j] = da;
      s[H + j] = dr;
      s[2 * H + j] = dhn;
    }
    dhw_mine[j] = da;
    dhw_mine[H + j] = dr;
    dhw_mine[2 * H + j] = dhn;
    __syncthreads();  // the row's dhw staged; every read of hb is done

    // dh_prev = dh (1 - z) + dhw . wh[j, :], all fp32.
    const bf16* wrow = wh_s + j * H3;
    float acc = 0.f;
    int c = j % H3;
    for (int i = 0; i < H3; ++i) {
      acc = fmaf(dhw_mine[c], __bfloat162float(wrow[c]), acc);
      c = c + 1 == H3 ? 0 : c + 1;
    }
    dh = dh * (1.0f - z) + acc;

    xz = nxz;
    xr = nxr;
    xn = nxn;
    hp = nhp;
    dy = ndy;
  }
}

int cluster_smem_bytes(int H, int C) {
  const int U = H / C;
  return 2 * C * U * 4 + 3 * U * 4 + 6 * H * H / C + H * 2;  // reduce slots + dhw + wh slice + h_prev
}

// One batch row per cluster of C CTAs; CTA p owns hidden units [p*U, (p+1)*U).
template <int C>
__global__ void gru_bwd_cluster_kernel(const float* __restrict__ xw, const bf16* __restrict__ wh,
                                       const float* __restrict__ hs, const float* __restrict__ dhs,
                                       float* __restrict__ dxw, float* __restrict__ dhw, int T, int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int U = H / C;
  const int U3 = 3 * U;
  const int H3 = 3 * H;
  const int p = static_cast<int>(cluster.block_rank());
  float* red_s = reinterpret_cast<float*>(smem);          // [2][C][U]: partial dh sums from each CTA
  float* dhw_s = red_s + 2 * C * U;                       // [3U]: this CTA's columns of the row's dhw
  bf16* wh_s = reinterpret_cast<bf16*>(dhw_s + U3);       // [H, 3U]: wh[k][g*H + p*U + u] at [k][g*U + u]
  bf16* hb = wh_s + H * U3;                               // [H]: bf16(h_prev)

  const int u = threadIdx.x;
  const int j = p * U + u;
  const size_t row = blockIdx.x / C;

  for (int i = threadIdx.x; i < H * U3; i += blockDim.x) {
    const int k = i / U3, lc = i % U3;
    wh_s[i] = wh[(size_t)k * H3 + (lc / U) * H + p * U + lc % U];
  }

  const float* xrow = xw + row * T * H3;
  const float* hrow = hs + row * T * H;
  const float* dyrow = dhs + row * T * H;
  float* dxrow = dxw + row * T * H3;
  float* dhwrow = dhw + row * T * H3;

  // Inputs of step t: xw[t] at unit j, h_prev = hs[t-1] at units m*U + u, dhs[t] at j.
  auto load = [&](int t, float& xz, float& xr, float& xn, float (&hp)[C], float& dy) {
    xz = xr = xn = dy = 0.f;
#pragma unroll
    for (int m = 0; m < C; ++m) hp[m] = 0.f;
    if (t < 0) return;
    const float* x = xrow + (size_t)t * H3;
    xz = x[j];
    xr = x[H + j];
    xn = x[2 * H + j];
    if (t > 0) {
#pragma unroll
      for (int m = 0; m < C; ++m) hp[m] = hrow[(size_t)(t - 1) * H + m * U + u];
    }
    dy = dyrow[(size_t)t * H + j];
  };
  float xz, xr, xn, hp[C], dy;
  load(T - 1, xz, xr, xn, hp, dy);
  float dh = 0.f;
  cluster.sync();  // wh staged, and every CTA of the cluster runs before the first remote write

  for (int t = T - 1; t >= 0; --t) {
    float nxz, nxr, nxn, nhp[C], ndy;
    load(t - 1, nxz, nxr, nxn, nhp, ndy);

    float hj = 0.f;  // h_prev at this thread's own unit j = p*U + u
#pragma unroll
    for (int m = 0; m < C; ++m) {
      hb[m * U + u] = __float2bfloat16(hp[m]);
      if (m == p) hj = hp[m];
    }
    __syncthreads();  // h_prev staged; the last step's reads of dhw_s are done
    float hz = 0.f, hr = 0.f, hn = 0.f;
#pragma unroll 8
    for (int k = 0; k < H; ++k) {
      const float hk = __bfloat162float(hb[k]);
      const bf16* w = wh_s + k * U3 + u;
      hz = fmaf(hk, __bfloat162float(w[0]), hz);
      hr = fmaf(hk, __bfloat162float(w[U]), hr);
      hn = fmaf(hk, __bfloat162float(w[2 * U]), hn);
    }
    const float z = sigmoidf(xz + hz);
    const float rg = sigmoidf(xr + hr);
    const float n = tanhf(xn + rg * hn);

    dh += dy;
    const float dn = dh * z * (1.0f - n * n);
    const float da = dh * (n - hj) * z * (1.0f - z);
    const float dr = dn * hn * rg * (1.0f - rg);
    const float dhn = dn * rg;
    float* o = dxrow + (size_t)t * H3;
    o[j] = da;
    o[H + j] = dr;
    o[2 * H + j] = dn;
    float* s = dhwrow + (size_t)t * H3;
    s[j] = da;
    s[H + j] = dr;
    s[2 * H + j] = dhn;
    dhw_s[u] = da;
    dhw_s[U + u] = dr;
    dhw_s[2 * U + u] = dhn;
    __syncthreads();  // the CTA's dhw staged; every read of hb is done

    // Partial dh_prev of unit m*U + u over this CTA's columns, sent to CTA m.
    float* red = red_s + (t & 1) * C * U;
#pragma unroll
    for (int m = 0; m < C; ++m) {
      const bf16* wrow = wh_s + (m * U + u) * U3;
      float acc = 0.f;
      int c = u % U3;
      for (int i = 0; i < U3; ++i) {
        acc = fmaf(dhw_s[c], __bfloat162float(wrow[c]), acc);
        c = c + 1 == U3 ? 0 : c + 1;
      }
      *cluster.map_shared_rank(red + p * U + u, m) = acc;
    }
    cluster.sync();  // every CTA's partials of this CTA's units have arrived
    float acc = 0.f;
#pragma unroll
    for (int q = 0; q < C; ++q) acc += red[q * U + u];
    dh = dh * (1.0f - z) + acc;

    xz = nxz;
    xr = nxr;
    xn = nxn;
#pragma unroll
    for (int m = 0; m < C; ++m) hp[m] = nhp[m];
    dy = ndy;
  }
}

template <int C>
cudaError_t launch_cluster(const void* xw, const void* wh, const void* hs, const void* dhs, void* dxw, void* dhw,
                           int B, int T, int H, cudaStream_t s) {
  const int smem = cluster_smem_bytes(H, C);
  cudaError_t e =
      cudaFuncSetAttribute(gru_bwd_cluster_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
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
  e = cudaLaunchKernelEx(&cfg, gru_bwd_cluster_kernel<C>, static_cast<const float*>(xw), static_cast<const bf16*>(wh),
                         static_cast<const float*>(hs), static_cast<const float*>(dhs), static_cast<float*>(dxw),
                         static_cast<float*>(dhw), T, H);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" int gru_bwd_smem_bytes(int H) { return bwd_smem_bytes(H); }

// CTAs that hold wh for H: 1 (one block, H <= 196), the smallest of 2, 4, 8
// that divides H and whose slices fit, or 0 when no path takes H.
extern "C" int gru_bwd_cluster_size(int H) {
  if (H <= 0) return 0;
  if (rows_per_block(H) * H <= 1024 && bwd_smem_bytes(H) <= kMaxSmem) return 1;
  for (int c = 2; c <= 8; c *= 2) {
    if (H % c == 0 && H / c <= 1024 && cluster_smem_bytes(H, c) <= kMaxSmem) return c;
  }
  return 0;
}

// Number of partial dwh sums the wrapper allocates ([splits, H, 3H] fp32).
extern "C" int gru_bwd_splits(int B, int T, int H) { return recurrent_dw::num_splits(B * T, H, 3 * H); }

extern "C" int gru_bwd(const void* xw, const void* wh, const void* hs, const void* dhs, void* dxw, void* dhw,
                       void* dwh_partial, void* dwh, int B, int T, int H, int device, void* stream) {
  const int cluster = gru_bwd_cluster_size(H);
  if (cluster == 0 || B <= 0 || T <= 0) return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cluster > 1) {
    switch (cluster) {
      case 2: e = launch_cluster<2>(xw, wh, hs, dhs, dxw, dhw, B, T, H, s); break;
      case 4: e = launch_cluster<4>(xw, wh, hs, dhs, dxw, dhw, B, T, H, s); break;
      default: e = launch_cluster<8>(xw, wh, hs, dhs, dxw, dhw, B, T, H, s); break;
    }
    if (e != cudaSuccess) return e;
  } else {
    const int rows = rows_per_block(H);
    const int threads = rows * H;
    const int smem = bwd_smem_bytes(H);
    if (smem > 48 * 1024) {
      e = cudaFuncSetAttribute(gru_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return e;
    }
    gru_bwd_kernel<<<(B + rows - 1) / rows, threads, smem, s>>>(
        static_cast<const float*>(xw), static_cast<const bf16*>(wh), static_cast<const float*>(hs),
        static_cast<const float*>(dhs), static_cast<float*>(dxw), static_cast<float*>(dhw), B, T, H, rows);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }

  return recurrent_dw::launch(static_cast<const float*>(hs), static_cast<const float*>(dhw),
                              static_cast<float*>(dwh_partial), static_cast<float*>(dwh), B, T, H, 3 * H, s);
}
