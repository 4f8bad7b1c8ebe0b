// The recurrent-weight gradient shared by the recurrences' backward kernels
// (csrc/gru_bwd.cu, csrc/lstm.cu, csrc/rnn.cu):
//
//   dW [H, N] fp32 = sum over b, t of h_prev[b, t]^T d[b, t]
//
// where h_prev[b, t] = hs[b, t-1] (0 at t = 0) and d [B, T, N] is the
// cotangent of the recurrent product h_prev @ W (N = 3H for the GRU, 4H for
// the LSTM, H for the RNN).
//
// What bounds it on this card: an fp32 product [H, B*T] x [B*T, N] on the
// CUDA cores (2*H*N*B*T operations; 0.54 GFLOP for the LSTM at B=64, T=64,
// H=128). It is kept in fp32, as the TPU kernels keep dwh.
//
// Design: 64 x 64 output tiles, each thread 4 x 4, with the B*T sum split
// into `splits` contiguous chunks of rows (one per grid z) so the card has
// ~4 blocks an SM; reduce_kernel then adds the partials in split
// order. No atomics: the result is the same bits every run.

#pragma once

#include <cuda_runtime.h>

namespace recurrent_dw {
namespace {  // internal linkage: each source that includes this gets its own copy

constexpr int kTile = 64;
constexpr int kK = 32;         // B*T rows per smem stage
constexpr int kThreads = 256;  // 16 x 16, 4 x 4 outputs each

// partial[s][k][c] = sum over rows i of chunk s of h_prev[i][k] * d[i][c],
// where row i = b*T + t and h_prev[i] = hs[i-1] (0 where t == 0).
__global__ void __launch_bounds__(kThreads)
    partial_kernel(const float* __restrict__ hs, const float* __restrict__ d, float* __restrict__ partial, int BT,
                   int T, int H, int N, int chunk) {
  __shared__ float a_s[kK][kTile];
  __shared__ float b_s[kK][kTile];
  const int k0 = blockIdx.y * kTile;
  const int c0 = blockIdx.x * kTile;
  const int i_begin = blockIdx.z * chunk;
  const int i_end = min(BT, i_begin + chunk);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[4][4] = {};
  for (int i0 = i_begin; i0 < i_end; i0 += kK) {
    for (int e = threadIdx.x; e < kK * kTile; e += kThreads) {
      const int ii = e / kTile, col = e % kTile;
      const int i = i0 + ii;
      const bool in = i < i_end;
      const int k = k0 + col, c = c0 + col;
      a_s[ii][col] = in && k < H && i % T != 0 ? hs[(size_t)(i - 1) * H + k] : 0.f;
      b_s[ii][col] = in && c < N ? d[(size_t)i * N + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int ii = 0; ii < kK; ++ii) {
      float a[4], bb[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) a[m] = a_s[ii][ty + 16 * m];
#pragma unroll
      for (int n = 0; n < 4; ++n) bb[n] = b_s[ii][tx + 16 * n];
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n) acc[m][n] = fmaf(a[m], bb[n], acc[m][n]);
    }
    __syncthreads();
  }
  float* out = partial + (size_t)blockIdx.z * H * N;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int k = k0 + ty + 16 * m;
    if (k >= H) continue;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int c = c0 + tx + 16 * n;
      if (c < N) out[(size_t)k * N + c] = acc[m][n];
    }
  }
}

__global__ void reduce_kernel(const float* __restrict__ partial, float* __restrict__ dw, int n, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += partial[(size_t)z * n + i];
  dw[i] = s;
}

// Rows of B*T per split: enough splits to put ~4 blocks on each of the
// card's SMs, each a multiple of kK rows.
inline int chunk_rows(int BT, int H, int N) {
  const int tiles = ((H + kTile - 1) / kTile) * ((N + kTile - 1) / kTile);
  int splits = (528 + tiles - 1) / tiles;
  const int max_splits = (BT + kK - 1) / kK;
  if (splits > max_splits) splits = max_splits;
  if (splits < 1) splits = 1;
  const int per = (BT + splits - 1) / splits;
  return (per + kK - 1) / kK * kK;
}

// Number of partial sums the wrapper allocates ([splits, H, N] fp32).
inline int num_splits(int BT, int H, int N) {
  if (BT <= 0 || H <= 0 || N <= 0) return 1;
  const int chunk = chunk_rows(BT, H, N);
  return (BT + chunk - 1) / chunk;
}

// Launches the partial product and the ordered reduce on `s`; dw [H, N].
inline cudaError_t launch(const float* hs, const float* d, float* partial, float* dw, int B, int T, int H, int N,
                          cudaStream_t s) {
  const int BT = B * T;
  const int chunk = chunk_rows(BT, H, N);
  const int splits = (BT + chunk - 1) / chunk;
  const dim3 grid((N + kTile - 1) / kTile, (H + kTile - 1) / kTile, splits);
  partial_kernel<<<grid, kThreads, 0, s>>>(hs, d, partial, BT, T, H, N, chunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int n = H * N;
  reduce_kernel<<<(n + 255) / 256, 256, 0, s>>>(partial, dw, n, splits);
  return cudaGetLastError();
}

}  // namespace
}  // namespace recurrent_dw
