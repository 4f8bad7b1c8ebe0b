// Vanilla-RNN recurrence of the ST-RNN tower, forward and backward (BPTT),
// for Hopper (sm_90a).
//
// Replaces the TPU kernels poi_tpu/ops/fused_rnn.py:_fwd_kernel (B5, driven
// by fused_rnn_scan/_fwd) and :_bwd_kernel (B6, driven by _bwd_vjp). The
// ST-RNN's spatial-temporal transitions are applied outside (models/strnn.py),
// leaving the serial chain below.
//
// Contract (the TPU kernels' function; the mask is [B, T] here, where the TPU
// kernels take it broadcast to [B, T, H] for their lane layout):
//   xin  [B, T, H] fp32  pre-projected inputs, bias included
//   mask [B, T]    fp32  1 on a valid step, 0 on a padded one
//   C    [H, H]    bf16
//   forward, h0 = 0, per step:
//     h_raw = tanh(xin[t] + bf16(h) @ C)   (fp32 sums)
//     h = m h_raw + (1 - m) h;  hs[t] = h   (fp32)
//   backward, t = T-1 .. 0, with h_prev = hs[t-1] (0 at t = 0):
//     h_raw recomputed as in the forward
//     dh += dhs[t];  dpre = dh m (1 - h_raw^2)
//     dxin[t] = dpre   (exactly 0 on a padded step)
//     dh = dh (1 - m) + dpre @ C^T   (fp32, C widened from bf16)
//   dC [H, H] fp32 = sum over b, t of h_prev^T dpre   (csrc/recurrent_dwh.cuh)
// No cotangent is rounded to bf16.
//
// What bounds it on this card: the serial chain of T tiny [rows, H] x [H, H]
// products (2H^2 operations a row a step: 33k at H = 128): latency, one
// barrier (two in the backward) and an H-long FMA chain a step, not FLOPs or
// bytes. dC is a separate fp32 product on the CUDA cores.
//
// Design: the LSTM kernels' layout (csrc/lstm.cu) with one gate. A block owns
// `rows` = 128 / H whole rows (one at H >= 128), thread (row, j) owns unit j,
// its fp32 h (and dh) in a register, bf16(h) double-buffered in shared
// memory; bf16 C (2H^2 bytes: 32 KB at H = 128) sits in shared memory. The
// backward recomputes h_raw through the same inlined k-ordered FMA chain as
// the forward, stages the row's dpre (fp32) for dpre @ C^T, and thread j
// walks row j of C from column j so a warp's reads spread over the banks.
// The kernels take H <= rnn_max_hidden() (339); a larger H is refused
// (cudaErrorInvalidValue), and the Python wrapper raises first and names the
// limit.
//
// The entry points launch on the given stream, do not synchronise and
// allocate nothing; they return cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "recurrent_dwh.cuh"

namespace {

constexpr int kMaxSmem = 232448;  // 227 KB: the most a block may opt into

using bf16 = __nv_bfloat16;

int rows_per_block(int H) { return H >= 128 ? 1 : 128 / H; }

int fwd_smem_bytes(int H) { return 2 * H * H + 2 * rows_per_block(H) * H * 2; }  // C + double-buffered bf16(h)

int bwd_smem_bytes(int H) {
  const int rows = rows_per_block(H);
  return rows * H * 4 + 2 * H * H + rows * H * 2;  // dpre (fp32) + C + bf16(h_prev)
}

bool takes(int H) {
  return H > 0 && rows_per_block(H) * H <= 1024 && fwd_smem_bytes(H) <= kMaxSmem && bwd_smem_bytes(H) <= kMaxSmem;
}

// tanh(x + bf16(h) @ C[:, j]) from the row's bf16(h) in shared memory: the
// one k-ordered FMA chain both kernels use.
__device__ __forceinline__ float step_raw(const bf16* __restrict__ h_s, const bf16* __restrict__ c_s, int H, int j,
                                          float x) {
  float acc = 0.f;
#pragma unroll 8
  for (int k = 0; k < H; ++k) acc = fmaf(__bfloat162float(h_s[k]), __bfloat162float(c_s[k * H + j]), acc);
  return tanhf(x + acc);
}

__global__ void rnn_fwd_kernel(const float* __restrict__ xin, const float* __restrict__ mask,
                               const bf16* __restrict__ cw, float* __restrict__ hs, int B, int T, int H, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* c_s = reinterpret_cast<bf16*>(smem);  // [H, H]
  bf16* hb = c_s + H * H;                     // [2, rows, H]

  const int r = threadIdx.x / H;
  const int j = threadIdx.x % H;
  const int b = blockIdx.x * rows + r;
  const bool valid = b < B;

  for (int i = threadIdx.x; i < H * H; i += blockDim.x) c_s[i] = cw[i];
  hb[r * H + j] = __float2bfloat16(0.0f);

  const size_t row = valid ? b : 0;
  const float* xrow = xin + row * T * H;
  const float* mrow = mask + row * T;
  float* hrow = hs + row * T * H;
  float x = valid ? xrow[j] : 0.f;
  float m = valid ? mrow[0] : 0.f;
  float h = 0.f;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const bool more = valid && t + 1 < T;
    const float nx = more ? xrow[(size_t)(t + 1) * H + j] : 0.f;
    const float nm = more ? mrow[t + 1] : 0.f;
    const float h_raw = step_raw(hb + (t & 1) * rows * H + r * H, c_s, H, j, x);
    h = m * h_raw + (1.0f - m) * h;
    if (valid) hrow[(size_t)t * H + j] = h;
    hb[((t + 1) & 1) * rows * H + r * H + j] = __float2bfloat16(h);
    x = nx;
    m = nm;
    __syncthreads();
  }
}

__global__ void rnn_bwd_kernel(const float* __restrict__ xin, const float* __restrict__ mask,
                               const bf16* __restrict__ cw, const float* __restrict__ hs,
                               const float* __restrict__ dhs, float* __restrict__ dxin, int B, int T, int H,
                               int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* dp_s = reinterpret_cast<float*>(smem);           // [rows, H]
  bf16* c_s = reinterpret_cast<bf16*>(dp_s + rows * H);  // [H, H]
  bf16* hb = c_s + H * H;                                // [rows, H]

  const int r = threadIdx.x / H;
  const int j = threadIdx.x % H;
  const int b = blockIdx.x * rows + r;
  const bool valid = b < B;

  for (int i = threadIdx.x; i < H * H; i += blockDim.x) c_s[i] = cw[i];

  const size_t row = valid ? b : 0;
  const float* xrow = xin + row * T * H;
  const float* mrow = mask + row * T;
  const float* hrow = hs + row * T * H;
  const float* dyrow = dhs + row * T * H;
  float* dxrow = dxin + row * T * H;
  float* dp_mine = dp_s + r * H;
  const bf16* hb_mine = hb + r * H;

  // Inputs of step t: xin[t], mask[t], h_prev and dhs[t] at j.
  auto load = [&](int t, float& x, float& m, float& hp, float& dy) {
    x = m = hp = dy = 0.f;
    if (!valid || t < 0) return;
    x = xrow[(size_t)t * H + j];
    m = mrow[t];
    hp = t > 0 ? hrow[(size_t)(t - 1) * H + j] : 0.f;
    dy = dyrow[(size_t)t * H + j];
  };
  float x, m, hp, dy;
  load(T - 1, x, m, hp, dy);
  float dh = 0.f;

  for (int t = T - 1; t >= 0; --t) {
    float nx, nm, nhp, ndy;
    load(t - 1, nx, nm, nhp, ndy);

    hb[r * H + j] = __float2bfloat16(hp);
    __syncthreads();  // h_prev staged; the last step's reads of dp_s are done
    const float h_raw = step_raw(hb_mine, c_s, H, j, x);
    dh += dy;
    const float dpre = dh * m * (1.0f - h_raw * h_raw);
    if (valid) dxrow[(size_t)t * H + j] = dpre;
    dp_mine[j] = dpre;
    __syncthreads();  // the row's dpre staged; every read of hb is done

    // dh_prev = dh (1 - m) + dpre . C[j, :], all fp32.
    const bf16* crow = c_s + j * H;
    float acc = 0.f;
    int c = j;
    for (int i = 0; i < H; ++i) {
      acc = fmaf(dp_mine[c], __bfloat162float(crow[c]), acc);
      c = c + 1 == H ? 0 : c + 1;
    }
    dh = dh * (1.0f - m) + acc;

    x = nx;
    m = nm;
    hp = nhp;
    dy = ndy;
  }
}

}  // namespace

// The largest hidden width both kernels take (bf16 C in one block).
extern "C" int rnn_max_hidden() {
  for (int H = 1024; H > 0; --H) {
    if (takes(H)) return H;
  }
  return 0;
}

// Number of partial dC sums the wrapper allocates ([splits, H, H] fp32).
extern "C" int rnn_bwd_splits(int B, int T, int H) { return recurrent_dw::num_splits(B * T, H, H); }

extern "C" int rnn_fwd(const void* xin, const void* mask, const void* cw, void* hs, int B, int T, int H, int device,
                       void* stream) {
  if (!takes(H)) return cudaErrorInvalidValue;
  if (B <= 0 || T <= 0) return cudaSuccess;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const int rows = rows_per_block(H);
  const int smem = fwd_smem_bytes(H);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(rnn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  rnn_fwd_kernel<<<(B + rows - 1) / rows, rows * H, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xin), static_cast<const float*>(mask), static_cast<const bf16*>(cw),
      static_cast<float*>(hs), B, T, H, rows);
  return cudaGetLastError();
}

extern "C" int rnn_bwd(const void* xin, const void* mask, const void* cw, const void* hs, const void* dhs,
                       void* dxin, void* dc_partial, void* dc, int B, int T, int H, int device, void* stream) {
  if (!takes(H) || B <= 0 || T <= 0) return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = rows_per_block(H);
  const int smem = bwd_smem_bytes(H);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(rnn_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  rnn_bwd_kernel<<<(B + rows - 1) / rows, rows * H, smem, s>>>(
      static_cast<const float*>(xin), static_cast<const float*>(mask), static_cast<const bf16*>(cw),
      static_cast<const float*>(hs), static_cast<const float*>(dhs), static_cast<float*>(dxin), B, T, H, rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return recurrent_dw::launch(static_cast<const float*>(hs), static_cast<const float*>(dxin),
                              static_cast<float*>(dc_partial), static_cast<float*>(dc), B, T, H, H, s);
}
