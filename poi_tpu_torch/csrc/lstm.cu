// LSTM recurrence, forward and backward (BPTT), for Hopper (sm_90a).
//
// Replaces the TPU kernels poi_tpu/ops/fused_lstm.py:_fwd_kernel (B3, driven
// by fused_lstm_scan/_fwd) and :_bwd_kernel (B4, driven by _bwd_vjp).
//
// Contract (the TPU kernels' function; the mask is [B, T] here, where the TPU
// kernels take it broadcast to [B, T, H] for their lane layout):
//   xw   [B, T, 4H] fp32  hoisted input projection + bias, gate blocks i | f | g | o
//   mask [B, T]     fp32  1 on a valid step, 0 on a padded one
//   wh   [H, 4H]    bf16
//   forward, h0 = c0 = 0, per step:
//     pre = xw[t] + bf16(h) @ wh   (fp32 sums)
//     i = sigmoid(pre_i), f = sigmoid(pre_f), g = tanh(pre_g), o = sigmoid(pre_o)
//     c_raw = f c + i g;  h_raw = o tanh(c_raw)
//     c = m c_raw + (1 - m) c;  h = m h_raw + (1 - m) h   (m in {0, 1}: a padded
//     step passes both carries through exactly)
//     hs[t] = h, cs[t] = c   (fp32)
//   backward, t = T-1 .. 0, with h_prev = hs[t-1], c_prev = cs[t-1] (0 at t = 0):
//     the gates recomputed as in the forward; tc = tanh(c_raw)
//     dh += dhs[t];  dh_raw = dh m
//     dc_raw = dc m + dh_raw o (1 - tc^2)
//     do = dh_raw tc o (1 - o);  di = dc_raw g i (1 - i)
//     df = dc_raw c_prev f (1 - f);  dg = dc_raw i (1 - g^2)
//     dxw[t] = [di, df, dg, do]   (exactly 0 on a padded step)
//     dh = dh (1 - m) + dxw[t] @ wh^T   (fp32, wh widened from bf16)
//     dc = dc (1 - m) + dc_raw f
//   dwh [H, 4H] fp32 = sum over b, t of h_prev^T dxw
// The gate pre-activations see xw and h_prev @ wh alike, so the cotangent of
// the recurrent product is dxw itself: no second scratch. No cotangent is
// rounded to bf16 (a bf16-cotangent backward trains to a much worse recall,
// poi_tpu/ops/fused_gru.py:113-120).
//
// What bounds it on this card: the T steps are a serial chain, and each step
// is a tiny [rows, H] x [H, 4H] product (8H^2 operations a row: 131k at
// H = 128). Like the GRU kernels it is latency-bound, not FLOP- or byte-bound:
// a step costs one block barrier (two in the backward) plus an H-long chain of
// four dependent FMAs a thread on shared-memory operands. dwh is a separate
// fp32 product on the CUDA cores (csrc/recurrent_dwh.cuh).
//
// Design (the layout of csrc/gru_fwd.cu's one-block path):
// - A block owns `rows` = 128 / H whole batch rows (one at H >= 128); thread
//   (row, j) owns hidden unit j. It needs only its own four gate columns j,
//   H+j, 2H+j, 3H+j of the product, so its fp32 h and c stay in registers
//   for the whole sequence; only bf16(h), which every thread of the row reads,
//   goes to shared memory, double-buffered so a step needs one barrier.
// - bf16 wh (8H^2 bytes: 128 KB at H = 128) is loaded once into dynamic
//   shared memory (above 48 KB after cudaFuncSetAttribute).
// - The next step's xw and mask are loaded while this step computes.
// - The backward walks t down with the same layout; dh and dc live in
//   registers. Each step stages bf16(h_prev) (one barrier), recomputes the
//   gates through the same inlined k-ordered FMA chain as the forward, so
//   they are the forward's bit for bit, then stages the row's dxw (fp32, a
//   second barrier) for dxw @ wh^T: thread j reads row j of wh, starting its
//   walk at column j so a warp's reads spread over the banks.
// - Rows past B (the ragged last block) compute on zeros and store nothing.
// - One block holds wh, so the kernels take H <= lstm_max_hidden() (169).
//   A larger H is refused (cudaErrorInvalidValue); the Python wrapper raises
//   first and names the limit.
//
// The entry points launch on the given stream, do not synchronise and
// allocate nothing; they return cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "recurrent_dwh.cuh"

namespace {

constexpr int kMaxSmem = 232448;  // 227 KB: the most a block may opt into

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / (1.0f + expf(-x)); }

int rows_per_block(int H) { return H >= 128 ? 1 : 128 / H; }

int fwd_smem_bytes(int H) { return 8 * H * H + 2 * rows_per_block(H) * H * 2; }  // wh + double-buffered bf16(h)

int bwd_smem_bytes(int H) {
  const int rows = rows_per_block(H);
  return rows * 4 * H * 4 + 8 * H * H + rows * H * 2;  // dxw (fp32) + wh + bf16(h_prev)
}

bool takes(int H) {
  return H > 0 && rows_per_block(H) * H <= 1024 && fwd_smem_bytes(H) <= kMaxSmem && bwd_smem_bytes(H) <= kMaxSmem;
}

// Gates of unit j from the row's bf16(h) in shared memory: the one k-ordered
// FMA chain both kernels use, so the backward's recompute equals the forward.
__device__ __forceinline__ void gates(const bf16* __restrict__ h_s, const bf16* __restrict__ wh_s, int H, int j,
                                      float xi, float xf, float xg, float xo, float& ig, float& fg, float& gg,
                                      float& og) {
  const int H4 = 4 * H;
  float ai = 0.f, af = 0.f, ag = 0.f, ao = 0.f;
#pragma unroll 8
  for (int k = 0; k < H; ++k) {
    const float hk = __bfloat162float(h_s[k]);
    const bf16* w = wh_s + k * H4 + j;
    ai = fmaf(hk, __bfloat162float(w[0]), ai);
    af = fmaf(hk, __bfloat162float(w[H]), af);
    ag = fmaf(hk, __bfloat162float(w[2 * H]), ag);
    ao = fmaf(hk, __bfloat162float(w[3 * H]), ao);
  }
  ig = sigmoidf(xi + ai);
  fg = sigmoidf(xf + af);
  gg = tanhf(xg + ag);
  og = sigmoidf(xo + ao);
}

__global__ void lstm_fwd_kernel(const float* __restrict__ xw, const float* __restrict__ mask,
                                const bf16* __restrict__ wh, float* __restrict__ hs, float* __restrict__ cs, int B,
                                int T, int H, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H4 = 4 * H;
  bf16* wh_s = reinterpret_cast<bf16*>(smem);  // [H, 4H]
  bf16* hb = wh_s + H * H4;                    // [2, rows, H]

  const int r = threadIdx.x / H;
  const int j = threadIdx.x % H;
  const int b = blockIdx.x * rows + r;
  const bool valid = b < B;

  for (int i = threadIdx.x; i < H * H4; i += blockDim.x) wh_s[i] = wh[i];
  hb[r * H + j] = __float2bfloat16(0.0f);

  const size_t row = valid ? b : 0;
  const float* xrow = xw + row * T * H4;
  const float* mrow = mask + row * T;
  float* hrow = hs + row * T * H;
  float* crow = cs + row * T * H;
  auto load = [&](int t, float& xi, float& xf, float& xg, float& xo, float& m) {
    xi = xf = xg = xo = m = 0.f;
    if (!valid || t >= T) return;
    const float* x = xrow + (size_t)t * H4;
    xi = x[j];
    xf = x[H + j];
    xg = x[2 * H + j];
    xo = x[3 * H + j];
    m = mrow[t];
  };
  float xi, xf, xg, xo, m;
  load(0, xi, xf, xg, xo, m);
  float h = 0.f, c = 0.f;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    float nxi, nxf, nxg, nxo, nm;
    load(t + 1, nxi, nxf, nxg, nxo, nm);
    float ig, fg, gg, og;
    gates(hb + (t & 1) * rows * H + r * H, wh_s, H, j, xi, xf, xg, xo, ig, fg, gg, og);
    const float c_raw = fg * c + ig * gg;
    const float h_raw = og * tanhf(c_raw);
    c = m * c_raw + (1.0f - m) * c;
    h = m * h_raw + (1.0f - m) * h;
    if (valid) {
      hrow[(size_t)t * H + j] = h;
      crow[(size_t)t * H + j] = c;
    }
    hb[((t + 1) & 1) * rows * H + r * H + j] = __float2bfloat16(h);
    xi = nxi;
    xf = nxf;
    xg = nxg;
    xo = nxo;
    m = nm;
    __syncthreads();
  }
}

__global__ void lstm_bwd_kernel(const float* __restrict__ xw, const float* __restrict__ mask,
                                const bf16* __restrict__ wh, const float* __restrict__ hs,
                                const float* __restrict__ cs, const float* __restrict__ dhs, float* __restrict__ dxw,
                                int B, int T, int H, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H4 = 4 * H;
  float* dxw_s = reinterpret_cast<float*>(smem);           // [rows, 4H]
  bf16* wh_s = reinterpret_cast<bf16*>(dxw_s + rows * H4);  // [H, 4H]
  bf16* hb = wh_s + H * H4;                                 // [rows, H]

  const int r = threadIdx.x / H;
  const int j = threadIdx.x % H;
  const int b = blockIdx.x * rows + r;
  const bool valid = b < B;

  for (int i = threadIdx.x; i < H * H4; i += blockDim.x) wh_s[i] = wh[i];

  const size_t row = valid ? b : 0;
  const float* xrow = xw + row * T * H4;
  const float* mrow = mask + row * T;
  const float* hrow = hs + row * T * H;
  const float* crow = cs + row * T * H;
  const float* dyrow = dhs + row * T * H;
  float* dxrow = dxw + row * T * H4;
  float* dxw_mine = dxw_s + r * H4;
  const bf16* hb_mine = hb + r * H;

  // Inputs of step t: xw[t] (four gates), mask[t], h_prev and c_prev at j, dhs[t] at j.
  struct In {
    float xi, xf, xg, xo, m, hp, cp, dy;
  };
  auto load = [&](int t) {
    In in = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (!valid || t < 0) return in;
    const float* x = xrow + (size_t)t * H4;
    in.xi = x[j];
    in.xf = x[H + j];
    in.xg = x[2 * H + j];
    in.xo = x[3 * H + j];
    in.m = mrow[t];
    if (t > 0) {
      in.hp = hrow[(size_t)(t - 1) * H + j];
      in.cp = crow[(size_t)(t - 1) * H + j];
    }
    in.dy = dyrow[(size_t)t * H + j];
    return in;
  };
  In cur = load(T - 1);
  float dh = 0.f, dc = 0.f;

  for (int t = T - 1; t >= 0; --t) {
    const In next = load(t - 1);

    hb[r * H + j] = __float2bfloat16(cur.hp);
    __syncthreads();  // h_prev staged; the last step's reads of dxw_s are done
    float ig, fg, gg, og;
    gates(hb_mine, wh_s, H, j, cur.xi, cur.xf, cur.xg, cur.xo, ig, fg, gg, og);
    const float m = cur.m;
    const float c_raw = fg * cur.cp + ig * gg;
    const float tc = tanhf(c_raw);

    dh += cur.dy;
    const float dh_raw = dh * m;
    const float dc_raw = dc * m + dh_raw * og * (1.0f - tc * tc);
    const float d_o = dh_raw * tc * og * (1.0f - og);
    const float d_i = dc_raw * gg * ig * (1.0f - ig);
    const float d_f = dc_raw * cur.cp * fg * (1.0f - fg);
    const float d_g = dc_raw * ig * (1.0f - gg * gg);
    if (valid) {
      float* o = dxrow + (size_t)t * H4;
      o[j] = d_i;
      o[H + j] = d_f;
      o[2 * H + j] = d_g;
      o[3 * H + j] = d_o;
    }
    dxw_mine[j] = d_i;
    dxw_mine[H + j] = d_f;
    dxw_mine[2 * H + j] = d_g;
    dxw_mine[3 * H + j] = d_o;
    __syncthreads();  // the row's dxw staged; every read of hb is done

    // dh_prev = dh (1 - m) + dxw . wh[j, :], all fp32.
    const bf16* wrow = wh_s + j * H4;
    float acc = 0.f;
    int c = j;
    for (int i = 0; i < H4; ++i) {
      acc = fmaf(dxw_mine[c], __bfloat162float(wrow[c]), acc);
      c = c + 1 == H4 ? 0 : c + 1;
    }
    dh = dh * (1.0f - m) + acc;
    dc = dc * (1.0f - m) + dc_raw * fg;
    cur = next;
  }
}

}  // namespace

// The largest hidden width both kernels take (bf16 wh in one block).
extern "C" int lstm_max_hidden() {
  for (int H = 1024; H > 0; --H) {
    if (takes(H)) return H;
  }
  return 0;
}

// Number of partial dwh sums the wrapper allocates ([splits, H, 4H] fp32).
extern "C" int lstm_bwd_splits(int B, int T, int H) { return recurrent_dw::num_splits(B * T, H, 4 * H); }

extern "C" int lstm_fwd(const void* xw, const void* mask, const void* wh, void* hs, void* cs, int B, int T, int H,
                        int device, void* stream) {
  if (!takes(H)) return cudaErrorInvalidValue;
  if (B <= 0 || T <= 0) return cudaSuccess;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const int rows = rows_per_block(H);
  const int smem = fwd_smem_bytes(H);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(lstm_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  lstm_fwd_kernel<<<(B + rows - 1) / rows, rows * H, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xw), static_cast<const float*>(mask), static_cast<const bf16*>(wh),
      static_cast<float*>(hs), static_cast<float*>(cs), B, T, H, rows);
  return cudaGetLastError();
}

extern "C" int lstm_bwd(const void* xw, const void* mask, const void* wh, const void* hs, const void* cs,
                        const void* dhs, void* dxw, void* dwh_partial, void* dwh, int B, int T, int H, int device,
                        void* stream) {
  if (!takes(H) || B <= 0 || T <= 0) return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = rows_per_block(H);
  const int smem = bwd_smem_bytes(H);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(lstm_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  lstm_bwd_kernel<<<(B + rows - 1) / rows, rows * H, smem, s>>>(
      static_cast<const float*>(xw), static_cast<const float*>(mask), static_cast<const bf16*>(wh),
      static_cast<const float*>(hs), static_cast<const float*>(cs), static_cast<const float*>(dhs),
      static_cast<float*>(dxw), B, T, H, rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return recurrent_dw::launch(static_cast<const float*>(hs), static_cast<const float*>(dxw),
                              static_cast<float*>(dwh_partial), static_cast<float*>(dwh), B, T, H, 4 * H, s);
}
