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
// the recurrent product is dxw itself. No cotangent is rounded to bf16 (a
// bf16-cotangent backward trains to a much worse recall,
// poi_tpu/ops/fused_gru.py:113-120).
//
// What bounds it on this card: the T steps are a serial chain, and each step
// is a small [B, H] x [H, 4H] product (8H^2 operations a row: 131k at
// H = 128), so a step's time is its latency, not its FLOPs or bytes. What
// does not depend on the carry is parallel work: the backward's gate
// recompute, a product [B*T, H] x [H, 4H], and dwh, an fp32 product on the
// CUDA cores (csrc/recurrent_dwh.cuh).
//
// Forward (B3): a block owns `rows` = 128 / H whole batch rows (one at
// H >= 128); thread (row, j) owns hidden unit j and needs only its four gate
// columns j, H+j, 2H+j, 3H+j of the product, so its fp32 h and c stay in
// registers; only bf16(h), which every thread of the row reads, goes to
// shared memory, double-buffered so a step needs one barrier. bf16 wh (8H^2
// bytes: 128 KB at H = 128) is loaded once into dynamic shared memory; the
// product is an H-long k-ordered FMA chain a gate. The next step's xw and
// mask are loaded while this step computes. Rows past B compute on zeros
// and store nothing. One block holds wh, so the forward, and with it the
// pair, takes H <= lstm_max_hidden() (170); a larger H is refused
// (cudaErrorInvalidValue), and the Python wrapper raises first and names
// the limit.
//
// Backward (B4): csrc/gru_bwd.cu's three passes, for four gates and two
// carries, and the shared dwh product.
// 1. lstm_bwd_gates_kernel: the gate recompute of every step at once on the
//    tensor cores (mma.sync m16n8k16: exact bf16 products summed in fp32, the
//    TPU kernel's arithmetic, _gates; the summation order is the tensor
//    cores', so the gates match the forward's scalar walk to fp32 rounding,
//    not bit for bit), and from the gates and c_prev each element's
//    coefficients, which depend on the forward alone: kappa = o (1 - tc^2),
//    omega = tc o (1 - o), iota = g i (1 - i), phi = c_prev f (1 - f),
//    gamma = i (1 - g^2) and f. iota, phi, gamma and omega go into dxw's
//    blocks, kappa and f into an fp32 scratch [B, T, 2H] the wrapper
//    allocates.
// 2. lstm_bwd_carry_kernel, the serial chain: csrc/gru_bwd.cu's carry with
//    32 columns an octet (i, f, g, o of 8 units) and a second carry. A
//    cluster of C CTAs owns a group of R = 16 batch rows (8 at a cluster of
//    16); CTA p owns unit octets [p*O/C, (p+1)*O/C) of O = ceil(H/8) and
//    keeps their four gate columns of wh for every unit, [Hk, 32 an octet]
//    bf16, in shared memory; its first warps each own an octet, whose dh and
//    dc stay in registers for the whole reverse loop. Per step:
//    - each owner thread, from its prefetched coefficients: d = dh + dhs[t],
//      dh_raw = d m, dc_raw = dc m + dh_raw kappa, dxw[t] = [dc_raw iota,
//      dc_raw phi, dc_raw gamma, dh_raw omega] (exactly 0 where m = 0), and
//      dc = dc (1 - m) + dc_raw f (elementwise: dc never leaves the thread);
//    - dxw[t] @ wh^T on mma.sync, each fp32 element split into three exact
//      bf16 terms (cluster_carry.cuh's split3), each term into its own fp32
//      accumulator, summed smallest first: the TPU kernel's fp32 cotangent at
//      Precision.HIGHEST (poi_tpu/ops/fused_lstm.py:116-126). The CTA
//      multiplies its columns for every unit; the partial sums of octet m go
//      into the CTA that owns m over distributed shared memory, slot p;
//    - one split cluster barrier: its arrive releases the partials; dxw[t]
//      out (over its coefficients) and the cp.async prefetch of step t - 2's
//      inputs (into a three-slot ring of the thread's own shared memory) go
//      before its wait; then dh = d (1 - m) + the C partials, added in rank
//      order. The slots are double-buffered by step parity. No atomics: the
//      same bits every run.
//    The carry writes dxw itself: every coefficient it needs for the product
//    is in its registers, so an outputs pass would only move dxw once more.
//    C: the backward carries' rule (cluster_carry.cuh): the smallest of 1,
//    2, 4, 8, 16 that fits, then doubled (up to 8) while the groups'
//    clusters fit on the 132 SMs at once (B = 64, H = 128: 4 groups x 8).
//    Any H up to the pair's limit, ragged ones included: a ragged H
//    zero-pads the last octet and K.
// 3. dwh: recurrent_dw::launch over the final dxw (csrc/recurrent_dwh.cuh).
//
// The entry points launch on the given stream, do not synchronise and
// allocate nothing; they return cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_carry.cuh"
#include "recurrent_dwh.cuh"

namespace {

__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / (1.0f + expf(-x)); }

int rows_per_block(int H) { return H >= 128 ? 1 : 128 / H; }

int fwd_smem_bytes(int H) { return 8 * H * H + 2 * rows_per_block(H) * H * 2; }  // wh + double-buffered bf16(h)

// The widths the forward takes, and so the pair's: bf16 wh in one block.
bool takes(int H) { return H > 0 && rows_per_block(H) * H <= 1024 && fwd_smem_bytes(H) <= kMaxSmem; }

// Gates of unit j from the row's bf16(h) in shared memory: one k-ordered
// FMA chain a gate.
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

// ------------------------------------------------------------- backward, pass 1: the gates
//
// The gate recompute of every (b, t) at once: pre = xw + bf16(h_prev) @ wh
// as a batched product [B*T, Hk] x [Hk, 4H] (mma.sync, exact bf16 products,
// fp32 sums), and from the gates and c_prev each element's coefficients,
// which depend on the forward alone (tc = tanh(f c_prev + i g)):
//   kappa = o (1 - tc^2), omega = tc o (1 - o), iota = g i (1 - i),
//   phi = c_prev f (1 - f), gamma = i (1 - g^2), and f
// so that the carry's dc_raw = dc m + dh_raw kappa and
// dxw = [dc_raw iota, dc_raw phi, dc_raw gamma, dh_raw omega]. iota, phi,
// gamma and omega go into dxw's own blocks, kappa and f into the scratch
// coef [B*T, 2H]. A block is 8 warps of 16 rows (128 rows of B*T) x 4 unit
// octets (their i, f, g and o columns); K streams through smem in chunks of
// 64. Where H % 8 == 0 (kVec) the loads move 4 (h) and 8 (wh) elements at a
// time and the epilogue two units.
constexpr int kGateRows = 128, kGateOct = 4, kGateK = 64, kGateThreads = 256;
constexpr int kGateLdA = kGateK + 8, kGateLdB = 32 * kGateOct + 8;

template <bool kVec>
__global__ void __launch_bounds__(kGateThreads)
    lstm_bwd_gates_kernel(const float* __restrict__ xw, const bf16* __restrict__ wh, const float* __restrict__ hs,
                          const float* __restrict__ cs, float* __restrict__ dxw, float* __restrict__ coef, int BT,
                          int T, int H) {
  __shared__ __align__(16) bf16 a_s[kGateRows * kGateLdA];
  __shared__ __align__(16) bf16 b_s[kGateK * kGateLdB];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const int r0 = blockIdx.x * kGateRows, o0 = blockIdx.y * kGateOct;
  const int H4 = 4 * H, Hk = (H + 15) / 16 * 16;
  float acc[4 * kGateOct][4];
#pragma unroll
  for (int i = 0; i < 4 * kGateOct; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const uint32_t a_a = shared_addr(a_s), b_a = shared_addr(b_s);
  for (int k0 = 0; k0 < Hk; k0 += kGateK) {
    // A: bf16(h_prev) of rows r0.. (h_prev of row r = b T + t is hs row r - 1, 0 at t = 0).
    if constexpr (kVec) {
#pragma unroll
      for (int i = 0; i < kGateRows * kGateK / 4 / kGateThreads; ++i) {
        const int e = threadIdx.x + i * kGateThreads, rr = e / (kGateK / 4), k = k0 + (e % (kGateK / 4)) * 4;
        const int r = r0 + rr;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < BT && r % T != 0 && k < H) v = *reinterpret_cast<const float4*>(hs + (size_t)(r - 1) * H + k);
        __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(a_s + rr * kGateLdA + k - k0);
        dst[0] = __floats2bfloat162_rn(v.x, v.y);
        dst[1] = __floats2bfloat162_rn(v.z, v.w);
      }
    } else {
      for (int e = threadIdx.x; e < kGateRows * kGateK; e += kGateThreads) {
        const int rr = e / kGateK, k = k0 + e % kGateK, r = r0 + rr;
        const bool ok = r < BT && r % T != 0 && k < H;
        a_s[rr * kGateLdA + e % kGateK] = __float2bfloat16(ok ? hs[(size_t)(r - 1) * H + k] : 0.f);
      }
    }
    // B: wh rows k0.., local column 32 lo + 8 gate + u = wh column gate H + 8 (o0 + lo) + u.
    if constexpr (kVec) {
      for (int e = threadIdx.x; e < kGateK * 4 * kGateOct; e += kGateThreads) {
        const int kk = e / (4 * kGateOct), grp8 = e % (4 * kGateOct), k = k0 + kk;  // grp8 = 4 lo + gate
        const int j = 8 * (o0 + grp8 / 4);
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (k < H && j < H) v = *reinterpret_cast<const uint4*>(wh + (size_t)k * H4 + (grp8 % 4) * H + j);
        *reinterpret_cast<uint4*>(b_s + kk * kGateLdB + 8 * grp8) = v;
      }
    } else {
      for (int e = threadIdx.x; e < kGateK * 32 * kGateOct; e += kGateThreads) {
        const int kk = e / (32 * kGateOct), lc = e % (32 * kGateOct), k = k0 + kk;
        const int j = 8 * (o0 + lc / 32) + lc % 8;
        b_s[kk * kGateLdB + lc] = k < H && j < H ? wh[(size_t)k * H4 + ((lc % 32) / 8) * H + j] : __float2bfloat16(0.f);
      }
    }
    __syncthreads();
    const int ks_end = (Hk - k0 < kGateK ? Hk - k0 : kGateK) / 16;
    for (int ks = 0; ks < ks_end; ++ks) {
      uint32_t a[4];
      ldsm_x4(a, a_a + ((warp * 16 + lane % 16) * kGateLdA + ks * 16 + (lane / 16) * 8) * 2);
#pragma unroll
      for (int nt = 0; nt < 4 * kGateOct; ++nt) {
        uint32_t b0, b1;
        ldsm_x2_trans(b0, b1, b_a + ((ks * 16 + lane % 16) * kGateLdB + nt * 8) * 2);
        mma_bf16(acc[nt], a, b0, b1);
      }
    }
    __syncthreads();
  }
  // Accumulator (n-tile 4 lo + gate) holds rows g (+ 8) x units 2 tq (+ 1) of octet o0 + lo.
#pragma unroll
  for (int lo = 0; lo < kGateOct; ++lo) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = r0 + warp * 16 + g + 8 * rr, j0 = 8 * (o0 + lo) + 2 * tq;
      if (r >= BT || j0 >= H) continue;
      const size_t o = (size_t)r * H4 + j0, oc = (size_t)r * 2 * H + j0;
      const float* cp_row = cs + (size_t)(r - 1) * H + j0;
      float x[4][2], cp[2];
      if constexpr (kVec) {  // j0 even, H % 8 == 0: both units valid, 8-byte aligned
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 v = *reinterpret_cast<const float2*>(xw + o + q * H);
          x[q][0] = v.x, x[q][1] = v.y;
        }
        const float2 c = r % T != 0 ? *reinterpret_cast<const float2*>(cp_row) : make_float2(0.f, 0.f);
        cp[0] = c.x, cp[1] = c.y;
      } else {
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const bool ok = j0 + ii < H;
#pragma unroll
          for (int q = 0; q < 4; ++q) x[q][ii] = ok ? xw[o + q * H + ii] : 0.f;
          cp[ii] = ok && r % T != 0 ? cp_row[ii] : 0.f;
        }
      }
      float v[6][2];  // iota, phi, gamma, omega (dxw's i, f, g, o blocks), kappa, f (coef's two blocks)
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const int ci = 2 * rr + ii;
        const float ig = sigmoidf(x[0][ii] + acc[4 * lo][ci]);
        const float fg = sigmoidf(x[1][ii] + acc[4 * lo + 1][ci]);
        const float gg = tanhf(x[2][ii] + acc[4 * lo + 2][ci]);
        const float og = sigmoidf(x[3][ii] + acc[4 * lo + 3][ci]);
        const float tc = tanhf(fg * cp[ii] + ig * gg);
        v[0][ii] = gg * ig * (1.0f - ig);
        v[1][ii] = cp[ii] * fg * (1.0f - fg);
        v[2][ii] = ig * (1.0f - gg * gg);
        v[3][ii] = tc * og * (1.0f - og);
        v[4][ii] = og * (1.0f - tc * tc);
        v[5][ii] = fg;
      }
      float* dst[6] = {dxw + o, dxw + o + H, dxw + o + 2 * H, dxw + o + 3 * H, coef + oc, coef + oc + H};
#pragma unroll
      for (int q = 0; q < 6; ++q) {
        if constexpr (kVec) {
          *reinterpret_cast<float2*>(dst[q]) = make_float2(v[q][0], v[q][1]);
        } else {
          dst[q][0] = v[q][0];
          if (j0 + 1 < H) dst[q][1] = v[q][1];
        }
      }
    }
  }
}

// ------------------------------------------------------------- backward, pass 2: the carry
//
// One cluster of C CTAs a group of R batch rows; blockDim = 32 W. The
// owner threads prefetch step t's inputs (kappa, f, iota, phi, gamma,
// omega, dhs at their pairs, the mask of their rows) two steps ahead with
// cp.async into private slots of a three-slot ring, so no step waits on
// device memory. Per step t = T-1 .. 0, at each (row, unit) of the warp's
// octet: d = dh + dhs[t]; dh_raw = d m; dc_raw = dc m + dh_raw kappa;
// dxw[t] = [dc_raw iota, dc_raw phi, dc_raw gamma, dh_raw omega], split into
// three bf16 terms in smem; dc = dc (1 - m) + dc_raw f, which never leaves
// the thread. The CTA multiplies its columns by its wh slice for every unit
// (the warps splitting the unit octets), the partials go to the CTAs that
// own the units, and after the cluster barrier dh = d (1 - m) + their sum,
// in rank order. dxw[t] is written over its coefficients.
constexpr int kPairVals = 7;                          // kappa, f, iota, phi, gamma, omega, dhs
constexpr int kRowVals = 2 * kPairVals + 1;           // a row's two units, and its mask
constexpr int kSlots = 3;                             // ring slots: two steps in flight
constexpr int kStage = kSlots * kRowVals * 32 * 4;  // ring bytes a warp, for each 8 rows of the group

template <int C>
__global__ void __launch_bounds__(32 * max_warps(C))
    lstm_bwd_carry_kernel(const bf16* __restrict__ wh, const float* __restrict__ dhs, const float* __restrict__ mask,
                          float* __restrict__ dxw, const float* __restrict__ coef, int B, int T, int H) {
  constexpr int R = group_rows(C);
  constexpr int NR = R / 8;  // accumulator rows a thread holds: g, and g + 8 at R = 16
  constexpr int kVals = NR * kRowVals;
  constexpr int kChunk = C >= 4 ? 2 : 1;  // unit octets a warp multiplies at once
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(H, C, 4, kStage);
  const int p = C > 1 ? static_cast<int>(cta_rank()) : 0;
  const int grp = blockIdx.x / C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const int ob = p * L.O / C, n_oct = (p + 1) * L.O / C - ob;
  const bool owner = warp < n_oct;  // warp-uniform: this warp owns octet ob + warp
  const int H4 = 4 * H, RU = 8 * L.ocp, NT = 32 * L.ocp;
  const int n_per = (L.O + L.W - 1) / L.W;  // unit octets of the carry product a warp takes (the same for all)
  bf16* slice = reinterpret_cast<bf16*>(smem);                // [Hk][ldw]
  bf16* dt = reinterpret_cast<bf16*>(smem + L.dt_off);        // [3][R][ldw]
  float* red = reinterpret_cast<float*>(smem + L.red_off);    // [2][C][R][RU]
  float* ring = reinterpret_cast<float*>(smem + L.ring_off);  // [kSlots][kVals][NT]: one column an owner thread
  const uint32_t slice_a = shared_addr(slice), dt_a = shared_addr(dt), red_a = shared_addr(red);

  // Zero the cotangent terms (their padding stays zero), then the wh slice:
  // local column lc = 32 lo + 8 gate + u is column gate * H + 8 (ob + lo) + u
  // of wh, zero past H and past the CTA's octets.
  for (int i = threadIdx.x; i < (L.red_off - L.dt_off) / 16; i += blockDim.x) {
    reinterpret_cast<uint4*>(smem + L.dt_off)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  for (int i = threadIdx.x; i < L.Hk * L.NC; i += blockDim.x) {
    const int k = i / L.NC, lc = i % L.NC;
    const int lo = lc / 32, j = 8 * (ob + lo) + lc % 8;
    const bool ok = k < H && lo < n_oct && j < H;
    slice[k * L.ldw + lc] = ok ? wh[(size_t)k * H4 + ((lc % 32) / 8) * H + j] : __float2bfloat16(0.f);
  }

  // This thread's (row, unit) pairs: rows g (+ 8), units 2 tq (+ 1) of its octet.
  const int j0 = 8 * (ob + warp) + 2 * tq;
  int brow[NR];
  bool okr[NR], ok[NR][2];
#pragma unroll
  for (int rr = 0; rr < NR; ++rr) {
    brow[rr] = grp * R + g + 8 * rr;
    okr[rr] = owner && brow[rr] < B;
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) ok[rr][ii] = okr[rr] && j0 + ii < H;
  }

  // Step t's inputs into ring slot t % kSlots (zero past B and H, and for t < 0), one cp.async group.
  auto fetch = [&](int t) {
    float* slot = ring + (t + kSlots) % kSlots * kVals * NT + threadIdx.x;
#pragma unroll
    for (int rr = 0; rr < NR; ++rr) {
      const size_t row = (size_t)brow[rr] * T + t;
      const bool kr = okr[rr] && t >= 0;
      float* s = slot + rr * kRowVals * NT;
      cp_async4(s + 2 * kPairVals * NT, mask + (kr ? row : 0), kr);
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const bool k = ok[rr][ii] && t >= 0;
        const size_t o = k ? row * H4 + j0 + ii : 0, oc = k ? row * 2 * H + j0 + ii : 0;
        const size_t od = k ? row * H + j0 + ii : 0;
        const float* src[kPairVals] = {coef + oc, coef + oc + H, dxw + o, dxw + o + H, dxw + o + 2 * H,
                                       dxw + o + 3 * H, dhs + od};
#pragma unroll
        for (int v = 0; v < kPairVals; ++v) cp_async4(s + (ii * kPairVals + v) * NT, src[v], k);
      }
    }
    cp_async_commit();
  };

  float dh[NR][2], dc[NR][2], keep[NR][2], xo[NR][2][4];
#pragma unroll
  for (int rr = 0; rr < NR; ++rr) dh[rr][0] = dh[rr][1] = dc[rr][0] = dc[rr][1] = 0.f;
  if (owner) {
    fetch(T - 1);
    fetch(T - 2);
  }
  __syncthreads();
  // Every CTA of the cluster runs before the first remote write.
  cluster_arrive();
  cluster_wait();

  for (int t = T - 1; t >= 0; --t) {
    if (owner) {
      cp_async_wait<1>();  // step t's slot has landed (t - 1's may still be in flight)
      const float* slot = ring + t % kSlots * kVals * NT + threadIdx.x;
#pragma unroll
      for (int rr = 0; rr < NR; ++rr) {
        const float* s = slot + rr * kRowVals * NT;
        const float m = s[2 * kPairVals * NT];
        float x[4][2];
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const float* c = s + ii * kPairVals * NT;
          const float kappa = c[0], fg = c[NT], iota = c[2 * NT], phi = c[3 * NT], gamma = c[4 * NT],
                      omega = c[5 * NT], dy = c[6 * NT];
          const float d = dh[rr][ii] + dy;
          const float dh_raw = d * m;
          const float dc_raw = dc[rr][ii] * m + dh_raw * kappa;
          x[0][ii] = dc_raw * iota;
          x[1][ii] = dc_raw * phi;
          x[2][ii] = dc_raw * gamma;
          x[3][ii] = dh_raw * omega;
          keep[rr][ii] = d * (1.0f - m);
          dc[rr][ii] = dc[rr][ii] * (1.0f - m) + dc_raw * fg;
#pragma unroll
          for (int q = 0; q < 4; ++q) xo[rr][ii][q] = x[q][ii];
        }
        // dxw[t] of the pairs, split into three bf16 terms.
        const int at = (g + 8 * rr) * L.ldw + warp * 32 + 2 * tq;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          __nv_bfloat162 terms[3];
          split3(x[q][0], x[q][1], terms);
          *reinterpret_cast<__nv_bfloat162*>(dt + at + q * 8) = terms[0];
          *reinterpret_cast<__nv_bfloat162*>(dt + R * L.ldw + at + q * 8) = terms[1];
          *reinterpret_cast<__nv_bfloat162*>(dt + 2 * R * L.ldw + at + q * 8) = terms[2];
        }
      }
    }
    __syncthreads();  // the CTA's cotangent terms staged

    // dxw[:, CTA columns] @ wh[:, CTA columns]^T for every unit, as in
    // csrc/gru_bwd.cu's carry: this warp's n_per unit octets nt = warp + j W,
    // kChunk at a time, each of the three terms into its own accumulator,
    // summed smallest first; then each octet's partials go to the CTA that
    // owns it, slot p. Every warp runs the same mma sequence (a j past the
    // octets recomputes the last one and stores nothing).
    const uint32_t red_t = red_a + (t & 1) * C * R * RU * 4;
    for (int jb = 0; jb < n_per; jb += kChunk) {
      float acc[3][kChunk][4];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj) acc[q][jj][0] = acc[q][jj][1] = acc[q][jj][2] = acc[q][jj][3] = 0.f;
      }
      int ntc[kChunk];
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) ntc[jj] = min(warp + (jb + jj) * L.W, L.O - 1);
#pragma unroll 2
      for (int kb = 0; kb < L.NC / 16; ++kb) {
        uint32_t a[3][4], b[kChunk][2];
#pragma unroll
        for (int q = 0; q < 3; ++q) load_a_frag<R>(a[q], dt_a + q * R * L.ldw * 2, L.ldw, kb * 16, lane);
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj) {
          ldsm_x2(b[jj][0], b[jj][1], slice_a + ((ntc[jj] * 8 + lane % 8) * L.ldw + kb * 16 + ((lane / 8) % 2) * 8) * 2);
        }
#pragma unroll
        for (int q = 0; q < 3; ++q) {
#pragma unroll
          for (int jj = 0; jj < kChunk; ++jj) mma_bf16(acc[q][jj], a[q], b[jj][0], b[jj][1]);
        }
      }
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const int nt = warp + (jb + jj) * L.W;
        if (jb + jj < n_per && nt < L.O) {
          int m = 0;
          while ((m + 1) * L.O / C <= nt) ++m;
          const int lu = (nt - m * L.O / C) * 8 + 2 * tq;
#pragma unroll
          for (int rr = 0; rr < NR; ++rr) {
            const float x = (acc[2][jj][2 * rr] + acc[1][jj][2 * rr]) + acc[0][jj][2 * rr];
            const float y = (acc[2][jj][2 * rr + 1] + acc[1][jj][2 * rr + 1]) + acc[0][jj][2 * rr + 1];
            st_cluster_f2(red_t + ((p * R + g + 8 * rr) * RU + lu) * 4, m, x, y);
          }
        }
      }
    }
    // The arrive releases the partials; the step's global traffic (dxw[t]
    // out, step t - 2's inputs in) goes between it and the wait.
    cluster_arrive();
    if (owner) {
#pragma unroll
      for (int rr = 0; rr < NR; ++rr) {
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          if (!ok[rr][ii]) continue;
          float* o = dxw + ((size_t)brow[rr] * T + t) * H4 + j0 + ii;
#pragma unroll
          for (int q = 0; q < 4; ++q) o[q * H] = xo[rr][ii][q];
        }
      }
      fetch(t - 2);
    }
    cluster_wait();  // every CTA's partials of this CTA's units have arrived

    if (owner) {
      const float* rd = red + (t & 1) * C * R * RU;
#pragma unroll
      for (int rr = 0; rr < NR; ++rr) {
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const int at = (g + 8 * rr) * RU + warp * 8 + 2 * tq + ii;
          float s = 0.f;
#pragma unroll
          for (int q = 0; q < C; ++q) s += rd[q * R * RU + at];
          dh[rr][ii] = keep[rr][ii] + s;
        }
      }
    }
  }
}

template <int C>
cudaError_t launch_carry(const void* wh, const void* dhs, const void* mask, void* dxw, const void* coef, int B, int T,
                         int H, cudaStream_t s) {
  const Layout L = layout(H, C, 4, kStage);
  auto kernel = lstm_bwd_carry_kernel<C>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (e != cudaSuccess) return e;
  if (C > 8) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  const int groups = (B + group_rows(C) - 1) / group_rows(C);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(groups * C);
  cfg.blockDim = dim3(32 * L.W);
  cfg.dynamicSmemBytes = L.bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const bf16*>(wh), static_cast<const float*>(dhs),
                         static_cast<const float*>(mask), static_cast<float*>(dxw), static_cast<const float*>(coef), B,
                         T, H);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// The largest hidden width the pair takes: the forward's, bf16 wh in one block.
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
                        const void* dhs, void* dxw, void* coef, void* dwh_partial, void* dwh, int B, int T, int H,
                        int device, void* stream) {
  const int c = takes(H) ? pick_cluster(B, H, 4, kStage) : 0;  // the carry's cluster: 1, 2, 4, 8 or 16
  if (c == 0 || B <= 0 || T <= 0) return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int BT = B * T;
  const dim3 gates_grid((BT + kGateRows - 1) / kGateRows, ((H + 7) / 8 + kGateOct - 1) / kGateOct);
  auto gates = H % 8 == 0 ? lstm_bwd_gates_kernel<true> : lstm_bwd_gates_kernel<false>;
  gates<<<gates_grid, kGateThreads, 0, s>>>(static_cast<const float*>(xw), static_cast<const bf16*>(wh),
                                            static_cast<const float*>(hs), static_cast<const float*>(cs),
                                            static_cast<float*>(dxw), static_cast<float*>(coef), BT, T, H);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  switch (c) {
    case 1: e = launch_carry<1>(wh, dhs, mask, dxw, coef, B, T, H, s); break;
    case 2: e = launch_carry<2>(wh, dhs, mask, dxw, coef, B, T, H, s); break;
    case 4: e = launch_carry<4>(wh, dhs, mask, dxw, coef, B, T, H, s); break;
    case 8: e = launch_carry<8>(wh, dhs, mask, dxw, coef, B, T, H, s); break;
    default: e = launch_carry<16>(wh, dhs, mask, dxw, coef, B, T, H, s); break;
  }
  if (e != cudaSuccess) return e;
  return recurrent_dw::launch(static_cast<const float*>(hs), static_cast<const float*>(dxw),
                              static_cast<float*>(dwh_partial), static_cast<float*>(dwh), B, T, H, 4 * H, s);
}
