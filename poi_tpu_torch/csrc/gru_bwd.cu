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
//     hw = bf16(h_prev) @ wh (exact bf16 products, fp32 sums); z, r, n, hn as in the forward
//     dh += dhs[t]
//     dn = dh z (1 - n^2);  da = dh (n - h_prev) z (1 - z)
//     dr_pre = dn hn r (1 - r);  dhn = dn r
//     dxw[t] = [da, dr_pre, dn];  dhw[t] = [da, dr_pre, dhn]
//     dh = dh (1 - z) + dhw[t] @ wh^T      (fp32-faithful, see below)
//   dwh [H, 3H] fp32 = sum over b, t of h_prev^T dhw
//
// What bounds it on this card: the carry is a serial chain of T steps; each
// step's product [3H] x [3H, H] a batch row is small, so a step's time is
// its latency (a barrier across the blocks that share a row group, the
// product, the exchange of partial sums) times T. What does not depend on
// the carry is parallel work: the gate recompute, a product
// [B*T, H] x [H, 3H] (3.2 GFLOP at B=512, T=64, H=128), the elementwise
// outputs, and dwh, an fp32 product [H, B*T] x [B*T, 3H] on the CUDA cores.
//
// Design: three passes and the shared dwh product.
// 1. gru_bwd_gates_kernel: the gate recompute of every step at once on the
//    tensor cores (mma.sync m16n8k16: exact bf16 products summed in fp32,
//    the TPU kernel's arithmetic, _gates; the summation order is the tensor
//    cores', so the gates match the forward's scalar walk to fp32 rounding,
//    not bit for bit), and from the gates each element's coefficients,
//    which depend on the forward alone: with d = dh + dhs[t],
//    da = d alpha, dr_pre = d beta, dn = d delta, dhn = d gamma, and the
//    carry's own factor 1 - z. They go into the outputs' buffers.
// 2. gru_bwd_carry_kernel, the serial chain. A cluster of C CTAs owns a
//    group of R = 16 batch rows (8 at a cluster of 16), the mma's M. The H
//    units are cut into octets of 8 (the mma's N); CTA p owns octets
//    [p*O/C, (p+1)*O/C) of O = ceil(H/8) and keeps their z, r and n columns
//    of wh, [Hk, 24 per octet] bf16 (Hk = H rounded up to 16, padding zero),
//    in shared memory; its first warps each own an octet, whose carry dh
//    stays in registers for the whole reverse loop. Per step:
//    - each owner warp forms dhw = d [alpha, beta, gamma] of its units and
//      splits each fp32 element x into three bf16 terms, b0 = bf16(x),
//      b1 = bf16(x - b0), b2 = bf16(x - b0 - b1) (the differences are exact
//      in fp32; together the terms carry fp32's 24 significant bits), staged
//      in smem. The TPU kernel computes dhw @ wh^T at Precision.HIGHEST from
//      fp32 dhw; no cotangent is rounded to bf16 as a whole (a bf16
//      cotangent trains config #2 to a much worse recall,
//      poi_tpu/ops/fused_gru.py:113-120);
//    - the CTA multiplies its columns by its wh slice for every unit (all its
//      warps splitting the unit octets), each term exactly into its own fp32
//      accumulator, the three summed smallest first; it writes the partial
//      sums of octet m into the CTA that owns m (distributed shared memory),
//      slot p;
//    - one cluster barrier, split: its arrive releases the partials, the
//      step's global traffic (d out, the next step's inputs in) runs before
//      its wait; then dh = d (1 - z) + the C partials, added in rank order.
//      The slots are double-buffered by step parity. No atomics: the same
//      bits every run.
//    C: the smallest of 1, 2, 4, 8, 16 whose slices fit in shared memory,
//    then doubled (up to 8) while the groups' clusters fit on the 132 SMs
//    at once (B = 512, H = 128: 32 groups x 4; B = 64, H = 256: 4 x 8). Any
//    H up to 640; a ragged H zero-pads the last octet and K. Past 640 the
//    carry runs on the whole card (gru_bwd_grid_carry_kernel, below, with
//    csrc/grid_carry.cuh): each CTA keeps wh's rows of its output units and
//    reads the three bf16 terms of every column of dhw from an L2-resident
//    buffer behind a step barrier of its row group; the other passes are
//    the same (gru_bwd_grid).
// 3. gru_bwd_outputs_kernel: dxw = d [alpha, beta, delta] and
//    dhw = d [alpha, beta, gamma], in place. Padded steps (z = 0 exactly
//    from the folded -1e9) have alpha = beta = gamma = delta = 0, so dxw is
//    exactly 0 there, and 1 - z = 1 passes dh through unchanged.
// dhw is an fp32 scratch [B, T, 3H] the wrapper allocates; dwh is the
// split-chunk product and ordered reduce of csrc/recurrent_dwh.cuh (shared
// with the LSTM and RNN backward).
//
// The entry point launches on the given stream, does not synchronise and
// allocates nothing; it returns cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_carry.cuh"
#include "recurrent_dwh.cuh"

namespace {

__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / (1.0f + expf(-x)); }

// ------------------------------------------------------------- pass 1: the gates
//
// The gate recompute of every (b, t) at once: hw = bf16(h_prev) @ wh as a
// batched product [B*T, Hk] x [Hk, 3H] (mma.sync, exact bf16 products, fp32
// sums), and from hw the step's coefficients, which depend on the forward
// alone:
//   z, r, n as in the forward; 1 - z; delta = z (1 - n^2);
//   alpha = (n - h_prev) z (1 - z); beta = delta hn r (1 - r); gamma = delta r
// so that with d = dh + dhs[t]: da = d alpha, dr_pre = d beta, dn = d delta,
// dhn = d gamma. They go into the outputs' own buffers: dxw [alpha, beta,
// delta], dhw [1 - z, gamma, -] (its third block is the serial kernel's d).
// A block is 8 warps of 16 rows (128 rows of B*T) x 8 unit octets (their z,
// r and n columns); K streams through smem in chunks of 64. Where H % 8 ==
// 0 (kVec) the loads move 4 (h) and 8 (wh) elements at a time and the
// epilogue two units.
constexpr int kGateRows = 128, kGateOct = 8, kGateK = 64, kGateThreads = 256;
constexpr int kGateLdA = kGateK + 8, kGateLdB = 24 * kGateOct + 8;

template <bool kVec>
__global__ void __launch_bounds__(kGateThreads)
    gru_bwd_gates_kernel(const float* __restrict__ xw, const bf16* __restrict__ wh, const float* __restrict__ hs,
                         float* __restrict__ dxw, float* __restrict__ dhw, int BT, int T, int H) {
  __shared__ __align__(16) bf16 a_s[kGateRows * kGateLdA];
  __shared__ __align__(16) bf16 b_s[kGateK * kGateLdB];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const int r0 = blockIdx.x * kGateRows, o0 = blockIdx.y * kGateOct;
  const int H3 = 3 * H, Hk = (H + 15) / 16 * 16;
  float acc[3 * kGateOct][4];
#pragma unroll
  for (int i = 0; i < 3 * kGateOct; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
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
    // B: wh rows k0.., local column 24 lo + 8 gate + u = wh column gate H + 8 (o0 + lo) + u.
    if constexpr (kVec) {
      for (int e = threadIdx.x; e < kGateK * 3 * kGateOct; e += kGateThreads) {
        const int kk = e / (3 * kGateOct), grp8 = e % (3 * kGateOct), k = k0 + kk;  // grp8 = 3 lo + gate
        const int j = 8 * (o0 + grp8 / 3);
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (k < H && j < H) v = *reinterpret_cast<const uint4*>(wh + (size_t)k * H3 + (grp8 % 3) * H + j);
        *reinterpret_cast<uint4*>(b_s + kk * kGateLdB + 8 * grp8) = v;
      }
    } else {
      for (int e = threadIdx.x; e < kGateK * 24 * kGateOct; e += kGateThreads) {
        const int kk = e / (24 * kGateOct), lc = e % (24 * kGateOct), k = k0 + kk;
        const int j = 8 * (o0 + lc / 24) + lc % 8;
        b_s[kk * kGateLdB + lc] = k < H && j < H ? wh[(size_t)k * H3 + ((lc % 24) / 8) * H + j] : __float2bfloat16(0.f);
      }
    }
    __syncthreads();
    const int ks_end = (Hk - k0 < kGateK ? Hk - k0 : kGateK) / 16;
    for (int ks = 0; ks < ks_end; ++ks) {
      uint32_t a[4];
      ldsm_x4(a, a_a + ((warp * 16 + lane % 16) * kGateLdA + ks * 16 + (lane / 16) * 8) * 2);
#pragma unroll
      for (int nt = 0; nt < 3 * kGateOct; ++nt) {
        uint32_t b0, b1;
        ldsm_x2_trans(b0, b1, b_a + ((ks * 16 + lane % 16) * kGateLdB + nt * 8) * 2);
        mma_bf16(acc[nt], a, b0, b1);
      }
    }
    __syncthreads();
  }
  // Accumulator (n-tile 3 lo + gate) holds rows g (+ 8) x units 2 tq (+ 1) of octet o0 + lo.
#pragma unroll
  for (int lo = 0; lo < kGateOct; ++lo) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = r0 + warp * 16 + g + 8 * rr, j0 = 8 * (o0 + lo) + 2 * tq;
      if (r >= BT || j0 >= H) continue;
      const size_t o = (size_t)r * H3 + j0;
      const float* hp_row = hs + (size_t)(r - 1) * H + j0;
      float xz[2], xr[2], xn[2], hp[2];
      if constexpr (kVec) {  // j0 even, H % 8 == 0: both units valid, 8-byte aligned
        const float2 a = *reinterpret_cast<const float2*>(xw + o);
        const float2 b = *reinterpret_cast<const float2*>(xw + o + H);
        const float2 c = *reinterpret_cast<const float2*>(xw + o + 2 * H);
        const float2 h = r % T != 0 ? *reinterpret_cast<const float2*>(hp_row) : make_float2(0.f, 0.f);
        xz[0] = a.x, xz[1] = a.y, xr[0] = b.x, xr[1] = b.y, xn[0] = c.x, xn[1] = c.y, hp[0] = h.x, hp[1] = h.y;
      } else {
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const bool ok = j0 + ii < H;
          xz[ii] = ok ? xw[o + ii] : 0.f;
          xr[ii] = ok ? xw[o + H + ii] : 0.f;
          xn[ii] = ok ? xw[o + 2 * H + ii] : 0.f;
          hp[ii] = ok && r % T != 0 ? hp_row[ii] : 0.f;
        }
      }
      float v[5][2];  // alpha, beta, delta, 1 - z, gamma of the two units
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const int ci = 2 * rr + ii;
        const float hz = acc[3 * lo][ci], hr = acc[3 * lo + 1][ci], hn = acc[3 * lo + 2][ci];
        const float z = sigmoidf(xz[ii] + hz);
        const float rg = sigmoidf(xr[ii] + hr);
        const float n = tanhf(xn[ii] + rg * hn);
        const float delta = z * (1.0f - n * n);
        v[0][ii] = (n - hp[ii]) * z * (1.0f - z);
        v[1][ii] = delta * hn * rg * (1.0f - rg);
        v[2][ii] = delta;
        v[3][ii] = 1.0f - z;
        v[4][ii] = delta * rg;
      }
      float* dst[5] = {dxw + o, dxw + o + H, dxw + o + 2 * H, dhw + o, dhw + o + H};
#pragma unroll
      for (int q = 0; q < 5; ++q) {
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

// ------------------------------------------------------------- pass 2: the carry
//
// One cluster of C CTAs a group of R batch rows; blockDim = 32 W. Per step
// t = T-1 .. 0, with d = dh + dhs[t] at each (row, unit) of the warp's octet:
// dhw = d [alpha, beta, gamma] is split into three bf16 terms in smem, the
// CTA multiplies its columns by its wh slice for every unit (the warps
// splitting the unit octets), the partials go to the CTAs that own the
// units, and after the cluster barrier dh = d (1 - z) + their sum, in rank
// order. d is written to dhw's third block for pass 3.
template <int C>
__global__ void __launch_bounds__(32 * max_warps(C))
    gru_bwd_carry_kernel(const bf16* __restrict__ wh, const float* __restrict__ dhs, const float* __restrict__ coef_x,
                         float* __restrict__ coef_h, int B, int T, int H) {
  constexpr int R = group_rows(C);
  constexpr int NR = R / 8;  // accumulator rows a thread holds: g, and g + 8 at R = 16
  constexpr int kChunk = C >= 4 ? 2 : 1;  // unit octets a warp multiplies at once
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(H, C, 3);
  const int p = C > 1 ? static_cast<int>(cta_rank()) : 0;
  const int grp = blockIdx.x / C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const int ob = p * L.O / C, n_oct = (p + 1) * L.O / C - ob;
  const bool owner = warp < n_oct;  // warp-uniform: this warp owns octet ob + warp
  const int H3 = 3 * H, RU = 8 * L.ocp;
  const int n_per = (L.O + L.W - 1) / L.W;  // unit octets of the carry product a warp takes (the same for all)
  bf16* slice = reinterpret_cast<bf16*>(smem);                // [Hk][ldw]
  bf16* dt = reinterpret_cast<bf16*>(smem + L.dt_off);        // [3][R][ldw]
  float* red = reinterpret_cast<float*>(smem + L.red_off);    // [2][C][R][RU]
  const uint32_t slice_a = shared_addr(slice), dt_a = shared_addr(dt), red_a = shared_addr(red);

  // Zero the dhw terms (their padding stays zero), then the wh slice: local
  // column lc = 24 lo + 8 gate + u is column gate * H + 8 (ob + lo) + u of
  // wh, zero past H and past the CTA's octets.
  for (int i = threadIdx.x; i < (L.red_off - L.dt_off) / 16; i += blockDim.x) {
    reinterpret_cast<uint4*>(smem + L.dt_off)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  for (int i = threadIdx.x; i < L.Hk * L.NC; i += blockDim.x) {
    const int k = i / L.NC, lc = i % L.NC;
    const int lo = lc / 24, j = 8 * (ob + lo) + lc % 8;
    const bool ok = k < H && lo < n_oct && j < H;
    slice[k * L.ldw + lc] = ok ? wh[(size_t)k * H3 + ((lc % 24) / 8) * H + j] : __float2bfloat16(0.f);
  }

  // This thread's (row, unit) pairs: rows g (+ 8), units 2 tq (+ 1) of its octet.
  int brow[NR];
  bool ok[NR][2];
#pragma unroll
  for (int rr = 0; rr < NR; ++rr) {
    brow[rr] = grp * R + g + 8 * rr;
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) ok[rr][ii] = owner && brow[rr] < B && 8 * (ob + warp) + 2 * tq + ii < H;
  }
  const int j0 = 8 * (ob + warp) + 2 * tq;

  // Step t's inputs at the thread's pairs: 1 - z, alpha, beta, gamma, dhs.
  float omz[NR][2], ca[NR][2], cb[NR][2], cg[NR][2], dy[NR][2];
  auto load = [&](int t) {
#pragma unroll
    for (int rr = 0; rr < NR; ++rr) {
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const size_t row = (size_t)brow[rr] * T + t;
        const size_t o = row * H3 + j0 + ii;
        const bool k = ok[rr][ii];
        omz[rr][ii] = k ? coef_h[o] : 1.f;
        cg[rr][ii] = k ? coef_h[o + H] : 0.f;
        ca[rr][ii] = k ? coef_x[o] : 0.f;
        cb[rr][ii] = k ? coef_x[o + H] : 0.f;
        dy[rr][ii] = k ? dhs[row * H + j0 + ii] : 0.f;
      }
    }
  };

  float dh[NR][2], d[NR][2];
#pragma unroll
  for (int rr = 0; rr < NR; ++rr) dh[rr][0] = dh[rr][1] = 0.f;
  if (owner) load(T - 1);
  __syncthreads();
  // Every CTA of the cluster runs before the first remote write.
  cluster_arrive();
  cluster_wait();

  for (int t = T - 1; t >= 0; --t) {
    float keep[NR][2];  // 1 - z of step t
    if (owner) {
      // dhw = d [alpha, beta, gamma], split into three bf16 terms.
#pragma unroll
      for (int rr = 0; rr < NR; ++rr) {
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          d[rr][ii] = dh[rr][ii] + dy[rr][ii];
          keep[rr][ii] = omz[rr][ii];
        }
        const int at = (g + 8 * rr) * L.ldw + warp * 24 + 2 * tq;
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const float* c = q == 0 ? ca[rr] : q == 1 ? cb[rr] : cg[rr];
          __nv_bfloat162 terms[3];
          split3(d[rr][0] * c[0], d[rr][1] * c[1], terms);
          *reinterpret_cast<__nv_bfloat162*>(dt + at + q * 8) = terms[0];
          *reinterpret_cast<__nv_bfloat162*>(dt + R * L.ldw + at + q * 8) = terms[1];
          *reinterpret_cast<__nv_bfloat162*>(dt + 2 * R * L.ldw + at + q * 8) = terms[2];
        }
      }
    }
    __syncthreads();  // the CTA's dhw terms staged

    // dhw[:, CTA columns] @ wh[:, CTA columns]^T for every unit: this warp's
    // n_per unit octets nt = warp + j * W, kChunk at a time, each of the
    // three terms into its own accumulator (three independent mma chains),
    // summed at the end; then each octet's partials go to the CTA that owns
    // it, slot p. Every warp runs the same mma sequence (a j past the
    // octets recomputes the last one and stores nothing), so no mma or
    // ldmatrix sits under a branch that may diverge.
    const uint32_t red_t = red_a + (t & 1) * C * R * RU * 4;
    for (int j0 = 0; j0 < n_per; j0 += kChunk) {
      float acc[3][kChunk][4];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj) acc[q][jj][0] = acc[q][jj][1] = acc[q][jj][2] = acc[q][jj][3] = 0.f;
      }
      int ntc[kChunk];
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) ntc[jj] = min(warp + (j0 + jj) * L.W, L.O - 1);
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
        const int nt = warp + (j0 + jj) * L.W;
        if (j0 + jj < n_per && nt < L.O) {
          int m = 0;
          while ((m + 1) * L.O / C <= nt) ++m;
          const int lu = (nt - m * L.O / C) * 8 + 2 * tq;
#pragma unroll
          for (int rr = 0; rr < NR; ++rr) {
            // The smallest term first.
            const float x = (acc[2][jj][2 * rr] + acc[1][jj][2 * rr]) + acc[0][jj][2 * rr];
            const float y = (acc[2][jj][2 * rr + 1] + acc[1][jj][2 * rr + 1]) + acc[0][jj][2 * rr + 1];
            st_cluster_f2(red_t + ((p * R + g + 8 * rr) * RU + lu) * 4, m, x, y);
          }
        }
      }
    }
    // The arrive releases the partials; the step's global traffic (d out,
    // the next step's inputs in) goes between it and the wait.
    cluster_arrive();
    if (owner) {
#pragma unroll
      for (int rr = 0; rr < NR; ++rr) {
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          if (ok[rr][ii]) coef_h[((size_t)brow[rr] * T + t) * H3 + 2 * H + j0 + ii] = d[rr][ii];
        }
      }
      if (t > 0) load(t - 1);
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
          dh[rr][ii] = d[rr][ii] * keep[rr][ii] + s;
        }
      }
    }
  }
}

// ------------------------------------------------------------- pass 3: the outputs
//
// In place: dxw = d [alpha, beta, delta], dhw = d [alpha, beta, gamma].
__global__ void gru_bwd_outputs_kernel(float* __restrict__ dxw, float* __restrict__ dhw, long long n, int H) {
  const int H3 = 3 * H;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n; i += (long long)gridDim.x * blockDim.x) {
    const long long o = i / H * H3 + i % H;
    const float d = dhw[o + 2 * H];
    const float da = d * dxw[o], dr = d * dxw[o + H];
    dxw[o] = da;
    dxw[o + H] = dr;
    dxw[o + 2 * H] *= d;
    dhw[o + 2 * H] = d * dhw[o + H];
    dhw[o] = da;
    dhw[o + H] = dr;
  }
}

// ------------------------------------------------------------- pass 2 past the cluster: the grid
//
// gru_bwd_grid_carry_kernel, for the widths no cluster takes (grid_carry.cuh
// has the grid, the barrier and the fragment loads). CTA (r, u) owns the
// output units of its octets: it keeps wh's rows of those units, [8 ocp][Kp
// + 8] bf16 (every column c < 3H, the k-steps' columns permuted by kperm), in
// shared memory, so that dhw[t] @ wh^T at its units is one product over all
// 3H columns: no partial sums cross a CTA. Step t = T-1 .. 1 of the row
// group:
// - each task's pairs form dhw = d [alpha, beta, gamma] (d = dh + dhs[t],
//   already in dhw's third block) and write its three exact bf16 terms
//   (split3) to the L2-resident buffer dt[t & 1] [3][R rows][Kp] at columns
//   gate * H + unit;
// - the group's barrier;
// - per task, the three terms' products with the CTA's slice, each into its
//   own fp32 accumulator (A straight from L2, kGridBwdPf k-steps ahead),
//   summed smallest first: s; dh = d (1 - z) + s and d(t - 1) = dh +
//   dhs[t - 1] into dhw's third block for the next step and for pass 3.
// Step 0's dh is the cotangent of h0, a constant: no product. d(T - 1) =
// dhs[T - 1] is written first. No atomics in any sum: the same bits every run.

__global__ void __launch_bounds__(32 * kGridWarps, 1)
    gru_bwd_grid_carry_kernel(const bf16* __restrict__ wh, const float* __restrict__ dhs,
                              const float* __restrict__ coef_x, float* __restrict__ coef_h, bf16* __restrict__ dt,
                              int* __restrict__ ctr, int B, int T, int H, GridShape S) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int O = (H + 7) / 8, H3 = 3 * H, Kp = (H3 + 15) / 16 * 16, ldk = Kp + 8;
  const int u = blockIdx.x % S.U, grp = blockIdx.x / S.U;
  const int ob = u * O / S.U, n_oct = (u + 1) * O / S.U - ob;
  const int row0 = grp * S.rows, n_rt = (min(S.rows, B - row0) + 15) / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const size_t term = (size_t)S.R * S.rows * Kp;  // one term of one parity of dt [2][3][R rows][Kp]
  int* my_ctr = ctr + grp * kCtrStride;
  int ng, gs;
  grid_tasks(n_rt, n_oct, ng, gs);

  // The slice: local unit lu's row holds wh[8 ob + lu][c] at physical column
  // p, c = kperm of p within its k-step (zero past 3H, past H and past the
  // CTA's octets).
  bf16* slice = reinterpret_cast<bf16*>(smem);
  for (int i = threadIdx.x; i < 8 * S.ocp * Kp; i += blockDim.x) {
    const int lu = i / Kp, p = i % Kp, c = (p & ~15) + kperm(p & 15), j = 8 * ob + lu;
    const bool ok = lu < 8 * n_oct && j < H && c < H3;
    slice[lu * ldk + p] = ok ? wh[(size_t)j * H3 + c] : __float2bfloat16(0.f);
  }
  const uint32_t slice_a = shared_addr(slice);

  // Calls f(lo, rr, ii, b, j) for each of this thread's pairs of a task that
  // lie below B and H.
  auto pairs = [&](int r0, int lo0, int no, auto&& f) {
#pragma unroll
    for (int lo = 0; lo < kTaskOct; ++lo) {
      if (lo >= no) break;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const int b = r0 + g + 8 * rr, j = 8 * (ob + lo0 + lo) + 2 * tq + ii;
          if (b < B && j < H) f(lo, rr, ii, b, j);
        }
      }
    }
  };
  for (int task = warp; task < n_rt * ng; task += kGridWarps) {  // d(T - 1) = dhs[T - 1]
    pairs(row0 + 16 * (task / ng), (task % ng) * gs, min(gs, n_oct - (task % ng) * gs),
          [&](int, int, int, int b, int j) {
            const size_t row = (size_t)b * T + T - 1;
            coef_h[row * H3 + 2 * H + j] = dhs[row * H + j];
          });
  }
  __syncthreads();

  for (int t = T - 1; t > 0; --t) {
    bf16* dtt = dt + (size_t)(t & 1) * 3 * term;
    for (int task = warp; task < n_rt * ng; task += kGridWarps) {
      const int r0 = row0 + 16 * (task / ng), lo0 = (task % ng) * gs, no = min(gs, n_oct - lo0);
#pragma unroll
      for (int lo = 0; lo < kTaskOct; ++lo) {
        if (lo >= no) break;
        const int j0 = 8 * (ob + lo0 + lo) + 2 * tq;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int b = r0 + g + 8 * rr;
          if (b >= B || j0 >= H) continue;
          float dv[2], c[3][2];
#pragma unroll
          for (int ii = 0; ii < 2; ++ii) {
            const bool ok = j0 + ii < H;
            const size_t o = ((size_t)b * T + t) * H3 + j0 + ii;
            dv[ii] = ok ? coef_h[o + 2 * H] : 0.f;
            c[0][ii] = ok ? coef_x[o] : 0.f;
            c[1][ii] = ok ? coef_x[o + H] : 0.f;
            c[2][ii] = ok ? coef_h[o + H] : 0.f;
          }
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            __nv_bfloat162 terms[3];
            split3(dv[0] * c[q][0], dv[1] * c[q][1], terms);
            bf16* at = dtt + (size_t)b * Kp + q * H + j0;
#pragma unroll
            for (int e = 0; e < 3; ++e) {
              if (j0 + 1 < H && H % 2 == 0) {
                *reinterpret_cast<__nv_bfloat162*>(at + e * term) = terms[e];
              } else {
                at[e * term] = terms[e].x;
                if (j0 + 1 < H) at[e * term + 1] = terms[e].y;
              }
            }
          }
        }
      }
    }
    group_arrive(my_ctr);
    group_wait(my_ctr, S.U * (T - t));  // every CTA of the group has written step t's terms
    for (int task = warp; task < n_rt * ng; task += kGridWarps) {
      const int r0 = row0 + 16 * (task / ng), lo0 = (task % ng) * gs, no = min(gs, n_oct - lo0);
      float acc[3][kTaskOct][4];
#pragma unroll
      for (int e = 0; e < 3; ++e) {
#pragma unroll
        for (int lo = 0; lo < kTaskOct; ++lo) acc[e][lo][0] = acc[e][lo][1] = acc[e][lo][2] = acc[e][lo][3] = 0.f;
      }
      grid_carry_product(acc, dtt + (size_t)(r0 + g) * Kp + 4 * tq, term, Kp, slice_a, ldk, lo0, no, lane);
      // dh = d (1 - z) + s, the smallest term first; then d(t - 1).
      pairs(r0, lo0, no, [&](int lo, int rr, int ii, int b, int j) {
        const int ci = 2 * rr + ii;
        const float s = (acc[2][lo][ci] + acc[1][lo][ci]) + acc[0][lo][ci];
        const size_t row = (size_t)b * T + t;
        const float dh = coef_h[row * H3 + 2 * H + j] * coef_h[row * H3 + j] + s;
        coef_h[(row - 1) * H3 + 2 * H + j] = dh + dhs[(row - 1) * H + j];
      });
    }
  }
}

template <int C>
cudaError_t launch_carry(const void* wh, const void* dhs, void* dxw, void* dhw, int B, int T, int H, cudaStream_t s) {
  const Layout L = layout(H, C, 3);
  auto kernel = gru_bwd_carry_kernel<C>;
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
                         static_cast<const float*>(dxw), static_cast<float*>(dhw), B, T, H);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// The cluster size the kernel runs a batch of B rows of width H on (1, 2, 4,
// 8 or 16), or 0 when no cluster takes H.
extern "C" int gru_bwd_cluster_size(int B, int H) { return pick_cluster(B, H, 3); }

// Number of partial dwh sums the wrapper allocates ([splits, H, 3H] fp32).
extern "C" int gru_bwd_splits(int B, int T, int H) { return recurrent_dw::num_splits(B * T, H, 3 * H); }

// The three passes and dwh around `carry`, which launches pass 2 on `s`.
template <class Carry>
cudaError_t run_passes(const void* xw, const void* wh, const void* hs, void* dxw, void* dhw, void* dwh_partial,
                       void* dwh, int B, int T, int H, cudaStream_t s, Carry carry) {
  const int BT = B * T;
  const dim3 gates_grid((BT + kGateRows - 1) / kGateRows, ((H + 7) / 8 + kGateOct - 1) / kGateOct);
  auto gates = H % 8 == 0 ? gru_bwd_gates_kernel<true> : gru_bwd_gates_kernel<false>;
  gates<<<gates_grid, kGateThreads, 0, s>>>(static_cast<const float*>(xw), static_cast<const bf16*>(wh),
                                            static_cast<const float*>(hs), static_cast<float*>(dxw),
                                            static_cast<float*>(dhw), BT, T, H);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = carry();
  if (e != cudaSuccess) return e;
  const long long n = (long long)BT * H;
  gru_bwd_outputs_kernel<<<4 * kSms, 256, 0, s>>>(static_cast<float*>(dxw), static_cast<float*>(dhw), n, H);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return recurrent_dw::launch(static_cast<const float*>(hs), static_cast<const float*>(dhw),
                              static_cast<float*>(dwh_partial), static_cast<float*>(dwh), B, T, H, 3 * H, s);
}

extern "C" int gru_bwd(const void* xw, const void* wh, const void* hs, const void* dhs, void* dxw, void* dhw,
                       void* dwh_partial, void* dwh, int B, int T, int H, int device, void* stream) {
  const int c = pick_cluster(B, H, 3);
  if (c == 0 || B <= 0 || T <= 0) return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return run_passes(xw, wh, hs, dxw, dhw, dwh_partial, dwh, B, T, H, s, [&]() {
    switch (c) {
      case 1: return launch_carry<1>(wh, dhs, dxw, dhw, B, T, H, s);
      case 2: return launch_carry<2>(wh, dhs, dxw, dhw, B, T, H, s);
      case 4: return launch_carry<4>(wh, dhs, dxw, dhw, B, T, H, s);
      case 8: return launch_carry<8>(wh, dhs, dxw, dhw, B, T, H, s);
      default: return launch_carry<16>(wh, dhs, dxw, dhw, B, T, H, s);
    }
  });
}

// The backward with pass 2 on the grid (gru_bwd_grid_carry_kernel), for the
// widths past the clusters'. dt: [2][3][R rows][Kp] bf16 zeros, ctr: R * 32
// int32 zeros (gru_grid_shape(B, H, 1)'s R and rows); both the caller's,
// left dirty. cudaErrorInvalidValue where no grid takes H.
extern "C" int gru_bwd_grid(const void* xw, const void* wh, const void* hs, const void* dhs, void* dxw, void* dhw,
                            void* dwh_partial, void* dwh, void* dt, void* ctr, int B, int T, int H, int device,
                            void* stream) {
  const GridShape g = grid_shape(B, H, true, 3);
  if (g.ocp == 0 || B <= 0 || T <= 0) return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return run_passes(xw, wh, hs, dxw, dhw, dwh_partial, dwh, B, T, H, s, [&]() {
    return launch_grid(gru_bwd_grid_carry_kernel, g, grid_slice_bytes(H, g.ocp, true, 3), s,
                       static_cast<const bf16*>(wh), static_cast<const float*>(dhs), static_cast<const float*>(dxw),
                       static_cast<float*>(dhw), static_cast<bf16*>(dt), static_cast<int*>(ctr), B, T, H, g);
  });
}
