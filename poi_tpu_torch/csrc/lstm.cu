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
// Forward (B3), lstm_fwd_kernel: csrc/gru_fwd.cu's design (B1) for four gate
// blocks and two carries, written as a kernel of its own rather than a
// template shared with gru_fwd.cu (the mask ring, the fourth gate block and
// the second carry reach every part of the step, and gru_fwd.cu keeps its
// code and bits); the two share cluster_carry.cuh's helpers: the fast
// gates, ldmatrix, st.async and the TMA load. The first design (one thread a unit of one row,
// a row a block at H >= 128, an H-long FMA chain a gate on shared-memory
// operands, IEEE gates, a block barrier a step: ~4.3 us a step) held all of
// bf16 wh in one block, which capped the pair at H <= 170.
// - A cluster of C CTAs owns a group of 16 batch rows (the mma's M); rows
//   past B compute on zeros and store nothing. CTA p owns unit octets
//   [p*O/C, (p+1)*O/C) of O = ceil(H/8) and their i, f, g and o columns of
//   wh, [Hk, 32 an octet] bf16 (Hk = H rounded up to 16; padding zero), in
//   shared memory; up to Hk = 128 each warp holds its octet's slice as mma B
//   fragments in registers (8 k-steps x 4 n-tiles x 2: 64 registers).
// - Consumer warp w of CTA p owns octet p*O/C + w. Its four accumulator
//   tiles hold the same (row, unit) positions, so the gate update runs in
//   registers, and the fp32 carries h and c of its 16 rows x 8 units stay in
//   that thread's registers, in the accumulator layout, for the sequence.
// - A step: wait for xw[t] and the mask (the ring below) and for h(t-1) (the
//   h buffer's mbarrier); bf16(h) @ wh on mma.sync m16n8k16 (exact bf16
//   products summed in fp32; h is rounded to bf16 by contract, so one term
//   suffices), two chains a gate added at the end; the gates with
//   cluster_carry.cuh's sigmoid_fast / tanh_fast (ex2.approx, rcp.approx),
//   tanh(c_raw) too; the blend with the row's m; bf16(h) into the next h
//   buffer of every CTA of the cluster by st.async, counted on that CTA's
//   mbarrier (double-buffered by step parity, no barrier in the step: a CTA
//   can only overwrite a buffer after every warp of every CTA has read it);
//   fp32 h and c out to hs and cs.
// - A producer warp streams xw in with one TMA box a step and CTA ([16 rows]
//   [i, f, g, o][the CTA's units] of xw seen as [B][T][4][H], zero past B
//   and H; 4-byte cp.async where H % 4 != 0), and the group's 16 mask values
//   beside it in the same ring slot by cp.async: the mask rides the ring, so
//   no T-long copy of it sits in shared memory. Up to 4 slots on full /
//   empty mbarriers; a consumer fences its reads of a slot against the async
//   proxy before it releases the slot.
// - Padded steps (m = 0) pass both carries through exactly: the gates are
//   finite (ex2 overflows to inf, and rcp(inf) = 0), so m c_raw = 0 and
//   (1 - m) c = c.
// - C: B1's rule, the smallest of 1, 2, 4, 8, 16 whose CTAs hold at most
//   4 octets each (else the smallest that fits): C = 2 at H = 64, 4 at
//   H = 128, 8 at H = 256. chip_smoke.py times every cluster that fits
//   (`lstm_fwd cluster choice`, device time): 4 octets a CTA was the
//   fastest at H = 64 and 256 (at 256 by 13% over 8 octets) and at batch
//   256; at config #2's B = 64, H = 128, 8 octets (C = 2) was 4-5% faster in
//   three runs, and at batch 1 two octets (C = 8) by 4%. Every cluster gives
//   the same bits: a warp's arithmetic does not depend on C.
// - No atomics: a second launch gives the same bits. The gates are
//   approximated and the product is two chains, so the backward's gate
//   recompute (IEEE sigmoidf / tanhf, the tensor cores' summation order)
//   matches these gates to fp32 rounding, not bit for bit.
// The cluster kernels take any H up to 512 (cluster_max_hidden()), ragged
// ones included, where both this forward and the backward's carry fit on
// some cluster. Past it wh no longer fits a cluster (2.1 MB at H = 512, 8.4
// MB at H = 1024), and the serial kernels run on the whole card:
// lstm_fwd_grid_kernel and lstm_bwd_grid_carry_kernel below
// (csrc/grid_carry.cuh, the GRU's grid-resident design with four gate
// blocks), up to lstm_max_hidden() (1600); a larger H is refused
// (cudaErrorInvalidValue), and the Python wrapper raises first and names the
// limit.
//
// Backward (B4): csrc/gru_bwd.cu's three passes, for four gates and two
// carries, and the shared dwh product.
// 1. lstm_bwd_gates_kernel: the gate recompute of every step at once on the
//    tensor cores (mma.sync m16n8k16: exact bf16 products summed in fp32, the
//    TPU kernel's arithmetic, _gates; IEEE sigmoidf / tanhf, and the
//    tensor cores' summation order, so the gates match the forward's fast
//    approximations to fp32 rounding, not bit for bit), and from the gates
//    and c_prev each element's
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

#include "grid_carry.cuh"
#include "recurrent_dwh.cuh"

namespace {

__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / (1.0f + expf(-x)); }

// ------------------------------------------------------------- forward (B3)
//
// gru_fwd.cu's design with four gate blocks and a second carry. A cluster of
// C CTAs owns 16 batch rows; CTA p owns unit octets [p*O/C, (p+1)*O/C) of
// O = ceil(H/8) and keeps their i, f, g and o columns of wh, [Hk, 32 an
// octet] bf16, in shared memory; up to Hk = 128 each warp holds its octet's
// slice as mma B fragments in registers (8 k-steps x 4 n-tiles x 2).
// Consumer warp w owns octet p*O/C + w: its four accumulator tiles hold the
// same (row, unit) positions, so the gate update runs in registers and the
// fp32 carries h and c of its 16 rows x 8 units stay in that thread's
// registers for the whole sequence (c never leaves the thread). A producer
// warp streams each step's xw (one TMA box [16 rows][i, f, g, o][the CTA's
// units] of xw seen as [B][T][4][H], zero past B and H; 4-byte cp.async
// where H % 4 != 0) and the group's 16 mask values (cp.async, zero past B)
// into a ring of up to 4 slots on full / empty mbarriers.
constexpr int kFwdRows = 16;     // batch rows a group: the mma's M
constexpr int kFwdMaxWarps = 8;  // unit octets (= consumer warps) a CTA at most
constexpr int kFwdPickOct = 4;   // unit octets a CTA of the cluster the kernel picks
constexpr int kFwdMaxSlots = 4;  // ring slots: steps t .. t + 3 (fewer where they do not fit)
constexpr int kMaskFloats = 32;  // a slot's mask: 16 rows, padded to 128 bytes

// The shared-memory layout of one CTA of the forward for width H on a cluster of C.
struct FwdLayout {
  int O;    // unit octets, ceil(H / 8)
  int ocp;  // octets a CTA at most, ceil(O / C): its consumer warps
  int Hk;   // H rounded up to 16: the product's K
  int ldb;  // bf16 row stride of the wh slice [Hk][32 ocp] (+ 8: conflict-free ldmatrix)
  int lda;  // bf16 row stride of the h buffers [2][16][Hk] (+ 8)
  int xu;   // units of a slot's gate block: the CTA's 8 ocp (+ 4, for the banks)
  int xs;   // fp32 row stride of a slot's xw [16][i | f | g | o][xu]: 4 xu
  int slot;  // fp32 a slot: xw, then the mask
  int slots;
  int a_off, x_off, bar_off, bytes;
};

__host__ __device__ inline FwdLayout fwd_layout(int H, int C) {
  FwdLayout L;
  L.O = (H + 7) / 8;
  L.ocp = (L.O + C - 1) / C;
  L.Hk = (H + 15) / 16 * 16;
  L.ldb = 32 * L.ocp + 8;
  L.lda = L.Hk + 8;
  L.xu = 8 * L.ocp + 4;
  L.xs = 4 * L.xu;
  L.slot = kFwdRows * L.xs + kMaskFloats;  // a multiple of 32 floats: 128-byte slots
  L.a_off = L.Hk * L.ldb * 2;                                         // wh slice [Hk][ldb] bf16 at 0
  L.x_off = (L.a_off + 2 * kFwdRows * L.lda * 2 + 127) / 128 * 128;   // h buffers [2][16][lda] bf16
  for (L.slots = kFwdMaxSlots; L.slots > 2; --L.slots) {
    if (L.x_off + L.slots * L.slot * 4 + (2 + 2 * kFwdMaxSlots) * 8 <= kMaxSmem) break;
  }
  L.bar_off = L.x_off + L.slots * L.slot * 4;
  L.bytes = L.bar_off + (2 + 2 * kFwdMaxSlots) * 8;  // mbarriers: h buffers, ring full, ring empty
  return L;
}

bool fwd_fits(int H, int C) {
  if (H <= 0) return false;
  const FwdLayout L = fwd_layout(H, C);
  return C <= L.O && L.ocp <= kFwdMaxWarps && L.bytes <= kMaxSmem;
}

// The cluster: the smallest of 1, 2, 4, 8, 16 that fits with at most
// kFwdPickOct octets a CTA, else the smallest that fits; 0 when none does.
int fwd_pick(int H) {
  int fit = 0;
  for (int c = 1; c <= 16; c *= 2) {
    if (!fwd_fits(H, c)) continue;
    if (fit == 0) fit = c;
    if (fwd_layout(H, c).ocp <= kFwdPickOct) return c;
  }
  return fit;
}

// One cluster of C CTAs a group of 16 rows; blockDim = 32 (ocp + 1): warps
// 0 .. ocp-1 own the CTA's octets (consumers), warp ocp is the producer.
// kRegK > 0: wh's fragments sit in registers (Hk <= 16 kRegK), else each
// step loads them from the shared slice. kVec: H % 4 == 0, so xw moves by one
// TMA copy a step (xmap: xw as [B][T][4][H]), else by 4-byte cp.async.
template <int kRegK, bool kVec>
__global__ void __launch_bounds__(32 * (kFwdMaxWarps + 1))
    lstm_fwd_kernel(const __grid_constant__ CUtensorMap xmap, const float* __restrict__ xw,
                    const float* __restrict__ mask, const bf16* __restrict__ wh, float* __restrict__ hs,
                    float* __restrict__ cs, int B, int T, int H, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  const FwdLayout L = fwd_layout(H, C);
  const int Hk = L.Hk, KS = Hk / 16, H4 = 4 * H, ocp = L.ocp;
  const int p = C > 1 ? static_cast<int>(cta_rank()) : 0;
  const int grp = blockIdx.x / C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const int ob = p * L.O / C, n_oct = (p + 1) * L.O / C - ob;
  const bool owner = warp < n_oct;    // warp-uniform: this warp owns octet ob + warp
  const bool producer = warp == ocp;  // warp-uniform: this warp moves xw and the mask in
  bf16* slice = reinterpret_cast<bf16*>(smem);
  float* xring = reinterpret_cast<float*>(smem + L.x_off);
  uint64_t* hbar = reinterpret_cast<uint64_t*>(smem + L.bar_off);  // [2]: bf16(h) of the cluster arrived in buffer b
  uint64_t* full = hbar + 2;                                         // [slots]: a step's xw and mask landed in slot s
  uint64_t* empty = full + kFwdMaxSlots;                             // [slots]: slot s read by every owner warp
  const int S = L.slots;
  const uint32_t slice_a = shared_addr(slice), abuf_a = shared_addr(smem + L.a_off), hbar_a = shared_addr(hbar);

  // The wh slice: local column lc = 32 lo + 8 gate + u is column
  // gate * H + 8 (ob + lo) + u of wh, zero past H and past the CTA's octets;
  // the h buffers (h0 = 0; K's padding stays zero) and the ring (rows past
  // B and units past H stay zero) zero.
  if (H % 8 == 0) {  // a gate's octet is 16 aligned bytes of a wh row
    for (int i = threadIdx.x; i < Hk * 4 * ocp; i += blockDim.x) {
      const int k = i / (4 * ocp), lo = (i % (4 * ocp)) / 4, q = i % 4;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (k < H && lo < n_oct) v = *reinterpret_cast<const uint4*>(wh + (size_t)k * H4 + q * H + 8 * (ob + lo));
      *reinterpret_cast<uint4*>(slice + k * L.ldb + 32 * lo + 8 * q) = v;
    }
  } else {
    for (int i = threadIdx.x; i < Hk * 32 * ocp; i += blockDim.x) {
      const int k = i / (32 * ocp), lc = i % (32 * ocp);
      const int lo = lc / 32, j = 8 * (ob + lo) + lc % 8;
      const bool ok = k < H && lo < n_oct && j < H;
      slice[k * L.ldb + lc] = ok ? wh[(size_t)k * H4 + ((lc % 32) / 8) * H + j] : __float2bfloat16(0.f);
    }
  }
  for (int i = threadIdx.x; i < (L.bar_off - L.a_off) / 16; i += blockDim.x) {
    reinterpret_cast<uint4*>(smem + L.a_off)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  // The bytes of bf16(h) a step brings to each CTA: every octet's 16 x 8.
  const uint32_t h_bytes = L.O * kFwdRows * 8 * 2;
  if (threadIdx.x == 0) {
    mbar_init(&hbar[0], 1);
    mbar_init(&hbar[1], 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], kVec ? 33 : 32);  // every producer lane's cp.async, and the TMA's bytes
      mbar_init(&empty[s], n_oct);
    }
    mbar_init_fence();
    // h(0) lands in buffer 1, h(1) in buffer 0 (h(T - 1) is never sent).
    if (T > 1) mbar_arrive_expect_tx(&hbar[1], h_bytes);
    if (T > 2) mbar_arrive_expect_tx(&hbar[0], h_bytes);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the zeros before any bulk copy
  __syncthreads();

  float h[2][2] = {{0.f, 0.f}, {0.f, 0.f}}, c[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  // Every CTA of the cluster runs, its barriers armed, before the first remote store.
  if (C > 1) {
    cluster_arrive();
    cluster_wait();
  }

  if (producer) {
    // Step t's xw (the group's rows, the CTA's units) and mask into ring
    // slot t % S, S - 1 steps ahead of the owners, once they have read the
    // slot's last step.
    const int nu = min(8 * n_oct, H - 8 * ob), u0 = 8 * ob;  // the CTA's units [u0, u0 + nu) below H
    const int rows = min(kFwdRows, B - grp * kFwdRows);
    for (int t = 0; t < T; ++t) {
      const int s = t % S;
      if (t >= S) mbar_wait(&empty[s], (t / S - 1) & 1);
      float* slot = xring + s * L.slot;
      if constexpr (kVec) {
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[s], kFwdRows * L.xs * 4);
          tma_load_4d(slot, &xmap, u0, 0, t, grp * kFwdRows, &full[s]);
        }
      } else {
        for (int e = lane; e < 4 * rows * nu; e += 32) {
          const int r = e / (4 * nu), q = (e / nu) % 4, u = e % nu;
          cp_async4(slot + r * L.xs + q * L.xu + u, xw + ((size_t)(grp * kFwdRows + r) * T + t) * H4 + q * H + u0 + u,
                    true);
        }
      }
      if (lane < kFwdRows) {
        cp_async4(slot + kFwdRows * L.xs + lane, mask + (lane < rows ? (size_t)(grp * kFwdRows + lane) * T + t : 0),
                  lane < rows);
      }
      cp_async_arrive(&full[s]);
    }
  } else if (owner) {
    // B fragments of the warp's i, f, g, o n-tiles at k-step kb.
    auto load_b = [&](uint32_t (&b)[4][2], int kb) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        ldsm_x2_trans(b[q][0], b[q][1], slice_a + ((kb * 16 + lane % 16) * L.ldb + warp * 32 + q * 8) * 2);
      }
    };
    uint32_t breg[kRegK > 0 ? kRegK : 1][4][2];
    if constexpr (kRegK > 0) {
#pragma unroll
      for (int kb = 0; kb < kRegK; ++kb) {
        if (kb < KS) load_b(breg[kb], kb);
      }
    }
    const int j0 = 8 * (ob + warp) + 2 * tq;
    bool ok[2][2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) ok[rr][ii] = grp * kFwdRows + g + 8 * rr < B && j0 + ii < H;
    }
    // fp32 h and c of step t out to hs and cs at the thread's pairs.
    auto store = [&](float* out, const float (&v)[2][2], int t) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float* dst = out + ((size_t)(grp * kFwdRows + g + 8 * rr) * T + t) * H + j0;
        if (ok[rr][1] && H % 2 == 0) {
          *reinterpret_cast<float2*>(dst) = make_float2(v[rr][0], v[rr][1]);
        } else {
          if (ok[rr][0]) dst[0] = v[rr][0];
          if (ok[rr][1]) dst[1] = v[rr][1];
        }
      }
    };
    for (int t = 0; t < T; ++t) {
      // Step t's xw at the thread's pairs (rows g (+ 8), units 2 tq (+ 1) of
      // its octet) and its rows' mask.
      const int s = t % S;
      mbar_wait(&full[s], (t / S) & 1);
      const float* slot = xring + s * L.slot;
      const float* xr = slot + g * L.xs + 8 * warp + 2 * tq;
      float2 x[2][4];
      float m[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
        for (int q = 0; q < 4; ++q) x[rr][q] = *reinterpret_cast<const float2*>(xr + rr * 8 * L.xs + q * L.xu);
        m[rr] = slot[kFwdRows * L.xs + g + 8 * rr];
      }
      // The slot's reads ordered before the producer's next bulk write into it.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      // h(t - 1) of the whole cluster in buffer t & 1 (zero at t = 0); then
      // the next phase of its barrier is armed for h(t + 1).
      if (t > 0) {
        mbar_wait(&hbar[t & 1], ((t - 1) >> 1) & 1);
        if (threadIdx.x == 0 && t + 1 < T - 1) mbar_arrive_expect_tx(&hbar[t & 1], h_bytes);
      }
      // bf16(h) @ wh: two mma chains a gate (even and odd k-steps), added at
      // the end, the next k-step's A fragment loaded ahead.
      float acc[2][4][4];
#pragma unroll
      for (int ch = 0; ch < 2; ++ch) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[ch][q][0] = acc[ch][q][1] = acc[ch][q][2] = acc[ch][q][3] = 0.f;
      }
      const uint32_t a_cur = abuf_a + (t & 1) * kFwdRows * L.lda * 2;
      uint32_t a[2][4];
      load_a_frag<kFwdRows>(a[0], a_cur, L.lda, 0, lane);
      if constexpr (kRegK > 0) {
#pragma unroll
        for (int kb = 0; kb < kRegK; ++kb) {
          if (kb < KS) {
            if (kb + 1 < KS) load_a_frag<kFwdRows>(a[(kb + 1) & 1], a_cur, L.lda, (kb + 1) * 16, lane);
#pragma unroll
            for (int q = 0; q < 4; ++q) mma_bf16(acc[kb & 1][q], a[kb & 1], breg[kb][q][0], breg[kb][q][1]);
          }
        }
      } else {
        uint32_t b[2][4][2];
        load_b(b[0], 0);
        for (int kb = 0; kb < KS; kb += 2) {  // two k-steps a turn, so the fragments' registers stay named
          const bool two = kb + 1 < KS;
          if (two) {
            load_a_frag<kFwdRows>(a[1], a_cur, L.lda, (kb + 1) * 16, lane);
            load_b(b[1], kb + 1);
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) mma_bf16(acc[0][q], a[0], b[0][q][0], b[0][q][1]);
          if (kb + 2 < KS) {
            load_a_frag<kFwdRows>(a[0], a_cur, L.lda, (kb + 2) * 16, lane);
            load_b(b[0], kb + 2);
          }
          if (two) {
#pragma unroll
            for (int q = 0; q < 4; ++q) mma_bf16(acc[1][q], a[1], b[1][q][0], b[1][q][1]);
          }
        }
      }
      // The gate update in registers: accumulator element 2 rr + ii is (row
      // g + 8 rr, unit j0 + ii); the blend with the row's mask (a padded
      // step, m = 0, keeps both carries exactly: the gates are finite); then
      // bf16(h) into every CTA's next buffer (not after the last step) and
      // fp32 h and c out.
      const uint32_t a_next = abuf_a + ((t + 1) & 1) * kFwdRows * L.lda * 2, bar_next = hbar_a + ((t + 1) & 1) * 8;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const int ci = 2 * rr + ii;
          float pre[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) pre[q] = (ii ? x[rr][q].y : x[rr][q].x) + (acc[0][q][ci] + acc[1][q][ci]);
          const float ig = sigmoid_fast(pre[0]), fg = sigmoid_fast(pre[1]), gg = tanh_fast(pre[2]);
          const float og = sigmoid_fast(pre[3]);
          const float c_raw = fg * c[rr][ii] + ig * gg;
          const float h_raw = og * tanh_fast(c_raw);
          c[rr][ii] = m[rr] * c_raw + (1.0f - m[rr]) * c[rr][ii];
          h[rr][ii] = m[rr] * h_raw + (1.0f - m[rr]) * h[rr][ii];
        }
        if (t + 1 < T) {
          const uint32_t v = pack_bf16(h[rr][0], h[rr][1]);
          const uint32_t at = a_next + ((g + 8 * rr) * L.lda + j0) * 2;
          for (int q = 0; q < C; ++q) st_async_u32(at, bar_next, q, v);
        }
      }
      store(hs, h, t);
      store(cs, c, t);
    }
  }
  // No CTA leaves while another may still store into its shared memory.
  if (C > 1) {
    cluster_arrive();
    cluster_wait();
  }
}

template <int kRegK, bool kVec>
cudaError_t launch_fwd(const void* xw, const void* mask, const void* wh, void* hs, void* cs, int B, int T, int H,
                       int C, int device, cudaStream_t s) {
  const FwdLayout L = fwd_layout(H, C);
  auto kernel = lstm_fwd_kernel<kRegK, kVec>;
  // Once an instantiation and device: the largest shared-memory opt-in, clusters of 16.
  static uint64_t attributes_set = 0;
  if (device >= 64 || !(attributes_set >> device & 1)) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e == cudaSuccess) e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    if (device < 64) attributes_set |= uint64_t{1} << device;
  }
  CUtensorMap xmap = {};
  if (kVec) {
    // xw as [B][T][4][H] fp32; a box is [16][1][4][xu], zero past B and H.
    cuuint64_t dims[4] = {static_cast<cuuint64_t>(H), 4, static_cast<cuuint64_t>(T), static_cast<cuuint64_t>(B)};
    cuuint64_t strides[3] = {static_cast<cuuint64_t>(H) * 4, static_cast<cuuint64_t>(H) * 16,
                             static_cast<cuuint64_t>(H) * 16 * T};
    cuuint32_t box[4] = {static_cast<cuuint32_t>(L.xu), 4, 1, kFwdRows};
    cuuint32_t elem[4] = {1, 1, 1, 1};
    if (cuTensorMapEncodeTiled(&xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(xw), dims, strides, box,
                               elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                               CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
      return cudaErrorInvalidValue;
    }
  }
  const int groups = (B + kFwdRows - 1) / kFwdRows;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(groups * C);
  cfg.blockDim = dim3(32 * (L.ocp + 1));
  cfg.dynamicSmemBytes = L.bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, xmap, static_cast<const float*>(xw), static_cast<const float*>(mask),
                                     static_cast<const bf16*>(wh), static_cast<float*>(hs), static_cast<float*>(cs), B,
                                     T, H, C);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
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


// ---------------------------------------------------------------- past the cluster: the grid
//
// lstm_fwd_grid_kernel, for the widths no cluster takes (grid_carry.cuh has
// the grid, the barrier and the fragment loads; gru_fwd.cu's
// gru_fwd_grid_kernel is the same design with three gate blocks). CTA (r, u)
// of the R x U grid keeps the i, f, g and o columns of wh for its unit
// octets, [Hk][32 ocp + 8] bf16 with the k-steps' rows permuted (kperm), in
// shared memory. A step: wait on the row group's barrier for h(t - 1); per
// task (a 16-row tile, up to kTaskOct octets), bf16(h(t - 1)) @ wh on
// mma.sync m16n8k16, A straight from the L2-resident buffer hbuf[(t - 1) &
// 1] (zero rows past B and zero columns past H: the wrapper zeroes it, and
// no CTA writes there), kLstmGridPf k-steps of fragments loaded ahead; the
// forward's gate update above (sigmoid_fast, tanh_fast, c_raw = f c + i g,
// h_raw = o tanh(c_raw)) and the blend of both carries with the row's mask,
// the fp32 h(t - 1) and c(t - 1) read back from hs and cs (this thread wrote
// them); fp32 h and c out to hs and cs, bf16(h) to hbuf[t & 1]; then
// arrive. A padded step (m = 0) passes both carries through exactly: the
// gates are finite. No atomics in any sum: a second launch gives the same
// bits.
constexpr int kLstmGridPf = 2;  // k-steps of A fragments loaded ahead

__global__ void __launch_bounds__(32 * kGridWarps, 1)
    lstm_fwd_grid_kernel(const float* __restrict__ xw, const float* __restrict__ mask, const bf16* __restrict__ wh,
                         float* __restrict__ hs, float* __restrict__ cs, bf16* __restrict__ hbuf,
                         int* __restrict__ ctr, int B, int T, int H, GridShape S) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int O = (H + 7) / 8, Hk = (H + 15) / 16 * 16, KS = Hk / 16, H4 = 4 * H, ldb = 32 * S.ocp + 8;
  const int u = blockIdx.x % S.U, grp = blockIdx.x / S.U;
  const int ob = u * O / S.U, n_oct = (u + 1) * O / S.U - ob;
  const int row0 = grp * S.rows, n_rt = (min(S.rows, B - row0) + 15) / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const size_t buf = (size_t)S.R * S.rows * Hk;  // one parity of hbuf [2][R rows][Hk]
  int* my_ctr = ctr + grp * kCtrStride;
  int ng, gs;
  grid_tasks(n_rt, n_oct, ng, gs);

  // The wh slice: physical row p of a k-step holds wh row k = kperm(p)
  // (zero past H); local column 32 lo + 8 gate + u is column gate * H +
  // 8 (ob + lo) + u (zero past H and past the CTA's octets).
  bf16* slice = reinterpret_cast<bf16*>(smem);
  if (H % 8 == 0) {
    for (int i = threadIdx.x; i < Hk * 4 * S.ocp; i += blockDim.x) {
      const int p = i / (4 * S.ocp), lo = (i % (4 * S.ocp)) / 4, q = i % 4, k = (p & ~15) + kperm(p & 15);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (k < H && lo < n_oct) v = *reinterpret_cast<const uint4*>(wh + (size_t)k * H4 + q * H + 8 * (ob + lo));
      *reinterpret_cast<uint4*>(slice + p * ldb + 32 * lo + 8 * q) = v;
    }
  } else {
    for (int i = threadIdx.x; i < Hk * 32 * S.ocp; i += blockDim.x) {
      const int p = i / (32 * S.ocp), lc = i % (32 * S.ocp), k = (p & ~15) + kperm(p & 15);
      const int lo = lc / 32, j = 8 * (ob + lo) + lc % 8;
      const bool ok = k < H && lo < n_oct && j < H;
      slice[p * ldb + lc] = ok ? wh[(size_t)k * H4 + ((lc % 32) / 8) * H + j] : __float2bfloat16(0.f);
    }
  }
  __syncthreads();
  const uint32_t slice_a = shared_addr(slice);

  for (int t = 0; t < T; ++t) {
    if (t > 0) group_wait(my_ctr, S.U * t);  // every CTA of the group has written h(t - 1)
    const bf16* hb = hbuf + ((t - 1) & 1) * buf;
    bf16* hn = hbuf + (t & 1) * buf;
    for (int task = warp; task < n_rt * ng; task += kGridWarps) {
      const int r0 = row0 + 16 * (task / ng), lo0 = (task % ng) * gs, no = min(gs, n_oct - lo0);
      // This thread's pairs: rows r0 + g (+ 8), units 8 (ob + lo0 + lo) + 2 tq (+ 1); xw of step t, the fp32
      // carries of step t - 1 there and the rows' mask, loaded ahead of the product.
      float x[kTaskOct][2][2][4], hp[kTaskOct][2][2], cp[kTaskOct][2][2], m[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int b = r0 + g + 8 * rr;
        m[rr] = b < B ? mask[(size_t)b * T + t] : 0.f;
      }
#pragma unroll
      for (int lo = 0; lo < kTaskOct; ++lo) {
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
          for (int ii = 0; ii < 2; ++ii) {
            const int b = r0 + g + 8 * rr, j = 8 * (ob + lo0 + lo) + 2 * tq + ii;
            const bool ok = lo < no && b < B && j < H;
            const size_t xo = ((size_t)b * T + t) * H4 + j, co = ((size_t)b * T + t - 1) * H + j;
#pragma unroll
            for (int q = 0; q < 4; ++q) x[lo][rr][ii][q] = ok ? xw[xo + q * H] : 0.f;
            hp[lo][rr][ii] = ok && t > 0 ? hs[co] : 0.f;
            cp[lo][rr][ii] = ok && t > 0 ? cs[co] : 0.f;
          }
        }
      }
      float acc[kTaskOct][4][4];
#pragma unroll
      for (int lo = 0; lo < kTaskOct; ++lo) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[lo][q][0] = acc[lo][q][1] = acc[lo][q][2] = acc[lo][q][3] = 0.f;
      }
      if (t > 0) {  // h(-1) = 0
        const bf16* ra = hb + (size_t)(r0 + g) * Hk + 4 * tq;
        grid_fwd_product<4, kLstmGridPf>(acc, ra, ra + 8 * Hk, KS, slice_a, ldb, lo0, no, lane);
      }
      // The gate update: accumulator element 2 rr + ii is (row g + 8 rr, unit 2 tq + ii).
#pragma unroll
      for (int lo = 0; lo < kTaskOct; ++lo) {
        if (lo >= no) break;
        const int j0 = 8 * (ob + lo0 + lo) + 2 * tq;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int b = r0 + g + 8 * rr;
          float h[2], c[2];
#pragma unroll
          for (int ii = 0; ii < 2; ++ii) {
            const int ci = 2 * rr + ii;
            const float* xv = x[lo][rr][ii];
            const float ig = sigmoid_fast(xv[0] + acc[lo][0][ci]), fg = sigmoid_fast(xv[1] + acc[lo][1][ci]);
            const float gg = tanh_fast(xv[2] + acc[lo][2][ci]), og = sigmoid_fast(xv[3] + acc[lo][3][ci]);
            const float c_raw = fg * cp[lo][rr][ii] + ig * gg;
            const float h_raw = og * tanh_fast(c_raw);
            c[ii] = m[rr] * c_raw + (1.0f - m[rr]) * cp[lo][rr][ii];
            h[ii] = m[rr] * h_raw + (1.0f - m[rr]) * hp[lo][rr][ii];
          }
          if (b >= B || j0 >= H) continue;
          const size_t o = ((size_t)b * T + t) * H + j0;
          bf16* hd = hn + (size_t)b * Hk + j0;
          hs[o] = h[0];
          cs[o] = c[0];
          if (j0 + 1 < H) {
            hs[o + 1] = h[1];
            cs[o + 1] = c[1];
            if (t + 1 < T) *reinterpret_cast<uint32_t*>(hd) = pack_bf16(h[0], h[1]);
          } else if (t + 1 < T) {
            hd[0] = __float2bfloat16(h[0]);
          }
        }
      }
    }
    if (t + 1 < T) group_arrive(my_ctr);
  }
}

// lstm_bwd_grid_carry_kernel, pass 2 of the backward past the clusters'
// widths (csrc/gru_bwd.cu's gru_bwd_grid_carry_kernel with four gate blocks,
// a second carry, and dxw written by the carry, as lstm_bwd_carry_kernel
// writes it). CTA (r, u) owns the output units of its octets: it keeps wh's
// rows of those units, [8 ocp][Kp + 8] bf16 (every column c < 4H, the
// k-steps' columns permuted by kperm), in shared memory, so that
// dxw[t] @ wh^T at its units is one product over all 4H columns: no partial
// sums cross a CTA. Step t = T-1 .. 0 of the row group:
// - each task's pairs, from the coefficients of pass 1 (kappa, f in coef;
//   iota, phi, gamma, omega in dxw) and the carries dh, dc of the step
//   after: d = dh + dhs[t], dh_raw = d m, dc_raw = dc m + dh_raw kappa,
//   dxw[t] = [dc_raw iota, dc_raw phi, dc_raw gamma, dh_raw omega] (over its
//   coefficients; exactly 0 where m = 0), dc = dc (1 - m) + dc_raw f and
//   d (1 - m) into the thread's slots of `carry` [2][B][H] (dh, dc: only
//   this thread reads them), and dxw[t]'s three exact bf16 terms (split3)
//   to the L2-resident buffer dt[t & 1] [3][R rows][Kp] at columns
//   gate * H + unit;
// - the group's barrier (not at t = 0: dh(-1) feeds nothing);
// - per task, the three terms' products with the CTA's slice, each into its
//   own fp32 accumulator (A straight from L2, kGridBwdPf k-steps ahead),
//   summed smallest first: s; dh = d (1 - m) + s.
// No atomics in any sum: the same bits every run.

__global__ void __launch_bounds__(32 * kGridWarps, 1)
    lstm_bwd_grid_carry_kernel(const bf16* __restrict__ wh, const float* __restrict__ dhs,
                               const float* __restrict__ mask, float* __restrict__ dxw, const float* __restrict__ coef,
                               float* __restrict__ carry, bf16* __restrict__ dt, int* __restrict__ ctr, int B, int T,
                               int H, GridShape S) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int O = (H + 7) / 8, H4 = 4 * H, Kp = (H4 + 15) / 16 * 16, ldk = Kp + 8;
  const int u = blockIdx.x % S.U, grp = blockIdx.x / S.U;
  const int ob = u * O / S.U, n_oct = (u + 1) * O / S.U - ob;
  const int row0 = grp * S.rows, n_rt = (min(S.rows, B - row0) + 15) / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const size_t term = (size_t)S.R * S.rows * Kp;  // one term of one parity of dt [2][3][R rows][Kp]
  int* my_ctr = ctr + grp * kCtrStride;
  float* dh_c = carry;                   // [B][H]: d (1 - m) of the step, then dh into the step before
  float* dc_c = carry + (size_t)B * H;  // [B][H]: dc into the step before
  int ng, gs;
  grid_tasks(n_rt, n_oct, ng, gs);

  // The slice: local unit lu's row holds wh[8 ob + lu][c] at physical column
  // p, c = kperm of p within its k-step (zero past 4H, past H and past the
  // CTA's octets).
  bf16* slice = reinterpret_cast<bf16*>(smem);
  for (int i = threadIdx.x; i < 8 * S.ocp * Kp; i += blockDim.x) {
    const int lu = i / Kp, p = i % Kp, c = (p & ~15) + kperm(p & 15), j = 8 * ob + lu;
    const bool ok = lu < 8 * n_oct && j < H && c < H4;
    slice[lu * ldk + p] = ok ? wh[(size_t)j * H4 + c] : __float2bfloat16(0.f);
  }
  __syncthreads();
  const uint32_t slice_a = shared_addr(slice);

  for (int t = T - 1; t >= 0; --t) {
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
          const size_t row = (size_t)b * T + t;
          const float m = mask[row];
          float x[4][2];
#pragma unroll
          for (int ii = 0; ii < 2; ++ii) {
            const int j = j0 + ii;
            x[0][ii] = x[1][ii] = x[2][ii] = x[3][ii] = 0.f;
            if (j >= H) continue;
            const size_t o = row * H4 + j, oc = row * 2 * H + j, oh = (size_t)b * H + j;
            const float dh = t == T - 1 ? 0.f : dh_c[oh], dc = t == T - 1 ? 0.f : dc_c[oh];
            const float d = dh + dhs[row * H + j];
            const float dh_raw = d * m;
            const float dc_raw = dc * m + dh_raw * coef[oc];
            x[0][ii] = dc_raw * dxw[o];
            x[1][ii] = dc_raw * dxw[o + H];
            x[2][ii] = dc_raw * dxw[o + 2 * H];
            x[3][ii] = dh_raw * dxw[o + 3 * H];
#pragma unroll
            for (int q = 0; q < 4; ++q) dxw[o + q * H] = x[q][ii];
            dc_c[oh] = dc * (1.0f - m) + dc_raw * coef[oc + H];
            dh_c[oh] = d * (1.0f - m);
          }
          if (t == 0) continue;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            __nv_bfloat162 terms[3];
            split3(x[q][0], x[q][1], terms);
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
    if (t == 0) break;
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
      // dh = d (1 - m) + s, the smallest term first.
#pragma unroll
      for (int lo = 0; lo < kTaskOct; ++lo) {
        if (lo >= no) break;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
          for (int ii = 0; ii < 2; ++ii) {
            const int b = r0 + g + 8 * rr, j = 8 * (ob + lo0 + lo) + 2 * tq + ii, ci = 2 * rr + ii;
            if (b >= B || j >= H) continue;
            const float s = (acc[2][lo][ci] + acc[1][lo][ci]) + acc[0][lo][ci];
            dh_c[(size_t)b * H + j] += s;
          }
        }
      }
    }
  }
}

// The backward's passes around `carry`, which launches pass 2 on `s`: the
// gates (pass 1) before it, dwh over the final dxw (pass 3) after it.
template <class Carry>
cudaError_t run_passes(const void* xw, const void* wh, const void* hs, const void* cs, void* dxw, void* coef,
                       void* dwh_partial, void* dwh, int B, int T, int H, cudaStream_t s, Carry carry) {
  const int BT = B * T;
  const dim3 gates_grid((BT + kGateRows - 1) / kGateRows, ((H + 7) / 8 + kGateOct - 1) / kGateOct);
  auto gates = H % 8 == 0 ? lstm_bwd_gates_kernel<true> : lstm_bwd_gates_kernel<false>;
  gates<<<gates_grid, kGateThreads, 0, s>>>(static_cast<const float*>(xw), static_cast<const bf16*>(wh),
                                            static_cast<const float*>(hs), static_cast<const float*>(cs),
                                            static_cast<float*>(dxw), static_cast<float*>(coef), BT, T, H);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = carry();
  if (e != cudaSuccess) return e;
  return recurrent_dw::launch(static_cast<const float*>(hs), static_cast<const float*>(dxw),
                              static_cast<float*>(dwh_partial), static_cast<float*>(dwh), B, T, H, 4 * H, s);
}

// The widest H up to which the cluster kernels take every width: the
// forward on some cluster, and the backward's carry on some cluster (512:
// past it neither fits its wh slice in a CTA's shared memory).
int cluster_max_hidden() {
  static int limit = -1;
  if (limit < 0) {
    int H = 0;
    while (H < 4096 && fwd_pick(H + 1) > 0 && pick_cluster(1, H + 1, 4, kStage) > 0) ++H;
    limit = H;
  }
  return limit;
}

}  // namespace

// The largest H up to which the pair takes every width: the cluster kernels
// up to cluster_max_hidden() (512), the grid-resident ones past it, both
// directions (1600: past it the forward's slice of two octets no longer
// fits a CTA, and one octet a CTA needs more CTAs than the card has SMs).
extern "C" int lstm_max_hidden() {
  static int limit = -1;
  if (limit < 0) {
    int H = cluster_max_hidden();
    while (H < 8192 && grid_shape(1, H + 1, false, 4).ocp > 0 && grid_shape(1, H + 1, true, 4).ocp > 0) ++H;
    limit = H;
  }
  return limit;
}

// The grid the grid-resident kernels run a batch of B rows of width H on
// (the forward's, bwd = 0, or the backward carry's): out[0..3] = octets a
// CTA, unit slices, row groups, rows a group. Returns 0 (out untouched)
// where no grid takes H.
extern "C" int lstm_grid_shape(int B, int H, int bwd, int* out) {
  const GridShape s = grid_shape(B, H, bwd != 0, 4);
  if (s.ocp == 0) return 0;
  out[0] = s.ocp;
  out[1] = s.U;
  out[2] = s.R;
  out[3] = s.rows;
  return 1;
}

// Number of partial dwh sums the wrapper allocates ([splits, H, 4H] fp32).
extern "C" int lstm_bwd_splits(int B, int T, int H) { return recurrent_dw::num_splits(B * T, H, 4 * H); }

// The forward's cluster size for width H (1, 2, 4, 8 or 16), or 0 past the
// cluster kernels' widths.
extern "C" int lstm_fwd_cluster_size(int H) { return H <= cluster_max_hidden() ? fwd_pick(H) : 0; }

// Whether a cluster of C blocks a row group takes width H in the forward.
extern "C" int lstm_fwd_fits(int H, int C) { return fwd_fits(H, C) ? 1 : 0; }

// cluster: 0 runs the kernel's own pick (the wrapper's); 1, 2, 4, 8 or 16
// forces that cluster size where it fits, else cudaErrorInvalidValue
// (chip_smoke.py times each to measure the pick).
extern "C" int lstm_fwd(const void* xw, const void* mask, const void* wh, void* hs, void* cs, int B, int T, int H,
                        int cluster, int device, void* stream) {
  const int c = cluster > 0 ? cluster : fwd_pick(H);
  if (H > cluster_max_hidden() || c == 0 || (c & (c - 1)) != 0 || c > 16 || !fwd_fits(H, c)) {
    return cudaErrorInvalidValue;
  }
  if (B <= 0 || T <= 0) return cudaSuccess;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // wh in registers up to Hk = 128 (8 k-steps), from shared memory above.
  if (H % 4 == 0) {
    if (H <= 128) return launch_fwd<8, true>(xw, mask, wh, hs, cs, B, T, H, c, device, s);
    return launch_fwd<0, true>(xw, mask, wh, hs, cs, B, T, H, c, device, s);
  }
  if (H <= 128) return launch_fwd<8, false>(xw, mask, wh, hs, cs, B, T, H, c, device, s);
  return launch_fwd<0, false>(xw, mask, wh, hs, cs, B, T, H, c, device, s);
}

extern "C" int lstm_bwd(const void* xw, const void* mask, const void* wh, const void* hs, const void* cs,
                        const void* dhs, void* dxw, void* coef, void* dwh_partial, void* dwh, int B, int T, int H,
                        int device, void* stream) {
  // The carry's cluster: 1, 2, 4, 8 or 16.
  const int c = H <= cluster_max_hidden() ? pick_cluster(B, H, 4, kStage) : 0;
  if (c == 0 || B <= 0 || T <= 0) return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return run_passes(xw, wh, hs, cs, dxw, coef, dwh_partial, dwh, B, T, H, s, [&]() {
    switch (c) {
      case 1: return launch_carry<1>(wh, dhs, mask, dxw, coef, B, T, H, s);
      case 2: return launch_carry<2>(wh, dhs, mask, dxw, coef, B, T, H, s);
      case 4: return launch_carry<4>(wh, dhs, mask, dxw, coef, B, T, H, s);
      case 8: return launch_carry<8>(wh, dhs, mask, dxw, coef, B, T, H, s);
      default: return launch_carry<16>(wh, dhs, mask, dxw, coef, B, T, H, s);
    }
  });
}

// The forward on the grid (lstm_fwd_grid_kernel), for the widths past the
// clusters'. hbuf: [2][R rows][Hk] bf16 zeros, ctr: R * 32 int32 zeros
// (lstm_grid_shape(B, H, 0)'s R and rows); both the caller's, left dirty.
// cudaErrorInvalidValue where no grid takes H.
extern "C" int lstm_fwd_grid(const void* xw, const void* mask, const void* wh, void* hs, void* cs, void* hbuf,
                             void* ctr, int B, int T, int H, int device, void* stream) {
  const GridShape g = grid_shape(B, H, false, 4);
  if (g.ocp == 0) return cudaErrorInvalidValue;
  if (B <= 0 || T <= 0) return cudaSuccess;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  return launch_grid(lstm_fwd_grid_kernel, g, grid_slice_bytes(H, g.ocp, false, 4), static_cast<cudaStream_t>(stream),
                     static_cast<const float*>(xw), static_cast<const float*>(mask), static_cast<const bf16*>(wh),
                     static_cast<float*>(hs), static_cast<float*>(cs), static_cast<bf16*>(hbuf),
                     static_cast<int*>(ctr), B, T, H, g);
}

// The backward with pass 2 on the grid (lstm_bwd_grid_carry_kernel), for
// the widths past the clusters'. dt: [2][3][R rows][Kp] bf16 zeros (Kp = 4H
// rounded up to 16), ctr: R * 32 int32 zeros (lstm_grid_shape(B, H, 1)'s R
// and rows), carry: [2][B][H] fp32; all the caller's, left dirty.
// cudaErrorInvalidValue where no grid takes H.
extern "C" int lstm_bwd_grid(const void* xw, const void* mask, const void* wh, const void* hs, const void* cs,
                             const void* dhs, void* dxw, void* coef, void* dwh_partial, void* dwh, void* dt, void* ctr,
                             void* carry, int B, int T, int H, int device, void* stream) {
  const GridShape g = grid_shape(B, H, true, 4);
  if (g.ocp == 0 || B <= 0 || T <= 0) return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return run_passes(xw, wh, hs, cs, dxw, coef, dwh_partial, dwh, B, T, H, s, [&]() {
    return launch_grid(lstm_bwd_grid_carry_kernel, g, grid_slice_bytes(H, g.ocp, true, 4), s,
                       static_cast<const bf16*>(wh), static_cast<const float*>(dhs), static_cast<const float*>(mask),
                       static_cast<float*>(dxw), static_cast<const float*>(coef), static_cast<float*>(carry),
                       static_cast<bf16*>(dt), static_cast<int*>(ctr), B, T, H, g);
  });
}
