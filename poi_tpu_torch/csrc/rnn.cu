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
//     dh = dh (1 - m) + dpre @ C^T   (fp32-faithful, see below)
//   dC [H, H] fp32 = sum over b, t of h_prev^T dpre
// No cotangent is rounded to bf16.
//
// What bounds it on this card: the serial chain of T tiny [rows, H] x [H, H]
// products (2H^2 operations a row a step: 33k at H = 128): latency, not
// FLOPs or bytes. What does not depend on the carry is parallel work: the
// backward's recompute of h_raw, a product [B*T, H] x [H, H], and dC.
//
// Forward (B5), rnn_fwd_kernel: the LSTM's first layout with one gate. A
// block owns `rows` = 128 / H whole rows (one at H >= 128), thread (row, j)
// owns unit j, its fp32 h in a register, bf16(h) double-buffered in shared
// memory; bf16 C (2H^2 bytes: 32 KB at H = 128) sits in shared memory, and
// each step is an H-long k-ordered FMA chain and a block barrier. It takes
// H <= rnn_max_hidden() (339: bf16 C in one block); a larger H is refused
// (cudaErrorInvalidValue), and the Python wrapper raises first and names the
// limit.
//
// Backward (B6): csrc/gru_bwd.cu's three-part pattern with one gate block.
// 1. rnn_bwd_coef_kernel: h_raw = tanh(xin + bf16(h_prev) @ C) of every
//    step at once on the tensor cores (mma.sync m16n8k16: exact bf16
//    products, fp32 sums, in the tensor cores' order, so h_raw matches the
//    forward's k-ordered chain to fp32 rounding, not bit for bit), and from
//    it the coefficient a = m (1 - h_raw^2), which depends on the forward
//    alone, written into dxin.
// 2. rnn_bwd_carry_kernel<kRegK, R>, the serial chain. A cluster of C CTAs
//    owns a group of 8 batch rows where the groups' clusters fit on the
//    card at once, else 16 (the mma's M; a group of 8 leaves the fragment's
//    upper rows zero; rows past B run on zeros and store nothing): the
//    exchange below moves 6 bytes a row and unit into every SM each step
//    and sets the step's pace. CTA p owns unit octets [p*O/C, (p+1)*O/C) of
//    O = ceil(H/8), a consumer warp each, and each warp holds the rows of C
//    of its 8 units as mma B fragments in registers (the columns of C^T:
//    2 Hk/16 registers, 44 at H = 339). Per step t = T-1 .. 0, at the
//    thread's (row, unit) pairs:
//    - dh = d(t+1) (1 - m(t+1)) + dpre(t+1) @ C^T, where dpre(t+1) of the
//      whole group arrived in this CTA's shared memory as three exact bf16
//      terms (cluster_carry.cuh's split3), each term's product on mma.sync
//      into its own fp32 accumulators (two chains, even and odd k-steps, the
//      next k-step's fragments loaded ahead), the three summed smallest
//      first: the TPU kernel's fp32 cotangent at Precision.HIGHEST;
//    - d = dh + dhs[t], dpre = d a[t], dxin[t] = dpre (over a);
//    - dpre's three terms into every CTA of the cluster by 16-byte st.async,
//      counted on that CTA's mbarrier, double-buffered by step parity: no
//      barrier in the step (B1's and B3's exchange). A CTA can only
//      overwrite a buffer after every warp of every CTA has read it: each
//      warp sends step t's terms after its product of step t+1, and a warp
//      writes step t's terms only once every warp's step t+1 terms have
//      arrived.
//    The thread's a, dhs and mask are prefetched two steps ahead by cp.async
//    into private slots of a three-slot ring (B4's carry). Padded steps
//    (a = 0) give dpre = 0 exactly, and products of zero terms add +0, so
//    the carry passes d through unchanged.
//    C: the smallest of 1, 2, 4, 8 whose CTAs hold at most 2 octets each
//    (else 8): 4 at H = 64, 8 at H = 100, 128 and 339. chip_smoke.py's
//    `rnn_bwd cluster choice` times every
//    size that fits (the C entry takes the cluster to force, the wrapper
//    passes 0). A warp's arithmetic depends neither on C nor on the group's
//    rows, so every cluster gives the same bits. A ragged H zero-pads the
//    last octet and K.
// 3. dC: recurrent_dw::launch over the final dxin (fp32 on the CUDA cores,
//    csrc/recurrent_dwh.cuh, as B2's and B4's dwh).
// No atomics: a second launch gives the same bits.
//
// The entry points launch on the given stream, do not synchronise and
// allocate nothing; they return cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_carry.cuh"
#include "recurrent_dwh.cuh"

namespace {

int rows_per_block(int H) { return H >= 128 ? 1 : 128 / H; }

int fwd_smem_bytes(int H) { return 2 * H * H + 2 * rows_per_block(H) * H * 2; }  // C + double-buffered bf16(h)

bool fwd_takes(int H) { return H > 0 && rows_per_block(H) * H <= 1024 && fwd_smem_bytes(H) <= kMaxSmem; }

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


// ------------------------------------------------------------- backward, part 1: the coefficients
//
// h_raw of every (b, t) at once: bf16(h_prev) @ C as a batched product
// [B*T, Hk] x [Hk, H] (mma.sync, exact bf16 products, fp32 sums), then
// a = m (1 - tanh(xin + .)^2) into coef (the dxin buffer). A block is 8 warps
// of 16 rows (128 rows of B*T) x 4 unit octets; K streams through smem in
// chunks of 64. Where H % 8 == 0 (kVec) the loads move 4 (h) and 8 (C)
// elements at a time.
constexpr int kCoefRows = 128, kCoefOct = 4, kCoefK = 64, kCoefThreads = 256;
constexpr int kCoefLdA = kCoefK + 8, kCoefLdB = 8 * kCoefOct + 8;

template <bool kVec>
__global__ void __launch_bounds__(kCoefThreads)
    rnn_bwd_coef_kernel(const float* __restrict__ xin, const float* __restrict__ mask, const bf16* __restrict__ cw,
                        const float* __restrict__ hs, float* __restrict__ coef, int BT, int T, int H) {
  __shared__ __align__(16) bf16 a_s[kCoefRows * kCoefLdA];
  __shared__ __align__(16) bf16 b_s[kCoefK * kCoefLdB];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const int r0 = blockIdx.x * kCoefRows, o0 = blockIdx.y * kCoefOct;
  const int Hk = (H + 15) / 16 * 16;
  float acc[kCoefOct][4];
#pragma unroll
  for (int i = 0; i < kCoefOct; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const uint32_t a_a = shared_addr(a_s), b_a = shared_addr(b_s);
  // The epilogue's xin and mask at the thread's (row, unit) pairs, loaded
  // first so their latency overlaps the product: accumulator lo holds rows
  // g (+ 8) x units 2 tq (+ 1) of octet o0 + lo.
  float xv[kCoefOct][2][2], mv[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = r0 + warp * 16 + g + 8 * rr;
    mv[rr] = r < BT ? mask[r] : 0.f;
#pragma unroll
    for (int lo = 0; lo < kCoefOct; ++lo) {
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const int j = 8 * (o0 + lo) + 2 * tq + ii;
        xv[lo][rr][ii] = r < BT && j < H ? xin[(size_t)r * H + j] : 0.f;
      }
    }
  }
  for (int k0 = 0; k0 < Hk; k0 += kCoefK) {
    // A: bf16(h_prev) of rows r0.. (h_prev of row r = b T + t is hs row r - 1, 0 at t = 0).
    if constexpr (kVec) {
#pragma unroll
      for (int i = 0; i < kCoefRows * kCoefK / 4 / kCoefThreads; ++i) {
        const int e = threadIdx.x + i * kCoefThreads, rr = e / (kCoefK / 4), k = k0 + (e % (kCoefK / 4)) * 4;
        const int r = r0 + rr;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < BT && r % T != 0 && k < H) v = *reinterpret_cast<const float4*>(hs + (size_t)(r - 1) * H + k);
        __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(a_s + rr * kCoefLdA + k - k0);
        dst[0] = __floats2bfloat162_rn(v.x, v.y);
        dst[1] = __floats2bfloat162_rn(v.z, v.w);
      }
    } else {
      for (int e = threadIdx.x; e < kCoefRows * kCoefK; e += kCoefThreads) {
        const int rr = e / kCoefK, k = k0 + e % kCoefK, r = r0 + rr;
        const bool ok = r < BT && r % T != 0 && k < H;
        a_s[rr * kCoefLdA + e % kCoefK] = __float2bfloat16(ok ? hs[(size_t)(r - 1) * H + k] : 0.f);
      }
    }
    // B: C rows k0.., local column 8 lo + u = column 8 (o0 + lo) + u of C.
    if constexpr (kVec) {
      for (int e = threadIdx.x; e < kCoefK * kCoefOct; e += kCoefThreads) {
        const int kk = e / kCoefOct, lo = e % kCoefOct, k = k0 + kk, j = 8 * (o0 + lo);
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (k < H && j < H) v = *reinterpret_cast<const uint4*>(cw + (size_t)k * H + j);
        *reinterpret_cast<uint4*>(b_s + kk * kCoefLdB + 8 * lo) = v;
      }
    } else {
      for (int e = threadIdx.x; e < kCoefK * 8 * kCoefOct; e += kCoefThreads) {
        const int kk = e / (8 * kCoefOct), lc = e % (8 * kCoefOct), k = k0 + kk, j = 8 * o0 + lc;
        b_s[kk * kCoefLdB + lc] = k < H && j < H ? cw[(size_t)k * H + j] : __float2bfloat16(0.f);
      }
    }
    __syncthreads();
    const int ks_end = (Hk - k0 < kCoefK ? Hk - k0 : kCoefK) / 16;
    for (int ks = 0; ks < ks_end; ++ks) {
      uint32_t a[4];
      ldsm_x4(a, a_a + ((warp * 16 + lane % 16) * kCoefLdA + ks * 16 + (lane / 16) * 8) * 2);
#pragma unroll
      for (int nt = 0; nt < kCoefOct; ++nt) {
        uint32_t b0, b1;
        ldsm_x2_trans(b0, b1, b_a + ((ks * 16 + lane % 16) * kCoefLdB + nt * 8) * 2);
        mma_bf16(acc[nt], a, b0, b1);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int lo = 0; lo < kCoefOct; ++lo) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = r0 + warp * 16 + g + 8 * rr, j0 = 8 * (o0 + lo) + 2 * tq;
      if (r >= BT || j0 >= H) continue;
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        if (j0 + ii >= H) continue;
        const float h_raw = tanhf(xv[lo][rr][ii] + acc[lo][2 * rr + ii]);
        coef[(size_t)r * H + j0 + ii] = mv[rr] * (1.0f - h_raw * h_raw);
      }
    }
  }
}

// ------------------------------------------------------------- backward, part 2: the carry
//
// One cluster of C CTAs a group of R rows (16, the mma's M, or 8 with the
// fragment's upper rows zero); blockDim = 32 ocp, warp w of CTA p owns octet
// p*O/C + w (a CTA with one octet fewer than ocp leaves its last warp idle).
// Shared memory: dpre's three bf16 terms for the whole group, [2 parity][3
// term][R rows][lda], each warp's send staging, the prefetch ring, and the
// two mbarriers of the term buffers. A warp sends its octet's terms as
// 16-byte st.async (a term's 8 units of one row, gathered through the
// staging from the 4 lanes that hold them).
//
// The exchange bounds the step: every SM receives the group's terms, 6 R H
// bytes (12 KB at R = 16, H = 128), whatever C, and distributed shared
// memory moves them at ~11 bytes a clock an SM (a clock64() profile: ~1,100
// clocks of a ~2,200-clock step). So the carry takes 8-row groups where
// their clusters still fit on the card at once (carry_rows), half the bytes
// a step, on twice the SMs.
constexpr int kCarryMaxWarps = 16;  // unit octets (= warps) a CTA at most
constexpr int kCarryPickOct = 2;    // unit octets a CTA of the cluster the kernel picks
constexpr int kCarrySlots = 3;      // prefetch ring slots: two steps in flight
constexpr int kCarryVals = 10;      // a thread's step inputs: a and dhs at its 2 x 2 pairs, its rows' mask
constexpr int kStageBytes = 8 * 6 * 16;  // a warp's send staging: [g][2 rows x 3 terms][8 units] bf16

struct CarryLayout {
  int O;    // unit octets, ceil(H / 8)
  int ocp;  // octets a CTA at most, ceil(O / C): its warps
  int Hk;   // H rounded up to 16: the product's K
  int lda;  // bf16 row stride of a term matrix (Hk + 8: conflict-free ldmatrix)
  int buf;  // bytes of one parity's three term matrices
  int stage_off, ring_off, bar_off, bytes;
};

__host__ __device__ inline CarryLayout carry_layout(int H, int C, int R) {
  CarryLayout L;
  L.O = (H + 7) / 8;
  L.ocp = (L.O + C - 1) / C;
  L.Hk = (H + 15) / 16 * 16;
  L.lda = L.Hk + 8;
  L.buf = 3 * R * L.lda * 2;
  L.stage_off = 2 * L.buf;
  L.ring_off = L.stage_off + L.ocp * kStageBytes;
  L.bar_off = L.ring_off + kCarrySlots * kCarryVals * 32 * L.ocp * 4;
  L.bytes = L.bar_off + 2 * 8;
  return L;
}

bool carry_fits(int H, int C) {
  if (H <= 0 || C < 1 || C > 16 || (C & (C - 1)) != 0) return false;
  const CarryLayout L = carry_layout(H, C, 16);
  return C <= L.O && L.ocp <= kCarryMaxWarps && L.bytes <= kMaxSmem;
}

// Rows a group: 8 where the 8-row groups' clusters fit on the card at once,
// else 16.
int carry_rows(int B, int C) { return (B + 7) / 8 * C <= kSms ? 8 : 16; }

// The cluster: the smallest of 1, 2, 4, 8 that fits with at most
// kCarryPickOct octets a CTA, else the largest of them that fits (16 only
// where none does: every CTA sends to all of its cluster each step, and 16
// was the slower at every width timed); 0 when none fits.
int carry_pick(int H) {
  int fit = 0;
  for (int c = 1; c <= 16; c *= 2) {
    if (!carry_fits(H, c) || (c == 16 && fit > 0)) continue;
    fit = c;
    if (carry_layout(H, c, 16).ocp <= kCarryPickOct) return c;
  }
  return fit;
}

// C[j][k] and C[j][k + 1] (zero past H) as one mma B register: C^T's column
// j at rows k and k + 1, K contiguous along C's row j.
__device__ __forceinline__ uint32_t c_pair(const bf16* __restrict__ cw, int H, int j, int k) {
  const uint16_t* p = reinterpret_cast<const uint16_t*>(cw + (size_t)j * H + k);
  const uint32_t lo = j < H && k < H ? p[0] : 0u, hi = j < H && k + 1 < H ? p[1] : 0u;
  return lo | (hi << 16);
}

// kRegK: the k-steps held in registers, at least Hk / 16; R: rows a group.
template <int kRegK, int R>
__global__ void __launch_bounds__(32 * kCarryMaxWarps)
    rnn_bwd_carry_kernel(const bf16* __restrict__ cw, const float* __restrict__ mask, const float* __restrict__ dhs,
                         float* __restrict__ dxin, int B, int T, int H, int C) {
  constexpr int NR = R / 8;     // rows a thread holds: g, and g + 8 at R = 16
  constexpr int kChunks = 3 * NR;  // 16-byte chunks a lane group sends a CTA: NR rows x 3 terms
  extern __shared__ __align__(16) unsigned char smem[];
  const CarryLayout L = carry_layout(H, C, R);
  const int KS = L.Hk / 16, NT = 32 * L.ocp;
  const int p = C > 1 ? static_cast<int>(cta_rank()) : 0;
  const int grp = blockIdx.x / C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const int ob = p * L.O / C, n_oct = (p + 1) * L.O / C - ob;
  const bool owner = warp < n_oct;  // warp-uniform: this warp owns octet ob + warp
  float* ring = reinterpret_cast<float*>(smem + L.ring_off);   // [kCarrySlots][kCarryVals][NT]
  uint64_t* tbar = reinterpret_cast<uint64_t*>(smem + L.bar_off);  // [2]: the group's dpre terms arrived in buffer b
  const uint32_t terms_a = shared_addr(smem), tbar_a = shared_addr(tbar);
  const uint32_t term_bytes = R * L.lda * 2;  // one term matrix

  // The term buffers zero: K's padding and units past 8 O stay zero.
  for (int i = threadIdx.x; i < L.stage_off / 16; i += blockDim.x) {
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  // The bytes of dpre's terms a step brings to each CTA: every octet's R x 8, three terms.
  const uint32_t step_bytes = L.O * R * 8 * 2 * 3;
  // dpre(s) is sent for s = T-1 .. 1 (dpre(0) feeds no carry) into buffer s & 1.
  if (threadIdx.x == 0) {
    mbar_init(&tbar[0], 1);
    mbar_init(&tbar[1], 1);
    mbar_init_fence();
    if (T - 1 >= 1) mbar_arrive_expect_tx(&tbar[(T - 1) & 1], step_bytes);
    if (T - 2 >= 1) mbar_arrive_expect_tx(&tbar[(T - 2) & 1], step_bytes);
  }
  __syncthreads();
  // Every CTA of the cluster runs, its barriers armed, before the first remote store.
  if (C > 1) {
    cluster_arrive();
    cluster_wait();
  }

  if (owner) {
    // This thread's (row, unit) pairs: rows g (+ 8) of the group, units j0 (+ 1).
    const int j0 = 8 * (ob + warp) + 2 * tq;
    int brow[NR];
    bool okr[NR], ok[NR][2];
#pragma unroll
    for (int rr = 0; rr < NR; ++rr) {
      brow[rr] = grp * R + g + 8 * rr;
      okr[rr] = brow[rr] < B;
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) ok[rr][ii] = okr[rr] && j0 + ii < H;
    }
    // The warp's columns of C^T as B fragments, for the whole sequence.
    uint32_t bf[kRegK][2];
    const int jb = 8 * (ob + warp) + g;
#pragma unroll
    for (int kb = 0; kb < kRegK; ++kb) {
      bf[kb][0] = c_pair(cw, H, jb, kb * 16 + 2 * tq);
      bf[kb][1] = c_pair(cw, H, jb, kb * 16 + 2 * tq + 8);
    }

    // Step t's inputs into ring slot t % kCarrySlots (zero past B and H, and
    // for t < 0), one cp.async group: per row rr, a and dhs of its two
    // units, then the row's mask.
    auto fetch = [&](int t) {
      float* slot = ring + (t + kCarrySlots) % kCarrySlots * kCarryVals * NT + threadIdx.x;
#pragma unroll
      for (int rr = 0; rr < NR; ++rr) {
        const size_t row = (size_t)brow[rr] * T + t;
        const bool kr = okr[rr] && t >= 0;
        cp_async4(slot + (5 * rr + 4) * NT, mask + (kr ? row : 0), kr);
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const bool k = ok[rr][ii] && t >= 0;
          const size_t o = k ? row * H + j0 + ii : 0;
          cp_async4(slot + (5 * rr + 2 * ii) * NT, dxin + o, k);
          cp_async4(slot + (5 * rr + 2 * ii + 1) * NT, dhs + o, k);
        }
      }
      cp_async_commit();
    };
    fetch(T - 1);
    fetch(T - 2);

    float keep[NR][2] = {};  // d (1 - m) of the step after
    for (int t = T - 1; t >= 0; --t) {
      float dh[NR][2] = {};
      if (t < T - 1) {
        // dpre(t + 1) of the whole group in buffer (t + 1) & 1; then that
        // buffer's barrier is armed for dpre(t - 1).
        const int b = (t + 1) & 1;
        mbar_wait(&tbar[b], ((T - 2 - t) >> 1) & 1);
        if (threadIdx.x == 0 && t - 1 >= 1) mbar_arrive_expect_tx(&tbar[b], step_bytes);
        // dpre(t + 1) @ C^T at the warp's units: six chains (a term's even
        // and odd k-steps), the next k-step's A fragments loaded ahead.
        float acc[2][3][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int q = 0; q < 3; ++q) acc[h][q][0] = acc[h][q][1] = acc[h][q][2] = acc[h][q][3] = 0.f;
        }
        const uint32_t base = terms_a + b * L.buf;
        uint32_t a[2][3][4];
#pragma unroll
        for (int q = 0; q < 3; ++q) load_a_frag<R>(a[0][q], base + q * term_bytes, L.lda, 0, lane);
#pragma unroll
        for (int kb = 0; kb < kRegK; ++kb) {
          if (kb < KS) {
            if (kb + 1 < KS) {
#pragma unroll
              for (int q = 0; q < 3; ++q) {
                load_a_frag<R>(a[(kb + 1) & 1][q], base + q * term_bytes, L.lda, (kb + 1) * 16, lane);
              }
            }
#pragma unroll
            for (int q = 0; q < 3; ++q) mma_bf16(acc[kb & 1][q], a[kb & 1][q], bf[kb][0], bf[kb][1]);
          }
        }
        // Element 2 rr + ii is (row g + 8 rr, unit j0 + ii); the smallest term first.
#pragma unroll
        for (int rr = 0; rr < NR; ++rr) {
#pragma unroll
          for (int ii = 0; ii < 2; ++ii) {
            const int e = 2 * rr + ii;
            const float p2 = acc[0][2][e] + acc[1][2][e], p1 = acc[0][1][e] + acc[1][1][e];
            dh[rr][ii] = keep[rr][ii] + ((p2 + p1) + (acc[0][0][e] + acc[1][0][e]));
          }
        }
      }
      cp_async_wait<1>();  // step t's slot has landed (t - 1's may still be in flight)
      const float* slot = ring + t % kCarrySlots * kCarryVals * NT + threadIdx.x;
      float dpre[NR][2];
#pragma unroll
      for (int rr = 0; rr < NR; ++rr) {
        const float m = slot[(5 * rr + 4) * NT];
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const float a = slot[(5 * rr + 2 * ii) * NT], dy = slot[(5 * rr + 2 * ii + 1) * NT];
          const float d = dh[rr][ii] + dy;
          dpre[rr][ii] = d * a;
          keep[rr][ii] = d * (1.0f - m);
          if (ok[rr][ii]) dxin[((size_t)brow[rr] * T + t) * H + j0 + ii] = dpre[rr][ii];
        }
      }
      if (t > 0) {
        // dpre(t)'s three terms into buffer t & 1 of every CTA of the
        // cluster. Chunk c = 3 rr + q of lane group g is term q of row g + 8 rr
        // at the octet's 8 units: the 4 lanes of the group stage their pairs,
        // then lane tq sends chunks tq and tq + 4 (below kChunks).
        uint32_t* stage = reinterpret_cast<uint32_t*>(smem + L.stage_off + warp * kStageBytes) + g * 24;
#pragma unroll
        for (int rr = 0; rr < NR; ++rr) {
          __nv_bfloat162 terms[3];
          split3(dpre[rr][0], dpre[rr][1], terms);
#pragma unroll
          for (int q = 0; q < 3; ++q) stage[(3 * rr + q) * 4 + tq] = *reinterpret_cast<uint32_t*>(&terms[q]);
        }
        __syncwarp();
        const bool one = tq < kChunks, two = tq + 4 < kChunks;
        const uint4 c0 = one ? reinterpret_cast<const uint4*>(stage)[tq] : make_uint4(0u, 0u, 0u, 0u);
        const uint4 c1 = two ? reinterpret_cast<const uint4*>(stage)[tq + 4] : make_uint4(0u, 0u, 0u, 0u);
        __syncwarp();  // the staging read before the next step's writes
        const int u0 = 8 * (ob + warp);
        const uint32_t off0 = (tq % 3) * term_bytes + ((g + 8 * (tq / 3)) * L.lda + u0) * 2;
        const uint32_t off1 = ((tq + 4) % 3) * term_bytes + ((g + 8 * ((tq + 4) / 3)) * L.lda + u0) * 2;
        const uint32_t at = terms_a + (t & 1) * L.buf, bar = tbar_a + (t & 1) * 8;
        for (int dst = 0; dst < C; ++dst) {
          const uint32_t ra = map_rank(at, dst), rb = map_rank(bar, dst);
          if (one) st_async_v4(ra + off0, rb, c0);
          if (two) st_async_v4(ra + off1, rb, c1);
        }
      }
      fetch(t - 2);
    }
  }
  // No CTA leaves while another may still store into its shared memory.
  if (C > 1) {
    cluster_arrive();
    cluster_wait();
  }
}

template <int kRegK, int R>
cudaError_t launch_carry(const void* cw, const void* mask, const void* dhs, void* dxin, int B, int T, int H, int C,
                         int device, cudaStream_t s) {
  const CarryLayout L = carry_layout(H, C, R);
  auto kernel = rnn_bwd_carry_kernel<kRegK, R>;
  // Once an instantiation and device: the largest shared-memory opt-in, clusters of 16.
  static uint64_t attributes_set = 0;
  if (device >= 64 || !(attributes_set >> device & 1)) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e == cudaSuccess) e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    if (device < 64) attributes_set |= uint64_t{1} << device;
  }
  const int groups = (B + R - 1) / R;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(groups * C);
  cfg.blockDim = dim3(32 * L.ocp);
  cfg.dynamicSmemBytes = L.bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const bf16*>(cw), static_cast<const float*>(mask),
                                     static_cast<const float*>(dhs), static_cast<float*>(dxin), B, T, H, C);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// C^T's fragments in registers: Hk / 16 k-steps, at most 22 (H <= 352).
template <int R>
cudaError_t launch_carry_k(const void* cw, const void* mask, const void* dhs, void* dxin, int B, int T, int H, int C,
                           int device, cudaStream_t s) {
  const int ks = (H + 15) / 16;
  if (ks <= 8) return launch_carry<8, R>(cw, mask, dhs, dxin, B, T, H, C, device, s);
  if (ks <= 16) return launch_carry<16, R>(cw, mask, dhs, dxin, B, T, H, C, device, s);
  if (ks <= 24) return launch_carry<24, R>(cw, mask, dhs, dxin, B, T, H, C, device, s);
  return cudaErrorInvalidValue;
}

bool takes(int H) { return fwd_takes(H) && carry_pick(H) > 0; }

}  // namespace

// The largest hidden width both directions take (the forward's bf16 C in one block).
extern "C" int rnn_max_hidden() {
  for (int H = 1024; H > 0; --H) {
    if (takes(H)) return H;
  }
  return 0;
}

// Number of partial dC sums the wrapper allocates ([splits, H, H] fp32).
extern "C" int rnn_bwd_splits(int B, int T, int H) { return recurrent_dw::num_splits(B * T, H, H); }

// The backward carry's cluster size for width H (1, 2, 4, 8 or 16), or 0
// when no cluster takes H.
extern "C" int rnn_bwd_cluster_size(int H) { return carry_pick(H); }

// Whether a cluster of C blocks a row group takes width H in the backward carry.
extern "C" int rnn_bwd_fits(int H, int C) { return carry_fits(H, C) ? 1 : 0; }

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

// cluster: 0 runs the carry's own pick (the wrapper's); 1, 2, 4, 8 or 16
// forces that cluster size where it fits, else cudaErrorInvalidValue
// (chip_smoke.py times each to measure the pick).
extern "C" int rnn_bwd(const void* xin, const void* mask, const void* cw, const void* hs, const void* dhs,
                       void* dxin, void* dc_partial, void* dc, int B, int T, int H, int cluster, int device,
                       void* stream) {
  const int c = cluster > 0 ? cluster : carry_pick(H);
  if (!takes(H) || c == 0 || !carry_fits(H, c) || B <= 0 || T <= 0) return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int BT = B * T;
  const dim3 coef_grid((BT + kCoefRows - 1) / kCoefRows, ((H + 7) / 8 + kCoefOct - 1) / kCoefOct);
  auto coef = H % 8 == 0 ? rnn_bwd_coef_kernel<true> : rnn_bwd_coef_kernel<false>;
  coef<<<coef_grid, kCoefThreads, 0, s>>>(static_cast<const float*>(xin), static_cast<const float*>(mask),
                                          static_cast<const bf16*>(cw), static_cast<const float*>(hs),
                                          static_cast<float*>(dxin), BT, T, H);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = carry_rows(B, c) == 8 ? launch_carry_k<8>(cw, mask, dhs, dxin, B, T, H, c, device, s)
                            : launch_carry_k<16>(cw, mask, dhs, dxin, B, T, H, c, device, s);
  if (e != cudaSuccess) return e;
  return recurrent_dw::launch(static_cast<const float*>(hs), static_cast<const float*>(dxin),
                              static_cast<float*>(dc_partial), static_cast<float*>(dc), B, T, H, H, s);
}
