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
// Forward (B5), rnn_fwd_kernel<kRegK, R, kVec>: lstm.cu's forward (B3) with
// one gate block and one carry; the two share cluster_carry.cuh's helpers
// (tanh_fast, ldmatrix, st.async, the TMA load). The first design (a thread
// a unit of one row, an H-long k-ordered FMA chain on shared-memory
// operands, IEEE tanhf, a block barrier a step: ~2.0 us a step at H = 128)
// held all of bf16 C in one block, which capped the pair at H <= 339.
// - A cluster of C CTAs owns a group of R batch rows: 8 where the 8-row
//   groups' clusters fit on the card at once (the A fragment's upper rows
//   zero), else 16 (the mma's M); rows past B compute on zeros and store
//   nothing. CTA p owns unit octets [p*O/C, (p+1)*O/C) of O = ceil(H/8) and
//   their columns of C, [Hk, 8 an octet] bf16 (Hk = H rounded up to 16;
//   padding zero), in shared memory; each consumer warp loads its octet's
//   columns once as mma B fragments into registers (2 Hk/16: up to 80 at
//   H = 640), so a step reads only bf16(h) from shared memory.
// - Consumer warp w of CTA p owns octet p*O/C + w; the fp32 carry h of its
//   R rows x 8 units stays in that thread's registers, in the accumulator
//   layout, for the sequence.
// - A step: wait for xin[t] and the mask (the ring below) and for h(t-1)
//   (the h buffer's mbarrier); bf16(h) @ C on mma.sync m16n8k16 (exact bf16
//   products summed in fp32, the TPU kernel's arithmetic), two chains (even
//   and odd k-steps) added at the end; + xin[t], tanh_fast (ex2.approx,
//   rcp.approx; within a few fp32 ulp of tanhf); the blend with the row's m;
//   bf16(h) into the next h buffer of every CTA of the cluster, a row's 8
//   units (gathered from the 4 lanes that hold them by shuffles) as one
//   16-byte st.async counted on that CTA's mbarrier, double-buffered by
//   step parity, with no barrier in the step (a CTA can only overwrite a
//   buffer after every warp of every CTA has read it); fp32 h out to hs.
//   The exchange brings 2 R H bytes into each SM a step (2 KB at R = 8,
//   H = 128), a third of the backward carry's three terms.
// - A producer warp streams xin in with one TMA box a step and CTA ([R rows]
//   [the CTA's units] of xin, zero past B and H; 4-byte cp.async where
//   H % 4 != 0), and the group's R mask values beside it in the same ring
//   slot by cp.async (the mask rides the ring). Up to 4 slots on full /
//   empty mbarriers; a consumer fences its reads of a slot against the async
//   proxy before it releases the slot.
// - Padded steps (m = 0) pass h through exactly: tanh_fast is finite, so
//   m h_raw = 0 and (1 - m) h = h.
// - C and R from (B, H): the smallest cluster that fits (at most 8 octets a
//   CTA: C = 1 at H = 64, 2 at 128, 8 at 339 and 512, 16 at 640), R as
//   above (rnn_fwd_cluster_size, rnn_fwd_group_rows). chip_smoke.py times
//   every cluster that fits (`rnn_fwd cluster choice`, device time). Every
//   cluster and row count gives the same bits: a warp's
//   arithmetic depends on neither, nor on kRegK (k-steps past Hk / 16 are
//   skipped).
// - No atomics: a second launch gives the same bits. The product is two
//   chains and tanh is approximated, so the backward's recompute (IEEE
//   tanhf, the tensor cores' order in one chain) matches this forward to
//   fp32 rounding, not bit for bit.
// The cluster kernels take any H up to 640 (cluster_max_hidden(): a warp's
// fragments of C, and of C^T in the backward carry, stay in registers up to
// 40 k-steps). Past it the serial kernels run on the whole card, C in the
// CTAs' shared memory: rnn_fwd_grid_kernel and rnn_bwd_grid_carry_kernel
// below (csrc/grid_carry.cuh, the GRU's grid-resident design with one gate
// block), up to rnn_max_hidden() (3168). Past it C no longer fits the CTAs'
// shared memory (33.6 MB at H = 4096), and the serial kernels read it from
// L2 or device memory every step (rnn_fwd_stream_kernel and
// rnn_bwd_stream_carry_kernel below, with csrc/grid_stream.cuh), any H >= 1.
// The Python wrapper picks the design (ops/fused_rnn.py design); an H <= 0
// is refused (cudaErrorInvalidValue).
//
// Backward (B6): csrc/gru_bwd.cu's three-part pattern with one gate block.
// 1. rnn_bwd_coef_kernel: h_raw = tanh(xin + bf16(h_prev) @ C) of every
//    step at once on the tensor cores (mma.sync m16n8k16: exact bf16
//    products; each k-step's 16 summed by the tensor core into a zeroed
//    fragment and the k-steps added in IEEE fp32, since the tensor core's
//    own fp32 accumulation over H / 16 k-steps truncates: at H = 1024 it
//    put B6 2e-5 from an fp64 reference, the plain version 4e-7; so h_raw
//    matches the forward's two chains and tanh_fast to fp32 rounding, not
//    bit for bit), and from
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
//    2 Hk/16 registers, 44 at H = 339, 80 at H = 640; past 24 k-steps a CTA
//    runs at most 8 warps, so that they fit). Per step t = T-1 .. 0, at the
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
//    C: the smallest of 1, 2, 4, 8 whose CTAs hold at most 2 octets each,
//    else the largest of them that fits, 16 where none does: 4 at H = 64, 8
//    at H = 100, 128, 339 and 512, 16 past 512. chip_smoke.py's
//    `rnn_bwd cluster choice` times every
//    size that fits (the C entry takes the cluster to force, the wrapper
//    passes 0). A warp's arithmetic depends neither on C nor on the group's
//    rows, so every cluster gives the same bits. A ragged H zero-pads the
//    last octet and K.
// 3. dC: recurrent_dw::launch over the final dxin (fp32 on the CUDA cores,
//    csrc/recurrent_dwh.cuh, as B2's and B4's dwh); on the streamed design
//    (rnn_bwd_stream) in runs of rows (run_parts' blocked), as the GRU's.
// No atomics: a second launch gives the same bits.
//
// The entry points launch on the given stream, do not synchronise and
// allocate nothing; they return cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_stream.cuh"
#include "recurrent_dwh.cuh"

namespace {

constexpr int kMaxK = 40;  // k-steps of C (forward) or C^T (backward carry) a warp holds in registers: Hk <= 640

// Rows a group, both directions: 8 (the A fragment's upper rows zero) where
// the 8-row groups' clusters of C fit on the card at once, else 16 (the
// mma's M). The exchange's bytes into each SM set a step's pace, and 8 rows
// halve them on twice the SMs.
int rows_a_group(int B, int C) { return (B + 7) / 8 * C <= kSms ? 8 : 16; }

// ------------------------------------------------------------- forward (B5)
//
// lstm.cu's forward (B3) with one gate block and one carry. A cluster of C
// CTAs owns a group of R rows (16, the mma's M, or 8 with the A fragment's
// upper rows zero); CTA p owns unit octets [p*O/C, (p+1)*O/C) of
// O = ceil(H/8) and keeps their columns of C, [Hk, 8 an octet] bf16, in
// shared memory, from which each consumer warp loads its octet's columns
// once as mma B fragments into registers (2 Hk/16 registers: 80 at
// H = 640). A producer warp streams each step's xin (one TMA box [R rows]
// [the CTA's units] of xin, zero past B and H; 4-byte cp.async where
// H % 4 != 0) and the group's R mask values (cp.async, zero past B) into a
// ring of up to 4 slots on full / empty mbarriers.
constexpr int kFwdMaxWarps = 8;   // unit octets (= consumer warps) a CTA at most
constexpr int kFwdMaxSlots = 4;   // ring slots: steps t .. t + 3 (fewer where they do not fit)
constexpr int kMaskFloats = 32;   // a slot's mask: up to 16 rows, padded to 128 bytes

// The shared-memory layout of one CTA of the forward for width H on a
// cluster of C, R rows a group.
struct FwdLayout {
  int O;     // unit octets, ceil(H / 8)
  int ocp;   // octets a CTA at most, ceil(O / C): its consumer warps
  int Hk;    // H rounded up to 16: the product's K
  int ldb;   // bf16 row stride of the C slice [Hk][8 ocp] (+ 8: conflict-free ldmatrix)
  int lda;   // bf16 row stride of the h buffers [2][R][Hk] (+ 8)
  int xu;    // fp32 row stride of a slot's xin [R][xu]: the CTA's 8 ocp units (+ 4, for the banks)
  int slot;  // fp32 a slot: xin, then the mask (a multiple of 32: 128-byte slots)
  int slots;
  int a_off, x_off, bar_off, bytes;
};

__host__ __device__ inline FwdLayout fwd_layout(int H, int C, int R) {
  FwdLayout L;
  L.O = (H + 7) / 8;
  L.ocp = (L.O + C - 1) / C;
  L.Hk = (H + 15) / 16 * 16;
  L.ldb = 8 * L.ocp + 8;
  L.lda = L.Hk + 8;
  L.xu = 8 * L.ocp + 4;
  L.slot = R * L.xu + kMaskFloats;
  L.a_off = (L.Hk * L.ldb * 2 + 127) / 128 * 128;               // C slice [Hk][ldb] bf16 at 0
  L.x_off = (L.a_off + 2 * R * L.lda * 2 + 127) / 128 * 128;    // h buffers [2][R][lda] bf16
  for (L.slots = kFwdMaxSlots; L.slots > 2; --L.slots) {
    if (L.x_off + L.slots * L.slot * 4 + (2 + 2 * kFwdMaxSlots) * 8 <= kMaxSmem) break;
  }
  L.bar_off = L.x_off + L.slots * L.slot * 4;
  L.bytes = L.bar_off + (2 + 2 * kFwdMaxSlots) * 8;  // mbarriers: h buffers, ring full, ring empty
  return L;
}

bool fwd_fits(int H, int C, int R) {
  if (H <= 0 || C < 1 || C > 16 || (C & (C - 1)) != 0 || (R != 8 && R != 16)) return false;
  const FwdLayout L = fwd_layout(H, C, R);
  return C <= L.O && L.ocp <= kFwdMaxWarps && L.Hk / 16 <= kMaxK && L.bytes <= kMaxSmem;
}

// The cluster for (B, H): the smallest of 1, 2, 4, 8, 16 that fits (at
// most 8 octets a CTA), on rows_a_group(B, C) rows a group; 0 when none fits.
// Timed at every cluster (`rnn_fwd cluster choice`): the fewest CTAs were
// the fastest or within 5% of it at every (B, H) measured, and a cluster of
// 16 at H = 512 lost 24% to 8.
int fwd_pick(int B, int H) {
  for (int c = 1; c <= 16; c *= 2) {
    if (fwd_fits(H, c, rows_a_group(B, c))) return c;
  }
  return 0;
}

// One cluster of C CTAs a group of R rows; blockDim = 32 (ocp + 1): warps
// 0 .. ocp-1 own the CTA's octets (consumers), warp ocp is the producer.
// kRegK: the k-steps of C's fragments held in registers, at least Hk / 16.
// kVec: H % 4 == 0, so xin moves by one TMA copy a step (xmap: xin as
// [B][T][H]), else by 4-byte cp.async.
template <int kRegK, int R, bool kVec>
__global__ void __launch_bounds__(32 * (kFwdMaxWarps + 1))
    rnn_fwd_kernel(const __grid_constant__ CUtensorMap xmap, const float* __restrict__ xin,
                   const float* __restrict__ mask, const bf16* __restrict__ cw, float* __restrict__ hs, int B, int T,
                   int H, int C) {
  constexpr int NR = R / 8;  // rows a thread holds: g, and g + 8 at R = 16
  extern __shared__ __align__(16) unsigned char smem[];
  const FwdLayout L = fwd_layout(H, C, R);
  const int KS = L.Hk / 16, ocp = L.ocp;
  const int p = C > 1 ? static_cast<int>(cta_rank()) : 0;
  const int grp = blockIdx.x / C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const int ob = p * L.O / C, n_oct = (p + 1) * L.O / C - ob;
  const bool owner = warp < n_oct;    // warp-uniform: this warp owns octet ob + warp
  const bool producer = warp == ocp;  // warp-uniform: this warp moves xin and the mask in
  bf16* slice = reinterpret_cast<bf16*>(smem);
  float* xring = reinterpret_cast<float*>(smem + L.x_off);
  uint64_t* hbar = reinterpret_cast<uint64_t*>(smem + L.bar_off);  // [2]: bf16(h) of the cluster arrived in buffer b
  uint64_t* full = hbar + 2;                                         // [slots]: a step's xin and mask landed in slot s
  uint64_t* empty = full + kFwdMaxSlots;                             // [slots]: slot s read by every owner warp
  const int S = L.slots;
  const uint32_t slice_a = shared_addr(slice), abuf_a = shared_addr(smem + L.a_off), hbar_a = shared_addr(hbar);

  // The C slice: local column 8 lo + u is column 8 (ob + lo) + u of C, zero
  // past H and past the CTA's octets; the h buffers (h0 = 0; K's padding
  // stays zero) and the ring (rows past B and units past H stay zero) zero.
  if (H % 8 == 0) {  // an octet is 16 aligned bytes of a row of C
    for (int i = threadIdx.x; i < L.Hk * ocp; i += blockDim.x) {
      const int k = i / ocp, lo = i % ocp;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (k < H && lo < n_oct) v = *reinterpret_cast<const uint4*>(cw + (size_t)k * H + 8 * (ob + lo));
      *reinterpret_cast<uint4*>(slice + k * L.ldb + 8 * lo) = v;
    }
  } else {
    for (int i = threadIdx.x; i < L.Hk * 8 * ocp; i += blockDim.x) {
      const int k = i / (8 * ocp), lc = i % (8 * ocp), lo = lc / 8, j = 8 * (ob + lo) + lc % 8;
      const bool ok = k < H && lo < n_oct && j < H;
      slice[k * L.ldb + lc] = ok ? cw[(size_t)k * H + j] : __float2bfloat16(0.f);
    }
  }
  for (int i = threadIdx.x; i < (L.bar_off - L.a_off) / 16; i += blockDim.x) {
    reinterpret_cast<uint4*>(smem + L.a_off)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  // The bytes of bf16(h) a step brings to each CTA: every octet's R rows x 8.
  const uint32_t h_bytes = L.O * R * 8 * 2;
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
  // Every CTA of the cluster runs, its barriers armed, before the first remote store.
  if (C > 1) {
    cluster_arrive();
    cluster_wait();
  }

  if (producer) {
    // Step t's xin (the group's rows, the CTA's units) and mask into ring
    // slot t % S, S - 1 steps ahead of the owners, once they have read the
    // slot's last step.
    const int nu = min(8 * n_oct, H - 8 * ob), u0 = 8 * ob;  // the CTA's units [u0, u0 + nu) below H
    const int rows = min(R, B - grp * R);
    for (int t = 0; t < T; ++t) {
      const int s = t % S;
      if (t >= S) mbar_wait(&empty[s], (t / S - 1) & 1);
      float* slot = xring + s * L.slot;
      if constexpr (kVec) {
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[s], R * L.xu * 4);
          tma_load_3d(slot, &xmap, u0, t, grp * R, &full[s]);
        }
      } else {
        for (int e = lane; e < rows * nu; e += 32) {
          const int r = e / nu, u = e % nu;
          cp_async4(slot + r * L.xu + u, xin + ((size_t)(grp * R + r) * T + t) * H + u0 + u, true);
        }
      }
      if (lane < R) {
        cp_async4(slot + R * L.xu + lane, mask + (lane < rows ? (size_t)(grp * R + lane) * T + t : 0), lane < rows);
      }
      cp_async_arrive(&full[s]);
    }
  } else if (owner) {
    // The warp's columns of C as B fragments, for the whole sequence.
    uint32_t breg[kRegK][2];
#pragma unroll
    for (int kb = 0; kb < kRegK; ++kb) {
      if (kb < KS) ldsm_x2_trans(breg[kb][0], breg[kb][1], slice_a + ((kb * 16 + lane % 16) * L.ldb + warp * 8) * 2);
    }
    const int j0 = 8 * (ob + warp) + 2 * tq;
    bool ok[NR][2];
#pragma unroll
    for (int rr = 0; rr < NR; ++rr) {
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) ok[rr][ii] = grp * R + g + 8 * rr < B && j0 + ii < H;
    }
    float h[NR][2] = {};
    for (int t = 0; t < T; ++t) {
      // Step t's xin at the thread's pairs (rows g (+ 8), units 2 tq (+ 1)
      // of its octet) and its rows' mask.
      const int s = t % S;
      mbar_wait(&full[s], (t / S) & 1);
      const float* slot = xring + s * L.slot;
      float2 x[NR];
      float m[NR];
#pragma unroll
      for (int rr = 0; rr < NR; ++rr) {
        x[rr] = *reinterpret_cast<const float2*>(slot + (g + 8 * rr) * L.xu + 8 * warp + 2 * tq);
        m[rr] = slot[R * L.xu + g + 8 * rr];
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
      // bf16(h) @ C: two mma chains (even and odd k-steps), added at the
      // end, the next k-step's A fragment loaded ahead.
      float acc[2][4] = {};
      const uint32_t a_cur = abuf_a + (t & 1) * R * L.lda * 2;
      uint32_t a[2][4];
      load_a_frag<R>(a[0], a_cur, L.lda, 0, lane);
#pragma unroll
      for (int kb = 0; kb < kRegK; ++kb) {
        if (kb < KS) {
          if (kb + 1 < KS) load_a_frag<R>(a[(kb + 1) & 1], a_cur, L.lda, (kb + 1) * 16, lane);
          mma_bf16(acc[kb & 1], a[kb & 1], breg[kb][0], breg[kb][1]);
        }
      }
      // Accumulator element 2 rr + ii is (row g + 8 rr, unit j0 + ii); the
      // blend with the row's mask (a padded step, m = 0, keeps h exactly:
      // tanh_fast is finite).
      uint32_t v[NR];
#pragma unroll
      for (int rr = 0; rr < NR; ++rr) {
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const int e = 2 * rr + ii;
          const float h_raw = tanh_fast((ii ? x[rr].y : x[rr].x) + (acc[0][e] + acc[1][e]));
          h[rr][ii] = m[rr] * h_raw + (1.0f - m[rr]) * h[rr][ii];
        }
        v[rr] = pack_bf16(h[rr][0], h[rr][1]);
      }
      // bf16(h) into every CTA's next buffer (not after the last step): the
      // 4 lanes of a group gather a row's 8 units, and lane tq sends row
      // g + 8 tq (tq < NR) as one 16-byte st.async.
      if (t + 1 < T) {
        uint4 row = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int rr = 0; rr < NR; ++rr) {
          const uint32_t w0 = __shfl_sync(0xffffffffu, v[rr], lane & ~3), w1 = __shfl_sync(0xffffffffu, v[rr], (lane & ~3) + 1);
          const uint32_t w2 = __shfl_sync(0xffffffffu, v[rr], (lane & ~3) + 2), w3 = __shfl_sync(0xffffffffu, v[rr], (lane & ~3) + 3);
          if (tq == rr) row = make_uint4(w0, w1, w2, w3);
        }
        if (tq < NR) {
          const uint32_t at = abuf_a + ((t + 1) & 1) * R * L.lda * 2 + ((g + 8 * tq) * L.lda + 8 * (ob + warp)) * 2;
          const uint32_t bar = hbar_a + ((t + 1) & 1) * 8;
          for (int dst = 0; dst < C; ++dst) st_async_v4(map_rank(at, dst), map_rank(bar, dst), row);
        }
      }
      // fp32 h of step t out to hs.
#pragma unroll
      for (int rr = 0; rr < NR; ++rr) {
        float* out = hs + ((size_t)(grp * R + g + 8 * rr) * T + t) * H + j0;
        if (ok[rr][1] && H % 2 == 0) {
          *reinterpret_cast<float2*>(out) = make_float2(h[rr][0], h[rr][1]);
        } else {
          if (ok[rr][0]) out[0] = h[rr][0];
          if (ok[rr][1]) out[1] = h[rr][1];
        }
      }
    }
  }
  // No CTA leaves while another may still store into its shared memory.
  if (C > 1) {
    cluster_arrive();
    cluster_wait();
  }
}

template <int kRegK, int R, bool kVec>
cudaError_t launch_fwd(const void* xin, const void* mask, const void* cw, void* hs, int B, int T, int H, int C,
                       int device, cudaStream_t s) {
  const FwdLayout L = fwd_layout(H, C, R);
  auto kernel = rnn_fwd_kernel<kRegK, R, kVec>;
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
    // xin as [B][T][H] fp32; a box is [R][1][xu], zero past B and H.
    cuuint64_t dims[3] = {static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(T), static_cast<cuuint64_t>(B)};
    cuuint64_t strides[2] = {static_cast<cuuint64_t>(H) * 4, static_cast<cuuint64_t>(H) * 4 * T};
    cuuint32_t box[3] = {static_cast<cuuint32_t>(L.xu), 1, static_cast<cuuint32_t>(R)};
    cuuint32_t elem[3] = {1, 1, 1};
    if (cuTensorMapEncodeTiled(&xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(xin), dims, strides, box,
                               elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                               CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
      return cudaErrorInvalidValue;
    }
  }
  const int groups = (B + R - 1) / R;
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
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, xmap, static_cast<const float*>(xin), static_cast<const float*>(mask),
                                     static_cast<const bf16*>(cw), static_cast<float*>(hs), B, T, H, C);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// C's fragments in registers: 8 k-steps up to H = 128, 16 up to 256, else 40.
template <int R, bool kVec>
cudaError_t launch_fwd_k(const void* xin, const void* mask, const void* cw, void* hs, int B, int T, int H, int C,
                         int device, cudaStream_t s) {
  const int ks = (H + 15) / 16;
  if (ks <= 8) return launch_fwd<8, R, kVec>(xin, mask, cw, hs, B, T, H, C, device, s);
  if (ks <= 16) return launch_fwd<16, R, kVec>(xin, mask, cw, hs, B, T, H, C, device, s);
  return launch_fwd<kMaxK, R, kVec>(xin, mask, cw, hs, B, T, H, C, device, s);
}

// ------------------------------------------------------------- backward, part 1: the coefficients
//
// h_raw of every (b, t) at once: bf16(h_prev) @ C as a batched product
// [B*T, Hk] x [Hk, H] (mma.sync, exact bf16 products, each k-step's into a
// zeroed fragment added to the sum in IEEE fp32), then
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
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(part, a, b0, b1);
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[nt][x] += part[x];
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
// their clusters still fit on the card at once (rows_a_group), half the bytes
// a step, on twice the SMs.
constexpr int kCarryPickOct = 2;    // unit octets a CTA of the cluster the kernel picks
constexpr int kCarrySlots = 3;      // prefetch ring slots: two steps in flight
constexpr int kCarryVals = 10;      // a thread's step inputs: a and dhs at its 2 x 2 pairs, its rows' mask
constexpr int kStageBytes = 8 * 6 * 16;  // a warp's send staging: [g][2 rows x 3 terms][8 units] bf16

// Unit octets (= warps) a CTA at most: 16 while a warp holds up to 24
// k-steps of C^T in registers, 8 past that (up to 40), whose threads hold more.
__host__ __device__ constexpr int carry_max_warps(int ks) { return ks <= 24 ? 16 : 8; }

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
  return C <= L.O && L.Hk / 16 <= kMaxK && L.ocp <= carry_max_warps(L.Hk / 16) && L.bytes <= kMaxSmem;
}


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
__global__ void __launch_bounds__(32 * carry_max_warps(kRegK))
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

// C^T's fragments in registers: Hk / 16 k-steps, at most 40 (H <= 640).
template <int R>
cudaError_t launch_carry_k(const void* cw, const void* mask, const void* dhs, void* dxin, int B, int T, int H, int C,
                           int device, cudaStream_t s) {
  const int ks = (H + 15) / 16;
  if (ks <= 8) return launch_carry<8, R>(cw, mask, dhs, dxin, B, T, H, C, device, s);
  if (ks <= 16) return launch_carry<16, R>(cw, mask, dhs, dxin, B, T, H, C, device, s);
  if (ks <= 24) return launch_carry<24, R>(cw, mask, dhs, dxin, B, T, H, C, device, s);
  if (ks <= kMaxK) return launch_carry<kMaxK, R>(cw, mask, dhs, dxin, B, T, H, C, device, s);
  return cudaErrorInvalidValue;
}

// Whether both directions take width H on some cluster.
bool takes(int H) { return fwd_pick(1, H) > 0 && carry_pick(H) > 0; }


// ---------------------------------------------------------------- past the cluster: the grid
//
// rnn_fwd_grid_kernel, for the widths no cluster takes (grid_carry.cuh has
// the grid, the barrier and the fragment loads; gru_fwd.cu's
// gru_fwd_grid_kernel is the same design with three gate blocks). CTA (r, u)
// of the R x U grid keeps C's columns of its unit octets, [Hk][8 ocp + 8]
// bf16 with the k-steps' rows permuted (kperm), in shared memory: past 40
// k-steps a warp's fragments of C no longer fit its registers. A step: wait
// on the row group's barrier for h(t - 1); per task (a 16-row tile, up to
// kTaskOct octets), bf16(h(t - 1)) @ C on mma.sync m16n8k16, A straight
// from the L2-resident buffer hbuf[(t - 1) & 1] (zero rows past B and zero
// columns past H: the wrapper zeroes it, and no CTA writes there),
// kRnnGridPf k-steps of fragments loaded ahead; h = m tanh_fast(xin + .) +
// (1 - m) h with the fp32 h(t - 1) read back from hs (this thread wrote it);
// fp32 h out to hs, bf16(h) to hbuf[t & 1]; then arrive. A padded step
// (m = 0) passes h through exactly: tanh_fast is finite. No atomics in any
// sum: a second launch gives the same bits.
constexpr int kRnnGridPf = 4;  // k-steps of A fragments loaded ahead

__global__ void __launch_bounds__(32 * kGridWarps, 1)
    rnn_fwd_grid_kernel(const float* __restrict__ xin, const float* __restrict__ mask, const bf16* __restrict__ cw,
                        float* __restrict__ hs, bf16* __restrict__ hbuf, int* __restrict__ ctr, int B, int T, int H,
                        GridShape S) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int O = (H + 7) / 8, Hk = (H + 15) / 16 * 16, KS = Hk / 16, ldb = 8 * S.ocp + 8;
  const int u = blockIdx.x % S.U, grp = blockIdx.x / S.U;
  const int ob = u * O / S.U, n_oct = (u + 1) * O / S.U - ob;
  const int row0 = grp * S.rows, n_rt = (min(S.rows, B - row0) + 15) / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const size_t buf = (size_t)S.R * S.rows * Hk;  // one parity of hbuf [2][R rows][Hk]
  int* my_ctr = ctr + grp * kCtrStride;
  int ng, gs;
  grid_tasks(n_rt, n_oct, ng, gs);

  // The C slice: physical row p of a k-step holds C's row k = kperm(p)
  // (zero past H); local column 8 lo + u is column 8 (ob + lo) + u (zero past
  // H and past the CTA's octets).
  bf16* slice = reinterpret_cast<bf16*>(smem);
  if (H % 8 == 0) {
    for (int i = threadIdx.x; i < Hk * S.ocp; i += blockDim.x) {
      const int p = i / S.ocp, lo = i % S.ocp, k = (p & ~15) + kperm(p & 15);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (k < H && lo < n_oct) v = *reinterpret_cast<const uint4*>(cw + (size_t)k * H + 8 * (ob + lo));
      *reinterpret_cast<uint4*>(slice + p * ldb + 8 * lo) = v;
    }
  } else {
    for (int i = threadIdx.x; i < Hk * 8 * S.ocp; i += blockDim.x) {
      const int p = i / (8 * S.ocp), lc = i % (8 * S.ocp), k = (p & ~15) + kperm(p & 15);
      const int lo = lc / 8, j = 8 * (ob + lo) + lc % 8;
      const bool ok = k < H && lo < n_oct && j < H;
      slice[p * ldb + lc] = ok ? cw[(size_t)k * H + j] : __float2bfloat16(0.f);
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
      // This thread's pairs: rows r0 + g (+ 8), units 8 (ob + lo0 + lo) + 2 tq (+ 1); xin of step t, the fp32
      // h(t - 1) there and the rows' mask, loaded ahead of the product.
      float x[kTaskOct][2][2], hp[kTaskOct][2][2], m[2];
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
            x[lo][rr][ii] = ok ? xin[((size_t)b * T + t) * H + j] : 0.f;
            hp[lo][rr][ii] = ok && t > 0 ? hs[((size_t)b * T + t - 1) * H + j] : 0.f;
          }
        }
      }
      float acc[kTaskOct][1][4];
#pragma unroll
      for (int lo = 0; lo < kTaskOct; ++lo) acc[lo][0][0] = acc[lo][0][1] = acc[lo][0][2] = acc[lo][0][3] = 0.f;
      if (t > 0) {  // h(-1) = 0
        const bf16* ra = hb + (size_t)(r0 + g) * Hk + 4 * tq;
        grid_fwd_product<1, kRnnGridPf>(acc, ra, ra + 8 * Hk, KS, slice_a, ldb, lo0, no, lane);
      }
      // The update: accumulator element 2 rr + ii is (row g + 8 rr, unit 2 tq + ii).
#pragma unroll
      for (int lo = 0; lo < kTaskOct; ++lo) {
        if (lo >= no) break;
        const int j0 = 8 * (ob + lo0 + lo) + 2 * tq;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int b = r0 + g + 8 * rr;
          float h[2];
#pragma unroll
          for (int ii = 0; ii < 2; ++ii) {
            const float h_raw = tanh_fast(x[lo][rr][ii] + acc[lo][0][2 * rr + ii]);
            h[ii] = m[rr] * h_raw + (1.0f - m[rr]) * hp[lo][rr][ii];
          }
          if (b >= B || j0 >= H) continue;
          float* dst = hs + ((size_t)b * T + t) * H + j0;
          bf16* hd = hn + (size_t)b * Hk + j0;
          dst[0] = h[0];
          if (j0 + 1 < H) {
            dst[1] = h[1];
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

// rnn_bwd_grid_carry_kernel, part 2 of the backward past the clusters'
// widths (csrc/gru_bwd.cu's gru_bwd_grid_carry_kernel with one gate block).
// CTA (r, u) owns the output units of its octets: it keeps C's rows of
// those units, [8 ocp][Hk + 8] bf16 (the k-steps' columns permuted by
// kperm), in shared memory, so that dpre(t) @ C^T at its units is one
// product over all H columns: no partial sums cross a CTA. Step t = T-1 .. 0
// of the row group:
// - each task's pairs, from part 1's coefficient a = m (1 - h_raw^2) (in
//   dxin) and the carry dh of the step after: d = dh + dhs[t], dpre = d a
//   into dxin[t] (exactly 0 on a padded step), d (1 - m) into the thread's
//   slot of `carry` [B][H] (only this thread reads it), and dpre's three
//   exact bf16 terms (split3) to the L2-resident buffer dt[t & 1]
//   [3][R rows][Hk];
// - the group's barrier (not at t = 0: dh(-1) feeds nothing);
// - per task, the three terms' products with the CTA's slice, each into its
//   own fp32 accumulator (A straight from L2, kGridBwdPf k-steps ahead;
//   term 0's k-steps added in IEEE fp32, grid_carry_product), summed
//   smallest first: s; dh = d (1 - m) + s.
// No atomics in any sum: the same bits every run.

__global__ void __launch_bounds__(32 * kGridWarps, 1)
    rnn_bwd_grid_carry_kernel(const bf16* __restrict__ cw, const float* __restrict__ dhs,
                              const float* __restrict__ mask, float* __restrict__ dxin, float* __restrict__ carry,
                              bf16* __restrict__ dt, int* __restrict__ ctr, int B, int T, int H, GridShape S) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int O = (H + 7) / 8, Kp = (H + 15) / 16 * 16, ldk = Kp + 8;
  const int u = blockIdx.x % S.U, grp = blockIdx.x / S.U;
  const int ob = u * O / S.U, n_oct = (u + 1) * O / S.U - ob;
  const int row0 = grp * S.rows, n_rt = (min(S.rows, B - row0) + 15) / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const size_t term = (size_t)S.R * S.rows * Kp;  // one term of one parity of dt [2][3][R rows][Kp]
  int* my_ctr = ctr + grp * kCtrStride;
  int ng, gs;
  grid_tasks(n_rt, n_oct, ng, gs);

  // The slice: local unit lu's row holds C[8 ob + lu][c] at physical column
  // p, c = kperm of p within its k-step (zero past H and past the CTA's
  // octets).
  bf16* slice = reinterpret_cast<bf16*>(smem);
  for (int i = threadIdx.x; i < 8 * S.ocp * Kp; i += blockDim.x) {
    const int lu = i / Kp, p = i % Kp, c = (p & ~15) + kperm(p & 15), j = 8 * ob + lu;
    const bool ok = lu < 8 * n_oct && j < H && c < H;
    slice[lu * ldk + p] = ok ? cw[(size_t)j * H + c] : __float2bfloat16(0.f);
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
          float dpre[2] = {0.f, 0.f};
#pragma unroll
          for (int ii = 0; ii < 2; ++ii) {
            const int j = j0 + ii;
            if (j >= H) continue;
            const size_t o = row * H + j, oh = (size_t)b * H + j;
            const float d = (t == T - 1 ? 0.f : carry[oh]) + dhs[o];
            dpre[ii] = d * dxin[o];
            dxin[o] = dpre[ii];
            carry[oh] = d * (1.0f - m);
          }
          if (t == 0) continue;
          __nv_bfloat162 terms[3];
          split3(dpre[0], dpre[1], terms);
          bf16* at = dtt + (size_t)b * Kp + j0;
#pragma unroll
          for (int e = 0; e < 3; ++e) {
            if (j0 + 1 < H) {
              *reinterpret_cast<__nv_bfloat162*>(at + e * term) = terms[e];
            } else {
              at[e * term] = terms[e].x;
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
            carry[(size_t)b * H + j] += (acc[2][lo][ci] + acc[1][lo][ci]) + acc[0][lo][ci];
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------- past the grid: the stream
//
// rnn_fwd_stream_kernel, for the widths past the grid's (grid_stream.cuh has
// the grid, the ring of k-chunks and the product; gru_fwd.cu's
// gru_fwd_stream_kernel is the same design with three gate blocks). What
// bounds it at config #3's batch 64 and T = 32 at H = 4096 (C [4096, 4096]
// bf16, 33.6 MB): the weight read once a step, 10 us from device memory at
// 3.35 TB/s (0.32 ms a call), less where L2 still holds some of C from the
// step before (it is loaded evict-first, grid_stream.cuh says why), plus
// the row group's barrier. The pick is
// the GRU's: one row group of 64 rows on 128 CTAs of 4-octet slices, one
// pass (mt = 2). With one gate block a slice is 32 columns of C, so an
// item's product has a narrow N (a warp's 8 columns) against the 64 rows x
// 4096 k of bf16(h) that every CTA reads from L2 (0.5 MB a step, beside
// its 0.26 MB of C). The pick stands: wider slices (8 octets, 64 CTAs)
// read the same 0.5 MB of bf16(h) and twice the C a CTA on half the SMs,
// and more row groups would split the 64 rows that share each slice's
// read of C.
// A step: wait on the row group's barrier for h(t - 1); for each item (a
// unit slice, a pass of 32 mt rows), bf16(h(t - 1)) @ C's columns of the
// slice (stream_fwd_product<1>: each k-step's product added in IEEE fp32),
// then h = m tanh_fast(xin + .) + (1 - m) h with the fp32 h(t - 1) read
// back from hs (this thread wrote it); fp32 h out, bf16(h) to hbuf[t & 1];
// then arrive. w is C with its columns padded to Hp = 8 ceil(H / 8) where
// H % 8 != 0 (the wrapper's). A padded step (m = 0) passes h through
// exactly: tanh_fast is finite. No atomics: a second launch gives the same
// bits.
template <int MT, int NO>
__global__ void __launch_bounds__(32 * kGridWarps, 1)
    rnn_fwd_stream_kernel(const float* __restrict__ xin, const float* __restrict__ mask, const bf16* __restrict__ w,
                          float* __restrict__ hs, bf16* __restrict__ hbuf, int* __restrict__ ctr, int B, int T, int H,
                          StreamShape S) {
  extern __shared__ __align__(128) unsigned char smem[];
  using F = StreamFwd<1, MT, NO>;
  const int O = (H + 7) / 8, Hp = 8 * O, Hk = (H + 15) / 16 * 16;
  const int c = blockIdx.x % S.Uc, grp = blockIdx.x / S.Uc;
  const int row0 = grp * S.rows, rend = row0 + S.rows, bend = min(rend, B);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const int wm = warp / 4, wn = warp % 4;
  const size_t buf = (size_t)S.R * S.rows * Hk;  // one parity of hbuf [2][R rows][Hk]
  int* my_ctr = ctr + grp * kCtrStride;
  const uint64_t policy = evict_first_policy();

  for (int t = 0; t < T; ++t) {
    if (t > 0) group_wait(my_ctr, S.Uc * t);  // every CTA of the group has written h(t - 1)
    const bf16* hb = hbuf + ((t - 1) & 1) * buf;
    bf16* hn = hbuf + (t & 1) * buf;
    for (int u = c; u < S.U; u += S.Uc) {
      const int ob = u * F::kOcp, n_oct = min(F::kOcp, O - ob);
      for (int r0 = row0; r0 < bend; r0 += F::kMc) {
        float acc[MT][NO][1][4] = {};
        if (t > 0) {  // h(-1) = 0
          stream_fwd_product<1, MT, NO>(acc, hb, Hk, r0, rend, w, (size_t)Hp, Hp, H, ob, n_oct, smem, policy);
        }
        // The update: accumulator element 2 rr + ii is (row g + 8 rr, unit 2 tq + ii) of the tile.
#pragma unroll
        for (int i = 0; i < MT; ++i) {
#pragma unroll
          for (int o = 0; o < NO; ++o) {
            const int j0 = 8 * (ob + wn * NO + o) + 2 * tq;
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              const int b = r0 + wm * 16 * MT + 16 * i + g + 8 * rr;
              if (b >= bend || j0 >= H) continue;
              const size_t row = (size_t)b * T + t, ho = row * H + j0;
              const float m = mask[row];
              float h[2] = {0.f, 0.f};
#pragma unroll
              for (int ii = 0; ii < 2; ++ii) {
                if (j0 + ii >= H) break;
                const float h_raw = tanh_fast(xin[ho + ii] + acc[i][o][0][2 * rr + ii]);
                const float hp = t > 0 ? hs[ho - H + ii] : 0.f;
                h[ii] = m * h_raw + (1.0f - m) * hp;
                hs[ho + ii] = h[ii];
              }
              if (t + 1 < T) *reinterpret_cast<uint32_t*>(hn + (size_t)b * Hk + j0) = pack_bf16(h[0], h[1]);
            }
          }
        }
      }
    }
    if (t + 1 < T) group_arrive(my_ctr);
  }
}

template <int MT, int NO>
cudaError_t launch_fwd_stream(const StreamShape& s, cudaStream_t st, const void* xin, const void* mask, const void* w,
                              void* hs, void* hbuf, void* ctr, int B, int T, int H) {
  return launch_coop(rnn_fwd_stream_kernel<MT, NO>, s.Uc * s.R, StreamFwd<1, MT, NO>::kSmem, st,
                     static_cast<const float*>(xin), static_cast<const float*>(mask), static_cast<const bf16*>(w),
                     static_cast<float*>(hs), static_cast<bf16*>(hbuf), static_cast<int*>(ctr), B, T, H, s);
}

// rnn_bwd_stream_carry_kernel, part 2 of the backward past the grid's
// widths (gru_bwd.cu's gru_bwd_stream_carry_kernel with one gate block and
// rnn_bwd_grid_carry_kernel's step). CTA c of a row group owns the output
// units of its slices: for each item (a slice, a pass of 32 mt rows)
// dpre(t) @ C^T at those units is one product over all Hp columns
// (stream_carry_product: the three bf16 terms of dpre(t) from the
// L2-resident buffer dt[t & 1] [3][R rows][Hp], C's rows of the units by
// k-chunks, term 0's k-steps added in IEEE fp32), so no partial sums cross
// a CTA. What bounds it at config #3's (64, 32, 4096): the pick (8-octet
// slices, 64 slices x 2 row groups of 32 rows, one pass) streams C's 33.6
// MB once a row group a step, and each CTA reads its slice's 0.5 MB of C's
// rows and 0.8 MB of the three terms a step; three products of 2 B H H =
// 2.1e9 operations a step are 6.5 us at 989 TFLOP/s.
// Step t = T-1 .. 0 of the row group:
// - per item, at this thread's pairs, from part 1's coefficient a = m (1 -
//   h_raw^2) (in dxin) and the carry dh of the step after: d = dh + dhs[t],
//   dpre = d a into dxin[t] (exactly 0 on a padded step), d (1 - m) into
//   the thread's slot of `carry` [B][H] (only this thread reads it), and
//   (t > 0) dpre's three exact bf16 terms (split3) into dt[t & 1];
// - the group's barrier (not at t = 0: dh(-1) feeds nothing);
// - per item, the product: s, summed smallest first (acc12 + acc0);
//   dh = d (1 - m) + s.
// No atomics in any sum: the same bits every run.
template <int MT, int NT>
__global__ void __launch_bounds__(32 * kGridWarps, 1)
    rnn_bwd_stream_carry_kernel(const bf16* __restrict__ w, const float* __restrict__ dhs,
                                const float* __restrict__ mask, float* __restrict__ dxin, float* __restrict__ carry,
                                bf16* __restrict__ dt, int* __restrict__ ctr, int B, int T, int H, StreamShape S) {
  extern __shared__ __align__(128) unsigned char smem[];
  using F = StreamCarry<MT, NT>;
  const int O = (H + 7) / 8, K = 8 * O;
  const int c = blockIdx.x % S.Uc, grp = blockIdx.x / S.Uc;
  const int row0 = grp * S.rows, rend = row0 + S.rows, bend = min(rend, B);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const int wm = warp / 4, wn = warp % 4;
  const size_t term = (size_t)S.R * S.rows * K;  // one term of one parity of dt [2][3][R rows][K]
  int* my_ctr = ctr + grp * kCtrStride;
  const uint64_t policy = evict_first_policy();

  for (int t = T - 1; t >= 0; --t) {
    bf16* dtt = dt + (size_t)(t & 1) * 3 * term;
    for (int u = c; u < S.U; u += S.Uc) {
      for (int r0 = row0; r0 < bend; r0 += F::kMc) {
#pragma unroll
        for (int i = 0; i < MT; ++i) {
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const int j0 = 8 * (u * F::kOcp + wn * NT + n) + 2 * tq;
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              const int b = r0 + wm * 16 * MT + 16 * i + g + 8 * rr;
              if (b >= bend || j0 >= H) continue;
              const size_t row = (size_t)b * T + t;
              const float m = mask[row];
              float dpre[2] = {0.f, 0.f};
#pragma unroll
              for (int ii = 0; ii < 2; ++ii) {
                const int j = j0 + ii;
                if (j >= H) break;
                const size_t o = row * H + j, oh = (size_t)b * H + j;
                const float d = (t == T - 1 ? 0.f : carry[oh]) + dhs[o];
                dpre[ii] = d * dxin[o];
                dxin[o] = dpre[ii];
                carry[oh] = d * (1.0f - m);
              }
              if (t == 0) continue;
              __nv_bfloat162 terms[3];
              split3(dpre[0], dpre[1], terms);
              bf16* at = dtt + (size_t)b * K + j0;
#pragma unroll
              for (int e = 0; e < 3; ++e) *reinterpret_cast<__nv_bfloat162*>(at + e * term) = terms[e];
            }
          }
        }
      }
    }
    if (t == 0) break;
    group_arrive(my_ctr);
    group_wait(my_ctr, S.Uc * (T - t));  // every CTA of the group has written step t's terms
    for (int u = c; u < S.U; u += S.Uc) {
      const int ob = u * F::kOcp, n_oct = min(F::kOcp, O - ob);
      for (int r0 = row0; r0 < bend; r0 += F::kMc) {
        float acc0[MT][NT][4] = {}, acc12[MT][NT][4] = {};
        stream_carry_product<MT, NT>(acc0, acc12, dtt, term, K, r0, rend, w, H, ob, n_oct, smem, policy);
        // dh = d (1 - m) + s, the smallest terms first.
#pragma unroll
        for (int i = 0; i < MT; ++i) {
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const int j0 = 8 * (ob + wn * NT + n) + 2 * tq;
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              const int b = r0 + wm * 16 * MT + 16 * i + g + 8 * rr;
#pragma unroll
              for (int ii = 0; ii < 2; ++ii) {
                if (b >= bend || j0 + ii >= H) continue;
                const int ci = 2 * rr + ii;
                carry[(size_t)b * H + j0 + ii] += acc12[i][n][ci] + acc0[i][n][ci];
              }
            }
          }
        }
      }
    }
  }
}

template <int MT, int NT>
cudaError_t launch_carry_stream(const StreamShape& s, cudaStream_t st, const void* w, const void* dhs,
                                const void* mask, void* dxin, void* carry, void* dt, void* ctr, int B, int T, int H) {
  return launch_coop(rnn_bwd_stream_carry_kernel<MT, NT>, s.Uc * s.R, StreamCarry<MT, NT>::kSmem, st,
                     static_cast<const bf16*>(w), static_cast<const float*>(dhs), static_cast<const float*>(mask),
                     static_cast<float*>(dxin), static_cast<float*>(carry), static_cast<bf16*>(dt),
                     static_cast<int*>(ctr), B, T, H, s);
}

// The widest H up to which the cluster kernels take every width (640: past
// it a warp's fragments of C, 40 k-steps, no longer fit its registers).
int cluster_max_hidden() {
  static int limit = -1;
  if (limit < 0) {
    int H = 0;
    while (H < 4096 && takes(H + 1)) ++H;
    limit = H;
  }
  return limit;
}

// The backward's parts around `carry`, which launches part 2 on `s`: the
// coefficients (part 1) before it, dC over the final dxin (part 3) after it;
// blocked (the streamed backward): dC sums its rows in runs
// (recurrent_dw::launch's blocked), as the GRU's streamed dwh does. Part 1
// adds its k-steps in IEEE fp32 on every design (C1).
template <class Carry>
cudaError_t run_parts(const void* xin, const void* mask, const void* cw, const void* hs, void* dxin, void* dc_partial,
                      void* dc, int B, int T, int H, cudaStream_t s, Carry carry, bool blocked = false) {
  const int BT = B * T;
  const dim3 coef_grid((BT + kCoefRows - 1) / kCoefRows, ((H + 7) / 8 + kCoefOct - 1) / kCoefOct);
  auto coef = H % 8 == 0 ? rnn_bwd_coef_kernel<true> : rnn_bwd_coef_kernel<false>;
  coef<<<coef_grid, kCoefThreads, 0, s>>>(static_cast<const float*>(xin), static_cast<const float*>(mask),
                                          static_cast<const bf16*>(cw), static_cast<const float*>(hs),
                                          static_cast<float*>(dxin), BT, T, H);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = carry();
  if (e != cudaSuccess) return e;
  return recurrent_dw::launch(static_cast<const float*>(hs), static_cast<const float*>(dxin),
                              static_cast<float*>(dc_partial), static_cast<float*>(dc), B, T, H, H, s, blocked);
}

}  // namespace

// The largest H up to which the cluster and grid-resident kernels take
// every width: the clusters up to cluster_max_hidden() (640), the grid past
// it, both directions (3168: past it the forward's slice of three octets no
// longer fits a CTA's shared memory beside four, and three octets a CTA need
// more CTAs than the card has SMs); the streamed kernels take every H past
// it.
extern "C" int rnn_max_hidden() {
  static int limit = -1;
  if (limit < 0) {
    int H = cluster_max_hidden();
    while (H < 8192 && grid_shape(1, H + 1, false, 1).ocp > 0 && grid_shape(1, H + 1, true, 1).ocp > 0) ++H;
    limit = H;
  }
  return limit;
}

// The grid the grid-resident kernels run a batch of B rows of width H on
// (the forward's, bwd = 0, or the backward carry's): out[0..3] = octets a
// CTA, unit slices, row groups, rows a group. Returns 0 (out untouched)
// where no grid takes H.
extern "C" int rnn_grid_shape(int B, int H, int bwd, int* out) {
  const GridShape s = grid_shape(B, H, bwd != 0, 1);
  if (s.ocp == 0) return 0;
  out[0] = s.ocp;
  out[1] = s.U;
  out[2] = s.R;
  out[3] = s.rows;
  return 1;
}

// Number of partial dC sums the wrapper allocates ([splits, H, H] fp32).
extern "C" int rnn_bwd_splits(int B, int T, int H) { return recurrent_dw::num_splits(B * T, H, H); }

// The forward's cluster size for (B, H) (1, 2, 4, 8 or 16), or 0 when no
// cluster takes H.
extern "C" int rnn_fwd_cluster_size(int B, int H) { return fwd_pick(B, H); }

// The forward's rows a group (8 or 16) for a batch of B on a cluster of C.
extern "C" int rnn_fwd_group_rows(int B, int C) { return rows_a_group(B, C); }

// Whether a cluster of C blocks a group of R rows takes width H in the forward.
extern "C" int rnn_fwd_fits(int H, int C, int R) { return fwd_fits(H, C, R) ? 1 : 0; }

// The backward carry's cluster size for width H (1, 2, 4, 8 or 16), or 0
// when no cluster takes H.
extern "C" int rnn_bwd_cluster_size(int H) { return carry_pick(H); }

// Whether a cluster of C blocks a row group takes width H in the backward carry.
extern "C" int rnn_bwd_fits(int H, int C) { return carry_fits(H, C) ? 1 : 0; }

// cluster, rows: 0 runs the kernel's own pick (the wrapper's); otherwise
// that cluster size (1, 2, 4, 8, 16) and rows a group (8, 16) where they
// fit, else cudaErrorInvalidValue (chip_smoke.py times each to measure the
// pick).
extern "C" int rnn_fwd(const void* xin, const void* mask, const void* cw, void* hs, int B, int T, int H, int cluster,
                       int rows, int device, void* stream) {
  const int c = cluster > 0 ? cluster : fwd_pick(B, H);
  const int r = rows > 0 ? rows : rows_a_group(B, c);
  if (H > cluster_max_hidden() || c == 0 || !fwd_fits(H, c, r)) return cudaErrorInvalidValue;
  if (B <= 0 || T <= 0) return cudaSuccess;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H % 4 == 0) {
    return r == 8 ? launch_fwd_k<8, true>(xin, mask, cw, hs, B, T, H, c, device, s)
                  : launch_fwd_k<16, true>(xin, mask, cw, hs, B, T, H, c, device, s);
  }
  return r == 8 ? launch_fwd_k<8, false>(xin, mask, cw, hs, B, T, H, c, device, s)
                : launch_fwd_k<16, false>(xin, mask, cw, hs, B, T, H, c, device, s);
}

// cluster: 0 runs the carry's own pick (the wrapper's); 1, 2, 4, 8 or 16
// forces that cluster size where it fits, else cudaErrorInvalidValue
// (chip_smoke.py times each to measure the pick).
extern "C" int rnn_bwd(const void* xin, const void* mask, const void* cw, const void* hs, const void* dhs,
                       void* dxin, void* dc_partial, void* dc, int B, int T, int H, int cluster, int device,
                       void* stream) {
  const int c = cluster > 0 ? cluster : carry_pick(H);
  if (H > cluster_max_hidden() || c == 0 || !carry_fits(H, c) || B <= 0 || T <= 0) return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return run_parts(xin, mask, cw, hs, dxin, dc_partial, dc, B, T, H, s, [&]() {
    return rows_a_group(B, c) == 8 ? launch_carry_k<8>(cw, mask, dhs, dxin, B, T, H, c, device, s)
                                   : launch_carry_k<16>(cw, mask, dhs, dxin, B, T, H, c, device, s);
  });
}

// The forward on the grid (rnn_fwd_grid_kernel), for the widths past the
// clusters'. hbuf: [2][R rows][Hk] bf16 zeros, ctr: R * 32 int32 zeros
// (rnn_grid_shape(B, H, 0)'s R and rows); both the caller's, left dirty.
// cudaErrorInvalidValue where no grid takes H.
extern "C" int rnn_fwd_grid(const void* xin, const void* mask, const void* cw, void* hs, void* hbuf, void* ctr, int B,
                            int T, int H, int device, void* stream) {
  const GridShape g = grid_shape(B, H, false, 1);
  if (g.ocp == 0) return cudaErrorInvalidValue;
  if (B <= 0 || T <= 0) return cudaSuccess;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  return launch_grid(rnn_fwd_grid_kernel, g, grid_slice_bytes(H, g.ocp, false, 1), static_cast<cudaStream_t>(stream),
                     static_cast<const float*>(xin), static_cast<const float*>(mask), static_cast<const bf16*>(cw),
                     static_cast<float*>(hs), static_cast<bf16*>(hbuf), static_cast<int*>(ctr), B, T, H, g);
}

// The backward with part 2 on the grid (rnn_bwd_grid_carry_kernel), for the
// widths past the clusters'. dt: [2][3][R rows][Hk] bf16 zeros, ctr: R * 32
// int32 zeros (rnn_grid_shape(B, H, 1)'s R and rows), carry: [B][H] fp32;
// all the caller's, left dirty. cudaErrorInvalidValue where no grid takes H.
extern "C" int rnn_bwd_grid(const void* xin, const void* mask, const void* cw, const void* hs, const void* dhs,
                            void* dxin, void* dc_partial, void* dc, void* dt, void* ctr, void* carry, int B, int T,
                            int H, int device, void* stream) {
  const GridShape g = grid_shape(B, H, true, 1);
  if (g.ocp == 0 || B <= 0 || T <= 0) return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return run_parts(xin, mask, cw, hs, dxin, dc_partial, dc, B, T, H, s, [&]() {
    return launch_grid(rnn_bwd_grid_carry_kernel, g, grid_slice_bytes(H, g.ocp, true, 1), s,
                       static_cast<const bf16*>(cw), static_cast<const float*>(dhs), static_cast<const float*>(mask),
                       static_cast<float*>(dxin), static_cast<float*>(carry), static_cast<bf16*>(dt),
                       static_cast<int*>(ctr), B, T, H, g);
  });
}

// The grid the streamed kernels run a batch of B rows of width H on (the
// forward's, bwd = 0, or the carry's; grid_stream.cuh's stream_shape):
// out[0..5] = octets a slice, unit slices, CTAs a row group, row groups,
// rows a group, mt (32 mt rows a pass). Returns 0 (out untouched) at H <= 0.
extern "C" int rnn_stream_shape(int B, int H, int bwd, int* out) {
  return stream_shape_out(B, H, bwd != 0, out);
}

// The forward streamed (rnn_fwd_stream_kernel), any H >= 1. w: C with its
// columns padded to Hp = 8 ceil(H / 8), [H][Hp] bf16 (C itself where H % 8
// == 0); hbuf: [2][R rows][Hk] bf16 zeros, ctr: R * 32 int32 zeros
// (rnn_stream_shape(B, H, 0)'s R and rows); both the caller's, left dirty.
// cudaErrorInvalidValue at H <= 0.
extern "C" int rnn_fwd_stream(const void* xin, const void* mask, const void* w, void* hs, void* hbuf, void* ctr, int B,
                              int T, int H, int device, void* stream) {
  const StreamShape s = stream_shape(B, H, false);
  if (s.ocp == 0) return cudaErrorInvalidValue;
  if (B <= 0 || T <= 0) return cudaSuccess;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool two = s.ocp == 8;  // two octets a warp
  switch (s.mt) {
    case 1: return two ? launch_fwd_stream<1, 2>(s, st, xin, mask, w, hs, hbuf, ctr, B, T, H)
                       : launch_fwd_stream<1, 1>(s, st, xin, mask, w, hs, hbuf, ctr, B, T, H);
    case 2: return two ? launch_fwd_stream<2, 2>(s, st, xin, mask, w, hs, hbuf, ctr, B, T, H)
                       : launch_fwd_stream<2, 1>(s, st, xin, mask, w, hs, hbuf, ctr, B, T, H);
    default: return two ? launch_fwd_stream<4, 2>(s, st, xin, mask, w, hs, hbuf, ctr, B, T, H)
                        : launch_fwd_stream<4, 1>(s, st, xin, mask, w, hs, hbuf, ctr, B, T, H);
  }
}

// The backward with part 2 streamed (rnn_bwd_stream_carry_kernel) and dC
// summed in runs, any H >= 1. cw: C [H][H] bf16 (the coefficient pass's); w:
// C with its columns padded to Hp, [H][Hp] (C itself where H % 8 == 0); dt:
// [2][3][R rows][Hp] bf16 zeros, ctr: R * 32 int32 zeros
// (rnn_stream_shape(B, H, 1)'s R and rows), carry: [B][H] fp32; all the
// caller's, left dirty. cudaErrorInvalidValue at H <= 0 or an empty batch.
extern "C" int rnn_bwd_stream(const void* xin, const void* mask, const void* cw, const void* hs, const void* dhs,
                              void* dxin, void* dc_partial, void* dc, const void* w, void* dt, void* ctr, void* carry,
                              int B, int T, int H, int device, void* stream) {
  const StreamShape g = stream_shape(B, H, true);
  if (g.ocp == 0 || B <= 0 || T <= 0) return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return run_parts(xin, mask, cw, hs, dxin, dc_partial, dc, B, T, H, s, [&]() {
    const bool four = g.ocp == 16;  // four octets a warp
    if (g.mt == 1) {
      return four ? launch_carry_stream<1, 4>(g, s, w, dhs, mask, dxin, carry, dt, ctr, B, T, H)
                  : launch_carry_stream<1, 2>(g, s, w, dhs, mask, dxin, carry, dt, ctr, B, T, H);
    }
    return four ? launch_carry_stream<2, 4>(g, s, w, dhs, mask, dxin, carry, dt, ctr, B, T, H)
                : launch_carry_stream<2, 2>(g, s, w, dhs, mask, dxin, carry, dt, ctr, B, T, H);
  }, true);
}
