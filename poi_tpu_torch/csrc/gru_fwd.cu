// GRU forward recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel poi_tpu/ops/fused_gru.py:_fwd_kernel (driven by
// fused_gru_scan/_fwd, through _gates): the whole T-step recurrence in one
// launch, h0 = 0, with the padding mask already folded into the z block of
// xw as -1e9.
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
// is a small [B, H] x [H, 3H] product (B=512, H=128: 50 MFLOP a step), so a
// step's time is its latency: the product, the gate update, the exchange of
// the new h across the CTAs that share a row group. The bytes (xw in, hs
// out) and the FLOPs, spread over the whole card, take a few microseconds.
//
// Design: the forward of csrc/gru_bwd.cu's carry kernel, with no barrier in
// the step.
// - A cluster of C CTAs owns a group of R = 16 batch rows (the mma's M);
//   rows past B compute on zeros and store nothing. The H units are cut into
//   octets of 8 (the mma's N); CTA p owns octets [p*O/C, (p+1)*O/C) of
//   O = ceil(H/8) and keeps their z, r and n columns of wh, [Hk, 24 an
//   octet] bf16 (Hk = H rounded up to 16; padding zero), in shared memory;
//   up to Hk = 256 each warp holds its octet's slice as mma B fragments in
//   registers (up to 16 k-steps x 3 n-tiles x 2).
// - Consumer warp w of CTA p owns octet p*O/C + w. Its z, r and n
//   accumulator tiles hold the same (row, unit) positions, so the gate
//   update runs in registers, and the fp32 carry h of its 16 rows x 8 units
//   stays in those registers, in the accumulator layout, for the sequence.
// - A step: wait for xw[t] (the ring below) and for h(t-1) (the h buffer's
//   mbarrier); hw = bf16(h) @ wh on mma.sync m16n8k16 (exact bf16 products
//   summed in fp32, the TPU kernel's arithmetic; h is rounded to bf16 by
//   contract, so one term suffices), in two chains a gate (even and odd
//   k-steps) added at the end; the gate update with sigmoid and tanh from
//   ex2.approx and rcp.approx (cluster_carry.cuh's sigmoid_fast, tanh_fast:
//   branch-free, so a thread's four pairs interleave; each within a few fp32
//   ulp); bf16(h) into the next h buffer
//   of every CTA of the cluster by st.async, which counts its bytes on that
//   CTA's mbarrier; fp32 h out to hs.
// - The h buffers are double-buffered by step parity, each with an
//   mbarrier armed for the bytes of one step (every octet's 16 x 8 bf16).
//   No barrier is needed for their reuse: a CTA can only compute h(t+1),
//   and so write a buffer that holds h(t-1), once every warp of every CTA
//   has sent h(t), which each sends after reading h(t-1).
// - A producer warp streams xw in with one TMA copy a step and CTA (a box
//   [16 rows][z, r, n][the CTA's units] of xw seen as [B][T][3][H], zero past
//   B and H) into a ring of up to 4 slots on full / empty mbarriers, up to
//   three steps ahead. A consumer fences its generic reads of a slot against
//   the async proxy (fence.proxy.async) before it releases the slot: without
//   the fence the next bulk write overtook the reads when many CTAs shared
//   an SM. A width that is no multiple of 4 moves xw by 4-byte cp.async.
// - No atomics: a second launch gives the same bits. hw is no longer one
//   chain over k and the gates are approximated, so csrc/gru_bwd.cu's
//   recompute (IEEE sigmoidf/tanhf, one chain) matches these gates to fp32
//   rounding, not bit for bit.
// - Padded steps: the folded -1e9 gives ex2(+inf) = inf and rcp(inf) = 0,
//   so z = 0 exactly and h passes through unchanged.
// - C: the smallest of 1, 2, 4, 8, 16 whose CTAs hold at most 4 octets each
//   (else the smallest that fits). chip_smoke.py times every cluster that
//   fits at the serve shapes (batch 1 and 256, H = 64), the bench shape and
//   config #4's (`gru_fwd cluster choice`): 4 octets a CTA was the fastest
//   at each but the bench shape, where 8 (C = 2) was 3-7% faster, and a
//   single CTA, with no exchange outside the SM, was not faster at batch 1.
//   Any H up to 640; a ragged H zero-pads the last octet and K.
//
// Past 640 no cluster holds wh, and gru_fwd_grid runs gru_fwd_grid_kernel
// (below, and csrc/grid_carry.cuh): the whole card as R row groups x U
// unit slices, one CTA an SM, each CTA's z, r, n columns of wh in its shared
// memory, bf16(h) exchanged through an L2-resident buffer behind a step
// barrier of the row group, any H up to gru_max_hidden() (2064).
//
// An H that neither design takes is refused (cudaErrorInvalidValue); the
// Python wrapper raises a clear error first (ops/fused_gru.py design).
//
// The entry point launches on the given stream, does not synchronise and
// allocates nothing; it returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_carry.cuh"

namespace {

constexpr int kRows = 16;      // batch rows a group: the mma's M
constexpr int kMaxWarps = 8;   // unit octets (= consumer warps) a CTA at most
constexpr int kPickOct = 4;    // unit octets a CTA of the cluster the kernel picks
constexpr int kMaxSlots = 4;   // xw ring slots: steps t .. t + 3 (fewer where they do not fit)

// The shared-memory layout of one CTA for width H on a cluster of C.
struct FwdLayout {
  int O;    // unit octets, ceil(H / 8)
  int ocp;  // octets a CTA at most, ceil(O / C): its consumer warps
  int Hk;   // H rounded up to 16: the product's K
  int ldb;  // bf16 row stride of the wh slice [Hk][24 ocp] (+ 8: conflict-free ldmatrix)
  int lda;  // bf16 row stride of the h buffers [2][16][Hk] (+ 8)
  int xu;   // units of an xw slot's gate block: the CTA's 8 ocp (+ 4, for the banks)
  int xs;   // fp32 row stride of an xw slot [16][z | r | n][xu]: 3 xu
  int slots;
  int a_off, x_off, bar_off, bytes;
};

__host__ __device__ inline FwdLayout fwd_layout(int H, int C) {
  FwdLayout L;
  L.O = (H + 7) / 8;
  L.ocp = (L.O + C - 1) / C;
  L.Hk = (H + 15) / 16 * 16;
  L.ldb = 24 * L.ocp + 8;
  L.lda = L.Hk + 8;
  L.xu = 8 * L.ocp + 4;
  L.xs = 3 * L.xu;
  L.a_off = L.Hk * L.ldb * 2;                                       // wh slice [Hk][ldb] bf16 at 0
  L.x_off = (L.a_off + 2 * kRows * L.lda * 2 + 127) / 128 * 128;    // h buffers [2][16][lda] bf16
  for (L.slots = kMaxSlots; L.slots > 2; --L.slots) {  // xw ring [slots][16][xs] fp32 (128-byte slots)
    if (L.x_off + L.slots * kRows * L.xs * 4 + (2 + 2 * kMaxSlots) * 8 <= kMaxSmem) break;
  }
  L.bar_off = L.x_off + L.slots * kRows * L.xs * 4;
  L.bytes = L.bar_off + (2 + 2 * kMaxSlots) * 8;  // mbarriers: h buffers, ring full, ring empty
  return L;
}

bool fwd_fits(int H, int C) {
  if (H <= 0) return false;
  const FwdLayout L = fwd_layout(H, C);
  return C <= L.O && L.ocp <= kMaxWarps && L.bytes <= kMaxSmem;
}

// The cluster: the smallest of 1, 2, 4, 8, 16 that fits with at most
// kPickOct octets a CTA (as measured; see the header), else the smallest
// that fits; 0 when none does.
int fwd_pick(int H) {
  int fit = 0;
  for (int c = 1; c <= 16; c *= 2) {
    if (!fwd_fits(H, c)) continue;
    if (fit == 0) fit = c;
    if (fwd_layout(H, c).ocp <= kPickOct) return c;
  }
  return fit;
}

// One cluster of C CTAs a group of 16 rows; blockDim = 32 (ocp + 1): warps
// 0 .. ocp-1 own the CTA's octets (consumers), warp ocp is the producer.
// kRegK > 0: wh's fragments sit in registers (Hk <= 16 kRegK), else each
// step loads them from the shared slice. kVec: H % 4 == 0, so xw moves by one
// TMA copy a step (xmap: xw as [B][T][3][H]), else by 4-byte cp.async.
template <int kRegK, bool kVec>
__global__ void __launch_bounds__(32 * (kMaxWarps + 1))
    gru_fwd_kernel(const __grid_constant__ CUtensorMap xmap, const float* __restrict__ xw, const bf16* __restrict__ wh,
                   float* __restrict__ hs, int B, int T, int H, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  const FwdLayout L = fwd_layout(H, C);
  const int Hk = L.Hk, KS = Hk / 16, H3 = 3 * H, ocp = L.ocp;
  const int p = C > 1 ? static_cast<int>(cta_rank()) : 0;
  const int grp = blockIdx.x / C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const int ob = p * L.O / C, n_oct = (p + 1) * L.O / C - ob;
  const bool owner = warp < n_oct;        // warp-uniform: this warp owns octet ob + warp
  const bool producer = warp == ocp;      // warp-uniform: this warp moves xw in
  bf16* slice = reinterpret_cast<bf16*>(smem);
  bf16* abuf = reinterpret_cast<bf16*>(smem + L.a_off);
  float* xring = reinterpret_cast<float*>(smem + L.x_off);
  uint64_t* hbar = reinterpret_cast<uint64_t*>(smem + L.bar_off);  // [2]: bf16(h) of the cluster arrived in buffer b
  uint64_t* full = hbar + 2;                                         // [slots]: xw of a step landed in slot s
  uint64_t* empty = full + kMaxSlots;                                // [slots]: slot s read by every owner warp
  const int S = L.slots;
  const uint32_t slice_a = shared_addr(slice), abuf_a = shared_addr(abuf), hbar_a = shared_addr(hbar);

  // The wh slice: local column lc = 24 lo + 8 gate + u is column
  // gate * H + 8 (ob + lo) + u of wh, zero past H and past the CTA's octets;
  // the h buffers (h0 = 0; K's padding stays zero) and the xw ring (rows past
  // B and units past H stay zero) zero.
  if (H % 8 == 0) {  // a gate's octet is 16 aligned bytes of a wh row
    for (int i = threadIdx.x; i < Hk * 3 * ocp; i += blockDim.x) {
      const int k = i / (3 * ocp), lo = (i % (3 * ocp)) / 3, q = i % 3;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (k < H && lo < n_oct) v = *reinterpret_cast<const uint4*>(wh + (size_t)k * H3 + q * H + 8 * (ob + lo));
      *reinterpret_cast<uint4*>(slice + k * L.ldb + 24 * lo + 8 * q) = v;
    }
  } else {
    for (int i = threadIdx.x; i < Hk * 24 * ocp; i += blockDim.x) {
      const int k = i / (24 * ocp), lc = i % (24 * ocp);
      const int lo = lc / 24, j = 8 * (ob + lo) + lc % 8;
      const bool ok = k < H && lo < n_oct && j < H;
      slice[k * L.ldb + lc] = ok ? wh[(size_t)k * H3 + ((lc % 24) / 8) * H + j] : __float2bfloat16(0.f);
    }
  }
  for (int i = threadIdx.x; i < (L.bar_off - L.a_off) / 16; i += blockDim.x) {
    reinterpret_cast<uint4*>(smem + L.a_off)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  // The bytes of bf16(h) a step brings to each CTA: every octet's 16 x 8.
  const uint32_t h_bytes = L.O * kRows * 8 * 2;
  if (threadIdx.x == 0) {
    mbar_init(&hbar[0], 1);
    mbar_init(&hbar[1], 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], kVec ? 1 : 32);
      mbar_init(&empty[s], n_oct);
    }
    mbar_init_fence();
    // h(0) lands in buffer 1, h(1) in buffer 0 (h(T - 1) is never sent).
    if (T > 1) mbar_arrive_expect_tx(&hbar[1], h_bytes);
    if (T > 2) mbar_arrive_expect_tx(&hbar[0], h_bytes);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the zeros before any bulk copy
  __syncthreads();

  float h[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  // Every CTA of the cluster runs, its barriers armed, before the first remote store.
  if (C > 1) {
    cluster_arrive();
    cluster_wait();
  }

  if (producer) {
    // xw of step t (the group's rows, the CTA's units) into ring slot
    // t % S, S - 1 steps ahead of the owners, once they have read
    // the slot's last step: one TMA box [16 rows][z, r, n][xu units] (zero
    // past B and H), or every 32nd element a lane by cp.async.
    const int nu = min(8 * n_oct, H - 8 * ob), u0 = 8 * ob;  // the CTA's units [u0, u0 + nu) below H
    const int rows = min(kRows, B - grp * kRows);
    for (int t = 0; t < T; ++t) {
      const int s = t % S;
      if (t >= S) mbar_wait(&empty[s], (t / S - 1) & 1);
      float* slot = xring + s * kRows * L.xs;
      if constexpr (kVec) {
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[s], kRows * L.xs * 4);
          tma_load_4d(slot, &xmap, u0, 0, t, grp * kRows, &full[s]);
        }
      } else {
        for (int e = lane; e < 3 * rows * nu; e += 32) {
          const int r = e / (3 * nu), q = (e / nu) % 3, u = e % nu;
          cp_async4(slot + r * L.xs + q * L.xu + u, xw + ((size_t)(grp * kRows + r) * T + t) * H3 + q * H + u0 + u,
                    true);
        }
        cp_async_arrive(&full[s]);
      }
    }
  } else if (owner) {
    // B fragments of the warp's z, r, n n-tiles at k-step kb.
    auto load_b = [&](uint32_t (&b)[3][2], int kb) {
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        ldsm_x2_trans(b[q][0], b[q][1], slice_a + ((kb * 16 + lane % 16) * L.ldb + warp * 24 + q * 8) * 2);
      }
    };
    uint32_t breg[kRegK > 0 ? kRegK : 1][3][2];
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
      for (int ii = 0; ii < 2; ++ii) ok[rr][ii] = grp * kRows + g + 8 * rr < B && j0 + ii < H;
    }
    // fp32 h of step t out to hs at the thread's pairs.
    auto store_hs = [&](int t) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float* dst = hs + ((size_t)(grp * kRows + g + 8 * rr) * T + t) * H + j0;
        if (ok[rr][1] && H % 2 == 0) {
          *reinterpret_cast<float2*>(dst) = make_float2(h[rr][0], h[rr][1]);
        } else {
          if (ok[rr][0]) dst[0] = h[rr][0];
          if (ok[rr][1]) dst[1] = h[rr][1];
        }
      }
    };
    for (int t = 0; t < T; ++t) {
      // xw of step t at the thread's pairs: rows g (+ 8), units 2 tq (+ 1) of its octet.
      const int s = t % S;
      mbar_wait(&full[s], (t / S) & 1);
      const float* xr = xring + s * kRows * L.xs + g * L.xs + 8 * warp + 2 * tq;
      float2 x[2][3];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
        for (int q = 0; q < 3; ++q) x[rr][q] = *reinterpret_cast<const float2*>(xr + rr * 8 * L.xs + q * L.xu);
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
      // hw = bf16(h) @ wh: two mma chains a gate (even and odd k-steps),
      // added at the end, the next k-step's A fragment loaded ahead.
      float acc[2][3][4];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
#pragma unroll
        for (int q = 0; q < 3; ++q) acc[c][q][0] = acc[c][q][1] = acc[c][q][2] = acc[c][q][3] = 0.f;
      }
      const uint32_t a_cur = abuf_a + (t & 1) * kRows * L.lda * 2;
      uint32_t a[2][4];
      load_a_frag<kRows>(a[0], a_cur, L.lda, 0, lane);
      if constexpr (kRegK > 0) {
#pragma unroll
        for (int kb = 0; kb < kRegK; ++kb) {
          if (kb < KS) {
            if (kb + 1 < KS) load_a_frag<kRows>(a[(kb + 1) & 1], a_cur, L.lda, (kb + 1) * 16, lane);
#pragma unroll
            for (int q = 0; q < 3; ++q) mma_bf16(acc[kb & 1][q], a[kb & 1], breg[kb][q][0], breg[kb][q][1]);
          }
        }
      } else {
        uint32_t b[2][3][2];
        load_b(b[0], 0);
        for (int kb = 0; kb < KS; kb += 2) {  // two k-steps a turn, so the fragments' registers stay named
          const bool two = kb + 1 < KS;
          if (two) {
            load_a_frag<kRows>(a[1], a_cur, L.lda, (kb + 1) * 16, lane);
            load_b(b[1], kb + 1);
          }
#pragma unroll
          for (int q = 0; q < 3; ++q) mma_bf16(acc[0][q], a[0], b[0][q][0], b[0][q][1]);
          if (kb + 2 < KS) {
            load_a_frag<kRows>(a[0], a_cur, L.lda, (kb + 2) * 16, lane);
            load_b(b[0], kb + 2);
          }
          if (two) {
#pragma unroll
            for (int q = 0; q < 3; ++q) mma_bf16(acc[1][q], a[1], b[1][q][0], b[1][q][1]);
          }
        }
      }
      // The gate update in registers: accumulator element 2 rr + ii is (row
      // g + 8 rr, unit j0 + ii); then bf16(h) into every CTA's next buffer
      // (not after the last step) and fp32 h out.
      const uint32_t a_next = abuf_a + ((t + 1) & 1) * kRows * L.lda * 2, bar_next = hbar_a + ((t + 1) & 1) * 8;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const int ci = 2 * rr + ii;
          const float xz = ii ? x[rr][0].y : x[rr][0].x, xrg = ii ? x[rr][1].y : x[rr][1].x;
          const float xn = ii ? x[rr][2].y : x[rr][2].x;
          const float z = sigmoid_fast(xz + (acc[0][0][ci] + acc[1][0][ci]));
          const float rg = sigmoid_fast(xrg + (acc[0][1][ci] + acc[1][1][ci]));
          const float n = tanh_fast(xn + rg * (acc[0][2][ci] + acc[1][2][ci]));
          h[rr][ii] = (1.0f - z) * h[rr][ii] + z * n;
        }
        if (t + 1 < T) {
          const uint32_t v = pack_bf16(h[rr][0], h[rr][1]);
          const uint32_t at = a_next + ((g + 8 * rr) * L.lda + j0) * 2;
          for (int q = 0; q < C; ++q) st_async_u32(at, bar_next, q, v);
        }
      }
      store_hs(t);
    }
  }
  // No CTA leaves while another may still store into its shared memory.
  if (C > 1) {
    cluster_arrive();
    cluster_wait();
  }
}

template <int kRegK, bool kVec>
cudaError_t launch(const void* xw, const void* wh, void* hs, int B, int T, int H, int C, int device, cudaStream_t s) {
  const FwdLayout L = fwd_layout(H, C);
  auto kernel = gru_fwd_kernel<kRegK, kVec>;
  // Once an instantiation and device (a host call each launch cost
  // microseconds at batch 1): the largest shared-memory opt-in, clusters of 16.
  static uint64_t attributes_set = 0;
  if (device >= 64 || !(attributes_set >> device & 1)) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e == cudaSuccess) e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    if (device < 64) attributes_set |= uint64_t{1} << device;
  }
  CUtensorMap xmap = {};
  if (kVec) {
    // xw as [B][T][3][H] fp32; a box is [16][1][3][xu], zero past B and H.
    cuuint64_t dims[4] = {static_cast<cuuint64_t>(H), 3, static_cast<cuuint64_t>(T), static_cast<cuuint64_t>(B)};
    cuuint64_t strides[3] = {static_cast<cuuint64_t>(H) * 4, static_cast<cuuint64_t>(H) * 12,
                             static_cast<cuuint64_t>(H) * 12 * T};
    cuuint32_t box[4] = {static_cast<cuuint32_t>(L.xu), 3, 1, kRows};
    cuuint32_t elem[4] = {1, 1, 1, 1};
    if (cuTensorMapEncodeTiled(&xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(xw), dims, strides, box,
                               elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                               CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
      return cudaErrorInvalidValue;
    }
  }
  const int groups = (B + kRows - 1) / kRows;
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
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, xmap, static_cast<const float*>(xw), static_cast<const bf16*>(wh),
                         static_cast<float*>(hs), B, T, H, C);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// ---------------------------------------------------------------- past the cluster: the grid
//
// gru_fwd_grid_kernel, for the widths no cluster takes (grid_carry.cuh has
// the grid, the barrier and the fragment loads). CTA (r, u) of the R x U
// grid keeps the z, r and n columns of wh for its unit octets, [Hk][24 ocp
// + 8] bf16 with the k-steps' rows permuted (kperm), in shared memory. A
// step: wait on the row group's barrier for h(t - 1); per task (a 16-row
// tile, up to kTaskOct octets), hw = bf16(h(t - 1)) @ wh on mma.sync
// m16n8k16, A straight from the L2-resident buffer hbuf[(t - 1) & 1] (zero
// rows past B and zero columns past H: the wrapper zeroes it, and no CTA
// writes there), kGridPf k-steps of fragments loaded ahead; the gate update
// of the forward above (sigmoid_fast, tanh_fast, h = (1 - z) h + z n) with
// the fp32 h(t - 1) read back from hs (this thread wrote it); fp32 h out to
// hs, bf16(h) to hbuf[t & 1]; then arrive. Padded steps: z = 0 exactly
// from the folded -1e9, so h passes through. No atomics in any sum: a
// second launch gives the same bits.
constexpr int kGridPf = 4;  // k-steps of A fragments loaded ahead

__global__ void __launch_bounds__(32 * kGridWarps, 1)
    gru_fwd_grid_kernel(const float* __restrict__ xw, const bf16* __restrict__ wh, float* __restrict__ hs,
                        bf16* __restrict__ hbuf, int* __restrict__ ctr, int B, int T, int H, GridShape S) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int O = (H + 7) / 8, Hk = (H + 15) / 16 * 16, KS = Hk / 16, H3 = 3 * H, ldb = 24 * S.ocp + 8;
  const int u = blockIdx.x % S.U, grp = blockIdx.x / S.U;
  const int ob = u * O / S.U, n_oct = (u + 1) * O / S.U - ob;
  const int row0 = grp * S.rows, n_rt = (min(S.rows, B - row0) + 15) / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const size_t buf = (size_t)S.R * S.rows * Hk;  // one parity of hbuf [2][R rows][Hk]
  int* my_ctr = ctr + grp * kCtrStride;
  int ng, gs;
  grid_tasks(n_rt, n_oct, ng, gs);

  // The wh slice: physical row p of a k-step holds wh row k = kperm(p)
  // (zero past H); local column 24 lo + 8 gate + u is column gate * H +
  // 8 (ob + lo) + u (zero past H and past the CTA's octets).
  bf16* slice = reinterpret_cast<bf16*>(smem);
  if (H % 8 == 0) {
    for (int i = threadIdx.x; i < Hk * 3 * S.ocp; i += blockDim.x) {
      const int p = i / (3 * S.ocp), lo = (i % (3 * S.ocp)) / 3, q = i % 3, k = (p & ~15) + kperm(p & 15);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (k < H && lo < n_oct) v = *reinterpret_cast<const uint4*>(wh + (size_t)k * H3 + q * H + 8 * (ob + lo));
      *reinterpret_cast<uint4*>(slice + p * ldb + 24 * lo + 8 * q) = v;
    }
  } else {
    for (int i = threadIdx.x; i < Hk * 24 * S.ocp; i += blockDim.x) {
      const int p = i / (24 * S.ocp), lc = i % (24 * S.ocp), k = (p & ~15) + kperm(p & 15);
      const int lo = lc / 24, j = 8 * (ob + lo) + lc % 8;
      const bool ok = k < H && lo < n_oct && j < H;
      slice[p * ldb + lc] = ok ? wh[(size_t)k * H3 + ((lc % 24) / 8) * H + j] : __float2bfloat16(0.f);
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
      // This thread's pairs: rows r0 + g (+ 8), units 8 (ob + lo0 + lo) + 2 tq (+ 1); xw of step t and the
      // fp32 h(t - 1) there, loaded ahead of the product.
      float x[kTaskOct][2][2][3], hp[kTaskOct][2][2];
#pragma unroll
      for (int lo = 0; lo < kTaskOct; ++lo) {
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
          for (int ii = 0; ii < 2; ++ii) {
            const int b = r0 + g + 8 * rr, j = 8 * (ob + lo0 + lo) + 2 * tq + ii;
            const bool ok = lo < no && b < B && j < H;
            const size_t xo = ((size_t)b * T + t) * H3 + j;
#pragma unroll
            for (int q = 0; q < 3; ++q) x[lo][rr][ii][q] = ok ? xw[xo + q * H] : 0.f;
            hp[lo][rr][ii] = ok && t > 0 ? hs[((size_t)b * T + t - 1) * H + j] : 0.f;
          }
        }
      }
      float acc[kTaskOct][3][4];
#pragma unroll
      for (int lo = 0; lo < kTaskOct; ++lo) {
#pragma unroll
        for (int q = 0; q < 3; ++q) acc[lo][q][0] = acc[lo][q][1] = acc[lo][q][2] = acc[lo][q][3] = 0.f;
      }
      if (t > 0) {  // h(-1) = 0
        const bf16* ra = hb + (size_t)(r0 + g) * Hk + 4 * tq;
        grid_fwd_product<3, kGridPf>(acc, ra, ra + 8 * Hk, KS, slice_a, ldb, lo0, no, lane);
      }
      // The gate update: accumulator element 2 rr + ii is (row g + 8 rr, unit 2 tq + ii).
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
            const int ci = 2 * rr + ii;
            const float z = sigmoid_fast(x[lo][rr][ii][0] + acc[lo][0][ci]);
            const float rg = sigmoid_fast(x[lo][rr][ii][1] + acc[lo][1][ci]);
            const float n = tanh_fast(x[lo][rr][ii][2] + rg * acc[lo][2][ci]);
            h[ii] = (1.0f - z) * hp[lo][rr][ii] + z * n;
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

}  // namespace

// The grid the grid-resident kernels run a batch of B rows of width H on
// (the forward's, bwd = 0, or the backward carry's): out[0..3] = octets a
// CTA, unit slices, row groups, rows a group. Returns 0 (out untouched)
// where no grid takes H.
extern "C" int gru_grid_shape(int B, int H, int bwd, int* out) {
  const GridShape s = grid_shape(B, H, bwd != 0, 3);
  if (s.ocp == 0) return 0;
  out[0] = s.ocp;
  out[1] = s.U;
  out[2] = s.R;
  out[3] = s.rows;
  return 1;
}

// The widest H the GRU pair takes, every narrower one with it: the cluster
// kernels up to 640, the grid-resident ones past it (both directions).
extern "C" int gru_max_hidden() {
  static int limit = -1;
  if (limit < 0) {
    int H = 0;
    while (H < 8192 && (fwd_pick(H + 1) > 0 || grid_shape(1, H + 1, false, 3).ocp > 0) &&
           (pick_cluster(1, H + 1, 3) > 0 || grid_shape(1, H + 1, true, 3).ocp > 0)) {
      ++H;
    }
    limit = H;
  }
  return limit;
}

// The forward on the grid (gru_fwd_grid_kernel). hbuf: [2][R rows][Hk]
// bf16 zeros, ctr: R * 32 int32 zeros (gru_grid_shape's R and rows); both
// the caller's, left dirty. cudaErrorInvalidValue where no grid takes H.
extern "C" int gru_fwd_grid(const void* xw, const void* wh, void* hs, void* hbuf, void* ctr, int B, int T, int H,
                            int device, void* stream) {
  const GridShape s = grid_shape(B, H, false, 3);
  if (s.ocp == 0) return cudaErrorInvalidValue;
  if (B <= 0 || T <= 0) return cudaSuccess;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  return launch_grid(gru_fwd_grid_kernel, s, grid_slice_bytes(H, s.ocp, false, 3), static_cast<cudaStream_t>(stream),
                     static_cast<const float*>(xw), static_cast<const bf16*>(wh), static_cast<float*>(hs),
                     static_cast<bf16*>(hbuf), static_cast<int*>(ctr), B, T, H, s);
}

// The cluster size the kernel runs width H on (1, 2, 4, 8 or 16), or 0 when
// no cluster takes H.
extern "C" int gru_fwd_cluster_size(int H) { return fwd_pick(H); }

// Whether a cluster of C blocks a row group takes width H.
extern "C" int gru_fwd_fits(int H, int C) { return fwd_fits(H, C) ? 1 : 0; }

// cluster: 0 runs the kernel's own pick (the wrapper's); 1, 2, 4, 8 or 16
// forces that cluster size where it fits, else cudaErrorInvalidValue
// (chip_smoke.py times each to measure the pick).
extern "C" int gru_fwd(const void* xw, const void* wh, void* hs, int B, int T, int H, int cluster, int device,
                       void* stream) {
  const int c = cluster > 0 ? cluster : fwd_pick(H);
  if (c == 0 || (c & (c - 1)) != 0 || c > 16 || !fwd_fits(H, c)) return cudaErrorInvalidValue;
  if (B <= 0 || T <= 0) return cudaSuccess;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // wh in registers up to Hk = 256 (8 or 16 k-steps), from shared memory above.
  const int ks = (H + 15) / 16;
  if (H % 4 == 0) {
    if (ks <= 8) return launch<8, true>(xw, wh, hs, B, T, H, c, device, s);
    if (ks <= 16) return launch<16, true>(xw, wh, hs, B, T, H, c, device, s);
    return launch<0, true>(xw, wh, hs, B, T, H, c, device, s);
  }
  if (ks <= 8) return launch<8, false>(xw, wh, hs, B, T, H, c, device, s);
  if (ks <= 16) return launch<16, false>(xw, wh, hs, B, T, H, c, device, s);
  return launch<0, false>(xw, wh, hs, B, T, H, c, device, s);
}

extern "C" const char* poi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
