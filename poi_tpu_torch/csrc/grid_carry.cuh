// Helpers of the recurrences' grid-resident serial kernels (csrc/gru_fwd.cu's
// gru_fwd_grid_kernel, csrc/gru_bwd.cu's gru_bwd_grid_carry_kernel, and
// csrc/lstm.cu's and csrc/rnn.cu's counterparts), which take the widths whose
// recurrent weights no cluster holds (the GRU past H = 640: wh [H, 3H] bf16
// is 2.46 MB at H = 640, 154 KB on each of a cluster's 16 CTAs, and 6.29 MB
// at H = 1024, more than 16 CTAs of 227 KB hold; the LSTM past 512, the RNN
// past 640). G is the gate blocks of the weight: 3 (GRU), 4 (LSTM), 1 (RNN).
//
// - The grid is R row groups x U unit slices, one CTA an SM, launched
//   cooperatively (cudaLaunchAttributeCooperative): a grid that cannot be
//   co-resident fails to launch, so the step barrier below never waits on a
//   CTA that is not running.
// - CTA (r, u) keeps the recurrent weights of its unit octets (at most
//   kTaskOct) in shared memory for the whole launch and owns the (row, unit)
//   pairs of its row group and octets. The operand every CTA of a row group
//   needs a step (bf16(h), or the three bf16 terms of the cotangent) goes
//   through a global buffer that L2 holds, double-buffered by step parity,
//   and is read back with ld.global.cg (L2 only: other CTAs wrote it during
//   this launch, and L1 is not coherent).
// - The step barrier of a row group is a counter in global memory: each CTA
//   adds one (release, gpu scope) once its step's writes are out and waits,
//   one thread spinning (acquire), until all U have. One barrier a step
//   suffices for the double buffers: a CTA writes step t's buffer only after
//   the barrier of step t - 1, which every CTA of its group reaches after it
//   has read the buffer's previous contents (step t - 2's). The counter adds
//   no sum, so no result depends on the order of arrivals.
// - A warp's task is one 16-row tile and up to kTaskOct octets of the CTA;
//   where the row group has fewer tiles than warps, the CTA's octets are
//   split into groups so that more warps work.
// - The A operand comes straight from L2 into mma.sync fragments by one
//   8-byte load a row: within each k-step of 16, the weight slices hold
//   logical k kperm(p) at physical position p, so that the fragment's
//   k 2tq, 2tq + 1, 2tq + 8, 2tq + 9 are the logical k 4tq .. 4tq + 3.

#pragma once

#include "cluster_carry.cuh"

namespace {

constexpr int kGridWarps = 8;  // warps a CTA
constexpr int kTaskOct = 4;    // unit octets a CTA, and a warp's task, at most

// The launch of a grid-resident kernel: a CTA's octets at most (its slice),
// unit slices, row groups, and the rows of a group (a multiple of 16).
struct GridShape {
  int ocp, U, R, rows;
};

// The logical k at physical position p of a k-step of 16 (see the top).
__host__ __device__ constexpr int kperm(int p) { return p < 8 ? 4 * (p / 2) + p % 2 : 4 * ((p - 8) / 2) + 2 + p % 2; }

// Shared memory of a CTA's weight slice with `ocp` unit octets and G gate
// blocks. The forward: the G gate columns of the octets for every k (the
// GRU's z, r, n), [Hk][8 G ocp + 8] bf16. The backward's carry: the weight's
// rows of the octets' units, [8 ocp][Kp + 8] bf16 (Kp = G H rounded up to
// 16). The + 8: conflict-free ldmatrix.
__host__ __device__ inline int grid_slice_bytes(int H, int ocp, bool bwd, int G) {
  if (bwd) return 8 * ocp * ((G * H + 15) / 16 * 16 + 8) * 2;
  return (H + 15) / 16 * 16 * (8 * G * ocp + 8) * 2;
}

// The grid for a batch of B rows of width H, G gate blocks: the most octets
// a CTA (up to kTaskOct) whose slice fits, as few unit slices as that
// allows, and as many row groups as the card's other SMs take (no more than
// the batch has 16-row tiles). ocp = 0 where no slice fits or the slices
// outnumber the SMs.
inline GridShape grid_shape(int B, int H, bool bwd, int G) {
  GridShape s = {0, 0, 0, 0};
  if (H <= 0) return s;
  for (int c = 1; c <= kTaskOct; ++c) {
    if (grid_slice_bytes(H, c, bwd, G) <= kMaxSmem) s.ocp = c;
  }
  if (s.ocp == 0) return s;
  s.U = ((H + 7) / 8 + s.ocp - 1) / s.ocp;
  if (s.U > kSms) return GridShape{0, 0, 0, 0};
  const int tiles = B > 0 ? (B + 15) / 16 : 1;
  const int rmax = kSms / s.U;
  const int per = (tiles + rmax - 1) / rmax;
  s.R = (tiles + per - 1) / per;
  s.rows = 16 * per;
  return s;
}

// A warp's tasks in a CTA with n_rt row tiles and n_oct octets: ng octet
// groups of gs octets a tile (n_rt * ng tasks).
__device__ __forceinline__ void grid_tasks(int n_rt, int n_oct, int& ng, int& gs) {
  ng = kGridWarps / n_rt;
  ng = ng < 1 ? 1 : ng > n_oct ? n_oct : ng;
  gs = (n_oct + ng - 1) / ng;
  ng = (n_oct + gs - 1) / gs;
}

// The A fragment of rows g and g + 8 (pointers ra, rb at the k-step's
// logical k 4 tq) from L2: one 8-byte load a row.
__device__ __forceinline__ void lda_l2(uint32_t (&a)[4], const bf16* ra, const bf16* rb) {
  const uint2 x = __ldcg(reinterpret_cast<const uint2*>(ra));
  const uint2 y = __ldcg(reinterpret_cast<const uint2*>(rb));
  a[0] = x.x;
  a[1] = y.x;
  a[2] = x.y;
  a[3] = y.y;
}

// A forward step's product for one task: acc[lo][q] += bf16(h) @ the slice's
// gate block q of octet lo0 + lo (no octets), on mma.sync m16n8k16. A comes
// straight from L2 (ra, rb: rows g and g + 8 at logical k 4 tq of the step's
// operand), kPf k-steps of fragments loaded ahead; the slice is [Hk][8 G ocp
// + 8] bf16 at slice_a, row stride ldb.
template <int G, int kPf>
__device__ __forceinline__ void grid_fwd_product(float (&acc)[kTaskOct][G][4], const bf16* ra, const bf16* rb,
                                                 int KS, uint32_t slice_a, int ldb, int lo0, int no, int lane) {
  uint32_t ac[kPf][4], an[kPf][4];
  auto load = [&](uint32_t (&dst)[kPf][4], int kb0) {
#pragma unroll
    for (int i = 0; i < kPf; ++i) {
      if (kb0 + i < KS) lda_l2(dst[i], ra + 16 * (kb0 + i), rb + 16 * (kb0 + i));
    }
  };
  load(ac, 0);
  for (int kb0 = 0; kb0 < KS; kb0 += kPf) {
    if (kb0 + kPf < KS) load(an, kb0 + kPf);
#pragma unroll
    for (int i = 0; i < kPf; ++i) {
      const int kb = kb0 + i;
      if (kb >= KS) break;
#pragma unroll
      for (int lo = 0; lo < kTaskOct; ++lo) {
        if (lo >= no) break;
#pragma unroll
        for (int q = 0; q < G; ++q) {
          uint32_t b0, b1;
          ldsm_x2_trans(b0, b1, slice_a + ((kb * 16 + lane % 16) * ldb + (lo0 + lo) * 8 * G + q * 8) * 2);
          mma_bf16(acc[lo][q], ac[i], b0, b1);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kPf; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) ac[i][e] = an[i][e];
    }
  }
}

// k-steps of the backward carries' three terms loaded ahead.
constexpr int kGridBwdPf = 2;

// A backward carry step's product for one task: acc[e][lo] += term e of the
// cotangent @ the slice's rows of octet lo0 + lo (no octets), each of the
// three bf16 terms into its own accumulator, on mma.sync m16n8k16. A comes
// straight from L2 (ra: row g at logical k 4 tq of term 0; the terms `term`
// elements apart, rows Kp apart), kGridBwdPf k-steps ahead; the slice is [8
// ocp][Kp + 8] bf16 at slice_a, row stride ldk.
__device__ __forceinline__ void grid_carry_product(float (&acc)[3][kTaskOct][4], const bf16* ra, size_t term, int Kp,
                                                   uint32_t slice_a, int ldk, int lo0, int no, int lane) {
  const int KS = Kp / 16;
  uint32_t ac[kGridBwdPf][3][4], an[kGridBwdPf][3][4];
  auto load = [&](uint32_t (&dst)[kGridBwdPf][3][4], int kb0) {
#pragma unroll
    for (int i = 0; i < kGridBwdPf; ++i) {
      if (kb0 + i < KS) {
#pragma unroll
        for (int e = 0; e < 3; ++e) {
          const bf16* p = ra + e * term + 16 * (kb0 + i);
          lda_l2(dst[i][e], p, p + 8 * Kp);
        }
      }
    }
  };
  load(ac, 0);
  for (int kb0 = 0; kb0 < KS; kb0 += kGridBwdPf) {
    if (kb0 + kGridBwdPf < KS) load(an, kb0 + kGridBwdPf);
#pragma unroll
    for (int i = 0; i < kGridBwdPf; ++i) {
      const int kb = kb0 + i;
      if (kb >= KS) break;
#pragma unroll
      for (int lo = 0; lo < kTaskOct; ++lo) {
        if (lo >= no) break;
        uint32_t b0, b1;
        ldsm_x2(b0, b1, slice_a + (((lo0 + lo) * 8 + lane % 8) * ldk + kb * 16 + ((lane / 8) % 2) * 8) * 2);
#pragma unroll
        for (int e = 0; e < 3; ++e) mma_bf16(acc[e][lo], ac[i][e], b0, b1);
      }
    }
#pragma unroll
    for (int i = 0; i < kGridBwdPf; ++i) {
#pragma unroll
      for (int e = 0; e < 3; ++e) {
#pragma unroll
        for (int x = 0; x < 4; ++x) ac[i][e][x] = an[i][e][x];
      }
    }
  }
}

// The row group's step barrier (see the top): every thread's writes of the
// step are out before thread 0 adds one to *ctr.
__device__ __forceinline__ void group_arrive(int* ctr) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    asm volatile("red.release.gpu.global.add.s32 [%0], 1;\n" ::"l"(ctr) : "memory");
  }
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// A step's wait that lasts this long means a CTA that never arrives (a
// fault, since the launch is co-resident): the kernel traps, and the launch
// fails, rather than hang the card.
constexpr uint64_t kWaitLimitNs = 20000000000ull;

// Waits until *ctr reaches `target`; the block's later reads see every write
// made before those arrivals.
__device__ __forceinline__ void group_wait(const int* ctr, int target) {
  if (threadIdx.x == 0) {
    const uint64_t t0 = global_ns();
    int v;
    asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(ctr) : "memory");
    while (v < target) {
      if (global_ns() - t0 > kWaitLimitNs) __trap();
      asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(ctr) : "memory");
    }
  }
  __syncthreads();
}

// The step counters: one a row group, 128 bytes apart.
constexpr int kCtrStride = 32;

// A cooperative launch of `kernel` on a grid of U x R CTAs of kGridWarps
// warps with `smem` bytes of shared memory; fails where they cannot all be
// resident at once.
template <class K, class... Args>
cudaError_t launch_grid(K kernel, const GridShape& s, int smem, cudaStream_t stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(s.U * s.R);
  cfg.blockDim = dim3(32 * kGridWarps);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace
