// Helpers of the recurrences' serial kernels that run a group of batch rows
// on a thread-block cluster, one mma.sync tile product a step
// (csrc/gru_fwd.cu, csrc/gru_bwd.cu, csrc/lstm.cu, csrc/rnn.cu):
//
// - fragment loads from shared memory (ldmatrix);
// - the forwards' fast sigmoid and tanh;
// - the cluster's rank, its split barrier (arrive with release, wait with
//   acquire) and stores into another CTA's shared memory (mapa);
// - the split of an fp32 cotangent into three exact bf16 terms;
// - the backward carries' layout and the cluster they run on.

#pragma once

#include "mma_tiles.cuh"
#include "wgmma_tiles.cuh"

namespace {

constexpr int kMaxSmem = 232448;  // 227 KB: the most a block may opt into

constexpr float kLog2e = 1.4426950408889634f;

// sigmoid and tanh from ex2.approx and rcp.approx: no branches, so the
// compiler interleaves a thread's (row, unit) pairs; each within a few fp32
// ulp. A pre-activation of -1e9 gives ex2(+inf) = inf and rcp(inf) = 0: a
// sigmoid of exactly 0 (the GRU's z on a padded step).
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float sigmoid_fast(float x) { return rcp_approx(1.0f + ex2_approx(-kLog2e * x)); }
__device__ __forceinline__ float tanh_fast(float x) {
  return fmaf(-2.0f, rcp_approx(1.0f + ex2_approx(2.0f * kLog2e * x)), 1.0f);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n" : "=r"(r0), "=r"(r1) : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t& r0, uint32_t& r1, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr)
               : "memory");
}

// An A fragment (R x 16, row-major, row stride ld bf16) at column k0 of a
// bf16 smem matrix; at R = 8 the fragment's rows 8-15 are zero.
template <int R>
__device__ __forceinline__ void load_a_frag(uint32_t (&a)[4], uint32_t base, int ld, int k0, int lane) {
  if constexpr (R == 16) {
    ldsm_x4(a, base + ((lane % 16) * ld + k0 + (lane / 16) * 8) * 2);
  } else {
    ldsm_x2(a[0], a[2], base + ((lane % 8) * ld + k0 + ((lane / 8) % 2) * 8) * 2);
    a[1] = a[3] = 0u;
  }
}

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cta_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_arrive() { asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory"); }

__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  return remote;
}

// Two floats into CTA `rank`'s shared memory at the offset of local address `addr`.
__device__ __forceinline__ void st_cluster_f2(uint32_t addr, int rank, float x, float y) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(map_rank(addr, rank)), "f"(x), "f"(y) : "memory");
}

// 32 bits into CTA `rank`'s shared memory at the offset of local address
// `addr`, its completion counted in bytes on that CTA's mbarrier at the
// offset of local address `bar`: no fence, no barrier; the receiver waits
// on its mbarrier.
__device__ __forceinline__ void st_async_u32(uint32_t addr, uint32_t bar, int rank, uint32_t v) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(map_rank(addr, rank)),
               "r"(v), "r"(map_rank(bar, rank))
               : "memory");
}

// 16 bytes by st.async at addresses already mapped into the receiving CTA's
// window (map_rank): a CTA's shared memory is one contiguous window, so an
// offset added to a mapped base stays in that CTA. One 16-byte store moves
// four times the bytes of st_async_u32's in one transaction.
__device__ __forceinline__ void st_async_v4(uint32_t remote_addr, uint32_t remote_bar, uint4 v) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(
                   remote_addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(remote_bar)
               : "memory");
}

// The box of a 4-D tensor map at (c0, c1, c2, c3) into this CTA's shared
// memory, counted in bytes on `bar`; elements past the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], "
      "[%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// One arrival on `bar` once this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Two fp32 values x as three bf16 terms each: b0 = bf16(x), b1 = bf16(x - b0),
// b2 = bf16(x - b0 - b1). The differences are exact in fp32; together the
// terms carry fp32's 24 significant bits, so three exact bf16 products, each
// into its own fp32 accumulator and summed smallest first, keep a product
// fp32-faithful.
__device__ __forceinline__ void split3(float v0, float v1, __nv_bfloat162 (&t)[3]) {
  t[0] = __floats2bfloat162_rn(v0, v1);
  const float e0 = v0 - __low2float(t[0]), e1 = v1 - __high2float(t[0]);
  t[1] = __floats2bfloat162_rn(e0, e1);
  t[2] = __floats2bfloat162_rn(e0 - __low2float(t[1]), e1 - __high2float(t[1]));
}

// ----------------------------------------------------------------- the backward carries
//
// A cluster of C CTAs owns a group of group_rows(C) batch rows; the H units
// are cut into O = ceil(H/8) octets; CTA p owns octets [p*O/C, (p+1)*O/C)
// and keeps their G gate columns of wh (8 G an octet: 24 for the GRU, 32 for
// the LSTM) for every unit k, [Hk, NC] bf16, in shared memory, the carry
// product's B operand.

// Rows a group: the mma's M, halved at a cluster of 16 to fit its slots
// and to put twice the groups on the card.
__host__ __device__ constexpr int group_rows(int C) { return C >= 16 ? 8 : 16; }
// Warps a CTA may run: fewer at the large clusters, whose threads hold more
// partial sums in registers.
__host__ __device__ constexpr int max_warps(int C) { return C >= 16 ? 8 : 16; }

// The shared-memory layout of one CTA of a carry kernel for width H, G gate
// blocks, on a cluster of C, with `stage` bytes of prefetch slots for each
// octet it owns and each 8 rows of its group.
struct Layout {
  int O;     // unit octets, ceil(H / 8)
  int ocp;   // octets a CTA (at most): ceil(O / C); its first ocp warps own one each
  int W;     // warps a CTA: 2 ocp (4 ocp from a cluster of 8), up to max_warps; all split the carry product
  int NC;    // the CTA's wh columns, 8 G an octet, rounded up to 16 (the carry product's K)
  int Hk;    // H rounded up to 16
  int ldw;   // bf16 row stride of the wh slice and the cotangent terms (NC + 8: conflict-free ldmatrix)
  int dt_off, red_off, ring_off, bytes;
};

__host__ __device__ inline Layout layout(int H, int C, int G, int stage = 0) {
  Layout L;
  const int R = group_rows(C);
  L.O = (H + 7) / 8;
  L.ocp = (L.O + C - 1) / C;
  const int W = (C >= 8 ? 4 : 2) * L.ocp;
  L.W = W < max_warps(C) ? W : max_warps(C);
  L.NC = (8 * G * L.ocp + 15) / 16 * 16;
  L.Hk = (H + 15) / 16 * 16;
  L.ldw = L.NC + 8;
  L.dt_off = L.Hk * L.ldw * 2;                       // wh slice [Hk][ldw] bf16 at 0
  L.red_off = L.dt_off + 3 * R * L.ldw * 2;          // cotangent terms [3][R][ldw] bf16
  L.ring_off = L.red_off + 2 * C * R * 8 * L.ocp * 4;  // reduce slots [2][C][R][8 ocp] fp32
  L.bytes = L.ring_off + stage * L.ocp * (R / 8);
  return L;
}

inline bool fits(int H, int C, int G, int stage = 0) {
  if (H <= 0) return false;
  const Layout L = layout(H, C, G, stage);
  return C <= L.O && L.ocp <= L.W && L.bytes <= kMaxSmem;
}

// The cluster a carry kernel runs (B, H) on: the smallest of 1, 2, 4, 8, 16
// that fits, doubled (up to 8, the portable size: a cluster of 16 measured
// slower at config #4's shape) while the groups' clusters still fit on the
// card at once; 0 when none fits.
inline int pick_cluster(int B, int H, int G, int stage = 0) {
  int c = 0;
  for (int k = 1; k <= 16 && c == 0; k *= 2) {
    if (fits(H, k, G, stage)) c = k;
  }
  const int b = B > 0 ? B : 1;
  while (c > 0 && c < 8 && fits(H, 2 * c, G, stage) &&
         (b + group_rows(2 * c) - 1) / group_rows(2 * c) * 2 * c <= kSms) {
    c *= 2;
  }
  return c;
}

}  // namespace
