// Tensor-core tile helpers of the catalog kernels (topk.cu; ce_bwd.cu and
// sampled.cu take a few of them).
//
// A block is 4 warps; each warp owns 16 rows of a "resident" operand, and the
// other operand streams through shared memory in tiles of kTile rows,
// double-buffered with cp.async. Products are warp-level mma.sync m16n8k16
// with bf16 operands and fp32 accumulators. Smem rows are padded by kPad
// bf16 so that the fragment loads of a warp hit 32 banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;    // rows of a streamed tile, and resident rows per block (4 warps x 16)
constexpr int kThreads = 128;
constexpr int kPad = 8;       // bf16 of padding per smem row
constexpr float kNegInit = -1e30f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = pred ? 16 : 0;  // 0 source bytes: the 16 destination bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [r0, r0 + kTile) of a row-major [R, D] bf16 matrix into a smem tile
// with row stride D + kPad; rows past R are zero-filled. Threads is the
// block's thread count (ce.cu's 128-row forward runs 256).
template <int D, int Threads = kThreads>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0, int R) {
  constexpr int kVec = D / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < kTile * kVec; i += Threads) {
    const int r = i / kVec;
    const int c = (i % kVec) * 8;
    const bool ok = r0 + r < R;
    cp_async16(dst + r * (D + kPad) + c, src + (size_t)(ok ? r0 + r : 0) * D + c, ok);
  }
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) { return *reinterpret_cast<const uint32_t*>(p); }

// Two bf16 from two addresses as one operand register, the first in the low half.
__device__ __forceinline__ uint32_t pack2(const bf16* lo, const bf16* hi) {
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(lo)) |
         (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragment (16 x 16, row-major) of rows row0.., columns k0.. of a smem tile.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* s, int row0, int k0, int g, int t) {
  const bf16* p = s + (row0 + g) * LD + k0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * LD);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * LD + 8);
}

// Logits of this warp's 16 resident rows against the 64 rows of a streamed
// tile: acc[j] holds columns 8j + 2t + {0, 1} of rows g (acc[j][0..1]) and
// g + 8 (acc[j][2..3]).
template <int D>
__device__ __forceinline__ void tile_logits(float (&acc)[8][4], const uint32_t (&a)[D / 16][4], const bf16* tile, int g,
                                            int t) {
  constexpr int LD = D + kPad;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bf16* p = tile + (j * 8 + g) * LD + ks * 16 + 2 * t;
      mma_bf16(acc[j], a[ks], ld32(p), ld32(p + 8));
    }
  }
}

// out[16 x D] += bf16(p)[16 x 64] . tile[64 x D]: p in the accumulator
// layout of tile_logits, tile row-major with row stride LD (D + kPad for a
// whole tile; a column slice of a wider tile passes the wider stride).
template <int D, int LD = D + kPad>
__device__ __forceinline__ void accumulate_product(float (&out)[D / 8][4], const float (&p)[8][4], const bf16* tile,
                                                   int g, int t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]), pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int jn = 0; jn < D / 8; ++jn) {
      const bf16* s = tile + (kk * 16 + 2 * t) * LD + jn * 8 + g;
      mma_bf16(out[jn], a, pack2(s, s + LD), pack2(s + 8 * LD, s + 9 * LD));
    }
  }
}

}  // namespace
