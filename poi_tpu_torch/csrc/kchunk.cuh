// K-chunked streaming for the loss kernels past D = 512: B7 and B8 (ce.cu,
// ce_bwd.cu), B9 and B10 (sampled.cu) at D = 768 and 1024.
//
// Why: up to D = 512 a block holds its 64 resident rows and whole 64-row
// streamed tiles in shared memory. At D = 1024 each is 128 KB, and a block
// may hold 227 KB (232,448 bytes). So here a streamed tile arrives as D /
// 256 K-chunks of 256 columns (32 KB: four 128-byte swizzled TMA boxes of 64
// columns under one mbarrier transaction count) through a ring of stages,
// and the tile's 64 x 64 logits accumulate in the wgmma accumulator across
// its chunks: the same m64n64k16 products, in the same k order, as one
// unchunked tile. A block is one consumer warpgroup (64 resident rows, read
// by descriptor from shared memory) and one producer warpgroup, one of whose
// threads issues the TMA loads.
//
// The forward (B7, B9): the producer streams each tile's chunks in order,
// the tile's vectors (B7: its bias; B9: its bias and ids) riding with its
// last chunk. The consumer keeps one chunk's product in flight behind the
// next and frees a chunk's stage once its product is done; after the last
// chunk it folds the tile's logits, then frees the last stage. The ring
// takes as many stages (2 to 4) as fit: 4 at D = 768 (3 for B9, whose ids
// take 256 bytes a stage more), 3 at 1024.
//
// The backward (B8, B10): a thread's sums of all D output columns would take
// D / 2 registers, so a block sums the 256 columns of one range z (gridDim.z
// = D / 256), every range recomputing the logits: (2 (D / 256) + 2) N V D
// operations a pass where the function needs 3 N V D (at D = 1024, 10 where
// it needs 3). The block needs the tile's chunk z twice: as K-chunk z of
// the logits and as the B operand of its product acc += bf16(gp) . tile[:,
// z] (read MN-major, the transpose bit). Chunk z therefore goes to a stage
// of its own (the hold), with the tile's vectors, and is freed after the
// product; the other chunks pass through the ring as in the forward. The
// logits, gp and the product are done one after the other: the tile's
// product is waited for before the next tile's logits start.
//
// Every output element is summed by one thread in one fixed order, with no
// atomics: a run gives the same bits every time.

#pragma once

#include "wgmma_tiles.cuh"

namespace {

constexpr int kKc = 256;                     // columns a K-chunk
constexpr int kKcRows = 64;                  // rows a streamed tile, and a block's resident rows
constexpr int kKcBoxBytes = kKcRows * 128;   // one 64-column, 128-byte swizzled box of 64 rows: 8 KB
constexpr int kKcBytes = kKcRows * kKc * 2;  // a chunk: 32 KB
constexpr int kKcSteps = kKc / 16;           // k16 steps a chunk
constexpr int kSmemOptIn = 232448;           // the dynamic smem a block may opt into on an H100

__host__ __device__ constexpr int kc_chunks(int D) { return D / kKc; }

// The most ring stages, 4 down to 2, of `per_stage` bytes that fit beside
// `fixed` bytes and the 1024 that align the base.
__host__ __device__ constexpr int kc_stages(int fixed, int per_stage) {
  int st = 4;
  while (st > 2 && 1024 + fixed + st * per_stage > kSmemOptIn) --st;
  return st;
}

// The forward's shared memory, NV streamed vectors a tile: the resident rows
// and their barrier; a stage: a chunk, the vectors, its full and empty
// barriers.
template <int D, int NV>
struct KcFwd {
  static constexpr int kFixed = kKcRows * D * 2 + 8;
  static constexpr int kPerStage = kKcBytes + NV * kKcRows * 4 + 16;
  static constexpr int kStages = kc_stages(kFixed, kPerStage);
  static constexpr int kSmem = 1024 + kFixed + kStages * kPerStage;
  static_assert(D % kKc == 0 && kSmem <= kSmemOptIn, "the K-chunked forward does not fit a block");
};

// The backward's: the resident rows, the hold (a chunk and the tile's NV
// vectors) and three barriers (resident, hold full, hold empty); a stage: a
// chunk and its two barriers.
template <int D, int NV>
struct KcBwd {
  static constexpr int kFixed = kKcRows * D * 2 + kKcBytes + NV * kKcRows * 4 + 24;
  static constexpr int kPerStage = kKcBytes + 16;
  static constexpr int kStages = kc_stages(kFixed, kPerStage);
  static constexpr int kSmem = 1024 + kFixed + kStages * kPerStage;
  static_assert(D % kKc == 0 && kSmem <= kSmemOptIn, "the K-chunked backward does not fit a block");
};

__device__ __forceinline__ unsigned char* kc_smem_base() {
  extern __shared__ unsigned char smem_raw[];
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
}

// Rows [r0, r0 + 64) of `map`, every column, as D / 64 boxes, on `bar`.
template <int D>
__device__ __forceinline__ void kc_load_resident(unsigned char* dst, const CUtensorMap* map, int r0, uint64_t* bar) {
  mbar_arrive_expect_tx(bar, kKcRows * D * 2);
  for (int b = 0; b < D / 64; ++b) tma_load_2d(dst + b * kKcBoxBytes, map, b * 64, r0, bar);
}

// Chunk c of tile `it` (rows it * 64.., columns c * 256..) of `map`: four
// boxes, on `bar` (whose transaction count the caller has set).
__device__ __forceinline__ void kc_load_chunk(unsigned char* dst, const CUtensorMap* map, int c, int it, uint64_t* bar) {
  for (int b = 0; b < kKc / 64; ++b) tma_load_2d(dst + b * kKcBoxBytes, map, c * kKc + b * 64, it * kKcRows, bar);
}

// s (+)= the resident rows' columns of chunk C . the chunk's 64 rows, both
// K-major in smem; chunk 0's first step overwrites s. Neither starts nor
// commits.
template <int C>
__device__ __forceinline__ void kc_chunk_logits(float (&s)[32], uint32_t res, uint32_t chunk) {
#pragma unroll
  for (int kk = 0; kk < kKcSteps; ++kk) {
    const int ks = C * kKcSteps + kk;  // the k16 step over D
    const uint64_t da = smem_desc(res + (ks / 4) * kKcBoxBytes + (ks % 4) * 32, 16, 1024, 128);
    const uint64_t db = smem_desc(chunk + (kk / 4) * kKcBoxBytes + (kk % 4) * 32, 16, 1024, 128);
    if (ks == 0) {
      wgmma_ss64_first(s, da, db);
    } else {
      wgmma_ss<64>(s, da, db, 1);
    }
  }
}

// ---------------------------------------------------------------- forward

// The producer thread: the resident rows once, then tiles [t0, t1), each
// chunk into the next stage of the ring, the tile's NV vectors with its last
// chunk.
template <int D, int NV>
__device__ __forceinline__ void kc_fwd_produce(unsigned char* res_s, unsigned char* ring_s, float* vec_s, uint64_t* full,
                                               uint64_t* empty, uint64_t* res_full, const CUtensorMap* res_map,
                                               const CUtensorMap* str_map, const CUtensorMap* const* vec_maps,
                                               int r0, int t0, int t1) {
  constexpr int ST = KcFwd<D, NV>::kStages, NC = kc_chunks(D);
  kc_load_resident<D>(res_s, res_map, r0, res_full);
  int k = 0;
  for (int it = t0; it < t1; ++it) {
    for (int c = 0; c < NC; ++c, ++k) {
      const int st = k % ST;
      const bool last = c == NC - 1;
      mbar_wait(&empty[st], ((k / ST) & 1) ^ 1);
      mbar_arrive_expect_tx(&full[st], kKcBytes + (last ? NV * kKcRows * 4 : 0));
      kc_load_chunk(ring_s + st * kKcBytes, str_map, c, it, &full[st]);
      if (last) {
        for (int v = 0; v < NV; ++v) tma_load_1d(vec_s + (st * NV + v) * kKcRows, vec_maps[v], it * kKcRows, &full[st]);
      }
    }
  }
}

// The consumer warpgroup: a tile's logits into s from chunks C.. (the
// tile's chunk 0 is ring chunk k0), one chunk's product in flight behind
// the next, each chunk's stage freed once its product is done but the
// last's. Returns with every product done.
template <int D, int NV, int C = 0>
__device__ __forceinline__ void kc_fwd_logits(float (&s)[32], uint32_t res, uint32_t ring, uint64_t* full, uint64_t* empty,
                                              int k0) {
  constexpr int ST = KcFwd<D, NV>::kStages;
  const int k = k0 + C;
  mbar_wait(&full[k % ST], (k / ST) & 1);
  if constexpr (C == 0) fence_regs(s);
  wgmma_fence();
  kc_chunk_logits<C>(s, res, ring + (k % ST) * kKcBytes);
  wgmma_commit();
  if constexpr (C > 0) {
    wgmma_wait<1>();
    mbar_arrive(&empty[(k - 1) % ST]);
  }
  if constexpr (C + 1 < kc_chunks(D)) {
    kc_fwd_logits<D, NV, C + 1>(s, res, ring, full, empty, k0);
  } else {
    wgmma_wait<0>();
    fence_regs(s);
  }
}

// One forward block: rows [blockIdx.x * 64, + 64) of `res_map` against
// tiles [t0, t1) of `str_map`, the running base-2 max m and sum l of each
// thread's two rows folded by fold(s, m, l, vec, it) (vec: the tile's NV
// vectors of 64). Returns false in the producer warpgroup, whose part is
// done, and true in the consumer warpgroup, whose m and l then hold its
// rows' partials over its columns.
template <int D, int NV, typename Fold>
__device__ __forceinline__ bool kc_fwd_run(float (&m)[2], float (&l)[2], const CUtensorMap* res_map,
                                           const CUtensorMap* str_map, const CUtensorMap* const* vec_maps, int t0,
                                           int t1, Fold&& fold) {
  constexpr int ST = KcFwd<D, NV>::kStages, NC = kc_chunks(D);
  unsigned char* base = kc_smem_base();
  unsigned char* res_s = base;                                                 // [D / 64][64][128 bytes]
  unsigned char* ring_s = base + kKcRows * D * 2;                              // [ST][4][64][128 bytes]
  float* vec_s = reinterpret_cast<float*>(ring_s + ST * kKcBytes);             // [ST][NV][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(vec_s + ST * NV * kKcRows);     // [ST]
  uint64_t* empty = full + ST;                                                 // [ST]
  uint64_t* res_full = empty + ST;
  if (threadIdx.x == 0) {
    for (int st = 0; st < ST; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 128);  // every consumer thread
    }
    mbar_init(res_full, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x >= 128) {
    if (threadIdx.x == 128) {
      kc_fwd_produce<D, NV>(res_s, ring_s, vec_s, full, empty, res_full, res_map, str_map, vec_maps,
                            blockIdx.x * kKcRows, t0, t1);
    }
    return false;
  }
  mbar_wait(res_full, 0);
  const uint32_t res = smem_u32(res_s), ring = smem_u32(ring_s);
  float s[32];
  int k = 0;
  for (int it = t0; it < t1; ++it, k += NC) {
    kc_fwd_logits<D, NV>(s, res, ring, full, empty, k);
    const int last = (k + NC - 1) % ST;
    fold(s, m, l, vec_s + last * NV * kKcRows, it);
    // The vectors were read by generic loads: ordered before the next bulk write into the stage.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive(&empty[last]);
  }
  return true;
}

// ---------------------------------------------------------------- backward

// The producer thread: the resident rows once, then tiles [t0, t1), chunk z
// and the tile's NV vectors into the hold (once the previous tile's product
// has freed it), every other chunk into the next stage of the ring.
template <int D, int NV>
__device__ __forceinline__ void kc_bwd_produce(unsigned char* res_s, unsigned char* hold_s, unsigned char* ring_s,
                                               float* vec_s, uint64_t* full, uint64_t* empty, uint64_t* hold_full,
                                               uint64_t* hold_empty, uint64_t* res_full, const CUtensorMap* res_map,
                                               const CUtensorMap* str_map, const CUtensorMap* const* vec_maps,
                                               int r0, int t0, int t1, int z) {
  constexpr int ST = KcBwd<D, NV>::kStages;
  kc_load_resident<D>(res_s, res_map, r0, res_full);
  int k = 0;
  uint32_t hp = 0;
  for (int it = t0; it < t1; ++it) {
    for (int c = 0; c < kc_chunks(D); ++c) {
      if (c == z) {
        mbar_wait(hold_empty, hp ^ 1);
        mbar_arrive_expect_tx(hold_full, kKcBytes + NV * kKcRows * 4);
        kc_load_chunk(hold_s, str_map, c, it, hold_full);
        for (int v = 0; v < NV; ++v) tma_load_1d(vec_s + v * kKcRows, vec_maps[v], it * kKcRows, hold_full);
        hp ^= 1;
      } else {
        const int st = k % ST;
        mbar_wait(&empty[st], ((k / ST) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[st], kKcBytes);
        kc_load_chunk(ring_s + st * kKcBytes, str_map, c, it, &full[st]);
        ++k;
      }
    }
  }
}

// The consumer warpgroup: a tile's logits into s from chunks C.., chunk z
// from the hold (its phase `hph`), the others from the ring (k: ring chunks
// taken so far, advanced here). One chunk's product in flight behind the
// next; each ring chunk's stage freed once its product is done. Returns with
// every product done and the hold still held.
template <int D, int NV, int C = 0>
__device__ __forceinline__ void kc_bwd_logits(float (&s)[32], uint32_t res, uint32_t ring, uint32_t hold, uint64_t* full,
                                              uint64_t* empty, uint64_t* hold_full, uint32_t hph, int z, int& k) {
  constexpr int ST = KcBwd<D, NV>::kStages;
  const bool own = C == z;
  mbar_wait(own ? hold_full : &full[k % ST], own ? hph : (k / ST) & 1);
  if constexpr (C == 0) fence_regs(s);
  wgmma_fence();
  kc_chunk_logits<C>(s, res, own ? hold : ring + (k % ST) * kKcBytes);
  wgmma_commit();
  if constexpr (C > 0) {
    wgmma_wait<1>();
    if (C - 1 != z) mbar_arrive(&empty[(k - 1) % ST]);  // chunk C - 1 was ring chunk k - 1
  }
  if (!own) ++k;
  if constexpr (C + 1 < kc_chunks(D)) {
    kc_bwd_logits<D, NV, C + 1>(s, res, ring, hold, full, empty, hold_full, hph, z, k);
  } else {
    wgmma_wait<0>();
    fence_regs(s);
    if (!own) mbar_arrive(&empty[(k - 1) % ST]);
  }
}

// One backward block: resident rows [blockIdx.x * 64, + 64) of `res_map`,
// output columns [z * 256, + 256) with z = blockIdx.z, against tiles [t0,
// t1) of `str_map`. For each tile, tile(s, vec, it, hold) turns its logits s
// (waited for) into gp, from the tile's NV vectors `vec`, and starts and
// commits acc += bf16(gp) . the hold's chunk (at smem address `hold`); the
// product is waited for before the hold is freed. Returns false in the
// producer warpgroup and true in the consumer warpgroup, whose acc then
// holds its rows' sums over its columns.
template <int D, int NV, typename Tile>
__device__ __forceinline__ bool kc_bwd_run(float (&acc)[2][64], const CUtensorMap* res_map, const CUtensorMap* str_map,
                                           const CUtensorMap* const* vec_maps, int t0, int t1, Tile&& tile) {
  constexpr int ST = KcBwd<D, NV>::kStages;
  unsigned char* base = kc_smem_base();
  unsigned char* res_s = base;                                              // [D / 64][64][128 bytes]
  unsigned char* hold_s = base + kKcRows * D * 2;                           // [4][64][128 bytes]
  unsigned char* ring_s = hold_s + kKcBytes;                                // [ST][4][64][128 bytes]
  float* vec_s = reinterpret_cast<float*>(ring_s + ST * kKcBytes);          // [NV][64], the hold's
  uint64_t* full = reinterpret_cast<uint64_t*>(vec_s + NV * kKcRows);       // [ST]
  uint64_t* empty = full + ST;                                              // [ST]
  uint64_t* hold_full = empty + ST;
  uint64_t* hold_empty = hold_full + 1;
  uint64_t* res_full = hold_empty + 1;
  const int z = blockIdx.z;
  if (threadIdx.x == 0) {
    for (int st = 0; st < ST; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 128);  // every consumer thread
    }
    mbar_init(hold_full, 1);
    mbar_init(hold_empty, 128);
    mbar_init(res_full, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x >= 128) {
    if (threadIdx.x == 128) {
      kc_bwd_produce<D, NV>(res_s, hold_s, ring_s, vec_s, full, empty, hold_full, hold_empty, res_full, res_map,
                            str_map, vec_maps, blockIdx.x * kKcRows, t0, t1, z);
    }
    return false;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
  }
  mbar_wait(res_full, 0);
  const uint32_t res = smem_u32(res_s), ring = smem_u32(ring_s), hold = smem_u32(hold_s);
  float s[32];
  int k = 0;
  uint32_t hph = 0;
  for (int it = t0; it < t1; ++it, hph ^= 1) {
    kc_bwd_logits<D, NV>(s, res, ring, hold, full, empty, hold_full, hph, z, k);
    tile(s, vec_s, it, hold);
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < 2; ++h) fence_regs(acc[h]);
    // The vectors were read by generic loads: ordered before the next bulk write into the hold.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive(hold_empty);
  }
  return true;
}

}  // namespace
