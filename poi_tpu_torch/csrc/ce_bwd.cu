// Full-catalog softmax cross-entropy, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel poi_tpu/ops/fused_ce.py:_bwd_kernel (driven by
// _bwd_slab / _pallas_bwd). Contract (ce.cu's, the TPU kernel's arithmetic):
//   q [N, D] bf16, table [V, D] bf16, bias [V] fp32 (-1e30 on padded rows),
//   lse [N] fp32, g [N] fp32;
//   logits l = q . table^T + bias: exact bf16 products, fp32 sums;
//   gp = exp(l - lse[n]) * g[n] in fp32, gpb = bf16(gp);
//   dq [N, D] = gpb . table, dtable [V, D] = gpb^T . q, dbias [V] = colsum(gp)
//   (the unrounded gp). The one-hot target terms are left to the caller.
//
// What bounds it on this card: four catalog products of 2*N*V*D FLOPs each
// (1.48 TFLOP at N=32768, V=44170, D=128: 1.50 ms at the tensor cores' 989
// TFLOP/s), then the N*V exponentials of each pass (two passes: 2.9e9 on the
// special-function units, 0.69 ms), both far above the bytes. The first
// version used warp-level mma.sync, which cannot reach Hopper's tensor-core
// rate, re-loaded every B fragment from smem warp by warp, held 64 resident
// rows a block (so the streamed operand was re-read from L2 once per 64 rows)
// and ran two cp.async stages with every warp both loading and computing.
//
// Design: two passes, each the same warp-specialised kernel (ce_bwd_pass):
// - dq:     row blocks of 128 queries stream the catalog;
// - dtable: catalog blocks of 128 rows stream the queries (and their lse, g),
//           and also sum dbias.
// A block is two consumer warpgroups, each owning 64 resident rows, and one
// producer warpgroup, whose registers go to the consumers (setmaxnreg). One
// producer thread starts TMA loads of the 64-row streamed tiles
// into a ring of kStages smem stages guarded by mbarriers (full: the bytes
// arrived; empty: all 256 consumer threads are done with the stage). A tile
// arrives as D * 2 / sw boxes of sw bytes a row (sw = 128, or 64 at D = 32),
// swizzled as wgmma's descriptors read them.
// For each tile a consumer warpgroup
//   1. computes its 64 x 64 logits with wgmma m64n64k16: A is the
//      warpgroup's resident rows, read once from smem into register
//      fragments for the whole kernel; B is the tile, K-major in smem (each
//      row contiguous in D);
//   2. turns them into gp in registers (the same __expf and masking of ragged
//      rows and columns as the first version);
//   3. rounds gp to bf16 straight into wgmma A-operand fragments (the fp32
//      accumulator layout of m64nN is the A layout of the next k16 step) and
//      multiplies them by the SAME smem tile read MN-major (the transpose
//      bit), adding into its [64, D] fp32 output accumulators. The tile is
//      not copied a second time.
// That is narrow_pass, for D = 32, 64 and 128. At D = 192 and 256 the
// [64, D] sums leave no registers for the resident fragments: wide_pass
// (below) reads A from smem for the logits, keeps one logits buffer and
// splits the gradient product into products of at most 128 columns. At D =
// 384 and 512 (csrc/sampled.cu's B10 at D = 512, without the hit mask) a
// block is one consumer warpgroup of 64 resident rows on a 2-stage ring and
// sums half the output columns (gridDim.z = 2), both halves recomputing the
// logits: 12*N*V*D operations where the function needs 6*N*V*D. At D =
// 768 and 1024 (kc_pass) a tile no longer fits beside the resident rows:
// kchunk.cuh's K-chunked backward streams it in chunks of 256 columns, and
// a block sums the 256 output columns of one range (gridDim.z = 3 or 4),
// every range recomputing the logits: 16*N*V*D operations at 768 and
// 20*N*V*D at 1024 for the function's 6*N*V*D. Past 1024, at any multiple
// of 256 (ce_bwd_pass<0, ...>, the width a run-time argument), the 64
// resident rows no longer fit beside the hold and the ring: they stream
// chunk by chunk with the tile (kchunk.cuh's kcs_bwd_run), and a block still
// sums one range of 256 output columns: (2 (D / 256) + 2) N V D operations a
// pass, 36*N*V*D at 2048. The wrapper pads any other D <= 1024 with zero
// columns to the next width above, and any wider D to the next multiple of
// 256 (ops/fused_ce.py).
// Where the resident blocks cannot fill the card (config #3's dq: 16 blocks
// of 128 rows), the streamed dimension is split S ways into fp32 partials
// [S, rows, D] (and [S, V] for dbias) in the caller's scratch, and
// sum_splits adds them in a fixed order. No atomics: every output element is
// summed by one thread in one fixed order, so a run gives the same bits
// every time.
//
// The tensor maps are built on the host with cuTensorMapEncodeTiled (the
// library links -lcuda). The entry points launch on the given stream, do not
// synchronise and allocate nothing; each returns cudaGetLastError() after its
// launches.

#include "kchunk.cuh"
#include "mma_tiles.cuh"
#include "wgmma_tiles.cuh"

namespace {

constexpr int kRes = 128;     // resident rows a block: two consumer warpgroups of 64
constexpr int kStr = 64;      // rows of a streamed tile
constexpr int kStages = 4;    // smem ring of streamed tiles

// Streamed fp32 vectors that arrive with each tile: the dq pass needs the
// catalog rows' bias, the dtable pass the query rows' lse and g.
template <bool kDtable>
__host__ __device__ constexpr int stream_vecs() {
  return kDtable ? 2 : 1;
}

// The shape of a block, by D. Up to D = 256: two consumer warpgroups
// (kRes resident rows), a ring of kStages, every output column in one
// block. At D = 384 and 512 (B10's D = 512 shape, sampled.cu, without the
// hit mask) a thread's sums of all D output columns would take 192 or 256
// registers, so a block sums one half of the columns (gridDim.z = 2, both
// halves recomputing the logits), and the resident rows (48 or 64 KB a
// warpgroup) and the tiles (as much each) leave room for one consumer
// warpgroup (64 rows) and a ring of 2.
__host__ __device__ constexpr int bwd_cons(int D) { return D >= 384 || D == 0 ? 1 : 2; }
__host__ __device__ constexpr int bwd_res(int D) { return 64 * bwd_cons(D); }  // resident rows a block
__host__ __device__ constexpr int bwd_stages(int D) { return D >= 384 ? 2 : kStages; }
// Output column ranges: halves at 384 and 512, ranges of 256 past 512.
// D = 0 is the streamed pass past 1024, whose ranges the launch counts
// from its run-time width.
__host__ __device__ constexpr int bwd_halves(int D) { return D > 512 ? D / kKc : D >= 384 ? 2 : 1; }
__host__ __device__ constexpr int bwd_threads(int D) { return 128 * (bwd_cons(D) + 1); }  // + 1 producer warpgroup

template <int D, bool kDtable>
constexpr int pass_smem_bytes() {
  if constexpr (D == 0) return KcsBwd<stream_vecs<kDtable>()>::kSmem;
  if constexpr (D > 512) return KcBwd<D, stream_vecs<kDtable>()>::kSmem;
  // 1024: room to align the base; the stages' vectors; the barriers.
  constexpr int Res = bwd_res(D), ST = bwd_stages(D);
  return 1024 + (Res + ST * kStr) * D * 2 + ST * stream_vecs<kDtable>() * kStr * 4 + (2 * ST + 1) * 8;
}

// gp of one streamed tile from its logits `s` (already waited for), in
// place: (row r of the thread, column c of the tile) is s[4 (c / 8) + 2 r +
// c % 2]. The dq pass: vec = the streamed catalog rows' bias; ra, rb = the
// resident queries' lse, g. The dtable pass: vec = the streamed queries'
// lse, then their g; ra = the resident catalog rows' bias; db sums gp a
// resident row.
template <bool kDtable>
__device__ __forceinline__ void tile_gp(float (&s)[32], float (&db)[2], const float* vec, int c0, int n_str,
                                        const bool (&ok)[2], const float (&ra)[2], const float (&rb)[2], int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = j * 8 + 2 * t + e;
      const bool okc = c0 + c < n_str;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float& x = s[j * 4 + 2 * r + e];
        // gp of every element, then a select (no branch: the logits of the
        // next tile are in flight on the tensor cores meanwhile).
        const bool keep = okc & ok[r];
        if constexpr (kDtable) {
          const float gp = __expf(x + ra[r] - vec[c]) * vec[kStr + c];
          x = keep ? gp : 0.f;
          db[r] += x;
        } else {
          const float gp = __expf(x + vec[c] - ra[r]) * rb[r];
          x = keep ? gp : 0.f;
        }
      }
    }
  }
}

// gp rounded to bf16 straight into wgmma A fragments (the fp32 accumulator
// layout of m64nN is the A layout of the next k16 step).
__device__ __forceinline__ void gp_fragments(uint32_t (&a)[4][4], const float (&s)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    a[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    a[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    a[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// One consumer warpgroup's work on one streamed tile: gp from the logits `s`
// (already waited for), rounded into A fragments and multiplied by the same
// tile, MN-major, into `acc`. Starts the product and commits it; the caller
// waits.
template <int D, bool kDtable>
__device__ __forceinline__ void tile_gradient(float (&s)[32], float (&acc)[D / 2], float (&db)[2], uint32_t tile,
                                              const float* vec, int c0, int n_str, const bool (&ok)[2],
                                              const float (&ra)[2], const float (&rb)[2], int t) {
  constexpr int SW = swizzle_bytes(D);
  tile_gp<kDtable>(s, db, vec, c0, n_str, ok, ra, rb, t);
  uint32_t a[4][4];
  gp_fragments(a, s);
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    // K = tile rows 16kk.., N = D: the same tile, MN-major; the next sw / 2
    // columns (chunk) lie kStr * SW bytes on.
    wgmma_rs<D, 1>(acc, a[kk], smem_desc(tile + kk * 16 * SW, kStr * SW, 8 * SW, SW), 1);
  }
  wgmma_commit();
}

// The logits of the warpgroup's 64 resident rows (A fragments `ra_frag` in
// registers) against a 64-row tile (K-major in smem). Starts and commits.
template <int D>
__device__ __forceinline__ void tile_logits(float (&s)[32], const uint32_t (&ra_frag)[D / 16][4], uint32_t tile) {
  constexpr int SW = swizzle_bytes(D), KPC = SW / 32;
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    wgmma_rs<64, 0>(s, ra_frag[ks], smem_desc(tile + (ks / KPC) * kStr * SW + (ks % KPC) * 32, 16, 8 * SW, SW), ks > 0);
  }
  wgmma_commit();
}

// One tile of the consumers' pipeline: wait for tile cur's logits (sc) and
// the previous tile's product, release the previous tile's stage, start tile
// cur + 1's logits into sn, then tile cur's gradient product. Past the
// split's last tile the step runs on that tile's stage (landed, never
// refilled) with every gp masked to 0, so that every wgmma is started on the
// one path all steps take: no wgmma under a branch.
template <int D, bool kDtable>
__device__ __forceinline__ void pipeline_step(float (&sc)[32], float (&sn)[32], float (&acc)[D / 2], float (&db)[2],
                                              const uint32_t (&rf)[D / 16][4], int cur, int t0, int t1, int n_str,
                                              uint64_t* full, uint64_t* empty, uint32_t str_addr, const float* vec_s,
                                              const bool (&ok)[2], const float (&ra)[2], const float (&rb)[2], int t) {
  constexpr int SW = swizzle_bytes(D), NCH = D / (SW / 2), NV = stream_vecs<kDtable>();
  const int st = (min(cur, t1 - 1) - t0) % kStages;
  wgmma_wait<0>();
  fence_regs(sc);
  fence_regs(acc);
  if (cur > t0 && cur < t1) mbar_arrive(&empty[(st + kStages - 1) % kStages]);
  const int k = min(cur + 1, t1 - 1) - t0;
  mbar_wait(&full[k % kStages], (k / kStages) & 1);
  tile_logits<D>(sn, rf, str_addr + (k % kStages) * NCH * kStr * SW);
  tile_gradient<D, kDtable>(sc, acc, db, str_addr + st * NCH * kStr * SW, vec_s + st * NV * kStr, cur * kStr,
                            cur < t1 ? n_str : 0, ok, ra, rb, t);
}

// One pass up to D = 128: the resident rows' A fragments in registers.
// kDtable false: the dq pass (resident = queries, streamed = catalog rows,
// out = dq). True: the dtable pass (resident = catalog rows, streamed =
// queries, out = dtable, and dbias). With S splits (gridDim.y), split s
// writes its partial sums at out + s * n_res * D and dbias + s * n_res.
// row_a / row_b: per resident row, the dq pass's lse and g, the dtable
// pass's bias (row_b unused).
template <int D, bool kDtable>
__device__ __forceinline__ void narrow_pass(const CUtensorMap& res_map, const CUtensorMap& str_map,
                                            const CUtensorMap& vec0_map, const CUtensorMap& vec1_map,
                                            const float* __restrict__ row_a, const float* __restrict__ row_b,
                                            float* __restrict__ out, float* __restrict__ dbias, int n_res, int n_str,
                                            int tiles_per_split) {
  constexpr int SW = swizzle_bytes(D), CC = SW / 2, NCH = D / CC, NV = stream_vecs<kDtable>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* res_s = base;                                     // [NCH][kRes][SW bytes]
  unsigned char* str_s = base + kRes * D * 2;                      // [kStages][NCH][kStr][SW bytes]
  float* vec_s = reinterpret_cast<float*>(str_s + kStages * kStr * D * 2);  // [kStages][NV][kStr]
  uint64_t* full = reinterpret_cast<uint64_t*>(vec_s + kStages * NV * kStr);
  uint64_t* empty = full + kStages;
  uint64_t* res_full = empty + kStages;

  const int r0 = blockIdx.x * kRes;
  const int split = blockIdx.y;
  const int n_tiles = (n_str + kStr - 1) / kStr;
  const int t0 = split * tiles_per_split, t1 = min(n_tiles, t0 + tiles_per_split);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);  // every consumer thread
    }
    mbar_init(res_full, 1);
    mbar_init_fence();
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp >= 8) {  // the producer warpgroup: one thread keeps the ring full
    // It needs few registers: hand them to the consumers (setmaxnreg works
    // per warpgroup, hence a whole producer warpgroup).
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 8 && lane == 0) {
      mbar_arrive_expect_tx(res_full, kRes * D * 2);
      for (int c = 0; c < NCH; ++c) tma_load_2d(res_s + c * kRes * SW, &res_map, c * CC, r0, res_full);
      int st = 0;
      uint32_t ph = 0;
      for (int it = t0; it < t1; ++it) {
        mbar_wait(&empty[st], ph ^ 1);
        mbar_arrive_expect_tx(&full[st], kStr * D * 2 + NV * kStr * 4);
        for (int c = 0; c < NCH; ++c) {
          tma_load_2d(str_s + (st * NCH + c) * kStr * SW, &str_map, c * CC, it * kStr, &full[st]);
        }
        tma_load_1d(vec_s + st * NV * kStr, &vec0_map, it * kStr, &full[st]);
        if constexpr (NV == 2) tma_load_1d(vec_s + (st * NV + 1) * kStr, &vec1_map, it * kStr, &full[st]);
        if (++st == kStages) {
          st = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // 232 registers a consumer thread (the launch gives 168): the accumulators,
  // two logit tiles and the resident fragments fit with no spills.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  // Consumers: warpgroup wg owns resident rows [wg * 64, wg * 64 + 64); each
  // thread holds rows g and g + 8 of its warp's 16 in the accumulators.
  const int wg = warp / 4, wi = warp % 4, g = lane / 4, t = lane % 4;
  int row[2];
  bool ok[2];
  float ra[2], rb[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row[r] = r0 + wg * 64 + wi * 16 + g + 8 * r;
    ok[r] = row[r] < n_res;
    ra[r] = ok[r] ? row_a[row[r]] : 0.f;
    rb[r] = ok[r] && !kDtable ? row_b[row[r]] : 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float db[2] = {0.f, 0.f};
  mbar_wait(res_full, 0);
  // The resident rows' A fragments, read once from the swizzled smem tile.
  uint32_t rf[D / 16][4];
  {
    const uint32_t res_addr = smem_u32(res_s);
    const int lr = wg * 64 + wi * 16 + g;  // local row
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int rr = lr + (h & 1) * 8, col = ks * 16 + 2 * t + (h >> 1) * 8;
        const uint32_t addr = res_addr + (col / CC) * kRes * SW + swizzled<SW>(rr, col % CC);
        asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(rf[ks][h]) : "r"(addr));
      }
    }
  }

  // Software pipeline over the tiles: the logits of tile it + 1 are on the
  // tensor cores while tile it's gp is computed (two logit buffers, s0 for
  // the even tiles of the split, s1 for the odd).
  const uint32_t str_addr = smem_u32(str_s);
  float s0[32] = {}, s1[32] = {};
  mbar_wait(&full[0], 0);  // every split has a tile
  tile_logits<D>(s0, rf, str_addr);
  for (int it = t0; it < t1; it += 2) {
    pipeline_step<D, kDtable>(s0, s1, acc, db, rf, it, t0, t1, n_str, full, empty, str_addr, vec_s, ok, ra, rb, t);
    pipeline_step<D, kDtable>(s1, s0, acc, db, rf, it + 1, t0, t1, n_str, full, empty, str_addr, vec_s, ok, ra, rb, t);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  float* dst0 = out + (size_t)split * n_res * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if constexpr (kDtable) {
      db[r] += __shfl_xor_sync(0xffffffffu, db[r], 1);
      db[r] += __shfl_xor_sync(0xffffffffu, db[r], 2);
      if (ok[r] && t == 0) dbias[(size_t)split * n_res + row[r]] = db[r];
    }
    if (!ok[r]) continue;
    float* dst = dst0 + (size_t)row[r] * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<float2*>(dst + j * 8) = make_float2(acc[j * 4 + 2 * r], acc[j * 4 + 2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------- D = 192, 256
//
// At D = 256 a consumer thread's [64, 256] fp32 sums take 128 registers;
// the resident rows' A fragments (64 more) and two logit tiles would not fit
// beside them under setmaxnreg's 232. So the wide pass is csrc/sampled.cu's
// backward at D = 256 (B10) without the hit mask: the logits read A (the
// warpgroup's resident rows) from shared memory by descriptor, one logits
// buffer a warpgroup (the other warpgroup's products run while this one
// forms gp), and the gradient product runs in products of NP columns
// (wgmma_rs takes N <= 128: two of 128 at D = 256, three of 64 at D = 192).
// Block shape, ring, splits and arithmetic are narrow_pass's.

template <int D>
__host__ __device__ constexpr int wide_cols() {
  return D % 128 == 0 ? 128 : 64;
}


// The 64 x 64 logits of the warpgroup's resident rows (at `res`, the first
// of the block's bwd_res(D)) against a streamed tile, A and B K-major in smem.
// Starts and commits; the caller waits.
template <int D>
__device__ __forceinline__ void wide_logits(float (&s)[32], uint32_t res, uint32_t tile) {
  constexpr int SW = swizzle_bytes(D), KPC = SW / 32;
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const uint32_t k_off = (ks % KPC) * 32;
    const uint64_t da = smem_desc(res + (ks / KPC) * bwd_res(D) * SW + k_off, 16, 8 * SW, SW);
    const uint64_t db = smem_desc(tile + (ks / KPC) * kStr * SW + k_off, 16, 8 * SW, SW);
    if (ks == 0) {
      wgmma_ss64_first(s, da, db);
    } else {
      wgmma_ss<64>(s, da, db, 1);
    }
  }
  wgmma_commit();
}

// acc[64 x D] += bf16(gp)[64 x 64] . tile[64 x D], the tile read MN-major,
// in products of NP columns (the chunks of 64 columns lie kStr * SW bytes
// apart). Starts and commits.
template <int D>
__device__ __forceinline__ void wide_product(float (&acc)[D / wide_cols<D>()][wide_cols<D>() / 2],
                                             const float (&s)[32], uint32_t tile) {
  constexpr int SW = swizzle_bytes(D), NP = wide_cols<D>(), NH = D / NP;
  uint32_t a[4][4];
  gp_fragments(a, s);
#pragma unroll
  for (int h = 0; h < NH; ++h) fence_regs(acc[h]);
  wgmma_fence();
#pragma unroll
  for (int h = 0; h < NH; ++h) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs<NP, 1>(acc[h], a[kk], smem_desc(tile + h * (NP / 64) * kStr * SW + kk * 16 * SW, kStr * SW, 8 * SW, SW),
                      1);
    }
  }
  wgmma_commit();
}

// One pass at D = 192, 256, 384 or 512; arguments as narrow_pass's. A block
// sums the output columns of its half (gridDim.z; one half but at D = 384
// and 512); dbias, the same in every half, is written by half 0.
template <int D, bool kDtable>
__device__ __forceinline__ void wide_pass(const CUtensorMap& res_map, const CUtensorMap& str_map,
                                          const CUtensorMap& vec0_map, const CUtensorMap& vec1_map,
                                          const float* __restrict__ row_a, const float* __restrict__ row_b,
                                          float* __restrict__ out, float* __restrict__ dbias, int n_res, int n_str,
                                          int tiles_per_split) {
  constexpr int SW = swizzle_bytes(D), CC = SW / 2, NCH = D / CC, NV = stream_vecs<kDtable>();
  constexpr int Cons = bwd_cons(D), kRes = bwd_res(D), kStages = bwd_stages(D), DO = D / bwd_halves(D);
  constexpr int NP = wide_cols<DO>(), NH = DO / NP;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* res_s = base;                                     // [NCH][kRes][SW bytes]
  unsigned char* str_s = base + kRes * D * 2;                      // [kStages][NCH][kStr][SW bytes]
  float* vec_s = reinterpret_cast<float*>(str_s + kStages * kStr * D * 2);  // [kStages][NV][kStr]
  uint64_t* full = reinterpret_cast<uint64_t*>(vec_s + kStages * NV * kStr);
  uint64_t* empty = full + kStages;
  uint64_t* res_full = empty + kStages;

  const int r0 = blockIdx.x * kRes;
  // A compile-time 0 where one block sums every column (a column offset in
  // registers had ptxas serialise B10's D = 256 wgmma, C7515).
  const int split = blockIdx.y, col0 = bwd_halves(D) > 1 ? blockIdx.z * DO : 0;
  const int n_tiles = (n_str + kStr - 1) / kStr;
  const int t0 = split * tiles_per_split, t1 = min(n_tiles, t0 + tiles_per_split);
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 128 * Cons);  // every consumer thread
    }
    mbar_init(res_full, 1);
    mbar_init_fence();
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp >= 4 * Cons) {  // the producer warpgroup, as narrow_pass's
    if constexpr (Cons == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 4 * Cons && lane == 0) {
      mbar_arrive_expect_tx(res_full, kRes * D * 2);
      for (int c = 0; c < NCH; ++c) tma_load_2d(res_s + c * kRes * SW, &res_map, c * CC, r0, res_full);
      int st = 0;
      uint32_t ph = 0;
      for (int it = t0; it < t1; ++it) {
        mbar_wait(&empty[st], ph ^ 1);
        mbar_arrive_expect_tx(&full[st], kStr * D * 2 + NV * kStr * 4);
        for (int c = 0; c < NCH; ++c) {
          tma_load_2d(str_s + (st * NCH + c) * kStr * SW, &str_map, c * CC, it * kStr, &full[st]);
        }
        tma_load_1d(vec_s + st * NV * kStr, &vec0_map, it * kStr, &full[st]);
        if constexpr (NV == 2) tma_load_1d(vec_s + (st * NV + 1) * kStr, &vec1_map, it * kStr, &full[st]);
        if (++st == kStages) {
          st = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // 232 registers a consumer thread with two consumer warpgroups: the [64,
  // D] sums, one logits tile and gp's A fragments. With one (D = 384 and
  // 512, 256 threads) the launch's limit of 255 holds its half.
  if constexpr (Cons == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = warp / 4, wi = warp % 4, g = lane / 4, t = lane % 4;
  int row[2];
  bool ok[2];
  float ra[2], rb[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row[r] = r0 + wg * 64 + wi * 16 + g + 8 * r;
    ok[r] = row[r] < n_res;
    ra[r] = ok[r] ? row_a[row[r]] : 0.f;
    rb[r] = ok[r] && !kDtable ? row_b[row[r]] : 0.f;
  }
  float acc[NH][NP / 2];
#pragma unroll
  for (int h = 0; h < NH; ++h) {
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) acc[h][i] = 0.f;
  }
  float db[2] = {0.f, 0.f};
  float s[32];
  const uint32_t res_addr = smem_u32(res_s) + wg * 64 * SW, str_addr = smem_u32(str_s);
  const uint32_t out_off = (col0 / 64) * kStr * SW;  // the tile's chunk of the block's first output column
  mbar_wait(res_full, 0);

  // A tile: its logits on the tensor cores, then (once they and the previous
  // tile's product are done) the previous tile's stage released, gp, and
  // this tile's product started; it runs while the next tile's logits are
  // started behind it.
  for (int it = t0; it < t1; ++it) {
    const int k = it - t0, st = k % kStages;
    const uint32_t tile = str_addr + st * NCH * kStr * SW;
    mbar_wait(&full[st], (k / kStages) & 1);
    wide_logits<D>(s, res_addr, tile);
    wgmma_wait<0>();
    fence_regs(s);
#pragma unroll
    for (int h = 0; h < NH; ++h) fence_regs(acc[h]);
    if (k > 0) {
      // The previous tile's vectors, read by generic loads, before the next bulk write into its stage.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(&empty[(st + kStages - 1) % kStages]);
    }
    tile_gp<kDtable>(s, db, vec_s + st * NV * kStr, it * kStr, n_str, ok, ra, rb, t);
    wide_product<DO>(acc, s, tile + out_off);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int h = 0; h < NH; ++h) fence_regs(acc[h]);

  float* dst0 = out + (size_t)split * n_res * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if constexpr (kDtable) {
      db[r] += __shfl_xor_sync(0xffffffffu, db[r], 1);
      db[r] += __shfl_xor_sync(0xffffffffu, db[r], 2);
      if (ok[r] && t == 0 && col0 == 0) dbias[(size_t)split * n_res + row[r]] = db[r];
    }
    if (!ok[r]) continue;
    float* dst = dst0 + (size_t)row[r] * D + col0 + 2 * t;
#pragma unroll
    for (int h = 0; h < NH; ++h) {
#pragma unroll
      for (int j = 0; j < NP / 8; ++j) {
        *reinterpret_cast<float2*>(dst + h * NP + j * 8) = make_float2(acc[h][j * 4 + 2 * r], acc[h][j * 4 + 2 * r + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------- D = 768, 1024

// One pass at D = 768 or 1024 (kchunk.cuh's K-chunked backward), or at D =
// 0 with `width` columns past 1024 (its streamed backward): a block sums the
// 256 output columns of range blockIdx.z, gp and its product as wide_pass's;
// arguments as narrow_pass's. dbias, the same in every range, is written by
// range 0.
template <int D, bool kDtable>
__device__ __forceinline__ void kc_pass(const CUtensorMap& res_map, const CUtensorMap& str_map,
                                        const CUtensorMap& vec0_map, const CUtensorMap& vec1_map,
                                        const float* __restrict__ row_a, const float* __restrict__ row_b,
                                        float* __restrict__ out, float* __restrict__ dbias, int n_res, int n_str,
                                        int tiles_per_split, int width) {
  const int split = blockIdx.y, col0 = blockIdx.z * kKc;
  const int n_tiles = (n_str + kStr - 1) / kStr;
  const int t0 = split * tiles_per_split, t1 = min(n_tiles, t0 + tiles_per_split);
  const int lane = threadIdx.x % 32, wi = threadIdx.x / 32 % 4, g = lane / 4, t = lane % 4;
  int row[2];
  bool ok[2];
  float ra[2], rb[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row[r] = blockIdx.x * kKcRows + wi * 16 + g + 8 * r;
    ok[r] = row[r] < n_res;
    ra[r] = ok[r] ? row_a[row[r]] : 0.f;
    rb[r] = ok[r] && !kDtable ? row_b[row[r]] : 0.f;
  }
  const CUtensorMap* const vecs[2] = {&vec0_map, &vec1_map};
  float acc[2][64];
  float db[2] = {0.f, 0.f};
  auto tile = [&](float (&s)[32], const float* vec, int it, uint32_t hold) {
    tile_gp<kDtable>(s, db, vec, it * kStr, n_str, ok, ra, rb, t);
    wide_product<kKc>(acc, s, hold);
  };
  bool consumer;
  if constexpr (D == 0) {
    consumer = kcs_bwd_run<stream_vecs<kDtable>()>(acc, &res_map, &str_map, vecs, t0, t1, width / kKc, tile);
  } else {
    consumer = kc_bwd_run<D, stream_vecs<kDtable>()>(acc, &res_map, &str_map, vecs, t0, t1, tile);
  }
  if (!consumer) return;

  const int W = D == 0 ? width : D;
  float* dst0 = out + (size_t)split * n_res * W;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if constexpr (kDtable) {
      db[r] += __shfl_xor_sync(0xffffffffu, db[r], 1);
      db[r] += __shfl_xor_sync(0xffffffffu, db[r], 2);
      if (ok[r] && t == 0 && col0 == 0) dbias[(size_t)split * n_res + row[r]] = db[r];
    }
    if (!ok[r]) continue;
    float* dst = dst0 + (size_t)row[r] * W + col0 + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        *reinterpret_cast<float2*>(dst + h * 128 + j * 8) = make_float2(acc[h][j * 4 + 2 * r], acc[h][j * 4 + 2 * r + 1]);
      }
    }
  }
}

// A pass as a kernel of its own name (the profiler tells the dq and dtable
// passes apart by kDtable): narrow_pass up to D = 128, wide_pass to 512,
// kc_pass above and at D = 0 (`width` columns past 1024; the other widths
// take no `width`).
template <int D, bool kDtable>
__global__ void __launch_bounds__(bwd_threads(D), 1)
    ce_bwd_pass(const __grid_constant__ CUtensorMap res_map, const __grid_constant__ CUtensorMap str_map,
                const __grid_constant__ CUtensorMap vec0_map, const __grid_constant__ CUtensorMap vec1_map,
                const float* __restrict__ row_a, const float* __restrict__ row_b, float* __restrict__ out,
                float* __restrict__ dbias, int n_res, int n_str, int tiles_per_split, int width) {
  if constexpr (D == 0) {
    kc_pass<0, kDtable>(res_map, str_map, vec0_map, vec1_map, row_a, row_b, out, dbias, n_res, n_str,
                        tiles_per_split, width);
  } else if constexpr (D <= 128) {
    narrow_pass<D, kDtable>(res_map, str_map, vec0_map, vec1_map, row_a, row_b, out, dbias, n_res, n_str,
                            tiles_per_split);
  } else if constexpr (D <= 512) {
    wide_pass<D, kDtable>(res_map, str_map, vec0_map, vec1_map, row_a, row_b, out, dbias, n_res, n_str,
                          tiles_per_split);
  } else {
    kc_pass<D, kDtable>(res_map, str_map, vec0_map, vec1_map, row_a, row_b, out, dbias, n_res, n_str,
                        tiles_per_split, width);
  }
}

// How many ways a pass at width D splits its streamed tiles (fill_splits):
// its blocks are the resident row blocks times the column halves.
int splits(int n_res, int n_str, int D, int* per) {
  return fill_splits((n_res + bwd_res(D) - 1) / bwd_res(D) * bwd_halves(D), (n_str + kStr - 1) / kStr, per);
}

// The template width of a pass at width D: D itself up to 1024, 0 (the
// streamed pass) past it.
__host__ __device__ constexpr int pass_dim(int D) { return D > 1024 ? 0 : D; }

// One pass at width `width` (D itself, or any multiple of 256 past 1024 at
// D = 0). vec0/vec1: the streamed rows' vectors (dq: bias; dtable: lse, g);
// row_a/row_b: the resident rows' (dq: lse, g; dtable: bias).
template <int D, bool kDtable>
cudaError_t run_pass(const void* res, int n_res, const void* str, int n_str, const float* vec0, const float* vec1,
                     const float* row_a, const float* row_b, float* out, float* dbias, float* scratch, int width,
                     cudaStream_t s) {
  constexpr int Res = bwd_res(D);
  CUtensorMap res_map, str_map, vec0_map, vec1_map;
  if (!make_map(&res_map, res, n_res, width, Res) || !make_map(&str_map, str, n_str, width, kStr) ||
      !make_vec_map(&vec0_map, vec0, n_str, kStr) || !make_vec_map(&vec1_map, vec1, n_str, kStr)) {
    return cudaErrorInvalidValue;
  }
  int per = 0;
  const int S = splits(n_res, n_str, width, &per);
  float* o = S > 1 ? scratch : out;
  float* ob = S > 1 ? scratch + (size_t)S * n_res * width : dbias;
  constexpr int smem = pass_smem_bytes<D, kDtable>();
  auto kernel = ce_bwd_pass<D, kDtable>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3((n_res + Res - 1) / Res, S, bwd_halves(width)), bwd_threads(D), smem, s>>>(
      res_map, str_map, vec0_map, vec1_map, row_a, row_b, o, ob, n_res, n_str, per, width);
  e = cudaGetLastError();
  if (e != cudaSuccess || S == 1) return e;
  sum_splits<<<2 * kSms, 256, 0, s>>>(o, out, (long long)n_res * width, S);
  if (kDtable) sum_splits<<<2 * kSms, 256, 0, s>>>(ob, dbias, n_res, S);
  return cudaGetLastError();
}

// Scratch floats a pass needs for its partials (0 when it does not split).
long long pass_scratch(int n_res, int n_str, int D, bool dtable) {
  int per = 0;
  const int S = splits(n_res, n_str, D, &per);
  return S > 1 ? (long long)S * n_res * (D + (dtable ? 1 : 0)) : 0;
}

template <int D>
cudaError_t run_bwd(const void* q, const void* table, const void* bias, const void* lse, const void* g, void* dq,
                    void* dtable, void* dbias, void* scratch, int N, int V, int width, cudaStream_t s) {
  const float* b = static_cast<const float*>(bias);
  const float* l = static_cast<const float*>(lse);
  const float* gg = static_cast<const float*>(g);
  float* sc = static_cast<float*>(scratch);
  cudaError_t e = run_pass<D, false>(q, N, table, V, b, b, l, gg, static_cast<float*>(dq), nullptr, sc, width, s);
  if (e != cudaSuccess) return e;
  return run_pass<D, true>(table, V, q, N, l, gg, b, b, static_cast<float*>(dtable), static_cast<float*>(dbias),
                           sc + pass_scratch(N, V, width, false), width, s);
}

}  // namespace

// The widths the CE kernels take, defined once in ce.cu.
extern "C" int ce_supports_dim(int D);

// The shape of ce_bwd's blocks at a width it is built for, as out[0..3]:
// the resident rows a block, the ring's stages, the output column ranges
// (gridDim.z) and the columns a streamed chunk (D itself up to 512);
// ops/fused_ce.py's bwd_plan mirrors it. The dq pass's and the dtable pass's
// are the same. Returns 0 for a width it is not built for.
extern "C" int ce_bwd_plan(int D, int* out) {
  static_assert(KcBwd<768, 1>::kStages == KcBwd<768, 2>::kStages &&
                KcBwd<1024, 1>::kStages == KcBwd<1024, 2>::kStages &&
                KcsBwd<1>::kStages == KcsBwd<2>::kStages, "the two passes' rings differ");
  if (!ce_supports_dim(D)) return 0;
  out[0] = bwd_res(D);
  out[1] = D > 1024  ? KcsBwd<1>::kStages
           : D == 768 ? KcBwd<768, 1>::kStages
           : D == 1024 ? KcBwd<1024, 1>::kStages
                       : bwd_stages(D);
  out[2] = bwd_halves(D);
  out[3] = D > 512 ? kKc : D;
  return 1;
}

// Floats of scratch ce_bwd needs for split partials (0: pass any pointer).
extern "C" long long ce_bwd_scratch(int N, int V, int D) {
  if (N <= 0 || V <= 0) return 0;
  return pass_scratch(N, V, D, false) + pass_scratch(V, N, D, true);
}

extern "C" int ce_bwd(const void* q, const void* table, const void* bias, const void* lse, const void* g, void* dq,
                      void* dtable, void* dbias, void* scratch, int N, int V, int D, int device, void* stream) {
  if (!ce_supports_dim(D) || V <= 0 || N <= 0) return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pass_dim(D)) {
    case 32: return run_bwd<32>(q, table, bias, lse, g, dq, dtable, dbias, scratch, N, V, D, s);
    case 64: return run_bwd<64>(q, table, bias, lse, g, dq, dtable, dbias, scratch, N, V, D, s);
    case 128: return run_bwd<128>(q, table, bias, lse, g, dq, dtable, dbias, scratch, N, V, D, s);
    case 192: return run_bwd<192>(q, table, bias, lse, g, dq, dtable, dbias, scratch, N, V, D, s);
    case 256: return run_bwd<256>(q, table, bias, lse, g, dq, dtable, dbias, scratch, N, V, D, s);
    case 384: return run_bwd<384>(q, table, bias, lse, g, dq, dtable, dbias, scratch, N, V, D, s);
    case 512: return run_bwd<512>(q, table, bias, lse, g, dq, dtable, dbias, scratch, N, V, D, s);
    case 768: return run_bwd<768>(q, table, bias, lse, g, dq, dtable, dbias, scratch, N, V, D, s);
    case 1024: return run_bwd<1024>(q, table, bias, lse, g, dq, dtable, dbias, scratch, N, V, D, s);
    default: return run_bwd<0>(q, table, bias, lse, g, dq, dtable, dbias, scratch, N, V, D, s);
  }
}
