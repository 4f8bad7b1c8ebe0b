// B11's wgmma design for Hopper (sm_90a): score + top-k on wgmma fed by
// TMA. topk.cu's header says what the two designs of B11 are and which shapes
// ops/topk.py's plan (topk_plan) gives to this one; the plan fixes every
// launch parameter below, and the C entry only checks them.
//
// What bounds it: config #5's eval (512 rows, 905,216 x 512 table) is 0.475
// TFLOP, 0.48 ms on the tensor cores, and the table 927 MB, 0.28 ms from
// device memory; a batch-1 request is the table's bytes alone. The mma.sync
// design (topk.cu) read the table B / 32 times there, through 2 cp.async
// stages, every score through smem, in 144 blocks (a second wave of 12).
//
// Pass 1, topk_wg_kernel, grid (slices, row groups), one block an SM:
// - A block holds a group of `rows` query rows, 64 a consumer warpgroup (one
//   or two), and walks one slice of the catalog's 64-row tiles. One producer
//   warp keeps a ring of `stages` stages full by TMA (128-byte swizzled boxes
//   of 64 columns), guarded by mbarriers (full: the bytes arrived; empty:
//   every consumer thread is done with the stage). A stage is one unit:
//   `unit_boxes` boxes of a tile's columns, and the tile's bias with its last
//   unit. The query rows stay resident where they fit beside the ring
//   (loaded once, `resident`); else each unit carries the same columns of
//   the query rows beside the tile's, read again from L2 for every tile. At B
//   <= 8 the block holds 8 query rows (qrows): the products' A descriptor
//   steps 0 bytes from one group of 8 rows to the next, so every group reads
//   those 8, and the ring takes the smem that 64 rows would.
// - Each consumer warpgroup runs wgmma m64n64k16 (A: its 64 query rows, B:
//   the tile, both K-major in smem by descriptor) over the tile's units, k16
//   steps in order over the whole width, into one of two accumulators. Once a
//   tile's products are done, its bias goes to registers and its stages are
//   freed; the next tile's first units (as many as leave the producer two
//   stages) go on the tensor cores, and the tile is selected while they run.
//   The table is read B / rows times from L2: 128 rows a block at B > 64.
// - Selection stays in registers: a thread holds two query rows' scores
//   against 16 of the tile's rows and adds their bias. Half a tile at a time,
//   it compares the max of its 8 scores a row with the row's running k-th
//   value; where no thread of the warp has one that can beat it (most halves
//   after a slice's first tiles at k = 10), that is all. Else each thread
//   appends its scores that beat the row's k-th (value, id) to the row's
//   survivor buffer (kWgSurv pairs) at offsets from a prefix sum over the quad that
//   owns the row; a buffer that a half tile might overflow is first merged,
//   by the warp that owns the row, into the row's sorted list of KP pairs in
//   device memory (cand [B, slices, KP], the pass's output), with
//   topk_select.cuh's bitonic networks and no block barrier, and the row's
//   k-th updated. The survivor buffers are in smem where the plan gives them
//   room (surv_rows), else in device memory; the code takes generic pointers.
//   No score tile goes through smem, and the [B, V] scores never reach
//   device memory.
// - Every block runs in one wave (row groups x slices <= 132): the slices
//   are as many as fill the card, their tiles cut evenly (slice s takes tiles
//   [s T / S, (s + 1) T / S)), so a batch-1 request streams the table on
//   every SM.
// Pass 2, topk_wg_merge_kernel, a block a row, 16 warps: each warp merges the
// sorted lists of every 16th slice into a sorted list in its registers (one
// bitonic combine a list, none for a list whose best misses the running k-th,
// the next list loaded meanwhile), then the warps' lists are merged pairwise
// in 4 rounds. It takes any number of slices.
//
// A score is the k16 steps of its row product summed in order on the tensor
// cores over the whole (zero-padded) width, then the fp32 bias added: the
// same steps and order as topk.cu's mma.sync design, which on the H100 gives
// the same bits for the same operands (chip_smoke.py's topk phase holds the
// two designs to each other's bits at every case). So two identical table
// rows score alike, a second launch gives the same bits, and a score does not
// depend on B, V, the slice or the design. The order (value desc, id asc) is
// total and ids are distinct, so the result does not depend on the slices,
// tiles or merges. Empty slots hold (-inf, INT_MAX).
//
// The entry point launches on the given stream, does not synchronise and
// allocates nothing; it returns cudaGetLastError() after its launches.

#include "topk_select.cuh"
#include "wgmma_tiles.cuh"

namespace {

constexpr int kWgTile = 64;                  // table rows a tile, the wgmma's N
constexpr int kWgBoxBytes = kWgTile * 128;   // a table box: 64 rows of 64 columns
constexpr int kWgSurv = 64;                  // a row's survivors between merges
constexpr int kWgHalf = 32;                  // a row's scores a half tile (a thread's 8)
constexpr int kWgMergeWarps = 16;
constexpr int kWgSmemOptIn = 232448;

__host__ __device__ constexpr int wg_boxes(int D) { return (D + 63) / 64; }

// A stage: the unit's table boxes, then (streamed) its query boxes of
// qrows rows.
__host__ __device__ constexpr int wg_stage_bytes(int qrows, int unit_boxes, bool resident) {
  return unit_boxes * (kWgBoxBytes + (resident ? 0 : qrows * 128));
}

// 1024 to align the base; the resident query rows; the ring; the stages'
// bias; the survivor buffers of surv_rows rows when they are in smem; the
// barriers (full and empty a stage, resident).
__host__ __device__ constexpr int wg_smem_bytes(int qrows, int D, int unit_boxes, int stages, bool resident,
                                                int surv_rows) {
  return 1024 + (resident ? qrows * wg_boxes(D) * 128 : 0) + stages * wg_stage_bytes(qrows, unit_boxes, resident) +
         stages * kWgTile * 4 + surv_rows * kWgSurv * 8 + (2 * stages + 1) * 8;
}

// s (+)= A box (64 rows, 64 columns) . B box (64 rows, 64 columns), K-major
// in smem at a and b; First overwrites s at the first of its 4 k16 steps.
// a_sbo: the bytes from one 8-row group of A to the next, 1024, or 0 where
// the block holds 8 query rows: every group then reads those 8.
template <bool First>
__device__ __forceinline__ void wg_box_products(float (&s)[32], uint32_t a, uint32_t b, uint32_t a_sbo) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t da = smem_desc(a + kk * 32, 16, a_sbo, 128);
    const uint64_t db = smem_desc(b + kk * 32, 16, 1024, 128);
    if (First && kk == 0) {
      wgmma_ss64_first(s, da, db);
    } else {
      wgmma_ss<64>(s, da, db, 1);
    }
  }
}

// A unit's products: nb boxes, the A box bx at a + bx * a_step, the B box at
// b + bx * kWgBoxBytes. Neither starts nor commits.
template <bool First>
__device__ __forceinline__ void wg_unit_products(float (&s)[32], uint32_t a, uint32_t a_step, uint32_t a_sbo,
                                                 uint32_t b, int nb) {
  wg_box_products<First>(s, a, b, a_sbo);
  for (int bx = 1; bx < nb; ++bx) wg_box_products<false>(s, a + bx * a_step, b + bx * kWgBoxBytes, a_sbo);
}

// A row's survivors (cnt <= kWgSurv pairs at sv, si) into its sorted
// list of KP pairs at lv, li in device memory (empty, (-inf, INT_MAX), when
// !has): the warp sorts the survivors, keeps the KP best of both lists (the
// better of list[i] and survivors[KP - 1 - i], a bitonic sequence) and sorts
// them back into the list. Returns the list's k-th pair in kv, ki. Called by
// the whole warp.
template <int KP>
__device__ __forceinline__ void wg_merge(float* lv, int* li, const float* sv, const int* si, int cnt, bool has, int k,
                                      int lane, float& kv, int& ki) {
  constexpr int ES = kWgSurv / 32, EK = KP / 32;
  float a[ES], tv[EK];
  int ai[ES], ti[EK];
  // The list's loads first: they wait on nothing, and their latency overlaps the survivors'.
#pragma unroll
  for (int e = 0; e < EK; ++e) {
    tv[e] = has ? lv[e * 32 + lane] : -INFINITY;
    ti[e] = has ? li[e * 32 + lane] : INT_MAX;
  }
  __syncwarp();  // the quad's appends are visible
#pragma unroll
  for (int e = 0; e < ES; ++e) {
    const int i = e * 32 + lane;
    const bool ok = i < cnt;
    a[e] = ok ? sv[i] : -INFINITY;
    ai[e] = ok ? si[i] : INT_MAX;
  }
  __syncwarp();  // read before the quad appends again
  warp_sort<ES>(a, ai, lane);
#pragma unroll
  for (int e = 0; e < EK; ++e) {
    if (EK - 1 - e >= ES) continue;  // survivor KP - 1 - i lies past the 32 ES held: an empty slot
    const float pv = __shfl_sync(kFull, a[EK - 1 - e < ES ? EK - 1 - e : 0], 31 - lane);
    const int pi = __shfl_sync(kFull, ai[EK - 1 - e < ES ? EK - 1 - e : 0], 31 - lane);
    if (before(pv, pi, tv[e], ti[e])) {
      tv[e] = pv;
      ti[e] = pi;
    }
  }
  warp_bitonic_merge<EK>(tv, ti, lane);
  float xv = tv[0];
  int xi = ti[0];
#pragma unroll
  for (int e = 0; e < EK; ++e) {
    lv[e * 32 + lane] = tv[e];
    li[e * 32 + lane] = ti[e];
    if (e == (k - 1) / 32) {
      xv = tv[e];
      xi = ti[e];
    }
  }
  kv = __shfl_sync(kFull, xv, (k - 1) % 32);
  ki = __shfl_sync(kFull, xi, (k - 1) % 32);
}

// Pass 1 (see the top of the file). lists_v/lists_i: [B, slices, KP].
template <int KP>
__global__ void __launch_bounds__(2 * 128 + 32, 1)
    topk_wg_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap t_map,
                   const __grid_constant__ CUtensorMap b_map, float* __restrict__ lists_v, int* __restrict__ lists_i,
                   float* __restrict__ surv_all_v, int* __restrict__ surv_all_i, int B, int V, int D, int k, int rows,
                   int qrows, int unit_boxes, int stages, int resident, int surv_rows) {
  const int boxes = wg_boxes(D), units = (boxes + unit_boxes - 1) / unit_boxes;
  const int slice = blockIdx.x, S = gridDim.x, r0 = blockIdx.y * rows;
  const int n_tiles = (V + kWgTile - 1) / kWgTile;
  const int t0 = (int)((long long)slice * n_tiles / S), t1 = (int)((long long)(slice + 1) * n_tiles / S);
  const int qbox = qrows * 128;  // a query box: the block's rows (or 8 of them), 64 columns
  const int sbytes = wg_stage_bytes(qrows, unit_boxes, resident);

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* q_s = base;                                          // [boxes][qrows][128 bytes] when resident
  unsigned char* ring = base + (resident ? boxes * qbox : 0);         // [stages][unit_boxes][8 KB] (+ [unit_boxes][qbox])
  float* bias_s = reinterpret_cast<float*>(ring + stages * sbytes);   // [stages][64]
  float* surv_s = bias_s + stages * kWgTile;                          // [surv_rows][kWgSurv] values, then ids
  uint64_t* full = reinterpret_cast<uint64_t*>(surv_s + surv_rows * kWgSurv * 2);
  uint64_t* empty = full + stages;
  uint64_t* res_full = empty + stages;

  const int cons = rows / 64;
  if (threadIdx.x == 0) {
    for (int st = 0; st < stages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], cons * 128);  // every consumer thread
    }
    mbar_init(res_full, 1);
    mbar_init_fence();
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp >= 4 * cons) {  // the producer warp: one thread keeps the ring full
    if (warp == 4 * cons && lane == 0) {
      if (resident) {
        mbar_arrive_expect_tx(res_full, boxes * qbox);
        for (int b = 0; b < boxes; ++b) tma_load_2d(q_s + b * qbox, &q_map, b * 64, r0, res_full);
      }
      int n = 0;
      for (int it = t0; it < t1; ++it) {
        for (int u = 0; u < units; ++u, ++n) {
          const int st = n % stages, nb = min(unit_boxes, boxes - u * unit_boxes);
          const bool last = u == units - 1;
          unsigned char* dst = ring + st * sbytes;
          mbar_wait(&empty[st], ((n / stages) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[st], nb * (kWgBoxBytes + (resident ? 0 : qbox)) + (last ? kWgTile * 4 : 0));
          for (int b = 0; b < nb; ++b) {
            tma_load_2d(dst + b * kWgBoxBytes, &t_map, (u * unit_boxes + b) * 64, it * kWgTile, &full[st]);
          }
          if (!resident) {
            for (int b = 0; b < nb; ++b) {
              tma_load_2d(dst + unit_boxes * kWgBoxBytes + b * qbox, &q_map, (u * unit_boxes + b) * 64, r0, &full[st]);
            }
          }
          if (last) tma_load_1d(bias_s + st * kWgTile, &b_map, it * kWgTile, &full[st]);
        }
      }
    }
    return;
  }

  // Consumers: warp wi of warpgroup wg; thread (g, t) holds rows lr and lr + 8
  // (of the block's) against columns 8j + 2t + e of a tile, s[4j + 2r + e].
  const int wg = warp / 4, wi = warp % 4, g = lane / 4, t = lane % 4;
  const int lr = wg * 64 + wi * 16 + g;
  const bool ok[2] = {r0 + lr < B, r0 + lr + 8 < B};
  float thr_v[2] = {-INFINITY, -INFINITY};
  int thr_i[2] = {INT_MAX, INT_MAX}, cnt[2] = {0, 0};
  bool has[2] = {false, false};

  // The block's rows' survivor buffers, [rows][kWgSurv] pairs: in smem
  // where the plan gives them room (surv_rows: the rows that can append,
  // 8 at B <= 8), else in device memory, where appends are stores that no
  // one waits for. Generic pointers, one code path.
  const size_t blk = ((size_t)blockIdx.y * S + slice) * rows * kWgSurv;
  float* surv_v = surv_rows ? surv_s : surv_all_v + blk;
  int* surv_i = surv_rows ? reinterpret_cast<int*>(surv_s + surv_rows * kWgSurv) : surv_all_i + blk;
  const uint32_t ring_a = smem_u32(ring);
  const uint32_t a_sbo = qrows == 8 ? 0 : 1024;
  const uint32_t a_res = smem_u32(q_s) + wg * 64 * 128;
  // The A operand of unit u in stage st: its first box, and the step to the next.
  auto a_box = [&](int st, int u) -> uint32_t {
    return resident ? a_res + u * unit_boxes * qbox : ring_a + st * sbytes + unit_boxes * kWgBoxBytes + wg * 64 * 128;
  };
  const uint32_t a_step = qbox;
  auto unit_boxes_of = [&](int u) { return min(unit_boxes, boxes - u * unit_boxes); };

  // Rows of this warp whose buffer holds more than lim survivors (and, at
  // the end, rows never merged), merged one after the other by the whole warp.
  auto merge_rows = [&](int lim, bool final) {
    const bool n0 = t == 0 && ok[0] && (cnt[0] > lim || (final && !has[0]));
    const bool n1 = t == 0 && ok[1] && (cnt[1] > lim || (final && !has[1]));
    unsigned long long need = (unsigned long long)__ballot_sync(kFull, n1) << 32 | __ballot_sync(kFull, n0);
    while (need) {
      const int bit = __ffsll((long long)need) - 1, l = bit & 31, r = bit >> 5;
      need &= need - 1;
      const int c = __shfl_sync(kFull, r ? cnt[1] : cnt[0], l);
      const bool h = __shfl_sync(kFull, (int)(r ? has[1] : has[0]), l) != 0;
      const int row = wg * 64 + wi * 16 + l / 4 + 8 * r;
      const size_t at = ((size_t)(r0 + row) * S + slice) * KP;
      float kv;
      int ki;
      wg_merge<KP>(lists_v + at, lists_i + at, surv_v + row * kWgSurv, surv_i + row * kWgSurv, c, h, k, lane, kv, ki);
      if (g == l / 4) {  // r is a run-time value: no dynamic index into the row arrays
        if (r) {
          thr_v[1] = kv;
          thr_i[1] = ki;
          cnt[1] = 0;
          has[1] = true;
        } else {
          thr_v[0] = kv;
          thr_i[0] = ki;
          cnt[0] = 0;
          has[0] = true;
        }
      }
    }
  };

  // A tile's scores (this thread's 32: the products plus the bias; -inf
  // past V, the last tile's zero rows) through the filter, half a tile at a
  // time. A slice's ids rise tile by tile and half by half, and a row's list
  // holds only earlier halves' pairs, so a score equal to the row's k-th
  // value loses on its id, unless the k-th is an empty slot (-inf, INT_MAX).
  // (Letting such ties through, a slice of the -1e30 padded rows, whose
  // scores are all -1e30, appended and merged every score.) Fast path: no
  // row of the warp has a score that can pass, by the max of each thread's 8
  // scores a row. Else the rows whose buffer might overflow are merged
  // first, and each thread appends its scores that beat its row's k-th
  // (value, id) at offsets from a prefix sum over the quad that owns the row.
  auto filter = [&](float (&s)[32], const float2 (&bb)[8], int v0) {
    const bool tail = v0 + kWgTile > V;  // warp-uniform
    float mx[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float& x = s[4 * j + 2 * r + e];
          x += e ? bb[j].y : bb[j].x;
          if (tail && v0 + j * 8 + 2 * t + e >= V) x = -INFINITY;
          mx[j / 4][r] = fmaxf(mx[j / 4][r], x);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // Branch-free compares (| and & on bools): a branch on a score here is a
      // divergent path that reads accumulator registers, and ptxas then
      // serialises every wgmma of the kernel (C7520).
      const bool may0 = (mx[h][0] > thr_v[0]) | ((mx[h][0] == thr_v[0]) & (thr_i[0] == INT_MAX));
      const bool may1 = (mx[h][1] > thr_v[1]) | ((mx[h][1] == thr_v[1]) & (thr_i[1] == INT_MAX));
      if (!__any_sync(kFull, (ok[0] & may0) | (ok[1] & may1))) continue;
      merge_rows(kWgSurv - kWgHalf, false);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        unsigned pm = 0;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = 4 * h + jj;
            const int v = v0 + j * 8 + 2 * t + e;
            const float x = s[4 * j + 2 * r + e];
            const bool pass = ((x > thr_v[r]) | ((x == thr_v[r]) & (v < thr_i[r]))) & (v < V);
            pm |= (unsigned)pass << (jj * 2 + e);
          }
        }
        if (!ok[r]) pm = 0;
        const int n = __popc(pm);
        int upto = n;  // the quad's inclusive prefix sum of n
        int y = __shfl_up_sync(kFull, upto, 1, 4);
        if (t >= 1) upto += y;
        y = __shfl_up_sync(kFull, upto, 2, 4);
        if (t >= 2) upto += y;
        const int total = __shfl_sync(kFull, upto, 3, 4);
        if (pm) {
          int at = (lr + 8 * r) * kWgSurv + cnt[r] + upto - n;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if ((pm >> (jj * 2 + e)) & 1u) {
                const int j = 4 * h + jj;
                surv_v[at] = s[4 * j + 2 * r + e];
                surv_i[at] = v0 + j * 8 + 2 * t + e;
                ++at;
              }
            }
          }
        }
        cnt[r] += total;
      }
    }
  };

  if (resident) mbar_wait(res_full, 0);
  // Tile it, unit u: ring index n = (it - t0) * units + u, stage n % stages.
  auto wait_unit = [&](int it, int u) -> int {
    const int n = (it - t0) * units + u;
    mbar_wait(&full[n % stages], (n / stages) & 1);
    return n % stages;
  };
  auto release = [&](int it, int from, int to) {
    for (int u = from; u < to; ++u) mbar_arrive(&empty[((it - t0) * units + u) % stages]);
  };
  // Units from..: each unit's product started once the unit has landed,
  // the stages of the units before it freed once its product is started and
  // theirs are done (rel: the first unit still held). The last stays held.
  int rel = 0;
  auto rest_of_tile = [&](float (&s)[32], int it, int from) {
    for (int u = from; u < units; ++u) {
      const int st = wait_unit(it, u);
      wgmma_fence();
      wg_unit_products<false>(s, a_box(st, u), a_step, a_sbo, ring_a + st * sbytes, unit_boxes_of(u));
      wgmma_commit();
      wgmma_wait<1>();
      release(it, rel, u);
      rel = u;
    }
  };

  float s0[32], s1[32];
  {
    const int st = wait_unit(t0, 0);
    fence_regs(s0);
    wgmma_fence();
    wg_unit_products<true>(s0, a_box(st, 0), a_step, a_sbo, ring_a + st * sbytes, unit_boxes_of(0));
    wgmma_commit();
    rest_of_tile(s0, t0, 1);
  }
  // Software pipeline: tile it is in cur (its products pending, the stages
  // of its units from rel on held). Once they are done, the tile's bias goes
  // to registers and its stages are freed; the next tile's first `pre` units
  // (as many as leave two stages to the producer) go on the tensor cores;
  // tile it is selected while they run; the next tile's other units follow.
  // Past the slice's last tile a step runs its products on the last tile's
  // last stage (landed, never refilled) into the accumulator that no one
  // reads, so every wgmma is started on the one path all steps take.
  // (Waiting for cur before the next products start, as B7's step does,
  // keeps ptxas from serialising them: with the wait after the start, it
  // cannot tell that the selection reads no accumulator in flight, C7514.)
  const int last_st = ((t1 - 1 - t0) * units + units - 1) % stages;
  const int pre = min(units, max(1, stages - 2));
  auto step = [&](float (&cur)[32], float (&nxt)[32], int it) {
    const bool more = it + 1 < t1;
    wgmma_wait<0>();
    fence_regs(cur);
    float2 bb[8];
    if (it < t1) {
      const float* bias = bias_s + (((it - t0) * units + units - 1) % stages) * kWgTile;
#pragma unroll
      for (int j = 0; j < 8; ++j) bb[j] = *reinterpret_cast<const float2*>(bias + j * 8 + 2 * t);
      // The bias was read by generic loads: ordered before the next bulk write into the stage.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      release(it, rel, units);
    }
    rel = 0;
    {
      const int st = more ? wait_unit(it + 1, 0) : last_st;
      const int u = more ? 0 : units - 1;
      fence_regs(nxt);
      wgmma_fence();
      wg_unit_products<true>(nxt, a_box(st, u), a_step, a_sbo, ring_a + st * sbytes, unit_boxes_of(u));
      wgmma_commit();
    }
    for (int u1 = 1; u1 < pre; ++u1) {
      const int st = more ? wait_unit(it + 1, u1) : last_st;
      const int u = more ? u1 : units - 1;
      wgmma_fence();
      wg_unit_products<false>(nxt, a_box(st, u), a_step, a_sbo, ring_a + st * sbytes, unit_boxes_of(u));
      wgmma_commit();
    }
    if (it < t1) filter(cur, bb, it * kWgTile);
    if (more) rest_of_tile(nxt, it + 1, pre);
  };
  for (int it = t0; it < t1; it += 2) {
    step(s0, s1, it);
    step(s1, s0, it + 1);
  }
  wgmma_wait<0>();
  fence_regs(s0);
  fence_regs(s1);
  merge_rows(0, true);
}

// The better KP of two sorted lists into t (sorted): t[i] against c[KP - 1 -
// i] (c reversed, given as cr: element e * 32 + lane of cr is c[KP - 1 - (e
// * 32 + lane)]) is a bitonic sequence holding them, then sorted. Called by
// the whole warp.
template <int EK>
__device__ __forceinline__ void wg_combine(float (&tv)[EK], int (&ti)[EK], const float (&cv)[EK], const int (&ci)[EK],
                                           int lane) {
#pragma unroll
  for (int e = 0; e < EK; ++e) {
    if (before(cv[e], ci[e], tv[e], ti[e])) {
      tv[e] = cv[e];
      ti[e] = ci[e];
    }
  }
  warp_bitonic_merge<EK>(tv, ti, lane);
}

// Pass 2 (see the top of the file): block b merges row b's `slices` sorted
// lists of KP. Warp w keeps a sorted list of KP in registers and merges into
// it the lists of slices w, w + 16, ..., the next one loaded while this one
// is merged, and one whose best pair misses the running k-th skipped; then
// the 16 warps' lists are merged pairwise in 4 rounds through smem, and warp
// 0 writes the first k. A list's first k are the slice's best; the pairs
// after them are real pairs of the slice too, so the first k of any merge of
// lists are the k best of their union.
template <int KP>
__global__ void __launch_bounds__(kWgMergeWarps * 32)
    topk_wg_merge_kernel(const float* __restrict__ lists_v, const int* __restrict__ lists_i, float* __restrict__ out_v,
                         int* __restrict__ out_i, int slices, int k) {
  constexpr int EK = KP / 32;
  __shared__ float sv[kWgMergeWarps / 2][KP];
  __shared__ int si[kWgMergeWarps / 2][KP];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, b = blockIdx.x;
  const float* rv = lists_v + (size_t)b * slices * KP;
  const int* ri = lists_i + (size_t)b * slices * KP;
  float tv[EK], nv[EK];
  int ti[EK], ni[EK];
  // A list reversed: element e * 32 + lane is the list's KP - 1 - (e * 32 + lane).
  auto load = [&](int sl, float (&v)[EK], int (&id)[EK]) {
#pragma unroll
    for (int e = 0; e < EK; ++e) {
      const bool in = sl < slices;
      const int at = sl * KP + KP - 1 - (e * 32 + lane);
      v[e] = in ? rv[at] : -INFINITY;
      id[e] = in ? ri[at] : INT_MAX;
    }
  };
#pragma unroll
  for (int e = 0; e < EK; ++e) {
    tv[e] = -INFINITY;
    ti[e] = INT_MAX;
  }
  load(warp, nv, ni);
  for (int sl = warp; sl < slices; sl += kWgMergeWarps) {
    float cv[EK];
    int ci[EK];
#pragma unroll
    for (int e = 0; e < EK; ++e) {
      cv[e] = nv[e];
      ci[e] = ni[e];
    }
    load(sl + kWgMergeWarps, nv, ni);
    // The list's best is its element 0: register EK - 1 of lane 31, reversed.
    const float bv = __shfl_sync(kFull, cv[EK - 1], 31);
    const int bi = __shfl_sync(kFull, ci[EK - 1], 31);
    float kv = tv[0];
    int ki = ti[0];
#pragma unroll
    for (int e = 0; e < EK; ++e) {
      if (e == (k - 1) / 32) {
        kv = tv[e];
        ki = ti[e];
      }
    }
    kv = __shfl_sync(kFull, kv, (k - 1) % 32);
    ki = __shfl_sync(kFull, ki, (k - 1) % 32);
    if (before(bv, bi, kv, ki)) wg_combine<EK>(tv, ti, cv, ci, lane);
  }
  for (int half = kWgMergeWarps / 2; half >= 1; half /= 2) {
    if (warp >= half && warp < 2 * half) {
#pragma unroll
      for (int e = 0; e < EK; ++e) {
        sv[warp - half][e * 32 + lane] = tv[e];
        si[warp - half][e * 32 + lane] = ti[e];
      }
    }
    __syncthreads();
    if (warp < half) {
      float cv[EK];
      int ci[EK];
#pragma unroll
      for (int e = 0; e < EK; ++e) {
        cv[e] = sv[warp][KP - 1 - (e * 32 + lane)];
        ci[e] = si[warp][KP - 1 - (e * 32 + lane)];
      }
      wg_combine<EK>(tv, ti, cv, ci, lane);
    }
    __syncthreads();
  }
  if (warp == 0) {
#pragma unroll
    for (int e = 0; e < EK; ++e) {
      if (e * 32 + lane < k) {
        out_v[(size_t)b * k + e * 32 + lane] = tv[e];
        out_i[(size_t)b * k + e * 32 + lane] = ti[e];
      }
    }
  }
}

template <int KP>
cudaError_t run_wg(const void* q, const void* table, const void* bias, void* cand_v, void* cand_i, void* surv_v,
                   void* surv_i, void* out_v, void* out_i, int B, int V, int D, int k, int slices, int rows, int qrows,
                   int unit_boxes, int stages, int resident, int surv_rows, cudaStream_t st) {
  CUtensorMap q_map, t_map, b_map;
  if (!make_map(&q_map, q, B, D, qrows) || !make_map(&t_map, table, V, D, kWgTile) ||
      !make_vec_map(&b_map, static_cast<const float*>(bias), V, kWgTile)) {
    return cudaErrorInvalidValue;
  }
  const int smem = wg_smem_bytes(qrows, D, unit_boxes, stages, resident != 0, surv_rows);
  auto kernel = topk_wg_kernel<KP>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(slices, (B + rows - 1) / rows), rows * 2 + 32, smem, st>>>(
      q_map, t_map, b_map, static_cast<float*>(cand_v), static_cast<int*>(cand_i), static_cast<float*>(surv_v),
      static_cast<int*>(surv_i), B, V, D, k, rows, qrows, unit_boxes, stages, resident, surv_rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  topk_wg_merge_kernel<KP><<<B, kWgMergeWarps * 32, 0, st>>>(static_cast<const float*>(cand_v),
                                                             static_cast<const int*>(cand_i),
                                                             static_cast<float*>(out_v), static_cast<int*>(out_i),
                                                             slices, k);
  return cudaGetLastError();
}

}  // namespace

// The shared memory of topk_wg_kernel at this launch shape (ops/topk.py's
// plan computes the same and keeps it within the opt-in).
extern "C" int topk_wg_smem(int qrows, int D, int unit_boxes, int stages, int resident, int surv_rows) {
  return wg_smem_bytes(qrows, D, unit_boxes, stages, resident != 0, surv_rows);
}

// cand_v/cand_i: scratch [B, slices, list_len(k)], pass 1's lists;
// surv_v/surv_i: scratch [row groups, slices, rows, 64], the rows' survivor
// buffers where they are not in smem (surv_rows = 0); out_v/out_i: [B, k].
// The launch shape is the plan's (ops/topk.py topk_plan); this checks it.
// qrows: the query rows a block holds, rows or, at B <= 8, 8; surv_rows: the
// rows whose survivor buffers are in smem, 0, qrows.
extern "C" int topk_wg(const void* q, const void* table, const void* bias, void* cand_v, void* cand_i, void* surv_v,
                       void* surv_i, void* out_v, void* out_i, int B, int V, int D, int k, int slices, int rows,
                       int qrows, int unit_boxes, int stages, int resident, int surv_rows, int device,
                       void* stream) {
  const int tiles = (V + kWgTile - 1) / kWgTile;
  if (k < 1 || k > 128 || k > V || D < 64 || D % 8 != 0 || (rows != 64 && rows != 128) ||
      (qrows != rows && !(qrows == 8 && rows == 64 && B <= 8)) || unit_boxes < 1 || unit_boxes > wg_boxes(D) ||
      stages < 2 || slices < 1 || slices > tiles || B > 65535 ||
      (surv_rows != 0 && surv_rows != qrows) ||
      wg_smem_bytes(qrows, D, unit_boxes, stages, resident != 0, surv_rows) > kWgSmemOptIn ||
      (long long)B * slices * list_len(k) > INT_MAX || (resident != 0 && resident != 1)) {
    return cudaErrorInvalidValue;
  }
  if (B <= 0) return cudaSuccess;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (list_len(k) == 32) {
    return run_wg<32>(q, table, bias, cand_v, cand_i, surv_v, surv_i, out_v, out_i, B, V, D, k, slices, rows, qrows,
                      unit_boxes, stages, resident, surv_rows, st);
  }
  return run_wg<128>(q, table, bias, cand_v, cand_i, surv_v, surv_i, out_v, out_i, B, V, D, k, slices, rows, qrows,
                     unit_boxes, stages, resident, surv_rows, st);
}
