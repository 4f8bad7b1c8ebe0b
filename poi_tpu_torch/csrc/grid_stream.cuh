// Helpers of the recurrences' streamed-weight serial kernels (csrc/gru_fwd.cu's
// gru_fwd_stream_kernel, csrc/gru_bwd.cu's gru_bwd_stream_carry_kernel,
// csrc/lstm.cu's lstm_fwd_stream_kernel and lstm_bwd_stream_carry_kernel,
// csrc/rnn.cu's rnn_fwd_stream_kernel and rnn_bwd_stream_carry_kernel), which
// take the widths whose recurrent weight no layout holds on the chip. G is
// the gate blocks of the weight: 3 (GRU), 4 (LSTM), 1 (RNN).
//
// Why stream: the grid-resident design (grid_carry.cuh) keeps each CTA's
// slice of the weight in shared memory for the whole launch. Past its limit
// (the GRU past H = 2064: two octets a CTA to fit 258 octets into 132 SMs,
// [2064][56] bf16 = 231,168 of a CTA's 232,448 bytes; the LSTM past 1600,
// the RNN past 3168) no slice fits: wh at H = 4096 is [4096, 12288] bf16 =
// 100.7 MB (the GRU), [4096, 16384] = 134.2 MB (the LSTM), 2x-2.7x the 50 MB
// L2 and 3.3x-4.5x the 30 MB of all 132 SMs' shared memory; the RNN's C
// [4096, 4096] is 33.6 MB, more than all shared memory but less than the
// L2. So the weight is read again every step, through a ring of k-chunks in
// shared memory.
//
// - The grid is R row groups x Uc CTAs, one CTA an SM, launched
//   cooperatively (launch_coop): a grid that cannot be co-resident fails to
//   launch, so the row group's step barrier (group_arrive / group_wait, with
//   its 20 s trap) never waits on a CTA that is not running.
// - The units are cut into U slices of ocp octets (8 units an octet); CTA c
//   of a row group takes slices c, c + Uc, ... (Uc = min(U, 132 / R)), and
//   for each, its group's rows in passes of 32 mt rows: a work item. The
//   (row, unit) pairs of an item, and the thread that owns each, are the
//   same every step, so a thread reads back what it wrote the step before.
// - An item's product is a tiled GEMM over K: each k-chunk of kStreamK rows
//   of the step's operand (bf16(h), or the three bf16 terms of the carry's
//   cotangent, from an L2-resident buffer that the row group's CTAs wrote
//   before the barrier) and of the weight (its slice's columns or rows)
//   lands in a ring of kStreamStages stages by 16-byte cp.async (L2 only:
//   .cg), the weight's with an L2 evict-first hint (evict_first_policy), so
//   that the 100 MB a step of streamed weight leaves the operand buffers and
//   the barrier counters in L2; the 8 warps (2 along the rows, 4 along the
//   columns) multiply it on mma.sync m16n8k16 from ldmatrix fragments, each
//   warp's accumulators in registers for the whole item.
// - The padding: units past H are columns of zero weight (the wrapper pads
//   wh's gate blocks to Hp = 8 ceil(H / 8) where H % 8 != 0, so that each
//   octet of a row is 16 aligned bytes); rows of K past the data arrive as
//   zeros (cp.async with 0 source bytes); rows past B are zero in the operand
//   buffers, which the wrapper zeroes and no CTA writes there.

#pragma once

#include "grid_carry.cuh"

namespace {

constexpr int kStreamK = 64;       // K rows of a chunk: 4 k-steps of 16
constexpr int kStreamStages = 4;   // chunks in flight
constexpr int kStreamLd = kStreamK + 8;  // bf16 row stride of a chunk's k-contiguous rows (+ 8: conflict-free ldmatrix)

// The launch of a streamed kernel: octets a unit slice, unit slices, CTAs a
// row group, row groups, rows a group (a multiple of 16), and mt (an item's
// pass is 32 mt rows: 16 mt a warp row).
struct StreamShape {
  int ocp, U, Uc, R, rows, mt;
};

// The streamed grid for a batch of B rows of width H: the forward's
// (bwd = false) or the carry's, the same for every G.
//
// The pick, from the reckoning at the bench workload's H = 4096, B = 512
// (T = 64): every SM holds B 3H / 132 fp32 accumulators of the forward (190
// KB, past what registers hold next to the fragments) and B H / 132 x 2 of
// the carry, so a CTA's rows go in passes that each re-stream its slice of
// the weight; the L2 reads a CTA makes a step are passes x slice + rows x K
// of the operand (x 3 terms for the carry), least near a square tile. The
// forward: slices of 4 octets (96 columns, the most CTAs for the HBM stream
// at small batch) where a group's rows take one pass of at most 128, else 8
// (192 columns: at B = 512, 64 slices x 2 row groups of 256 rows, two passes
// of 128; 5.1 MB of L2 reads a CTA a step, against 7.1 MB at 4 octets). The
// carry: slices of 8 octets where a group's rows take one pass of at most
// 64, else 16 (128 units: at B = 512, 32 slices x 4 row groups of 128 rows,
// two passes of 64; 15.7 MB a CTA a step, 22 MB at 8 octets). Measured once
// on an H100 (chip_smoke.py, PERF.md): B1 at B = 512 in 17.71 ms at 8
// octets against 21.86 at 4, at B = 1 in 3.90 ms at 4 against 5.40 at 8; B2
// at B = 512 in 266.73 ms at 16 octets against 286.92 at 8.
//
// A forward pass of 128 rows (mt = 4) holds MT x NO x G x 4 fp32
// accumulators a thread (StreamFwd): the GRU's <4, 2> 96, the LSTM's 128
// (half the register file), the RNN's 32. The LSTM's spills there (ptxas,
// -Xptxas -v: lstm_fwd_stream_kernel<4, 2> at 255 registers, 96 bytes of
// spill stores and 488 of loads; the GRU's <4, 2> 88 and 724), and passes
// of 64, which stream the slice's weight twice as often, are slower still:
// on an H100 at H = 4096, batch 256, 14.5 ms at passes of 128 against 22.5
// at 64 (poi_tpu_torch/scripts/stream_rules.py, PERF.md). So the pick does
// not depend on G; the carry's accumulators do not either (its K does).
inline StreamShape stream_shape(int B, int H, bool bwd) {
  StreamShape s = {0, 0, 0, 0, 0, 0};
  if (H <= 0) return s;
  const int choices[2] = {bwd ? 8 : 4, bwd ? 16 : 8};
  const int max_rows = bwd ? 64 : 128;
  const int O = (H + 7) / 8, tiles = B > 0 ? (B + 15) / 16 : 1;
  for (int i = 0; i < 2; ++i) {
    s.ocp = choices[i];
    s.U = (O + s.ocp - 1) / s.ocp;
    s.Uc = s.U < kSms ? s.U : kSms;
    int r = kSms / s.Uc;
    r = r < 1 ? 1 : r > tiles ? tiles : r;
    const int per = (tiles + r - 1) / r;
    s.R = (tiles + per - 1) / per;
    s.rows = 16 * per;
    if (s.rows <= max_rows) break;
  }
  s.mt = s.rows <= 32 ? 1 : (bwd || s.rows <= 64) ? 2 : 4;
  return s;
}

// The C entries' form of stream_shape (gru_stream_shape, lstm_stream_shape,
// rnn_stream_shape): out[0..5] = octets a slice, unit slices, CTAs a row
// group, row groups, rows a group, mt; 0 (out untouched) at H <= 0.
inline int stream_shape_out(int B, int H, bool bwd, int* out) {
  const StreamShape s = stream_shape(B, H, bwd);
  if (s.ocp == 0) return 0;
  const int v[6] = {s.ocp, s.U, s.Uc, s.R, s.rows, s.mt};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 1;
}

// The L2 policy of the streamed weight: evicted first, whatever its bytes.
// A weight that fits the 50 MB L2 (the RNN's C at H = 4096, 33.6 MB; the
// GRU's wh at H = 2304 and 2560, 31.9 and 39.3 MB; the LSTM's at 2048,
// 33.6 MB) could be kept there from step to step with evict-last instead.
// On an H100 (poi_tpu_torch/scripts/stream_rules.py, PERF.md) that moved
// the RNN's kernels at (64, 32, 4096) and the GRU's at (512, 64, 2304) and
// 2560 by at most 1.1% either way (the RNN's training step, forward and
// backward, 0.8% slower kept; the GRU's forwards slower, carries faster),
// and the LSTM's carry at (64, 64, 2048) by 0.7%; only the LSTM's forward
// there gained, 5.3%, at a width no configuration runs. So the bytes decide
// nothing on the paths, and one policy holds for the three recurrences.
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

// 16 bytes by cp.async (L2 only) under an L2 cache policy; pred false
// zero-fills the destination and reads nothing.
__device__ __forceinline__ void cp_async16_hint(void* smem, const void* gmem, bool pred, uint64_t policy) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n" ::"r"(s), "l"(gmem),
               "r"(pred ? 16 : 0), "l"(policy));
}

// The k-chunk pipeline of an item's product: chunks 0 .. n - 1, each loaded
// into stage kc % kStreamStages by load(stage, kc) (cp.async, one commit
// group a chunk) and multiplied by compute(stage) once it has landed, up to
// kStreamStages - 1 chunks ahead. It starts with a barrier, so the previous
// item's last reads of the stages are done before they are overwritten, and
// ends with every copy landed.
template <class Load, class Compute>
__device__ __forceinline__ void stream_chunks(int n, Load&& load, Compute&& compute) {
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kStreamStages - 1; ++s) {
    if (s < n) load(s, s);
    cp_async_commit();
  }
  for (int kc = 0; kc < n; ++kc) {
    cp_async_wait<kStreamStages - 2>();
    __syncthreads();  // chunk kc landed for every thread; chunk kc - 1's stage is free
    const int next = kc + kStreamStages - 1;
    if (next < n) load(next % kStreamStages, next);
    cp_async_commit();
    compute(kc % kStreamStages);
  }
  cp_async_wait<0>();
}

// The forward's item product: acc[i][o][q] += bf16(h) of the pass's rows @
// the slice's gate block q of the warp's octet o, over all K. Each k-step's
// product goes into a zeroed fragment that is added to acc in IEEE fp32, as
// the carry's term 0 is (below): the tensor core's own fp32 accumulation
// truncates, and the forward sums Hk / 16 k-steps (256 at H = 4096), which
// put one step 11.6x further from fp64 than cuBLAS's fp32 sums. Stage s holds
// A [32 MT rows][kStreamLd] (the operand's k-chunk) and B [kStreamK][8 G ocp
// + 8] (the weight's rows k of the slice's columns, local column 8 (G lo + q)
// + u = column q gs + 8 (ob + lo) + u of the weight, row stride ldw).
template <int G, int MT, int NO>
struct StreamFwd {
  static constexpr int kOcp = 4 * NO;            // octets a slice: 4 warps along the columns, NO each
  static constexpr int kMc = 32 * MT;            // rows a pass: 2 warps along the rows, 16 MT each
  static constexpr int kLdB = 8 * G * kOcp + 8;  // bf16 row stride of a B stage (+ 8: conflict-free ldmatrix)
  static constexpr int kStageA = kMc * kStreamLd * 2, kStage = kStageA + kStreamK * kLdB * 2;
  static constexpr int kSmem = kStreamStages * kStage;
};

template <int G, int MT, int NO>
__device__ __forceinline__ void stream_fwd_product(float (&acc)[MT][NO][G][4], const bf16* __restrict__ hb, int Hk,
                                                   int r0, int rend, const bf16* __restrict__ w, size_t ldw, int gs,
                                                   int H, int ob, int n_oct, unsigned char* smem, uint64_t policy) {
  using F = StreamFwd<G, MT, NO>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, wm = warp / 4, wn = warp % 4;
  const uint32_t base = shared_addr(smem);
  auto load = [&](int s, int kc) {
    bf16* sa = reinterpret_cast<bf16*>(smem + s * F::kStage);
    bf16* sb = reinterpret_cast<bf16*>(smem + s * F::kStage + F::kStageA);
    const int k0 = kc * kStreamK;
    for (int i = threadIdx.x; i < F::kMc * (kStreamK / 8); i += blockDim.x) {
      const int r = i / (kStreamK / 8), c = (i % (kStreamK / 8)) * 8;
      const bool ok = r0 + r < rend && k0 + c < Hk;
      cp_async16(sa + r * kStreamLd + c, hb + (ok ? (size_t)(r0 + r) * Hk + k0 + c : 0), ok);
    }
    for (int i = threadIdx.x; i < kStreamK * G * F::kOcp; i += blockDim.x) {
      const int kk = i / (G * F::kOcp), v = i % (G * F::kOcp), lo = v / G, q = v % G;
      const bool ok = k0 + kk < H && lo < n_oct;
      cp_async16_hint(sb + kk * F::kLdB + 8 * v, w + (ok ? (size_t)(k0 + kk) * ldw + q * gs + 8 * (ob + lo) : 0), ok,
                      policy);
    }
  };
  auto compute = [&](int s) {
    const uint32_t sa = base + s * F::kStage, sb = sa + F::kStageA;
#pragma unroll
    for (int ks = 0; ks < kStreamK / 16; ++ks) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        ldsm_x4(a[i], sa + ((wm * 16 * MT + 16 * i + lane % 16) * kStreamLd + ks * 16 + (lane / 16) * 8) * 2);
      }
#pragma unroll
      for (int o = 0; o < NO; ++o) {
#pragma unroll
        for (int q = 0; q < G; ++q) {
          uint32_t b0, b1;
          ldsm_x2_trans(b0, b1, sb + ((ks * 16 + lane % 16) * F::kLdB + ((wn * NO + o) * G + q) * 8) * 2);
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            float part[4] = {0.f, 0.f, 0.f, 0.f};
            mma_bf16(part, a[i], b0, b1);
#pragma unroll
            for (int x = 0; x < 4; ++x) acc[i][o][q][x] += part[x];
          }
        }
      }
    }
  };
  stream_chunks((Hk + kStreamK - 1) / kStreamK, load, compute);
}

// The carry's item product over K = the weight's G Hp columns: for each
// output unit of the warp's octets, the three bf16 terms of the cotangent
// rows (term e at dt + e term, row stride K) @ the weight's row of that
// unit (row stride K). Term 0 carries the sum: each k-step's product goes
// into a zeroed fragment that is added to acc0 in IEEE fp32, since the
// tensor core's own fp32 accumulation truncates and the carry sums K / 16
// k-steps (768 at H = 4096); terms 1 and 2, 2^-8 and 2^-16 of it, share
// acc12 on the tensor core. Stage s holds A [3][32 MT][kStreamLd] and B
// [32 NT units][kStreamLd].
template <int MT, int NT>
struct StreamCarry {
  static constexpr int kOcp = 4 * NT;  // octets a slice: 4 warps along the units, NT each
  static constexpr int kMc = 32 * MT;
  static constexpr int kStageA = 3 * kMc * kStreamLd * 2, kStage = kStageA + 8 * kOcp * kStreamLd * 2;
  static constexpr int kSmem = kStreamStages * kStage;
};

template <int MT, int NT>
__device__ __forceinline__ void stream_carry_product(float (&acc0)[MT][NT][4], float (&acc12)[MT][NT][4],
                                                     const bf16* __restrict__ dt, size_t term, int K, int r0,
                                                     int rend, const bf16* __restrict__ w, int H, int ob, int n_oct,
                                                     unsigned char* smem, uint64_t policy) {
  using F = StreamCarry<MT, NT>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, wm = warp / 4, wn = warp % 4;
  const uint32_t base = shared_addr(smem);
  auto load = [&](int s, int kc) {
    bf16* sa = reinterpret_cast<bf16*>(smem + s * F::kStage);
    bf16* sb = reinterpret_cast<bf16*>(smem + s * F::kStage + F::kStageA);
    const int k0 = kc * kStreamK;
    for (int i = threadIdx.x; i < 3 * F::kMc * (kStreamK / 8); i += blockDim.x) {
      const int e = i / (F::kMc * (kStreamK / 8)), r = (i / (kStreamK / 8)) % F::kMc, c = (i % (kStreamK / 8)) * 8;
      const bool ok = r0 + r < rend && k0 + c < K;
      cp_async16(sa + (e * F::kMc + r) * kStreamLd + c, dt + (ok ? e * term + (size_t)(r0 + r) * K + k0 + c : 0), ok);
    }
    for (int i = threadIdx.x; i < 8 * F::kOcp * (kStreamK / 8); i += blockDim.x) {
      const int lu = i / (kStreamK / 8), c = (i % (kStreamK / 8)) * 8, j = 8 * ob + lu;
      const bool ok = lu < 8 * n_oct && j < H && k0 + c < K;
      cp_async16_hint(sb + lu * kStreamLd + c, w + (ok ? (size_t)j * K + k0 + c : 0), ok, policy);
    }
  };
  auto compute = [&](int s) {
    const uint32_t sa = base + s * F::kStage, sb = sa + F::kStageA;
#pragma unroll
    for (int ks = 0; ks < kStreamK / 16; ++ks) {
      uint32_t a[3][MT][4];
#pragma unroll
      for (int e = 0; e < 3; ++e) {
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          ldsm_x4(a[e][i],
                  sa + ((e * F::kMc + wm * 16 * MT + 16 * i + lane % 16) * kStreamLd + ks * 16 + (lane / 16) * 8) * 2);
        }
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t b0, b1;
        ldsm_x2(b0, b1, sb + (((wn * NT + n) * 8 + lane % 8) * kStreamLd + ks * 16 + ((lane / 8) % 2) * 8) * 2);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          float part[4] = {0.f, 0.f, 0.f, 0.f};
          mma_bf16(part, a[0][i], b0, b1);
#pragma unroll
          for (int x = 0; x < 4; ++x) acc0[i][n][x] += part[x];
          mma_bf16(acc12[i][n], a[1][i], b0, b1);
          mma_bf16(acc12[i][n], a[2][i], b0, b1);
        }
      }
    }
  };
  stream_chunks((K + kStreamK - 1) / kStreamK, load, compute);
}

}  // namespace
