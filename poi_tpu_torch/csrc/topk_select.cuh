// Row selection of the score + top-k kernels (topk.cu, topk_wg.cu): the
// total order (value descending, then id ascending), a warp's bitonic sort of
// 32 * E (value, id) pairs in registers, and the merge of a row's survivors
// into its sorted list. Every call is made by a whole warp.

#pragma once

#include <climits>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSurv = 128;  // merge_row's buffer of survivors (pairs) between merges

// The length of a row's sorted list: k rounded up to 32 or 128.
__host__ __device__ constexpr int list_len(int k) { return k <= 32 ? 32 : 128; }

__device__ __forceinline__ bool before(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// One compare-exchange stage of a bitonic network over the warp's 32 * E
// pairs, element i = e * 32 + lane: stride 2^lt inside blocks of 2^ls, a
// block sorted into "before" order where (i & 2^ls) == 0 (all of them when
// 2^ls spans the warp's pairs), the other way elsewhere.
template <int E>
__device__ __forceinline__ void bitonic_stage(float (&v)[E], int (&id)[E], int lane, int ls, int lt) {
  const int sz = 1 << ls, s = 1 << lt;
  if (s >= 32) {
    const int m = s / 32;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (e & m) continue;
      const int f = e | m;
      const bool fwd = ((e * 32) & sz) == 0;
      const bool sw = fwd ? before(v[f], id[f], v[e], id[e]) : before(v[e], id[e], v[f], id[f]);
      if (sw) {
        const float tv = v[e];
        const int ti = id[e];
        v[e] = v[f];
        id[e] = id[f];
        v[f] = tv;
        id[f] = ti;
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float pv = __shfl_xor_sync(kFull, v[e], s);
      const int pi = __shfl_xor_sync(kFull, id[e], s);
      const int idx = e * 32 + lane;
      const bool keep_better = ((idx & s) == 0) == ((idx & sz) == 0);
      if (before(pv, pi, v[e], id[e]) == keep_better) {
        v[e] = pv;
        id[e] = pi;
      }
    }
  }
}

template <int E>
__host__ __device__ constexpr int log2_pairs() {
  return E == 4 ? 7 : E == 2 ? 6 : 5;  // log2(32 * E)
}

// Sorts the warp's 32 * E pairs into "before" order (a bitonic sort; the
// loop counters are additive so that both loops unroll and every register
// index is a constant).
template <int E>
__device__ __forceinline__ void warp_sort(float (&v)[E], int (&id)[E], int lane) {
  constexpr int kLog = log2_pairs<E>();
#pragma unroll
  for (int ls = 1; ls <= kLog; ++ls) {
#pragma unroll
    for (int lt = ls - 1; lt >= 0; --lt) bitonic_stage<E>(v, id, lane, ls, lt);
  }
}

// A bitonic sequence of 32 * E pairs into "before" order.
template <int E>
__device__ __forceinline__ void warp_bitonic_merge(float (&v)[E], int (&id)[E], int lane) {
  constexpr int kLog = log2_pairs<E>();
#pragma unroll
  for (int lt = kLog - 1; lt >= 0; --lt) bitonic_stage<E>(v, id, lane, kLog, lt);
}

// A row's buffer: its sorted list in [0, KP), then `cnt` appended survivors.
// The warp sorts the survivors, keeps the KP best of both sorted lists (the
// better of list[i] and survivors[KP - 1 - i] is a bitonic sequence holding
// them) and sorts that back into [0, KP). Called by the whole warp.
template <int KP>
__device__ __forceinline__ void merge_row(float* bv, int* bi, int cnt, int lane) {
  constexpr int ES = kSurv / 32, EK = KP / 32;
  float sv[ES], tv[EK];
  int si[ES], ti[EK];
#pragma unroll
  for (int e = 0; e < ES; ++e) {
    const int i = e * 32 + lane;
    const bool ok = i < cnt;
    sv[e] = ok ? bv[KP + i] : -INFINITY;
    si[e] = ok ? bi[KP + i] : INT_MAX;
  }
#pragma unroll
  for (int e = 0; e < EK; ++e) {
    tv[e] = bv[e * 32 + lane];
    ti[e] = bi[e * 32 + lane];
  }
  warp_sort<ES>(sv, si, lane);
#pragma unroll
  for (int e = 0; e < EK; ++e) {
    const float pv = __shfl_sync(kFull, sv[EK - 1 - e], 31 - lane);
    const int pi = __shfl_sync(kFull, si[EK - 1 - e], 31 - lane);
    if (before(pv, pi, tv[e], ti[e])) {
      tv[e] = pv;
      ti[e] = pi;
    }
  }
  warp_bitonic_merge<EK>(tv, ti, lane);
  __syncwarp();
#pragma unroll
  for (int e = 0; e < EK; ++e) {
    bv[e * 32 + lane] = tv[e];
    bi[e * 32 + lane] = ti[e];
  }
  __syncwarp();
}

}  // namespace
