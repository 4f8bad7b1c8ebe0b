// Native preprocessing fast path: check-in sequence -> padded example windows.
//
// The per-user windowing loops (poi_tpu_torch/data/dataset.py:_window_examples /
// _eval_examples) are the only O(dataset)-with-Python-overhead stage of the
// host pipeline; at the 1M-POI / 100k-user scale (BASELINE.json:11) the
// Python loop costs minutes while this translation runs in milliseconds.
// Exposed through a plain C ABI consumed via ctypes
// (poi_tpu_torch/native/__init__.py); the Python implementation remains both the
// fallback (no toolchain) and the property-test oracle.
//
// Layout contract (mirrors dataset.py): check-ins are sorted by (user, time);
// user u occupies rows [starts[u], starts[u]+lengths[u]); keep[i] selects the
// train (or test) subset; each kept run is cut into stride-T windows of T+1
// check-ins, the final ragged window right-padded.

#include <cstdint>
#include <cstring>

namespace {

// Gather the kept indices of user u into buf (caller-sized), returns count.
inline int64_t kept_indices(const int64_t start, const int64_t len,
                            const uint8_t* keep, int64_t* buf) {
  int64_t n = 0;
  for (int64_t i = start; i < start + len; ++i) {
    if (keep[i]) buf[n++] = i;
  }
  return n;
}

}  // namespace

extern "C" {

// Pass 1: number of train windows (rows of the output arrays).
int64_t count_train_windows(const int64_t* starts, const int64_t* lengths,
                            int64_t n_users, const uint8_t* keep, int64_t T) {
  int64_t total = 0;
  for (int64_t u = 0; u < n_users; ++u) {
    int64_t L = 0;
    for (int64_t i = starts[u]; i < starts[u] + lengths[u]; ++i) L += keep[i];
    if (L < 2) continue;
    // windows at offsets 0, T, 2T, ... while w < L-1
    total += (L - 2) / T + 1;
  }
  return total;
}

// Pass 2: fill the preallocated [N, T] outputs. Returns rows written.
int64_t build_train_windows(
    const int64_t* starts, const int64_t* lengths, int64_t n_users,
    const uint8_t* keep, int64_t T, int64_t max_len,
    const int32_t* user_ids,  // contiguous user id per user index
    const int32_t* poi, const int32_t* timeb, const int32_t* geob,
    const int32_t* tgapi, const int32_t* disti, const float* tgapf,
    const float* distf,
    int32_t* out_user, int32_t* out_poi_in, int32_t* out_poi_tgt,
    uint8_t* out_mask, int32_t* out_timeb, int32_t* out_geob,
    int32_t* out_tgapi, int32_t* out_disti, float* out_tgapf,
    float* out_distf) {
  int64_t* buf = new int64_t[max_len];
  int64_t row = 0;
  for (int64_t u = 0; u < n_users; ++u) {
    const int64_t L = kept_indices(starts[u], lengths[u], keep, buf);
    if (L < 2) continue;
    for (int64_t w = 0; w < L - 1; w += T) {
      const int64_t n_in = (L - w - 1) < T ? (L - w - 1) : T;
      const int64_t base = row * T;
      out_user[row] = user_ids[u];
      for (int64_t t = 0; t < n_in; ++t) {
        const int64_t src = buf[w + t];
        out_poi_in[base + t] = poi[src];
        out_poi_tgt[base + t] = poi[buf[w + t + 1]];
        out_mask[base + t] = 1;
        out_timeb[base + t] = timeb[src];
        out_geob[base + t] = geob[src];
        out_tgapi[base + t] = tgapi[src];
        out_disti[base + t] = disti[src];
        out_tgapf[base + t] = tgapf[src];
        out_distf[base + t] = distf[src];
      }
      for (int64_t t = n_in; t < T; ++t) {
        out_poi_in[base + t] = 0;
        out_poi_tgt[base + t] = 0;
        out_mask[base + t] = 0;
        out_timeb[base + t] = 0;
        out_geob[base + t] = 0;
        out_tgapi[base + t] = 0;
        out_disti[base + t] = 0;
        out_tgapf[base + t] = 0.f;
        out_distf[base + t] = 0.f;
      }
      ++row;
    }
  }
  delete[] buf;
  return row;
}

// Eval examples: one row per held-out check-in, context = the <=T preceding
// check-ins of the user (train + earlier test), only the final position
// scored. Pass 1 count:
int64_t count_eval_examples(const int64_t* starts, const int64_t* lengths,
                            int64_t n_users, const uint8_t* is_test) {
  int64_t total = 0;
  for (int64_t u = 0; u < n_users; ++u) {
    for (int64_t i = starts[u]; i < starts[u] + lengths[u]; ++i) {
      // needs at least one preceding check-in as context
      if (is_test[i] && i > starts[u]) ++total;
    }
  }
  return total;
}

int64_t build_eval_examples(
    const int64_t* starts, const int64_t* lengths, int64_t n_users,
    const uint8_t* is_test, int64_t T,
    const int32_t* user_ids,
    const int32_t* poi, const int32_t* timeb, const int32_t* geob,
    const int32_t* tgapi, const int32_t* disti, const float* tgapf,
    const float* distf,
    int32_t* out_user, int32_t* out_poi_in, int32_t* out_poi_tgt,
    uint8_t* out_mask, int32_t* out_timeb, int32_t* out_geob,
    int32_t* out_tgapi, int32_t* out_disti, float* out_tgapf,
    float* out_distf, int32_t* out_target) {
  int64_t row = 0;
  for (int64_t u = 0; u < n_users; ++u) {
    const int64_t s = starts[u];
    for (int64_t p = s; p < s + lengths[u]; ++p) {
      if (!is_test[p] || p == s) continue;
      const int64_t ctx0 = (p - T) > s ? (p - T) : s;
      const int64_t n_in = p - ctx0;
      const int64_t base = row * T;
      out_user[row] = user_ids[u];
      for (int64_t t = 0; t < n_in; ++t) {
        const int64_t src = ctx0 + t;
        out_poi_in[base + t] = poi[src];
        out_poi_tgt[base + t] = 0;
        // Validity-prefix mask: the recurrent cells freeze their carry at
        // mask == 0, so a one-hot "scored position" mask would zero out the
        // entire context. The scored position is recovered as
        // sum(mask) - 1 == n_in - 1 (eval/evaluate.py last_valid_queries).
        out_mask[base + t] = 1;
        out_timeb[base + t] = timeb[src];
        out_geob[base + t] = geob[src];
        out_tgapi[base + t] = tgapi[src];
        out_disti[base + t] = disti[src];
        out_tgapf[base + t] = tgapf[src];
        out_distf[base + t] = distf[src];
      }
      for (int64_t t = n_in; t < T; ++t) {
        out_poi_in[base + t] = 0;
        out_poi_tgt[base + t] = 0;
        out_mask[base + t] = 0;
        out_timeb[base + t] = 0;
        out_geob[base + t] = 0;
        out_tgapi[base + t] = 0;
        out_disti[base + t] = 0;
        out_tgapf[base + t] = 0.f;
        out_distf[base + t] = 0.f;
      }
      out_poi_tgt[base + n_in - 1] = poi[p];
      out_target[row] = poi[p];
      ++row;
    }
  }
  return row;
}

}  // extern "C"
