// Native batch event decoder for sed_tpu.
//
// Decodes packed threshold-crossing bitmasks (as produced on-device by the
// serving engine) into [bgn, fin) event pairs with exactly the semantics of
// sed_tpu.post.vad.activity_detection_masks — which itself mirrors the
// reference decoder (utils/vad.py:11-199) including its index quirks:
//   * run starts after the first run get +1, every run end gets +1 except
//     the last;
//   * the low pass extends boundaries to the surrounding low-run and then
//     re-smooths with gap 1;
//   * smooth merges chains whose gaps (vs the ORIGINAL previous fin) are
//     <= n_smooth;
//   * events with fin - bgn <= n_salt are dropped.
//
// Bit order matches numpy.unpackbits (MSB-first within each byte).

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

inline int get_bit(const uint8_t* arr, int64_t f) {
  return (arr[f >> 3] >> (7 - (f & 7))) & 1;
}

struct Scratch {
  int32_t* a_bgn;
  int32_t* a_fin;
  int32_t* b_bgn;
  int32_t* b_fin;
};

// Merge chained pairs whose gap to the original previous pair is
// <= n_smooth.  Reads (bgn,fin,n) and writes the merged set; returns count.
int smooth(const int32_t* bgn, const int32_t* fin, int n, int n_smooth,
           int32_t* out_bgn, int32_t* out_fin) {
  if (n == 0) return 0;
  int m = 0;
  int32_t mem_bgn = bgn[0];
  for (int j = 1; j < n; ++j) {
    if (bgn[j] - fin[j - 1] > n_smooth) {
      out_bgn[m] = mem_bgn;
      out_fin[m] = fin[j - 1];
      ++m;
      mem_bgn = bgn[j];
    }
  }
  out_bgn[m] = mem_bgn;
  out_fin[m] = fin[n - 1];
  return m + 1;
}

// Decode one track. Returns the number of events written (capped at cap).
int decode_one(const uint8_t* hi, const uint8_t* lo, int t, int n_smooth,
               int n_salt, Scratch s, int32_t* out_pairs, int cap) {
  // 1. high runs
  int n = 0;
  int prev = 0;
  for (int f = 0; f < t; ++f) {
    int cur = get_bit(hi, f);
    if (cur && !prev) s.a_bgn[n] = f;           // run start (inclusive)
    if (!cur && prev) s.a_fin[n++] = f - 1;     // run end (inclusive)
    prev = cur;
  }
  if (prev) s.a_fin[n++] = t - 1;
  if (n == 0) return 0;

  // 2. +1 quirks: pairs in (b_bgn, b_fin)
  for (int j = 0; j < n; ++j) {
    s.b_bgn[j] = s.a_bgn[j] + (j > 0 ? 1 : 0);
    s.b_fin[j] = s.a_fin[j] + (j < n - 1 ? 1 : 0);
  }

  // 3. low extension (against the low mask), if provided
  if (lo != nullptr) {
    for (int j = 0; j < n; ++j) {
      int32_t b = s.b_bgn[j];
      if (b < t && get_bit(lo, b)) {
        while (b > 0 && get_bit(lo, b - 1)) --b;
      } else if (b < t) {
        b = b + 1;
      }
      s.b_bgn[j] = b;
      int32_t f = s.b_fin[j];
      if (f < t && get_bit(lo, f)) {
        while (f < t && get_bit(lo, f)) ++f;
      }
      s.b_fin[j] = f;
    }
    n = smooth(s.b_bgn, s.b_fin, n, 1, s.a_bgn, s.a_fin);
  } else {
    memcpy(s.a_bgn, s.b_bgn, n * sizeof(int32_t));
    memcpy(s.a_fin, s.b_fin, n * sizeof(int32_t));
  }

  // 4. smooth(n_smooth), 5. salt removal
  n = smooth(s.a_bgn, s.a_fin, n, n_smooth, s.b_bgn, s.b_fin);
  int m = 0;
  for (int j = 0; j < n && m < cap; ++j) {
    if (s.b_fin[j] - s.b_bgn[j] > n_salt) {
      out_pairs[2 * m] = s.b_bgn[j];
      out_pairs[2 * m + 1] = s.b_fin[j];
      ++m;
    }
  }
  return m;
}

}  // namespace

extern "C" {

// Decode K tracks of packed masks.
//   high, low: (K, tb) uint8 packed masks; low may be nullptr.
//   t: frames per track; tb: bytes per track (>= ceil(t/8)).
//   n_smooth, n_salt: per-track parameters (K,) int32.
//   out_pairs: (K, max_events, 2) int32; out_counts: (K,) int32.
// Returns 0 on success, -1 on allocation failure.
int sed_decode_tracks(const uint8_t* high, const uint8_t* low,
                      int64_t k, int64_t tb, int64_t t,
                      const int32_t* n_smooth, const int32_t* n_salt,
                      int32_t* out_pairs, int32_t* out_counts,
                      int64_t max_events) {
  int64_t max_runs = t / 2 + 2;
  int32_t* buf =
      static_cast<int32_t*>(malloc(4 * max_runs * sizeof(int32_t)));
  if (buf == nullptr) return -1;
  Scratch s{buf, buf + max_runs, buf + 2 * max_runs, buf + 3 * max_runs};
  for (int64_t i = 0; i < k; ++i) {
    out_counts[i] = decode_one(
        high + i * tb, low == nullptr ? nullptr : low + i * tb,
        static_cast<int>(t), n_smooth[i], n_salt[i], s,
        out_pairs + i * max_events * 2, static_cast<int>(max_events));
  }
  free(buf);
  return 0;
}

}  // extern "C"
