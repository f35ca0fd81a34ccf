// Native IMA ADPCM encoder for sed_tpu_torch (a copy of
// sed_tpu/native/adpcm_codec.cc).  A host codec, not a device kernel.
//
// Bit-exact to the numpy encoder in sed_tpu_torch/data/audio_io.py
// (adpcm_encode_np): same block layout (4-byte header + low-nibble-first
// data, final block edge-padded, ONE trailing pad byte per clip row),
// same per-block step-index seeding (searchsorted of the block's mean
// |diff| into the step table), and the same truncating shift-add
// quantizer loop.  Exists because the numpy encode's spb-1 step
// recursion is a Python-level loop over every sample of a block, which
// sed_tpu measured as its train wire's bottleneck; here it is a scalar C++
// loop without interpreter overhead.
//
// The reference has no counterpart (it ships raw PCM,
// pytorch/predict.py:297-339); this supports the compressed train and
// serving wires.

#include <algorithm>
#include <cstdint>

namespace {

const int32_t kStepTable[89] = {
    7,     8,     9,     10,    11,    12,    13,    14,    16,    17,
    19,    21,    23,    25,    28,    31,    34,    37,    41,    45,
    50,    55,    60,    66,    73,    80,    88,    97,    107,   118,
    130,   143,   157,   173,   190,   209,   230,   253,   279,   307,
    337,   371,   408,   449,   494,   544,   598,   658,   724,   796,
    876,   963,   1060,  1166,  1282,  1411,  1552,  1707,  1878,  2066,
    2272,  2499,  2749,  3024,  3327,  3660,  4026,  4428,  4871,  5358,
    5894,  6484,  7132,  7845,  8630,  9493,  10442, 11487, 12635, 13899,
    15289, 16818, 18500, 20350, 22385, 24623, 27086, 29794, 32767};

const int32_t kIndexTable[16] = {-1, -1, -1, -1, 2, 4, 6, 8,
                                 -1, -1, -1, -1, 2, 4, 6, 8};

inline int32_t clamp_index(int32_t i) {
  return i < 0 ? 0 : (i > 88 ? 88 : i);
}

inline int32_t clamp16(int32_t v) {
  return v < -32768 ? -32768 : (v > 32767 ? 32767 : v);
}

}  // namespace

extern "C" {

// x: (b, s) int16 rows.  out: (b, nbl*ba + 1) uint8 rows, where
// spb = 2*(ba-4)+1 samples per block and nbl = ceil(s / spb); the final
// block is edge-padded with the row's last sample and the trailing pad
// byte is written as 0 (the odd-width dispatch marker — see
// audio_io.adpcm_bytes).  Returns 0 on success.
int sed_adpcm_encode(const int16_t* x, int64_t b, int64_t s, int64_t ba,
                     uint8_t* out) {
  if (ba < 8 || (ba & 3) != 0 || s <= 0 || b < 0) return 1;
  const int64_t spb = (ba - 4) * 2 + 1;
  const int64_t nbl = (s + spb - 1) / spb;
  const int64_t row_bytes = nbl * ba + 1;

  for (int64_t ci = 0; ci < b; ++ci) {
    const int16_t* row = x + ci * s;
    uint8_t* orow = out + ci * row_bytes;
    for (int64_t bi = 0; bi < nbl; ++bi) {
      const int64_t g0 = bi * spb;
      uint8_t* blk = orow + bi * ba;
      // edge-padded sample fetch for the final partial block
      auto sample = [&](int64_t t) -> int32_t {
        const int64_t g = g0 + t;
        return row[g < s ? g : s - 1];
      };
      int32_t pred = sample(0);
      // step-index seed: searchsorted(step_table, mean |diff|).  The
      // |diff| sum fits int64 and is exactly representable in double
      // (<= 65535 * (spb-1)), so sum-then-divide matches numpy's
      // float64 mean bit-for-bit.
      int64_t adiff_sum = 0;
      int32_t prev = pred;
      for (int64_t t = 1; t < spb; ++t) {
        const int32_t cur = sample(t);
        adiff_sum += cur > prev ? cur - prev : prev - cur;
        prev = cur;
      }
      const double mean_diff =
          static_cast<double>(adiff_sum) / static_cast<double>(spb - 1);
      int32_t index = 0;
      while (index < 89 && static_cast<double>(kStepTable[index]) <
                               mean_diff) {
        ++index;
      }
      index = clamp_index(index);

      blk[0] = static_cast<uint8_t>(pred & 0xFF);
      blk[1] = static_cast<uint8_t>((pred >> 8) & 0xFF);
      blk[2] = static_cast<uint8_t>(index);
      blk[3] = 0;

      for (int64_t t = 1; t < spb; ++t) {
        int32_t step = kStepTable[index];
        int32_t diff = sample(t) - pred;
        const int32_t sign = diff < 0 ? 8 : 0;
        if (diff < 0) diff = -diff;
        int32_t delta = 0;
        int32_t vpdiff = step >> 3;
        for (int bit = 4; bit >= 1; bit >>= 1) {
          if (diff >= step) {
            delta |= bit;
            diff -= step;
            vpdiff += step;
          }
          step >>= 1;
        }
        pred = clamp16(sign ? pred - vpdiff : pred + vpdiff);
        const uint8_t nib = static_cast<uint8_t>(sign | delta);
        // low nibble first within each data byte
        uint8_t* byte = blk + 4 + ((t - 1) >> 1);
        if ((t - 1) & 1) {
          *byte = static_cast<uint8_t>(*byte | (nib << 4));
        } else {
          *byte = nib;
        }
        index = clamp_index(index + kIndexTable[nib]);
      }
    }
    orow[row_bytes - 1] = 0;  // odd-width wire pad byte
  }
  return 0;
}

// Narrow-code variant (bits in {2, 3}): the same IMA predictor /
// step-index adaptation with bits-1 magnitude bits, big-endian packed
// codes, and `pad` trailing zero bytes per row (the width
// disambiguation marker — audio_io.ADPCM_N_PAD).  Bit-exact to
// audio_io.adpcm_n_encode_np.
int sed_adpcm_encode_n(const int16_t* x, int64_t b, int64_t s,
                       int64_t ba, int64_t bits, int64_t pad,
                       uint8_t* out) {
  if (ba < 8 || (ba & 3) != 0 || s <= 0 || b < 0) return 1;
  if (bits < 2 || bits > 3 || ((ba - 4) * 8) % bits != 0) return 1;
  const int64_t spb = (ba - 4) * 8 / bits + 1;
  const int64_t nbl = (s + spb - 1) / spb;
  const int64_t row_bytes = nbl * ba + pad;
  const int32_t sign_bit = 1 << (bits - 1);
  static const int32_t itab3[8] = {-1, -1, 1, 2, -1, -1, 1, 2};
  static const int32_t itab2[4] = {-1, 2, -1, 2};
  const int32_t* itab = bits == 3 ? itab3 : itab2;

  for (int64_t ci = 0; ci < b; ++ci) {
    const int16_t* row = x + ci * s;
    uint8_t* orow = out + ci * row_bytes;
    for (int64_t bi = 0; bi < nbl; ++bi) {
      const int64_t g0 = bi * spb;
      uint8_t* blk = orow + bi * ba;
      auto sample = [&](int64_t t) -> int32_t {
        const int64_t g = g0 + t;
        return row[g < s ? g : s - 1];
      };
      int32_t pred = sample(0);
      int64_t adiff_sum = 0;
      int32_t prev = pred;
      for (int64_t t = 1; t < spb; ++t) {
        const int32_t cur = sample(t);
        adiff_sum += cur > prev ? cur - prev : prev - cur;
        prev = cur;
      }
      const double mean_diff =
          static_cast<double>(adiff_sum) / static_cast<double>(spb - 1);
      int32_t index = 0;
      while (index < 89 && static_cast<double>(kStepTable[index]) <
                               mean_diff) {
        ++index;
      }
      index = clamp_index(index);

      blk[0] = static_cast<uint8_t>(pred & 0xFF);
      blk[1] = static_cast<uint8_t>((pred >> 8) & 0xFF);
      blk[2] = static_cast<uint8_t>(index);
      blk[3] = 0;

      uint8_t* data = blk + 4;
      for (int64_t i = 0; i < ba - 4; ++i) data[i] = 0;
      for (int64_t t = 1; t < spb; ++t) {
        int32_t step = kStepTable[index];
        int32_t diff = sample(t) - pred;
        const int32_t sign = diff < 0 ? sign_bit : 0;
        if (diff < 0) diff = -diff;
        int32_t delta = 0;
        int32_t vpdiff = step >> (bits - 1);
        for (int32_t bit = sign_bit >> 1; bit >= 1; bit >>= 1) {
          if (diff >= step) {
            delta |= bit;
            diff -= step;
            vpdiff += step;
          }
          step >>= 1;
        }
        pred = clamp16(sign ? pred - vpdiff : pred + vpdiff);
        const int32_t code = sign | delta;
        // big-endian bitstream: code t-1 at bit offset (t-1)*bits
        const int64_t bitpos = (t - 1) * bits;
        for (int64_t k = 0; k < bits; ++k) {
          if (code & (1 << (bits - 1 - k))) {
            data[(bitpos + k) >> 3] |=
                static_cast<uint8_t>(0x80 >> ((bitpos + k) & 7));
          }
        }
        index = clamp_index(index + itab[code]);
      }
    }
    for (int64_t k = 0; k < pad; ++k) orow[row_bytes - 1 - k] = 0;
  }
  return 0;
}

}  // extern "C"
