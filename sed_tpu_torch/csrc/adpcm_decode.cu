// IMA ADPCM decode at 4, 3 and 2 bits per code for Hopper (sm_90a): one
// warp per (clip, block) lane, both recurrences resolved by a warp scan of
// clamp-add transforms.
//
// Replaces sed_tpu/ops/wire.py:335 _adpcm_decode (jnp code, not a Pallas
// kernel; with _adpcm_split_dev at :130 and the blocked prefix
// _resolve_clamp_add_chain at :267).  Same function, bit for bit, on any
// bytes: (B, width) uint8 -> (B, samples) float32, per 256-byte block
//
//   pred_0 = int16 of bytes 0-1 (little-endian), idx = clip(byte 2, 0, 88)
//   codes from byte 4: low nibble first at 4 bits, a big-endian bitstream
//     at 3 and 2 bits: 504, 672 or 1008 codes, 505, 673 or 1009 samples
//   step = steps[idx], diff = step >> (bits-1) + sum over magnitude bits k
//     of step >> (bits-2-k), negated by the sign bit
//   pred = clip(pred + diff, -32768, 32767), idx = clip(idx + itab[c], 0, 88)
//   rows end in ADPCM_N_PAD[bits] bytes; out = pred / 32768, cut to samples
//
// What bounds it on an H100, and the design.  By bytes the function is
// tiny: at 32 x 80000 the wire is 1.30 MB at 4 bits, the output 10.24 MB,
// ~3.4 us at 3.35 TB/s.  But it has few lanes: 5 088 blocks at 4 bits, 3 808
// at 3, 2 560 at 2 bits, each a chain of 504-1008 dependent steps with two
// table lookups.  One thread a lane would be about one warp a SM, bound by
// the chain's latency far above the bytes.  Both chains, though, are chains
// of saturating adds x -> clip(x + a, lo, hi), and these transforms are
// closed under composition: (a1, l1, u1) then (a2, l2, u2) is
// (a1 + a2, clip(l1 + a2, l2, u2), clip(u1 + a2, l2, u2)), exact in int32.
// So a warp takes a lane, each thread G = 16, 21 or 32 consecutive codes
// (504 -> 512, 672 = 32 x 21, 1008 -> 1024, padded with the identity
// (0, lo, hi) of the chain's own bounds: in range, it cannot overflow when
// composed, as INT_MIN/INT_MAX bounds would), and
//
// 1. the warp stages the block's 256 bytes in shared memory (coalesced
//    byte loads: rows are odd-sized, so blocks are not aligned) and each
//    thread gathers its codes into one 64-bit word (G codes are at most 64
//    bits at every width);
// 2. step-index chain: each thread composes its G transforms (a = itab[c],
//    0, 88); an inclusive warp scan of the 32 composites (__shfl_up_sync,
//    5 rounds) gives each thread the state before its first code;
// 3. each thread walks its codes once more from that state: the step
//    table lookup (89 entries, in shared memory: divergent indices would
//    serialise in __constant__), the signed diff, kept in registers, and
//    the composite of the predictor transforms (diff, -32768, 32767);
// 4. a second warp scan gives each thread its starting predictor, and the
//    thread's samples follow by G clamped adds;
// 5. samples go to shared memory (skewed by one word every 32, so the
//    threads' G-strided writes hit distinct banks) and are stored as
//    coalesced runs, sample t + 32 k by lane t: a block's 505, 673 or
//    1009 samples are not 16-byte aligned in the output row.
//
// Sequential depth is ~2G + 10 steps instead of 504-1008.  kWarps = 4
// lanes a CUDA block; one launch covers a whole batch (the training shape,
// 256 clips x 160000 samples, is 81 152 lanes at 4 bits).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kBlockBytes = 256;       // ADPCM_BLOCK_ALIGN
constexpr int kWarps = 4;              // lanes per CUDA block
constexpr int kIdxMax = 88;

__device__ const int kStepTable[89] = {
    7,     8,     9,     10,    11,    12,    13,    14,    16,    17,
    19,    21,    23,    25,    28,    31,    34,    37,    41,    45,
    50,    55,    60,    66,    73,    80,    88,    97,    107,   118,
    130,   143,   157,   173,   190,   209,   230,   253,   279,   307,
    337,   371,   408,   449,   494,   544,   598,   658,   724,   796,
    876,   963,   1060,  1166,  1282,  1411,  1552,  1707,  1878,  2066,
    2272,  2499,  2749,  3024,  3327,  3660,  4026,  4428,  4871,  5358,
    5894,  6484,  7132,  7845,  8630,  9493,  10442, 11487, 12635, 13899,
    15289, 16818, 18500, 20350, 22385, 24623, 27086, 29794, 32767};

// audio_io.adpcm_index_table(bits), 4 bits then 3 then 2
__device__ const int kIndexTable4[16] = {-1, -1, -1, -1, 2, 4, 6, 8,
                                         -1, -1, -1, -1, 2, 4, 6, 8};
__device__ const int kIndexTable3[8] = {-1, -1, 1, 2, -1, -1, 1, 2};
__device__ const int kIndexTable2[4] = {-1, 2, -1, 2};

template <int kBits>
struct Codec {
  static constexpr int kCodes = (kBlockBytes - 4) * 8 / kBits;
  static constexpr int kSpb = kCodes + 1;                 // samples a block
  static constexpr int kPerThread = (kCodes + 31) / 32;   // G
  static constexpr int kPad = kBits == 4 ? 1 : kBits == 3 ? 3 : 5;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// sample t of a lane in the skewed sample buffer
__device__ __forceinline__ int skew(int t) { return t + (t >> 5); }

// the thread's codes as one 64-bit word; code k is code_at<kBits>(v, k)
template <int kBits>
__device__ __forceinline__ uint64_t thread_codes(const uint8_t* b,
                                                 int lane) {
  uint64_t v = 0;
  if (kBits == 4) {                    // bytes 4 + 8 lane .., little-endian
#pragma unroll
    for (int m = 7; m >= 0; --m) v = (v << 8) | b[4 + 8 * lane + m];
  } else if (kBits == 2) {             // bytes 4 + 8 lane .., big-endian
#pragma unroll
    for (int m = 0; m < 8; ++m) v = (v << 8) | b[4 + 8 * lane + m];
  } else {                             // bits 63 lane .. of the stream
    const int bit = 63 * lane;
    const uint8_t* p = b + 4 + (bit >> 3);
    const int o = bit & 7;
#pragma unroll
    for (int m = 0; m < 8; ++m) v = (v << 8) | p[m];
    if (o) v = (v << o) | (p[8] >> (8 - o));
  }
  return v;
}

template <int kBits>
__device__ __forceinline__ int code_at(uint64_t v, int k) {
  if (kBits == 4) return static_cast<int>(v >> (4 * k)) & 15;
  if (kBits == 2) return static_cast<int>(v >> (62 - 2 * k)) & 3;
  return static_cast<int>(v >> (61 - 3 * k)) & 7;
}

// inclusive warp scan of clamp-add transforms (lower lanes first), then
// the state after the lanes before this one, starting from x0
__device__ __forceinline__ int scan_start(int a, int l, int u, int lane,
                                          int x0, int lo, int hi) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int pa = __shfl_up_sync(0xffffffffu, a, d);
    const int pl = __shfl_up_sync(0xffffffffu, l, d);
    const int pu = __shfl_up_sync(0xffffffffu, u, d);
    if (lane >= d) {
      const int nl = clampi(pl + a, l, u);
      const int nu = clampi(pu + a, l, u);
      a += pa;
      l = nl;
      u = nu;
    }
  }
  int ea = __shfl_up_sync(0xffffffffu, a, 1);
  int el = __shfl_up_sync(0xffffffffu, l, 1);
  int eu = __shfl_up_sync(0xffffffffu, u, 1);
  if (lane == 0) {
    ea = 0;
    el = lo;
    eu = hi;
  }
  return clampi(x0 + ea, el, eu);
}

template <int kBits>
__global__ void __launch_bounds__(kWarps * 32)
    adpcm_decode_kernel(const uint8_t* __restrict__ wav, int width, int nbl,
                        float* __restrict__ out, int samples, int lanes) {
  using C = Codec<kBits>;
  constexpr int G = C::kPerThread;
  constexpr int kRow = C::kSpb + C::kSpb / 32 + 1;
  __shared__ int steps[89];
  __shared__ int itab[1 << kBits];
  __shared__ uint8_t bytes[kWarps][kBlockBytes + 16];
  __shared__ int32_t samp[kWarps][kRow];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid < 89) steps[tid] = kStepTable[tid];
  if (tid < (1 << kBits))
    itab[tid] = kBits == 4   ? kIndexTable4[tid]
                : kBits == 3 ? kIndexTable3[tid]
                             : kIndexTable2[tid];
  __syncthreads();
  const int ln = blockIdx.x * kWarps + warp;
  if (ln >= lanes) return;             // the whole warp: no barrier follows
  const int clip = ln / nbl, blk = ln - clip * nbl;

  // 1. the block's bytes, and this thread's codes
  uint8_t* b = bytes[warp];
  const uint8_t* src =
      wav + static_cast<size_t>(clip) * width + static_cast<size_t>(blk) *
                                                    kBlockBytes;
#pragma unroll
  for (int m = 0; m < kBlockBytes / 32; ++m) b[lane + 32 * m] = src[lane + 32 * m];
  if (lane < 16) b[kBlockBytes + lane] = 0;
  __syncwarp();
  const int pred0 = static_cast<int16_t>(b[0] | (b[1] << 8));
  const int idx0 = min(static_cast<int>(b[2]), kIdxMax);
  const uint64_t v = thread_codes<kBits>(b, lane);
  const int valid = min(G, C::kCodes - G * lane);

  // 2. step-index chain
  int a = 0, l = 0, u = kIdxMax;
#pragma unroll
  for (int k = 0; k < G; ++k) {
    const int d = k < valid ? itab[code_at<kBits>(v, k)] : 0;
    a += d;
    l = clampi(l + d, 0, kIdxMax);
    u = clampi(u + d, 0, kIdxMax);
  }
  int idx = scan_start(a, l, u, lane, idx0, 0, kIdxMax);

  // 3. signed diffs and the predictor composite
  int diff[G];
  a = 0;
  l = -32768;
  u = 32767;
#pragma unroll
  for (int k = 0; k < G; ++k) {
    int s = 0;
    if (k < valid) {
      const int c = code_at<kBits>(v, k);
      const int step = steps[idx];
      s = step >> (kBits - 1);
#pragma unroll
      for (int m = kBits - 2; m >= 0; --m)
        if (c & (1 << m)) s += step >> (kBits - 2 - m);
      if (c & (1 << (kBits - 1))) s = -s;
      idx = clampi(idx + itab[c], 0, kIdxMax);
    }
    diff[k] = s;
    a += s;
    l = clampi(l + s, -32768, 32767);
    u = clampi(u + s, -32768, 32767);
  }

  // 4. predictor chain
  int pred = scan_start(a, l, u, lane, pred0, -32768, 32767);
  int32_t* row = samp[warp];
  if (lane == 0) row[0] = pred0;
#pragma unroll
  for (int k = 0; k < G; ++k) {
    if (k < valid) {
      pred = clampi(pred + diff[k], -32768, 32767);
      row[skew(1 + G * lane + k)] = pred;
    }
  }
  __syncwarp();

  // 5. coalesced runs of the lane's samples, cut to `samples`
  const int first = blk * C::kSpb;
  const int n = min(C::kSpb, samples - first);
  float* dst = out + static_cast<size_t>(clip) * samples + first;
  for (int t = lane; t < n; t += 32)
    dst[t] = static_cast<float>(row[skew(t)]) / 32768.0f;
}

template <int kBits>
int launch(const uint8_t* wav, int clips, int width, float* out, int samples,
           cudaStream_t stream) {
  using C = Codec<kBits>;
  if (width < C::kPad) return (int)cudaErrorInvalidValue;
  const int nbl = (width - C::kPad) / kBlockBytes;
  if ((long long)nbl * C::kSpb < samples) return (int)cudaErrorInvalidValue;
  const long long lanes = (long long)clips * nbl;
  if (lanes <= 0 || lanes > 0x7fffffffLL - kWarps)
    return (int)cudaErrorInvalidValue;
  const int grid = (int)((lanes + kWarps - 1) / kWarps);
  adpcm_decode_kernel<kBits><<<grid, kWarps * 32, 0, stream>>>(
      wav, width, nbl, out, samples, (int)lanes);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`.  wav (clips, width) uint8, row-major; out (clips,
// samples) float32; bits 4, 3 or 2; the width's whole 256-byte blocks
// (after the ADPCM_N_PAD[bits] trailing bytes) must hold `samples`.
// Returns a cudaError_t as int (0 = launched).
int sed_adpcm_decode(const uint8_t* wav, int clips, int width, int bits,
                     float* out, int samples, void* stream) {
  if (clips <= 0 || samples <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 4: return launch<4>(wav, clips, width, out, samples, s);
    case 3: return launch<3>(wav, clips, width, out, samples, s);
    case 2: return launch<2>(wav, clips, width, out, samples, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* sed_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
