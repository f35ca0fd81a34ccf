// IMA ADPCM decode at 4, 3 and 2 bits per code for Hopper (sm_90a): a CUDA
// block decodes runs of kRun consecutive ADPCM blocks of one clip, a warp
// per ADPCM block, both recurrences resolved by warp scans of clamp-add
// transforms.
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
// What bounds it on an H100.  Bytes: at 32 x 80000 the wire is 1.30 MB at
// 4 bits and the output 10.24 MB, ~3.4 us at 3.35 TB/s; at 256 x 160000,
// 10.4 MB and 164 MB, ~55 us.  Its integer operations (~18 a sample) take
// less at the INT32 rate.  But each block is a chain of 504-1008 dependent
// steps with two table lookups, so the work must be cut into short chains,
// and cutting it costs instructions: this kernel issues ~30 a sample, so
// issue slots and shared-memory wavefronts (the lookups' random banks)
// run out before the bytes do, and at 32 x 80000 a launch (~2.3 us on
// its own) is a quarter of the time.
//
// Both chains are chains of saturating adds x -> clip(x + a, lo, hi);
// these transforms are closed under composition: (a1, l1, u1) then (a2,
// l2, u2) is (a1 + a2, clip(l1 + a2, l2, u2), clip(u1 + a2, l2, u2)),
// exact in int32.  So a warp takes a block, each thread G = 16, 21 or 32
// consecutive codes (504 = 31 x 16 + 8, 672 = 32 x 21, 1008 = 31 x 32 +
// 16: lane 31 walks only its first kAll codes), and
//
// 1. each thread gathers its codes into one 64-bit word (G codes are at
//    most 64 bits at every width) from the run's bytes in shared memory;
// 2. step-index chain: each thread composes its transforms (a = the index
//    table's entry, 0, 88), a group of 2 codes at 4 and 3 bits,
//    of 4 at 2 bits, by one lookup of the group's composite in a table;
//    an inclusive warp scan of the 32 composites (__shfl_up_sync, 5
//    rounds) gives each thread the state before its first code;
// 3. each thread walks its codes once more from that state, one lookup a
//    code in the decode table (89 x 2^bits words: the signed diff << 14 |
//    the next step index's row offset, so the next lookup's offset is one
//    LOP3), and sums the diffs;
// 4. the predictor: each thread starts from pred0 plus the diffs before
//    its codes (a warp scan of sums) and applies its G clamped adds.  That
//    is exact unless a clamp fires; the first thread whose clamp fires
//    started exactly and sees it, and then (__any_sync) the warp redoes
//    the walk from the scan of the predictor's clamp-add composites.  The
//    predictor is kept biased by the bits of 1.5 x 2^23, so that each
//    sample's float pred / 32768 is one exact fma; samples are staged as
//    float32 in shared memory.
//
// Sequential depth is ~2G + 10 steps instead of 504-1008.  Around that:
//
// - The run's wire bytes (kRun x 256, contiguous in the row) come in by one
//   TMA bulk copy on an mbarrier: its 16-byte-aligned interior, with the
//   unaligned head and tail (< 16 bytes each; a row of odd width, or a row
//   slice, starts anywhere) read by ordinary byte loads, so that no byte
//   outside the run, and so outside the tensor, is read.  The two tables
//   are built at compile time (make_table) and come in by a bulk copy on
//   the same barrier as the first run: no thread fills them.
// - The run's samples are one contiguous span of the output row.  They are
//   staged from the output's 16-byte group boundary below the span, a pad
//   word after every 32 (the threads' G-strided writes and the 4-word
//   reads of a float4 hit distinct banks), and stored as float4 over the
//   aligned body, with scalar stores for a head and a tail of up to 3
//   floats.
// - The grid is at most as many blocks as fit on the card at once; each
//   walks runs gridDim.x apart, and issues the next run's bulk copy (and
//   its head and tail loads) into the other of two stages before it
//   decodes the current one, so that the load hides behind the chains and
//   the stores of one run drain while the next decodes.  At 32 x 80000
//   (636 runs at 4 bits) the grid is just the runs, one wave; at 256 x
//   160000 (10 240 runs) each block walks ~10.
//
// One launch covers a whole batch.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "bulk_sm90.cuh"

namespace {

constexpr int kBlockBytes = 256;       // ADPCM_BLOCK_ALIGN
constexpr int kRun = 8;                // ADPCM blocks a run, a warp each
constexpr int kThreads = 32 * kRun;
constexpr int kIdxMax = 88;
// a stage: up to 15 bytes before the run's first 16-byte boundary, the
// run, and the <= 4 bytes past a block's end that step 1 reads (unused)
constexpr int kStageBytes = kRun * kBlockBytes + 32;

// word of staged sample j: a pad word after every 32, so that the threads'
// G-strided writes, and the 4 words a thread reads for a float4, hit
// distinct banks
__host__ __device__ constexpr int skew(int j) { return j + (j >> 5); }

template <int kBits>
struct Codec {
  static constexpr int kCodes = (kBlockBytes - 4) * 8 / kBits;
  static constexpr int kSpb = kCodes + 1;                 // samples a block
  static constexpr int kPerThread = (kCodes + 31) / 32;   // G
  static constexpr int kPad = kBits == 4 ? 1 : kBits == 3 ? 3 : 5;
  // staged samples of a run: up to 3 before the first 16-byte group
  static constexpr int kStageWords = skew(3 + kRun * kSpb + 3) + 1;
};

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int clampi(int v, int lo, int hi) {
  return imin(imax(v, lo), hi);
}

// audio_io.adpcm_index_table(bits)[c] from the code's magnitude bits m:
// 4 bits -1, -1, -1, -1, 2, 4, 6, 8; 3 bits -1, -1, 1, 2; 2 bits -1, 2
template <int kBits>
__host__ __device__ constexpr int index_step(int c) {
  return kBits == 4   ? imax(2 * (c & 7) - 7, -1) + ((c >> 2) & 1)
         : kBits == 3 ? imin(imax(2 * (c & 3) - 3, -1), (c & 3) - 1)
                      : 3 * (c & 1) - 1;
}

// The decode table: entry (idx, c), at byte offset (idx << (kBits + 2)) |
// (c << 2), holds the signed diff of code c at step index idx times 2^14
// plus the byte offset of the next step index's row, so that the next
// lookup's offset is (entry & kRowMask) | (c' << 2).  Built at compile
// time; a CUDA block brings it into shared memory with its first run.
//
// Beside it, the step-index transform of a group of kGroup consecutive
// codes (two at 4 and 3 bits, four at 2), as one clamp-add composite
// (a, l, u) packed a << 16 | u << 8 | l, by the group's kGroupBits bits.
template <int kBits>
struct Table {
  static constexpr int kRowShift = kBits + 2;
  static constexpr int kRowMask = 127 << kRowShift;
  static constexpr int kDiffShift = 14;
  static constexpr int kGroup = kBits == 2 ? 4 : 2;
  static constexpr int kGroupBits = kGroup * kBits;
  int e[89 << kBits];
  int g[1 << kGroupBits];
};

template <int kBits>
__host__ __device__ constexpr Table<kBits> make_table() {
  constexpr int kSteps[89] = {
      7,     8,     9,     10,    11,    12,    13,    14,    16,    17,
      19,    21,    23,    25,    28,    31,    34,    37,    41,    45,
      50,    55,    60,    66,    73,    80,    88,    97,    107,   118,
      130,   143,   157,   173,   190,   209,   230,   253,   279,   307,
      337,   371,   408,   449,   494,   544,   598,   658,   724,   796,
      876,   963,   1060,  1166,  1282,  1411,  1552,  1707,  1878,  2066,
      2272,  2499,  2749,  3024,  3327,  3660,  4026,  4428,  4871,  5358,
      5894,  6484,  7132,  7845,  8630,  9493,  10442, 11487, 12635, 13899,
      15289, 16818, 18500, 20350, 22385, 24623, 27086, 29794, 32767};
  using T = Table<kBits>;
  T t{};
  for (int idx = 0; idx < 89; ++idx) {
    const int step = kSteps[idx];
    for (int c = 0; c < (1 << kBits); ++c) {
      int s = step >> (kBits - 1);
      for (int m = kBits - 2; m >= 0; --m)
        if (c & (1 << m)) s += step >> (kBits - 2 - m);
      if (c & (1 << (kBits - 1))) s = -s;
      t.e[(idx << kBits) | c] =
          s * (1 << T::kDiffShift) +
          (clampi(idx + index_step<kBits>(c), 0, kIdxMax) << T::kRowShift);
    }
  }
  for (int f = 0; f < (1 << T::kGroupBits); ++f) {
    int a = 0, l = 0, u = kIdxMax;
    for (int i = 0; i < T::kGroup; ++i) {   // codes in stream order
      const int c = kBits == 4 ? (f >> (4 * i)) & 15
                               : (f >> (T::kGroupBits - kBits * (i + 1))) &
                                     ((1 << kBits) - 1);
      const int d = index_step<kBits>(c);
      a += d;
      l = clampi(l + d, 0, kIdxMax);
      u = clampi(u + d, 0, kIdxMax);
    }
    t.g[f] = a * 65536 + (u << 8) + l;
  }
  return t;
}

__device__ __align__(16) const Table<4> kTable4 = make_table<4>();
__device__ __align__(16) const Table<3> kTable3 = make_table<3>();
__device__ __align__(16) const Table<2> kTable2 = make_table<2>();

template <int kBits>
__device__ __forceinline__ const Table<kBits>& table_of() {
  if constexpr (kBits == 4) return kTable4;
  else if constexpr (kBits == 3) return kTable3;
  else return kTable2;
}

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

// the bits of codes kGroup g .. kGroup g + kGroup - 1 (a Table::g index)
template <int kBits>
__device__ __forceinline__ int group_at(uint64_t v, int g) {
  if (kBits == 4) return static_cast<int>(v >> (8 * g)) & 255;
  if (kBits == 2) return static_cast<int>(v >> (56 - 8 * g)) & 255;
  return static_cast<int>(v >> (58 - 6 * g)) & 63;
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

// the sum of x over the lanes before this one
__device__ __forceinline__ int exclusive_sum(int x, int lane) {
  int incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  return incl - x;
}

// One warp: the ADPCM block whose 256 bytes start at b (shared memory) to
// staged samples j0 .. j0 + kSpb - 1 of smp.
template <int kBits>
__device__ __forceinline__ void decode_block(const uint8_t* b, int lane,
                                             const Table<kBits>& table,
                                             float* smp,
                                             int j0) {
  using C = Codec<kBits>;
  constexpr int G = C::kPerThread;
  // every thread has its first kAll codes; lane 31 has no more (8, 21, 16
  // of 16, 21, 32), lanes 0-30 have G: each walk is one loop over the
  // first kAll codes and one over the rest, which lane 31 skips
  constexpr int kAll = C::kCodes - 31 * G;
  const int pred0 = static_cast<int16_t>(b[0] | (b[1] << 8));
  const int idx0 = min(static_cast<int>(b[2]), kIdxMax);
  const uint64_t v = thread_codes<kBits>(b, lane);
  const bool rest = lane < 31;

  // 2. step-index chain, a group of codes a lookup (at 3 bits the 21st
  // code alone)
  using T = Table<kBits>;
  constexpr int K = T::kGroup;
  static_assert(kAll == G || (kAll % K == 0 && G % K == 0), "groups");
  int a = 0, l = 0, u = kIdxMax;
  auto index_group = [&](int g) {
    const int e = table.g[group_at<kBits>(v, g)];
    const int ga = e >> 16, gu = (e >> 8) & 255, gl = e & 255;
    a += ga;
    l = clampi(l + ga, gl, gu);
    u = clampi(u + ga, gl, gu);
  };
#pragma unroll
  for (int g = 0; g < kAll / K; ++g) index_group(g);
  if (rest) {
#pragma unroll
    for (int g = kAll / K; g < G / K; ++g) index_group(g);
  }
  if (G % K) {                         // every lane has it: kAll == G
    const int d = index_step<kBits>(code_at<kBits>(v, G - 1));
    a += d;
    l = clampi(l + d, 0, kIdxMax);
    u = clampi(u + d, 0, kIdxMax);
  }
  int idx = scan_start(a, l, u, lane, idx0, 0, kIdxMax);

  // 3. signed diffs and their sum, one table lookup a code
  const char* tab = reinterpret_cast<const char*>(table.e);
  int off = idx << T::kRowShift;
  int diff[G];
  a = 0;
  auto diffs = [&](int k) {
    const int e = *reinterpret_cast<const int*>(
        tab + (off | (code_at<kBits>(v, k) << 2)));
    diff[k] = e >> T::kDiffShift;
    off = e & T::kRowMask;
    a += diff[k];
  };
#pragma unroll
  for (int k = 0; k < kAll; ++k) diffs(k);
  if (rest) {
#pragma unroll
    for (int k = kAll; k < G; ++k) diffs(k);
  }

  // 4. predictor chain, staged as float32.  First as if no clamp fired
  // before the thread's codes: its start is pred0 plus the diffs before
  // them (a warp scan of sums).  That is exact unless a clamp fires; the
  // first thread whose clamp fires started exactly, so it sees it, and
  // then the warp resolves the chain by the scan of clamp-add composites.
  if (lane == 0) smp[skew(j0)] = static_cast<float>(pred0) / 32768.0f;
  // the thread's samples p .. p + G - 1 cross at most one pad word: sample
  // p + k is at before[k] below the crossing, at after[k] from it
  const int p = j0 + 1 + G * lane;
  float* const before = smp + skew(p);
  float* const after = before + 1;
  const int cross = 32 - (p & 31);
  // the predictor is kept biased by kBias, the bits of the float 1.5 x
  // 2^23: for |x| < 2^22 the float of kBias + x is 1.5 x 2^23 + x, so
  // x / 32768 is one exact fma
  constexpr int kBias = 0x4B400000;
  int pred = kBias + pred0 + exclusive_sum(a, lane);
  bool clamped = false;
  auto samples = [&](int k) {
    const int t = pred + diff[k];
    pred = clampi(t, kBias - 32768, kBias + 32767);
    clamped |= t != pred;
    (k < cross ? before : after)[k] =
        __fmaf_rn(__int_as_float(pred), 1.0f / 32768.0f, -384.0f);
  };
#pragma unroll
  for (int k = 0; k < kAll; ++k) samples(k);
  if (rest) {
#pragma unroll
    for (int k = kAll; k < G; ++k) samples(k);
  }
  if (!__any_sync(0xffffffffu, clamped)) return;
  l = -32768;
  u = 32767;
  auto composite = [&](int k) {
    l = clampi(l + diff[k], -32768, 32767);
    u = clampi(u + diff[k], -32768, 32767);
  };
#pragma unroll
  for (int k = 0; k < kAll; ++k) composite(k);
  if (rest) {
#pragma unroll
    for (int k = kAll; k < G; ++k) composite(k);
  }
  pred = kBias + scan_start(a, l, u, lane, pred0, -32768, 32767);
#pragma unroll
  for (int k = 0; k < kAll; ++k) samples(k);
  if (rest) {
#pragma unroll
    for (int k = kAll; k < G; ++k) samples(k);
  }
}

// A run: kRun (fewer at a row's end) consecutive ADPCM blocks of one clip.
struct Run {
  const uint8_t* src;  // its first wire byte
  int lead;            // src's offset in its 16-byte group: the stage index
                       // of byte 0, so that the bulk copy lands aligned
  int head;            // bytes before the first 16-byte boundary (0-15)
  int body;            // bytes of the aligned interior, a multiple of 16
  int tail;            // bytes after it (0-15)
  int blocks;          // ADPCM blocks
  long long o0;        // its first output element
  int n_out;           // its output elements, cut to `samples`
};

template <int kBits>
__device__ __forceinline__ Run run_of(int q, const uint8_t* wav, int width,
                                      int nbl, int rpc, int samples) {
  using C = Codec<kBits>;
  Run r;
  const int clip = q / rpc;
  const int b0 = (q - clip * rpc) * kRun;
  r.blocks = min(kRun, nbl - b0);
  r.src = wav + static_cast<size_t>(clip) * width +
          static_cast<size_t>(b0) * kBlockBytes;
  r.lead = static_cast<int>(reinterpret_cast<uintptr_t>(r.src) & 15);
  const int bytes = r.blocks * kBlockBytes;        // >= 256: an interior
  r.head = (16 - r.lead) & 15;
  r.body = (bytes - r.head) & ~15;
  r.tail = bytes - r.head - r.body;
  r.o0 = static_cast<long long>(clip) * samples +
         static_cast<long long>(b0) * C::kSpb;
  r.n_out = max(0, min(r.blocks * C::kSpb, samples - b0 * C::kSpb));
  return r;
}

// lane's byte of the run's head (lanes 0-15) or tail (16-31): its offset in
// the run, or -1
__device__ __forceinline__ int edge_offset(const Run& r, int lane) {
  if (lane < 16) return lane < r.head ? lane : -1;
  return lane - 16 < r.tail ? r.head + r.body + lane - 16 : -1;
}

// thread 0: the run's aligned interior into stage (and, with the first
// run, the decode table into table); warp 0: the head and tail bytes into
// registers (written to the stage before the next barrier)
template <int kBits>
__device__ __forceinline__ void fetch_run(const Run& r, uint8_t* stage,
                                          uint64_t* bar, int tid, int& eoff,
                                          int& ebyte, Table<kBits>* table) {
  if (tid == 0) {
    const int tbytes = table ? static_cast<int>(sizeof(Table<kBits>)) : 0;
    sed::bulk_expect(bar, r.body + tbytes);
    if (table) sed::bulk_copy(table, &table_of<kBits>(), tbytes, bar);
    sed::bulk_copy(stage + r.lead + r.head, r.src + r.head, r.body, bar);
  }
  eoff = tid < 32 ? edge_offset(r, tid) : -1;
  ebyte = eoff >= 0 ? r.src[eoff] : 0;
}

// all threads: the run's staged samples to out[o0, o0 + n_out), float4
// stores over the 16-byte-aligned body (a 4-group of staged samples never
// spans a pad word: its 4 words are consecutive)
__device__ __forceinline__ void store_run(const Run& r, const float* smp,
                                          float* __restrict__ out, int tid) {
  const long long base = r.o0 & ~3LL;              // staged index 0
  const long long end = r.o0 + r.n_out;
  const long long e0 = (r.o0 + 3) & ~3LL, e1 = end & ~3LL;
  if (tid < min(e0, end) - r.o0)
    out[r.o0 + tid] = smp[skew(static_cast<int>(r.o0 + tid - base))];
  if (end <= e0) return;
  const int nvec = static_cast<int>((e1 - e0) >> 2);
  const int j0 = static_cast<int>(e0 - base);
  float4* dst = reinterpret_cast<float4*>(out + e0);
  for (int i = tid; i < nvec; i += kThreads) {
    const float* w = smp + skew(j0 + 4 * i);
    dst[i] = make_float4(w[0], w[1], w[2], w[3]);
  }
  if (tid < end - e1)
    out[e1 + tid] = smp[skew(static_cast<int>(e1 + tid - base))];
}

// blocks an SM the registers must allow: the most that compile without
// spills at 4 and 2 bits (6 and 4); at 3 bits 4 would cost the small
// batch more than it gains, so 3 (~85 registers)
template <int kBits>
__global__ void __launch_bounds__(kThreads, kBits == 4 ? 6 : kBits == 3 ? 3 : 4)
    adpcm_decode_kernel(const uint8_t* __restrict__ wav, int width, int nbl,
                        int rpc, float* __restrict__ out, int samples,
                        int runs) {
  using C = Codec<kBits>;
  __shared__ __align__(16) uint8_t stage[2][kStageBytes];
  __shared__ __align__(16) float smp[C::kStageWords];
  __shared__ __align__(16) Table<kBits> table;
  __shared__ __align__(8) uint64_t full[2];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    sed::mbar_init(&full[0]);
    sed::mbar_init(&full[1]);
    sed::fence_mbar_init();
  }
  __syncthreads();

  int q = blockIdx.x;                  // < runs: the grid is at most runs
  Run cur = run_of<kBits>(q, wav, width, nbl, rpc, samples);
  int eoff, ebyte;
  fetch_run<kBits>(cur, stage[0], &full[0], tid, eoff, ebyte, &table);

  for (int it = 0; q < runs; ++it) {
    const int s = it & 1;
    if (eoff >= 0) stage[s][cur.lead + eoff] = static_cast<uint8_t>(ebyte);
    // the stage's head and tail (and the table) visible; every thread
    // done with the other stage and with smp
    __syncthreads();
    const int qn = q + gridDim.x;
    Run nxt = cur;
    if (qn < runs) {
      nxt = run_of<kBits>(qn, wav, width, nbl, rpc, samples);
      fetch_run<kBits>(nxt, stage[s ^ 1], &full[s ^ 1], tid, eoff, ebyte,
                       nullptr);
    } else {
      eoff = -1;
    }
    sed::mbar_wait(&full[s], (it >> 1) & 1);
    if (warp < cur.blocks)
      decode_block<kBits>(stage[s] + cur.lead + warp * kBlockBytes, lane,
                          table, smp,
                          static_cast<int>(cur.o0 & 3) + warp * C::kSpb);
    __syncthreads();                   // the run's samples staged
    store_run(cur, smp, out, tid);
    cur = nxt;
    q = qn;
  }
}

// blocks of the kernel that fit on the current device at once
template <int kBits>
int resident_blocks(int* blocks) {
  static int cached[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 0 && dev < 64 && cached[dev] > 0) {
    *blocks = cached[dev];
    return 0;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, adpcm_decode_kernel<kBits>, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (dev >= 0 && dev < 64) cached[dev] = *blocks;
  return 0;
}

template <int kBits>
int launch(const uint8_t* wav, int clips, int width, float* out, int samples,
           cudaStream_t stream) {
  using C = Codec<kBits>;
  if (width < C::kPad) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(out) & 15) return (int)cudaErrorInvalidValue;
  const int nbl = (width - C::kPad) / kBlockBytes;
  if (nbl <= 0 || (long long)nbl * C::kSpb < samples)
    return (int)cudaErrorInvalidValue;
  const int rpc = (nbl + kRun - 1) / kRun;
  const long long runs = (long long)clips * rpc;
  if (runs <= 0 || runs > 0x7fffffffLL / 2) return (int)cudaErrorInvalidValue;
  int blocks = 0;
  const int err = resident_blocks<kBits>(&blocks);
  if (err != 0) return err;
  const int grid = (int)(runs < blocks ? runs : blocks);
  adpcm_decode_kernel<kBits><<<grid, kThreads, 0, stream>>>(
      wav, width, nbl, rpc, out, samples, (int)runs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`.  wav (clips, width) uint8, row-major, at any byte
// address; out (clips, samples) float32, 16-byte aligned; bits 4, 3 or 2;
// the width's whole 256-byte blocks (after the ADPCM_N_PAD[bits] trailing
// bytes) must hold `samples`.  Returns a cudaError_t as int (0 = launched).
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
