// The whole v6 pool decode for Hopper (sm_90a) in one launch: header parse,
// data-word gather, sub-group unpack, predictor recurrence and scaling.
//
// Replaces sed_tpu/ops/wire.py:409 dequant_v6_pool (jnp code, not a Pallas
// kernel: a header gather, a worst-case data-word gather at cumsum(width)
// offsets, six static-slice width unpacks and the 128-step lax.scan at
// wire.py:468).  Same function, bit for bit, on any words and offsets:
//
//   pool (P,) int32 words, offsets (B,) int32 -> (B, samples) float32
//   header of clip c: words pool[clip(off_c + k, 0, P-1)], k < hw, bytes
//     [0, 2nb) scale f16 | [2nb, 4nb) mode u16 | init1, init2, coef int8
//   mode: order = bits 0-1, sub-group g's width w_g = bits 2+3g .. 4+3g
//   sub-group s (block j = s / 4, g = s % 4) reads its words at
//     off_c + hw + sum_{s' < s} w_s' + k, each index clipped to [0, P-1];
//     widths 0 and 7 leave the residual 0 (and still advance the offset)
//   codes: big-endian bitstream of the little-endian words,
//     r = code - 2^(w-1)
//   q_t = r_t + pred_t, pred by the block's order (csrc comments below),
//     in int32 with wrapping; out_t = float(q_t) * float(scale)
//
// What bounds it on an H100: bytes.  At 32 clips x 80000 samples the pool
// holds ~1.9 MB of payload (mean 59 250 bytes a bench-corpus clip) and the
// output is 10.24 MB of float32: ~3.6 us at 3.35 TB/s.  The operations
// (a shift-and-mask unpack and 3-7 integer operations a sample) are far
// below that.  The torch formulation this kernel replaces launched 216
// kernels per 32 clips and wrote 10.24 MB of int32 residuals to read them
// back; here residuals live only in shared memory and registers, and
// device memory sees each payload byte (through L2) and each output byte
// once.
//
// Design.  A CUDA block takes one clip and a chunk of kChunk = 32
// consecutive v6 blocks (4096 samples).  At 80000 samples (625 v6 blocks)
// that is 20 chunks a clip, 640 CUDA blocks for 32 clips: ~5 a SM on 132
// SMs, all resident at once (20.6 KB of shared memory and 128 threads
// each), and a 4096-sample output span per block, long enough for float4
// stores.  Nothing carries over between CUDA blocks:
//
// 1. The chunk's first data word: the block sums the widths of the clip's
//    earlier sub-groups from their mode half-words (consecutive threads read
//    consecutive half-words; the header comes from L2 after the clip's
//    first block) with a block-wide reduction.
// 2. Warp 0 reads its lane's block parameters (scale, mode, init1, init2,
//    coef) and keeps them in registers for step 5; a warp scan of the
//    blocks' width sums gives each sub-group's word offset in the span.
// 3. The span's words (at most 32 x 4 x 7) go to shared memory with
//    coalesced 4-byte loads, each index clipped as the reference clips it.
// 4. Each warp unpacks one sub-group at a time, lane i code i, from two
//    byte-swapped words, into a residual tile of 32 rows x 128 int32 in
//    shared memory.  The tile's 16-byte columns are swizzled by row (slot
//    ^ row), so the unpack's row-contiguous writes, the recurrence's
//    column reads (32 rows at once) and the store's row-contiguous reads
//    are all free of bank conflicts.
// 5. Warp 0 runs the 128-step recurrence of its lane's block, 16 bytes of
//    the tile at a time, and writes the float samples back in place.  Orders
//    0-2 are linear, but order 3's rounding shift is not, so each chain is
//    sequential: only the blocks are parallel.  With ~5 CUDA blocks a SM
//    about 5 chains of 128 dependent steps run a SM, ~2 us.
// 6. The chunk's contiguous output span is stored with coalesced float4
//    stores.
//
// Sums and products wrap modulo 2^32 as numpy's, JAX's and torch's int32
// arithmetic does: they are done in uint32, where wrapping is defined, and
// order 3 shifts the signed product arithmetically as jnp's >> does.  The
// scale is widened by __half2float and multiplied in float32, as torch's
// .to(float32) * scale does on the card.

#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kSamples = 128;          // samples per v6 block (Q4_BLOCK)
constexpr int kSub = 4;                // sub-groups per block
constexpr int kSubLen = 32;            // samples per sub-group (V6_SUB)
constexpr int kChunk = 32;             // v6 blocks per CUDA block
constexpr int kThreads = 128;
constexpr int kSlots = kSamples / 4;   // 16-byte slots in a tile row
constexpr int kMaxWords = kChunk * kSub * 7;  // widths are 3 bits

__device__ __forceinline__ int32_t wrap(uint32_t v) {
  return static_cast<int32_t>(v);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// pool[clip(int32(index), 0, pmax)]: the index wraps as the reference's
// int32 offset arithmetic does, then is clipped
__device__ __forceinline__ uint32_t pool_word(const int32_t* __restrict__ pool,
                                              uint32_t index, int pmax) {
  return static_cast<uint32_t>(
      __ldg(pool + clampi(static_cast<int>(index), 0, pmax)));
}

// byte b (b < 4 hw) of the clip's header at word offset `off`
__device__ __forceinline__ uint32_t header_bits(
    const int32_t* __restrict__ pool, uint32_t off, int pmax, int b) {
  return pool_word(pool, off + static_cast<uint32_t>(b >> 2), pmax) >>
         (8 * (b & 3));
}

__device__ __forceinline__ int width_sum(uint32_t mode) {
  return ((mode >> 2) & 7) + ((mode >> 5) & 7) + ((mode >> 8) & 7) +
         ((mode >> 11) & 7);
}

// tile word of row j, sample t: 16-byte slot (t / 4) ^ j of row j
__device__ __forceinline__ int tile_index(int j, int t) {
  return (j * kSlots + ((t >> 2) ^ j)) * 4 + (t & 3);
}

__device__ __forceinline__ int32_t predict(int order, uint32_t coef,
                                           int32_t qp, int32_t qp2) {
  const uint32_t up = static_cast<uint32_t>(qp);
  const uint32_t up2 = static_cast<uint32_t>(qp2);
  const int32_t p2 = wrap(2u * up - up2);
  // arithmetic shift of the signed product, as jnp's >> on int32
  const int32_t p3 =
      wrap(static_cast<uint32_t>(wrap(coef * up + 16u) >> 5) - up2);
  return order == 1 ? qp : order == 2 ? p2 : order == 3 ? p3 : 0;
}

__global__ void __launch_bounds__(kThreads)
    v6_decode_kernel(const int32_t* __restrict__ pool, int pmax,
                     const int32_t* __restrict__ offsets,
                     int4* __restrict__ out, int nb, int hw, int nchunks) {
  __shared__ int4 tile[kChunk * kSlots];
  __shared__ uint32_t words[kMaxWords];
  __shared__ int sub_off[kChunk * kSub];
  __shared__ int sub_w[kChunk * kSub];
  __shared__ int warp_sums[kThreads / 32];
  __shared__ int span;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int clip = blockIdx.x / nchunks;
  const int j0 = (blockIdx.x - clip * nchunks) * kChunk;
  const int nblk = min(kChunk, nb - j0);
  const uint32_t off = static_cast<uint32_t>(offsets[clip]);

  // 1. words of the clip's sub-groups before the chunk
  int before = 0;
  for (int j = tid; j < j0; j += kThreads)
    before += width_sum(header_bits(pool, off, pmax, 2 * nb + 2 * j));
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    before += __shfl_xor_sync(0xffffffffu, before, d);
  if (lane == 0) warp_sums[warp] = before;

  // 2. warp 0: its lane's block parameters and the sub-groups' offsets
  int order = 0;
  uint32_t coef = 0;
  int32_t init1 = 0, init2 = 0;
  float scale = 0.0f;
  if (warp == 0) {
    uint32_t mode = 0;
    if (lane < nblk) {
      const int j = j0 + lane;
      mode = header_bits(pool, off, pmax, 2 * nb + 2 * j) & 0xffff;
      order = mode & 3;
      scale = __half2float(__ushort_as_half(static_cast<unsigned short>(
          header_bits(pool, off, pmax, 2 * j) & 0xffff)));
      init1 = static_cast<int8_t>(header_bits(pool, off, pmax, 4 * nb + j));
      init2 = static_cast<int8_t>(header_bits(pool, off, pmax, 5 * nb + j));
      coef = static_cast<uint32_t>(static_cast<int32_t>(
          static_cast<int8_t>(header_bits(pool, off, pmax, 6 * nb + j))));
    }
    const int mine = width_sum(mode);
    int incl = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    int start = incl - mine;
#pragma unroll
    for (int g = 0; g < kSub; ++g) {
      const int w = (mode >> (2 + 3 * g)) & 7;
      sub_off[lane * kSub + g] = start;
      sub_w[lane * kSub + g] = w;
      start += w;
    }
    if (lane == 31) span = incl;
  }
  __syncthreads();

  // 3. the span's words, each index clipped
  const uint32_t first = off + static_cast<uint32_t>(hw) +
                         static_cast<uint32_t>(warp_sums[0] + warp_sums[1] +
                                               warp_sums[2] + warp_sums[3]);
  const int n_words = span;
  for (int i = tid; i < n_words; i += kThreads)
    words[i] = pool_word(pool, first + static_cast<uint32_t>(i), pmax);
  __syncthreads();

  // 4. unpack: warp w takes sub-groups w, w + 4, ...; lane i code i
  int32_t* tile_w = reinterpret_cast<int32_t*>(tile);
  for (int s = warp; s < nblk * kSub; s += kThreads / 32) {
    const int w = sub_w[s];
    int32_t r = 0;
    if (w >= 1 && w <= 6) {
      const int bit = lane * w;
      const int k = bit >> 5, o = bit & 31;
      const uint32_t* src = words + sub_off[s];
      const uint32_t hi = __byte_perm(src[k], 0, 0x0123);   // big-endian
      uint32_t code;
      if (o + w <= 32) {
        code = hi >> (32 - o - w);
      } else {
        const uint32_t lo = __byte_perm(src[k + 1], 0, 0x0123);
        code = (hi << (o + w - 32)) | (lo >> (64 - o - w));
      }
      r = static_cast<int32_t>(code & ((1u << w) - 1)) - (1 << (w - 1));
    }
    tile_w[tile_index(s >> 2, (s & 3) * kSubLen + lane)] = r;
  }
  __syncthreads();

  // 5. warp 0: the recurrence of its lane's block, in place
  if (warp == 0 && lane < nblk) {
    int32_t qp = init1, qp2 = init2;
#pragma unroll 4
    for (int i = 0; i < kSlots; ++i) {
      int4* slot = tile + lane * kSlots + (i ^ lane);
      const int4 rv = *slot;
      int32_t q[4] = {rv.x, rv.y, rv.z, rv.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        q[k] = wrap(static_cast<uint32_t>(q[k]) +
                    static_cast<uint32_t>(predict(order, coef, qp, qp2)));
        qp2 = qp;
        qp = q[k];
      }
      *slot = make_int4(__float_as_int(static_cast<float>(q[0]) * scale),
                        __float_as_int(static_cast<float>(q[1]) * scale),
                        __float_as_int(static_cast<float>(q[2]) * scale),
                        __float_as_int(static_cast<float>(q[3]) * scale));
    }
  }
  __syncthreads();

  // 6. the chunk's output span, 16 bytes a thread, coalesced
  int4* dst = out + (static_cast<size_t>(clip) * nb + j0) * kSlots;
  for (int f = tid; f < nblk * kSlots; f += kThreads) {
    const int j = f / kSlots;
    dst[f] = tile[j * kSlots + ((f % kSlots) ^ j)];
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// Launch on `stream`.  pool (pool_words,) int32, 0 < pool_words < 2^31;
// offsets (clips,) int32 word offsets; out (clips, samples) float32,
// 16-byte aligned; samples a positive multiple of 128.  Returns a
// cudaError_t as int (0 = launched).
int sed_v6_decode(const int32_t* pool, long long pool_words,
                  const int32_t* offsets, float* out, int clips, int samples,
                  void* stream) {
  if (clips <= 0 || samples <= 0 || samples % kSamples != 0 ||
      pool_words <= 0 || pool_words > 0x7fffffffLL || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  const int nb = samples / kSamples;
  const int hw = (7 * nb + 15) / 16 * 4;      // v6_header_bytes(nb) / 4
  const int nchunks = (nb + kChunk - 1) / kChunk;
  const long long grid = (long long)clips * nchunks;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  v6_decode_kernel<<<(unsigned)grid, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      pool, (int)(pool_words - 1), offsets, reinterpret_cast<int4*>(out), nb,
      hw, nchunks);
  return (int)cudaGetLastError();
}

const char* sed_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
