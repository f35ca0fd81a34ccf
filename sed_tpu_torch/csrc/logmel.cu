// Fused log-mel frontend for Hopper (sm_90a) on the tensor cores: the DFT
// in fp64 mma, the mel product in 3xTF32 mma.
//
// Replaces the Pallas TPU kernel sed_tpu/ops/logmel_kernel.py
// (_logmel_kernel, called through fused_logmel).  Same function:
//
//   frames (rows, n_fft) @ windowed DFT [cos | sin] -> re^2 + im^2
//   -> @ mel (bins, 64) -> 10*log10(max(mel, amin)) - db_shift
//
// and, as on the TPU, only the (rows, 64) log-mel tile reaches device
// memory: frames, spectrum and power live in shared memory and registers.
//
// What bounds it on an H100.  A 5 s 16 kHz clip is ~0.28 GFLOP of DFT and
// mel work against ~320 KB of waveform, so device memory is not the limit;
// arithmetic is, at a precision fp32 FMA gives.  One TF32 pass costs ~0.2
// dB.  3xTF32 (2^-21 per product) was measured short as well: the DFT of
// a frame with loud low and faint high content cancels, its error is
// relative to sum |x w|, and on bench-corpus clips bands 80 dB down were
// 0.01 dB off the fp32 plain version (tolerance 1e-3 dB + 1e-4 relative).
// The fp64 tensor cores (mma.sync m16n8k8 f64, 67 TFLOP/s measured, as
// fast as 3xTF32's 320/3) take fp32 operands exactly, multiply exactly and
// sum in fp64, so the spectrum is as exact as the fp32 inputs.  The bound
// is then the fp64 tensor-core rate, and behind it the feed: every block
// streams the whole DFT matrix (n_fft^2 doubles, 2 MB at 16 kHz) from L2
// through shared memory.  The mel product sums non-negative terms, which
// keeps each term's relative error, so 3xTF32 is enough there.  The design:
//
// * Nyquist packed into the DC-imaginary slot.  For real frames the sine
//   columns of bins 0 and n_fft/2 are zero, so the packed matrix is exactly
//   (n_fft, n_fft): per group of 8 bins, 8 cosine columns then the 8 sine
//   columns of the same bins, and the slot of sine 0 carries the cosine of
//   bin n_fft/2.  The chunks of 128 columns come out whole at every rate
//   (no ragged chunk, 20% less work than 257 bins in 64-bin chunks).  Re
//   and im of a bin land in the same lane's accumulators, so power needs
//   no trip through shared memory.
// * A block owns kTileFrames = 64 frames of one clip and copies their
//   waveform span into shared memory once; frames are read in place.  The
//   span is stored skewed, word a at a + kSpanPad * (a / hop): frame rows
//   then sit hop + 4 words apart, which is 4 or 20 (mod 32) at hop 80, 160
//   and 320, so the 8 rows of an A fragment hit 8 distinct groups of 4
//   banks (without the skew, hop 160 and 320 put all 8 rows in one bank).
// * 8 warps: warp w owns frames 16 * (w % 4) .. +15 (one m16 tile) and
//   half w / 4 of each 128-column chunk (8 n8 tiles, 4 bin groups).
//   Frames convert to fp64 in registers; the matrix comes from the host as
//   fp64 in fragment order, one 16-byte shared load per lane and n8 tile.
// * The DFT tiles (16 rows x 128 columns, 16 KB) stream through a ring of
//   kStages = 2 stages by cp.async: the copy of tile i + 1 runs under the
//   products of tile i, with one barrier per tile.
// * After a chunk, the power of its bins (fp64, rounded once to fp32)
//   folds into (16 frames x 64 mels) partial sums per warp by 3xTF32 mma:
//   the power's C fragment is used as the A fragment directly, with the
//   mel rows permuted to match (A column t <- bin 2t, column t+4 <- bin
//   2t+1).  Mel tiles that are all zero (most: the filters are triangles)
//   are skipped by a per-group mask.  The Nyquist bin's power is folded in
//   fp32 FMA at the end, when the two column halves' sums are added.
// * The partial sums live in shared memory, 32 slots a thread that only
//   that thread touches, once per chunk: in registers they took the
//   kernel to 164 registers, one block an SM, 0.28 ms at 32 x 80000 and
//   16 kHz; in shared memory it needs 123 and two blocks share an SM
//   (16 warps), 0.21 ms.
//
// Shared memory: the skewed span, the ring (32 KB) and the partial sums
// (32 KB): 86 KB at 8 kHz, 107 KB at 16 kHz (two blocks an SM), 149 KB
// at 32 kHz (one).
//
// Plain C interface (built with nvcc, loaded with ctypes): the launch
// returns cudaGetLastError() so the caller sees a refused launch.

#include <cstdint>

#include <cuda_runtime.h>

#include "mma_sm90.cuh"

namespace {

using sed::cp_async16;
using sed::cp_async_commit;
using sed::cp_async_wait;
using sed::mma_3xtf32;
using sed::mma_f64;
using sed::split_tf32;

constexpr int kRowGroups = 4;             // warps along the frames
constexpr int kThreads = kRowGroups * 64; // times 2 column halves
constexpr int kTileFrames = kRowGroups * 16;
constexpr int kChunkCols = 128;           // packed DFT columns per chunk
constexpr int kWarpTiles = 8;             // n8 tiles of a warp (half a chunk)
constexpr int kStageRows = 16;            // DFT rows per ring stage
constexpr int kStages = 2;
constexpr int kStageF4 = kStageRows * kChunkCols * 8 / 16;  // 16-byte units
constexpr int kMels = 64;
constexpr int kMelTiles = kMels / 8;
constexpr int kSpanPad = 4;               // pad words after every hop words

__host__ __device__ inline int span_words(int hop, int n_fft) {
  return (kTileFrames - 1) * hop + n_fft;
}

// floats of the skewed span (a multiple of 4: the ring after it is aligned)
__host__ __device__ inline int span_store_floats(int hop, int n_fft) {
  const int s = span_words(hop, n_fft);
  return s + kSpanPad * ((s - 1) / hop);
}

// max(v, amin) that keeps a NaN, as jnp.maximum and torch.clamp do:
// fmaxf returns amin for a NaN v, so a non-finite input would come out
// as the -100 dB floor and a bad batch would look finite
__device__ __forceinline__ float clamp_amin(float v, float amin) {
  return v >= amin ? v : (isnan(v) ? v : amin);
}

__global__ void __launch_bounds__(kThreads, 2)
logmel_kernel(const float* __restrict__ wav,         // (batch, ld)
              const double2* __restrict__ dft,       // fragment order
              const float4* __restrict__ mel,        // fragment order
              const uint8_t* __restrict__ mel_mask,  // (n_fft / 16)
              const float* __restrict__ mel_nyq,     // (64) bin n_fft/2
              float* __restrict__ out,               // (batch, n_frames, 64)
              int ld, int n_frames, int n_fft, int hop, float amin,
              float db_shift) {
  extern __shared__ __align__(16) float smem[];
  float* wave_s = smem;
  double2* ring =
      reinterpret_cast<double2*>(smem + span_store_floats(hop, n_fft));
  // each thread's 32 mel partial sums: slot i of thread (warp, lane) at
  // mel_s[(warp * 32 + i) * 32 + lane]
  float* mel_s = reinterpret_cast<float*>(ring + kStages * kStageF4);

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTileFrames;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;              // fragment row / column group
  const int t = lane & 3;               // thread in group
  const int rg = warp % kRowGroups;     // frames 16 * rg .. +15
  const int half = warp / kRowGroups;   // n8 tiles 8 * half .. +7 of a chunk

  // waveform span of the tile, skewed; zeros past the row (frames of the
  // ragged last tile, which are not written back).  ld and t0 * hop are
  // multiples of 4, so a 16-byte piece is all inside or all outside.
  {
    const float* src = wav + (size_t)b * ld + (size_t)t0 * hop;
    const long long avail = (long long)ld - (long long)t0 * hop;
    const int span = span_words(hop, n_fft);
    for (int a = 4 * tid; a < span; a += 4 * kThreads) {
      const bool in = a < avail;
      cp_async16(wave_s + a + kSpanPad * (a / hop), in ? src + a : wav,
                 in ? 16 : 0);
    }
  }

  const int steps = n_fft / kStageRows;                  // stages per chunk
  const int n_chunks = n_fft / kChunkCols;
  const int n_tiles = steps * n_chunks;
  // tile i is the i-th kStageF4 16-byte units of dft, the host's order
  auto fetch = [&](int i) {
    if (i < n_tiles) {
      const double2* s = dft + (size_t)i * kStageF4;
      double2* d = ring + (i % kStages) * kStageF4;
#pragma unroll
      for (int q = tid; q < kStageF4; q += kThreads)
        cp_async16(d + q, s + q, 16);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) fetch(i);   // group 0 holds the span

  const int pitch = hop + kSpanPad;                 // skewed frame stride
  const float* rows = wave_s + (16 * rg + g) * pitch + t;
  const int off8 = 8 * pitch;

  float* my_mel = mel_s + warp * 32 * 32 + lane;
#pragma unroll
  for (int i = 0; i < 32; ++i) my_mel[i * 32] = 0.f;
  float nyq[2] = {0.f, 0.f};                  // power of bin n_fft/2

  int tile = 0;
  for (int c = 0; c < n_chunks; ++c) {
    double acc[kWarpTiles][4];
#pragma unroll
    for (int j = 0; j < kWarpTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.0;

    for (int s = 0; s < steps; ++s, ++tile) {
      cp_async_wait<kStages - 2>();   // this thread's copies of tile landed
      __syncthreads();                // everyone's; slot of tile - 1 free
      fetch(tile + kStages - 1);
      const double2* bt = ring + (tile % kStages) * kStageF4;
#pragma unroll
      for (int ks = 0; ks < kStageRows / 8; ++ks) {
        const int k = s * kStageRows + ks * 8;
        const float* p = rows + k + kSpanPad * (k / hop);  // k..k+7 share it
        const double a[4] = {p[0], p[off8], p[4], p[off8 + 4]};
#pragma unroll
        for (int j = 0; j < kWarpTiles; ++j) {
          const double2 w =
              bt[((ks * 2 + half) * kWarpTiles + j) * 32 + lane];
          mma_f64(acc[j], a, w.x, w.y);
        }
      }
    }

    // fold the power of this warp's 4 bin groups into the mel accumulator
#pragma unroll
    for (int q = 0; q < kWarpTiles / 2; ++q) {
      const int grp = c * (kChunkCols / 16) + half * (kWarpTiles / 2) + q;
      const double* re = acc[2 * q];
      const double* im = acc[2 * q + 1];
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[e] = static_cast<float>(re[e] * re[e] + im[e] * im[e]);
      if (grp == 0 && t == 0) {
        // bin 0: its sine slot holds the real part of bin n_fft/2
        p[0] = static_cast<float>(re[0] * re[0]);
        p[2] = static_cast<float>(re[2] * re[2]);
        nyq[0] = static_cast<float>(im[0] * im[0]);
        nyq[1] = static_cast<float>(im[2] * im[2]);
      }
      // C fragment -> A fragment: column t is bin 2t, column t+4 bin 2t+1
      uint32_t p_hi[4], p_lo[4];
      split_tf32(p[0], p_hi[0], p_lo[0]);
      split_tf32(p[2], p_hi[1], p_lo[1]);
      split_tf32(p[1], p_hi[2], p_lo[2]);
      split_tf32(p[3], p_hi[3], p_lo[3]);
      const unsigned mask = mel_mask[grp];
#pragma unroll
      for (int m = 0; m < kMelTiles; ++m) {
        if (mask & (1u << m)) {
          const float4 w = __ldg(mel + ((size_t)grp * kMelTiles + m) * 32 +
                                 lane);
          float d[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) d[e] = my_mel[(m * 4 + e) * 32];
          mma_3xtf32(d, p_hi, p_lo, w);
#pragma unroll
          for (int e = 0; e < 4; ++e) my_mel[(m * 4 + e) * 32] = d[e];
        }
      }
    }
  }

  // sum the two column halves, add the Nyquist bin, and write the log-mel
  // rows
  __syncthreads();
  if (half == 1) return;
  const float* other = my_mel + kRowGroups * 32 * 32;   // warp + 4
  float pn[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    pn[r] = __shfl_sync(0xffffffffu, nyq[r], lane & ~3);
#pragma unroll
  for (int m = 0; m < kMelTiles; ++m) {
    const float2 mn =
        __ldg(reinterpret_cast<const float2*>(mel_nyq + 8 * m + 2 * t));
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = t0 + 16 * rg + 8 * r + g;
      const int i = (m * 4 + 2 * r) * 32;
      float v0 = my_mel[i] + other[i];
      float v1 = my_mel[i + 32] + other[i + 32];
      v0 = fmaf(pn[r], mn.x, v0);
      v1 = fmaf(pn[r], mn.y, v1);
      if (row < n_frames) {
        float2 o;
        o.x = 10.f * log10f(clamp_amin(v0, amin)) - db_shift;
        o.y = 10.f * log10f(clamp_amin(v1, amin)) - db_shift;
        *reinterpret_cast<float2*>(
            out + ((size_t)b * n_frames + row) * kMels + 8 * m + 2 * t) = o;
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// Launch on `stream`.  wav (batch, ld) fp32, ld a multiple of 4 with zeros
// past the padded clip; dft (n_fft^2 fp64) and mel (8 * n_fft * 64 fp32)
// in the fragment order that
// sed_tpu_torch/ops/logmel_kernel.py:kernel_operands lays out; mel_mask
// (n_fft / 16) bytes; mel_nyq the 64 mel weights of bin n_fft/2; out
// (batch, n_frames, 64).  Needs n_fft % 128 == 0, hop % 8 == 0 and
// n_frames frames inside ld.  Returns a cudaError_t as int (0 = launched).
int sed_logmel_f32(const float* wav, const void* dft, const float* mel,
                   const uint8_t* mel_mask, const float* mel_nyq, float* out,
                   int batch, int ld, int n_frames, int n_fft, int hop,
                   float amin, float db_shift, void* stream) {
  if (batch <= 0 || n_frames <= 0 || batch > 65535 || n_fft <= 0 ||
      n_fft % kChunkCols != 0 || hop <= 0 || hop % 8 != 0 || ld % 4 != 0 ||
      (long long)(n_frames - 1) * hop + n_fft > ld || !aligned16(wav) ||
      !aligned16(dft) || !aligned16(mel) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)span_store_floats(hop, n_fft) +
                      16 * (size_t)kStages * kStageF4 +
                      sizeof(float) * kThreads * 32;
  cudaError_t err = cudaFuncSetAttribute(
      logmel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_frames + kTileFrames - 1) / kTileFrames, batch);
  logmel_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      wav, static_cast<const double2*>(dft),
      reinterpret_cast<const float4*>(mel), mel_mask, mel_nyq, out, ld,
      n_frames, n_fft, hop, amin, db_shift);
  return (int)cudaGetLastError();
}

const char* sed_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
