// Fused log-mel frontend for Hopper (sm_90a), fp32 FMA.
//
// Replaces the Pallas TPU kernel sed_tpu/ops/logmel_kernel.py
// (_logmel_kernel, called through fused_logmel).  Same function:
//
//   frames (rows, n_fft) @ windowed DFT [cos | sin] (n_fft, 2*bins)
//   -> re^2 + im^2 -> @ mel (bins, 64) -> 10*log10(max(mel, amin)) - db_shift
//
// and, as on the TPU, only the (rows, 64) log-mel tile reaches device
// memory: the (rows, 2*bins) spectrum lives in registers and shared memory.
//
// What bounds it on an H100: a 5 s 16 kHz clip is ~0.28 GFLOP of DFT and
// mel products against ~320 KB of padded waveform read, ~870 FLOP per
// byte, so it is bound by arithmetic, not by device memory.  Accuracy
// rules out plain TF32 (one reduced-precision pass costs ~0.2 dB on the
// TPU), so this version runs on the fp32 FMA pipes, and the limit is how
// fast shared memory can feed them.  The design:
//
// * Framing happens here.  A block owns kTileFrames frames of one clip and
//   loads their contiguous waveform span, (kTileFrames-1)*hop + n_fft
//   samples, into shared memory once; frame f starts at f*hop inside it.
//   The TPU path materialises the overlapped frames in device memory
//   (3.2x the samples); this kernel reads each sample from device memory
//   once per tile.
// * Each warp owns 8 frames; all 32 lanes of a warp read the same
//   waveform words (shared-memory broadcast, no bank conflicts), as
//   float4 over 4 DFT rows.  Each lane owns 2 adjacent DFT bins (re and
//   im), read as float2 from a DFT slice staged in shared memory.  Per 4
//   DFT rows a lane issues 16 shared loads for 128 FMAs.
// * The block walks the bins in chunks of kBinChunk.  A chunk's power
//   goes to shared memory and is folded at once into a (kTileFrames, 64)
//   mel accumulator held in registers (lane owns mel columns lane and
//   lane+32).  The last chunk is ragged (bins is 129, 257 or 513): its
//   DFT columns past bins are staged as zeros and its mel rows skipped.
// * Shared memory is (span + DFT slice + power chunk) floats: 45.8 KB at
//   8 kHz, 66.9 KB at 16 kHz, 109 KB at 32 kHz.  All three take the
//   dynamic shared memory attribute, not a smaller tile.
//
// Plain C interface (built with nvcc, loaded with ctypes): the launch
// returns cudaGetLastError() so the caller sees a refused launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFramesPerWarp = 8;
constexpr int kTileFrames = kWarps * kFramesPerWarp;   // 64
constexpr int kBinChunk = 64;                          // 2 bins per lane
constexpr int kKSlice = 16;                            // DFT rows per stage
constexpr int kMels = 64;                              // 2 columns per lane
constexpr int kDftSlice = kKSlice * 2 * kBinChunk;     // floats

__host__ __device__ inline int span_floats(int hop, int n_fft) {
  return (((kTileFrames - 1) * hop + n_fft) + 3) & ~3;
}

__global__ void __launch_bounds__(kThreads)
logmel_kernel(const float* __restrict__ wav,   // (batch, l_pad)
              const float* __restrict__ dft,   // (n_fft, 2 * n_bins)
              const float* __restrict__ mel,   // (n_bins, kMels)
              float* __restrict__ out,         // (batch, n_frames, kMels)
              int l_pad, int n_frames, int n_fft, int hop, int n_bins,
              float amin, float db_shift) {
  extern __shared__ __align__(16) float smem[];
  const int span = (kTileFrames - 1) * hop + n_fft;
  float* wave_s = smem;                                  // span, padded
  float* dft_s = wave_s + span_floats(hop, n_fft);       // kDftSlice
  float* pow_s = dft_s + kDftSlice;                      // kTileFrames x kBinChunk

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTileFrames;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // waveform span of this tile; zeros past the end of the clip (frames of
  // the ragged last tile that are not written back)
  const float* src = wav + (size_t)b * l_pad + (size_t)t0 * hop;
  const int avail = l_pad - t0 * hop;
  for (int i = tid; i < span_floats(hop, n_fft); i += kThreads)
    wave_s[i] = (i < span && i < avail) ? src[i] : 0.f;

  float acc[kFramesPerWarp][2];
#pragma unroll
  for (int i = 0; i < kFramesPerWarp; ++i) acc[i][0] = acc[i][1] = 0.f;

  const int dft_cols = 2 * n_bins;
  for (int c0 = 0; c0 < n_bins; c0 += kBinChunk) {
    float re[kFramesPerWarp][2], im[kFramesPerWarp][2];
#pragma unroll
    for (int i = 0; i < kFramesPerWarp; ++i)
      re[i][0] = re[i][1] = im[i][0] = im[i][1] = 0.f;

    for (int k0 = 0; k0 < n_fft; k0 += kKSlice) {
      // the previous slice (and the previous chunk's mel pass, which reads
      // pow_s) is finished by every thread past this barrier
      __syncthreads();
      for (int i = tid; i < kDftSlice; i += kThreads) {
        const int kk = i / (2 * kBinChunk);
        const int j = i % (2 * kBinChunk);
        const int bin = c0 + (j % kBinChunk);
        const int col = j < kBinChunk ? bin : n_bins + bin;
        dft_s[i] = bin < n_bins ? dft[(size_t)(k0 + kk) * dft_cols + col]
                                : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kKSlice; kk += 4) {
        float2 wr[4], wi[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float* row = dft_s + (kk + q) * 2 * kBinChunk;
          wr[q] = *reinterpret_cast<const float2*>(row + 2 * lane);
          wi[q] = *reinterpret_cast<const float2*>(row + kBinChunk + 2 * lane);
        }
#pragma unroll
        for (int i = 0; i < kFramesPerWarp; ++i) {
          const float4 x = *reinterpret_cast<const float4*>(
              wave_s + (warp + kWarps * i) * hop + k0 + kk);
          const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            re[i][0] = fmaf(xs[q], wr[q].x, re[i][0]);
            re[i][1] = fmaf(xs[q], wr[q].y, re[i][1]);
            im[i][0] = fmaf(xs[q], wi[q].x, im[i][0]);
            im[i][1] = fmaf(xs[q], wi[q].y, im[i][1]);
          }
        }
      }
    }

    // power of this chunk -> shared memory (bins past n_bins are 0)
#pragma unroll
    for (int i = 0; i < kFramesPerWarp; ++i) {
      float2 p;
      p.x = re[i][0] * re[i][0] + im[i][0] * im[i][0];
      p.y = re[i][1] * re[i][1] + im[i][1] * im[i][1];
      *reinterpret_cast<float2*>(
          pow_s + (warp + kWarps * i) * kBinChunk + 2 * lane) = p;
    }
    __syncthreads();

    // fold the chunk into the mel accumulator, skipping the ragged tail
    const int nb = min(kBinChunk, n_bins - c0);
    for (int kb = 0; kb < nb; ++kb) {
      const float* mrow = mel + (size_t)(c0 + kb) * kMels;
      const float m0 = __ldg(mrow + lane);
      const float m1 = __ldg(mrow + lane + 32);
#pragma unroll
      for (int i = 0; i < kFramesPerWarp; ++i) {
        const float p = pow_s[(warp + kWarps * i) * kBinChunk + kb];
        acc[i][0] = fmaf(p, m0, acc[i][0]);
        acc[i][1] = fmaf(p, m1, acc[i][1]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kFramesPerWarp; ++i) {
    const int t = t0 + warp + kWarps * i;
    if (t < n_frames) {
      float* row = out + ((size_t)b * n_frames + t) * kMels;
      row[lane] = 10.f * log10f(fmaxf(acc[i][0], amin)) - db_shift;
      row[lane + 32] = 10.f * log10f(fmaxf(acc[i][1], amin)) - db_shift;
    }
  }
}

}  // namespace

extern "C" {

// Launch on `stream`.  Shapes: wav (batch, l_pad), dft (n_fft, 2*n_bins),
// mel (n_bins, 64), out (batch, n_frames, 64), all fp32 and contiguous.
// Needs n_fft % 16 == 0, hop % 4 == 0 and n_frames frames inside l_pad.
// Returns a cudaError_t as int (0 = launched).
int sed_logmel_f32(const float* wav, const float* dft, const float* mel,
                   float* out, int batch, int l_pad, int n_frames, int n_fft,
                   int hop, int n_bins, float amin, float db_shift,
                   void* stream) {
  if (batch <= 0 || n_frames <= 0 || batch > 65535 || n_fft % kKSlice != 0 ||
      hop % 4 != 0 || n_bins != n_fft / 2 + 1 ||
      (long long)(n_frames - 1) * hop + n_fft > l_pad)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)span_floats(hop, n_fft) + kDftSlice +
                       (size_t)kTileFrames * kBinChunk);
  cudaError_t err = cudaFuncSetAttribute(
      logmel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_frames + kTileFrames - 1) / kTileFrames, batch);
  logmel_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      wav, dft, mel, out, l_pad, n_frames, n_fft, hop, n_bins, amin,
      db_shift);
  return (int)cudaGetLastError();
}

const char* sed_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
