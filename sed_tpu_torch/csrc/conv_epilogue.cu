// The eval-mode epilogue of a ConvBlock convolution for Hopper (sm_90a) in
// one pass: BatchNorm with the running statistics, ReLU and, after the
// second convolution of a pooled block, the 2x2 average pool.
//
// Replaces no Pallas kernel.  sed_tpu leaves BatchNorm, ReLU and the pool
// (sed_tpu/models/blocks.py ConvBlock) to XLA, which fuses them into one
// pass over each convolution's output.  Without this kernel the port runs
// them as three aten kernels (cuDNN's inference BatchNorm, the clamp, the
// pool), so each output crosses device memory three times.  Same function
// as F.batch_norm (eval) -> F.relu -> F.avg_pool2d:
//
//   x (B, C, H, W) float32, per channel c:
//     scale = weight[c] / sqrt(var[c] + eps), shift = bias[c] - mean[c] scale
//     y = relu(x scale + shift)          (NaN stays NaN, as torch's relu)
//   pool 1: out = y                       (B, C, H, W)
//   pool 2: out[i, j] = (((0 + y[2i, 2j]) + y[2i, 2j+1]) + y[2i+1, 2j])
//                       + y[2i+1, 2j+1]) / 4
//           (B, C, H/2, W/2), odd H or W floored; the sum in avg_pool2d's
//           order, so the pool equals avg_pool2d's on the same y bit for bit
//
// What bounds it on an H100: bytes.  It does ~3 operations an element.  A
// 5 s clip's 8 convolution outputs hold 7,684,096 floats; the pass reads
// each once and writes 4,990,976 (the first convolution of each block and
// the unpooled fourth block whole, blocks 1-3's pooled outputs a quarter):
// 50.7 MB a clip, 15.1 us at 3.35 TB/s, 0.484 ms a batch of 32.  The three
// aten kernels move 140.9 MB for the same work.
//
// Design.  A CUDA block takes one (batch, channel) plane and a chunk of it,
// so the channel's scale and shift are computed once, in registers, by
// every thread of the block from the four statistics (no prologue kernel).
// Each element is read once and each output written once:
//
// * pool 1: a thread handles kUnroll float4s of the plane (loads first,
//   then the stores), neighbouring threads on neighbouring 16 bytes;
// * pool 2, W % 8 == 0: a thread makes 4 outputs of one output row from
//   two float4s of each of the two input rows, and stores one float4;
// * any other W, or a base address not 16-byte aligned: the same mapping
//   one float (pool 1) or one output (pool 2) a thread.
//
// Grid: x over the B*C planes, y over the chunks of a plane (at most 65535,
// each block walks its chunks with stride gridDim.y).  A 5 s clip's block 4
// (512 planes of 62 x 8) is 512 blocks at batch 1 and block 1 (64 planes of
// 501 x 64) 512 blocks, so batch 1 fills 132 SMs as batch 32 does.
//
// Plain C interface (built with nvcc, loaded with ctypes): no allocation,
// no synchronisation; the launch returns cudaGetLastError() so the caller
// sees a refused launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;     // float4s a thread in a pool-1 chunk

struct Affine {
  float scale, shift;
};

// CPU BatchNorm's form (aten batch_norm_cpu_collect_linear_and_constant_
// terms): invstd = 1 / sqrt(var + eps), scale = invstd * weight,
// shift = bias - mean * scale, each correctly rounded.
__device__ __forceinline__ Affine channel_affine(
    const float* __restrict__ mean, const float* __restrict__ var,
    const float* __restrict__ weight, const float* __restrict__ bias,
    float eps, int c) {
  const float invstd = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var[c], eps)));
  const float scale = __fmul_rn(invstd, weight[c]);
  return {scale, __fsub_rn(bias[c], __fmul_rn(mean[c], scale))};
}

__device__ __forceinline__ float bn_relu(float v, Affine a) {
  v = __fmaf_rn(v, a.scale, a.shift);
  return v != v ? v : fmaxf(v, 0.0f);
}

__device__ __forceinline__ float4 bn_relu4(float4 v, Affine a) {
  return make_float4(bn_relu(v.x, a), bn_relu(v.y, a), bn_relu(v.z, a),
                     bn_relu(v.w, a));
}

// avg_pool2d's window sum: rows outer, columns inner, from 0
__device__ __forceinline__ float pool4(float r0c0, float r0c1, float r1c0,
                                       float r1c1) {
  float s = 0.0f;
  s += r0c0;
  s += r0c1;
  s += r1c0;
  s += r1c1;
  return s / 4.0f;
}

// pool 1.  n: float4s (kVec) or floats of a plane.
template <bool kVec>
__global__ void __launch_bounds__(kThreads) bn_relu_kernel(
    const float* __restrict__ x, float* __restrict__ out,
    const float* __restrict__ mean, const float* __restrict__ var,
    const float* __restrict__ weight, const float* __restrict__ bias,
    float eps, int channels, long long plane_floats, unsigned n) {
  const long long plane = blockIdx.x;
  const Affine a = channel_affine(mean, var, weight, bias, eps,
                                  (int)(plane % channels));
  const float* xp = x + plane * plane_floats;
  float* op = out + plane * plane_floats;
  constexpr unsigned kChunk = kThreads * kUnroll;
  for (unsigned base = blockIdx.y * kChunk; base < n;
       base += gridDim.y * kChunk) {
    if constexpr (kVec) {
      const float4* xv = reinterpret_cast<const float4*>(xp);
      float4* ov = reinterpret_cast<float4*>(op);
      float4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const unsigned i = base + u * kThreads + threadIdx.x;
        if (i < n) v[u] = __ldg(xv + i);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const unsigned i = base + u * kThreads + threadIdx.x;
        if (i < n) ov[i] = bn_relu4(v[u], a);
      }
    } else {
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const unsigned i = base + u * kThreads + threadIdx.x;
        if (i < n) v[u] = __ldg(xp + i);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const unsigned i = base + u * kThreads + threadIdx.x;
        if (i < n) op[i] = bn_relu(v[u], a);
      }
    }
  }
}

// pool 2.  An item is 4 outputs of one output row (kVec: width % 8 == 0)
// or one output; row_items items make an output row.
template <bool kVec>
__global__ void __launch_bounds__(kThreads) bn_relu_pool_kernel(
    const float* __restrict__ x, float* __restrict__ out,
    const float* __restrict__ mean, const float* __restrict__ var,
    const float* __restrict__ weight, const float* __restrict__ bias,
    float eps, int channels, int height, int width, unsigned row_items,
    unsigned n) {
  const long long plane = blockIdx.x;
  const Affine a = channel_affine(mean, var, weight, bias, eps,
                                  (int)(plane % channels));
  const int out_width = width / 2;
  const float* xp = x + plane * height * width;
  float* op = out + plane * (height / 2) * out_width;
  for (unsigned item = blockIdx.y * kThreads + threadIdx.x; item < n;
       item += gridDim.y * kThreads) {
    const unsigned i = item / row_items;
    const unsigned k = item - i * row_items;
    const float* r0 = xp + (long long)(2 * i) * width;
    const float* r1 = r0 + width;
    if constexpr (kVec) {
      const float4 a0 = __ldg(reinterpret_cast<const float4*>(r0) + 2 * k);
      const float4 a1 =
          __ldg(reinterpret_cast<const float4*>(r0) + 2 * k + 1);
      const float4 b0 = __ldg(reinterpret_cast<const float4*>(r1) + 2 * k);
      const float4 b1 =
          __ldg(reinterpret_cast<const float4*>(r1) + 2 * k + 1);
      const float4 p = bn_relu4(a0, a), q = bn_relu4(a1, a);
      const float4 s = bn_relu4(b0, a), t = bn_relu4(b1, a);
      reinterpret_cast<float4*>(op + (long long)i * out_width)[k] =
          make_float4(pool4(p.x, p.y, s.x, s.y), pool4(p.z, p.w, s.z, s.w),
                      pool4(q.x, q.y, t.x, t.y), pool4(q.z, q.w, t.z, t.w));
    } else {
      const float2 p = make_float2(bn_relu(__ldg(r0 + 2 * k), a),
                                   bn_relu(__ldg(r0 + 2 * k + 1), a));
      const float2 s = make_float2(bn_relu(__ldg(r1 + 2 * k), a),
                                   bn_relu(__ldg(r1 + 2 * k + 1), a));
      op[(long long)i * out_width + k] = pool4(p.x, p.y, s.x, s.y);
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

unsigned grid_y(unsigned n, unsigned per_block) {
  const unsigned chunks = (n + per_block - 1) / per_block;
  return chunks < 65535u ? chunks : 65535u;
}

}  // namespace

extern "C" {

// Launch on `stream`.  x (planes, height, width) float32, the planes in
// (batch, channel) order, contiguous; mean, var, weight, bias (channels)
// float32; out (planes, height, width) for pool 1, (planes, height / 2,
// width / 2) for pool 2.  Needs planes a positive multiple of channels,
// height * width < 2^31, and for pool 2 height and width >= 2.  Returns a
// cudaError_t as int (0 = launched).
int sed_conv_epilogue(const float* x, const float* mean, const float* var,
                      const float* weight, const float* bias, float eps,
                      float* out, long long planes, int channels, int height,
                      int width, int pool, void* stream) {
  const long long plane_floats = (long long)height * width;
  if (planes <= 0 || planes > 0x7fffffffLL || channels <= 0 ||
      planes % channels != 0 || height <= 0 || width <= 0 ||
      plane_floats > 0x7fffffffLL || (pool != 1 && pool != 2) ||
      (pool == 2 && (height < 2 || width < 2)))
    return (int)cudaErrorInvalidValue;
  const bool aligned = aligned16(x) && aligned16(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pool == 1) {
    constexpr unsigned kChunk = kThreads * kUnroll;
    if (aligned && plane_floats % 4 == 0) {
      const unsigned n = (unsigned)(plane_floats / 4);
      bn_relu_kernel<true><<<dim3((unsigned)planes, grid_y(n, kChunk)),
                             kThreads, 0, s>>>(
          x, out, mean, var, weight, bias, eps, channels, plane_floats, n);
    } else {
      const unsigned n = (unsigned)plane_floats;
      bn_relu_kernel<false><<<dim3((unsigned)planes, grid_y(n, kChunk)),
                              kThreads, 0, s>>>(
          x, out, mean, var, weight, bias, eps, channels, plane_floats, n);
    }
  } else {
    const unsigned out_rows = height / 2, out_width = width / 2;
    if (aligned && width % 8 == 0) {
      const unsigned row_items = out_width / 4, n = out_rows * row_items;
      bn_relu_pool_kernel<true><<<dim3((unsigned)planes, grid_y(n, kThreads)),
                                  kThreads, 0, s>>>(
          x, out, mean, var, weight, bias, eps, channels, height, width,
          row_items, n);
    } else {
      const unsigned n = out_rows * out_width;
      bn_relu_pool_kernel<false><<<dim3((unsigned)planes,
                                        grid_y(n, kThreads)),
                                   kThreads, 0, s>>>(
          x, out, mean, var, weight, bias, eps, channels, height, width,
          out_width, n);
    }
  }
  return (int)cudaGetLastError();
}

const char* sed_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
