// The v6 wire's predictor recurrence for Hopper (sm_90a): one thread per
// (clip, block) lane.
//
// Replaces sed_tpu/ops/wire.py:468, the 128-step lax.scan at the end of
// dequant_v6_pool (jnp code, not a Pallas kernel).  Same function, per lane
// of 128 samples, all in int32 exactly as wire.py:477-480:
//
//   pred_t = 0                                   order 0 (raw symbols)
//          = q_{t-1}                             order 1
//          = 2 q_{t-1} - q_{t-2}                 order 2
//          = ((coef q_{t-1} + 16) >> 5) - q_{t-2} order 3 (arithmetic shift)
//   q_t    = r_t + pred_t,   q_{-1} = init1,  q_{-2} = init2
//   out_t  = float(q_t) * scale                  (float32 multiply)
//
// Sums and products wrap modulo 2^32 as numpy's, JAX's and torch's int32
// arithmetic does (done in uint32 here, where wrapping is defined), so the
// result is bit-identical to audio_io.v6_decode_np for any input bytes.
//
// Why a kernel: the recurrence is sequential in t, and as torch ops it is a
// Python loop of ~8 launches a step, ~1000 launches per 32-clip batch.  Here
// it is one launch, each thread keeping q_{t-1} and q_{t-2} in registers.
//
// What bounds it on an H100: bytes.  Per lane it reads 128 int32 residuals
// and 5 words of parameters and writes 128 float32 samples, ~1 KB for ~6
// integer operations a sample; at 32 clips x 80000 samples (20 000 lanes)
// that is ~20.9 MB, ~6.2 us at 3.35 TB/s.  The chain of 128 dependent steps
// is short next to that only if enough lanes are in flight: 20 000 lanes
// are 157 blocks of 128 threads, all resident at once on 132 SMs.
//
// Layout: residuals and output are read and written as (lanes, 128), the
// layout in which the unpack produces them and the engine consumes them, not
// as the (128, lanes) layout sed_tpu scans over.  The transposed layout
// would make each warp's 4-byte accesses at a step contiguous, but costs a
// transpose of the residuals and one of the output (two extra launches, each
// moving as many bytes as this kernel).  Instead each thread moves 16 bytes
// at a time (int4 in, float4 out, every fourth step): a warp's access
// touches 32 sectors, and the next three steps use the rest of those sectors
// from L1 (loads) and L2 (stores), so device memory still sees each byte
// once.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kSamples = 128;  // samples per v6 block (audio_io.Q4_BLOCK)
constexpr int kThreads = 128;  // lanes per CUDA block

__device__ __forceinline__ int32_t wrap(uint32_t v) {
  return static_cast<int32_t>(v);
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
    v6_predict_kernel(const int4* __restrict__ r,
                      const int32_t* __restrict__ order,
                      const int32_t* __restrict__ coef,
                      const int32_t* __restrict__ init1,
                      const int32_t* __restrict__ init2,
                      const float* __restrict__ scale,
                      float4* __restrict__ out, int lanes) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= lanes) return;
  const int ord = order[lane];
  const uint32_t a = static_cast<uint32_t>(coef[lane]);
  const float s = scale[lane];
  int32_t qp = init1[lane];
  int32_t qp2 = init2[lane];
  const int4* src = r + static_cast<size_t>(lane) * (kSamples / 4);
  float4* dst = out + static_cast<size_t>(lane) * (kSamples / 4);
#pragma unroll 4
  for (int i = 0; i < kSamples / 4; ++i) {
    const int4 rv = src[i];
    int32_t q[4] = {rv.x, rv.y, rv.z, rv.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      q[k] = wrap(static_cast<uint32_t>(q[k]) +
                  static_cast<uint32_t>(predict(ord, a, qp, qp2)));
      qp2 = qp;
      qp = q[k];
    }
    dst[i] = make_float4(static_cast<float>(q[0]) * s,
                         static_cast<float>(q[1]) * s,
                         static_cast<float>(q[2]) * s,
                         static_cast<float>(q[3]) * s);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// Launch on `stream`.  r and out (lanes, 128) row-major, 16-byte aligned;
// order, coef, init1, init2 (lanes,) int32; scale (lanes,) float32.
// Returns a cudaError_t as int (0 = launched).
int sed_v6_predict(const int32_t* r, const int32_t* order,
                   const int32_t* coef, const int32_t* init1,
                   const int32_t* init2, const float* scale, float* out,
                   int lanes, void* stream) {
  if (lanes <= 0 || !aligned16(r) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  const int blocks = (lanes + kThreads - 1) / kThreads;
  v6_predict_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const int4*>(r), order, coef, init1, init2, scale,
      reinterpret_cast<float4*>(out), lanes);
  return (int)cudaGetLastError();
}

const char* sed_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
