// Tensor-core and async-copy helpers for Hopper (sm_90a), inline PTX.
//
// Two ways to fp32-grade products on the tensor cores:
//
// * FP64 mma (m16n8k8, sm_90): fp32 operands convert to fp64 exactly, their
//   products are exact and the sums are fp64.  67 TFLOP/s on an H100.
// * 3xTF32: an fp32 value x is split into two TF32 values, x = hi + lo,
//   hi = rna(x) and lo = rna(x - hi) (x - hi is exact in fp32).  A product
//   is then a_hi*b_hi + a_hi*b_lo + a_lo*b_hi, three TF32 passes with fp32
//   accumulators: about 2^-21 relative error per product against 2^-24
//   for fp32 and 2^-11 for one TF32 pass.  Good where the terms do not
//   cancel (a sum of non-negative terms keeps each term's relative error);
//   where they do, the error is relative to the sum of |terms|.  The host
//   rounds the same way (sed_tpu_torch/ops/logmel_kernel.py:tf32_round).
//
// Fragments of the m16n8k8 shapes, fp64 and TF32 alike (lane = 4 * g + t):
//   a[0] (row g, k t)  a[1] (row g+8, k t)  a[2] (row g, k t+4)
//   a[3] (row g+8, k t+4);  b0 (k t, col g)  b1 (k t+4, col g);
//   d[0], d[1] (row g, cols 2t, 2t+1)  d[2], d[3] (row g+8, cols 2t, 2t+1)

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace sed {

// d += a * b, fp64 tensor cores
__device__ __forceinline__ void mma_f64(double (&d)[4], const double (&a)[4],
                                        double b0, double b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b0), "d"(b1));
}

// fp32 -> TF32 bits, round to nearest with ties away from zero
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d += a * b, one TF32 pass with fp32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b in 3xTF32; b = (hi b0, hi b1, lo b0, lo b1) as the host lays
// it out.  The small terms go in first.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           const float4& b) {
  mma_tf32(d, a_lo, __float_as_uint(b.x), __float_as_uint(b.y));
  mma_tf32(d, a_hi, __float_as_uint(b.z), __float_as_uint(b.w));
  mma_tf32(d, a_hi, __float_as_uint(b.x), __float_as_uint(b.y));
}

// 16-byte global -> shared copy that bypasses L1; with src_bytes 0 it
// writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(s), "l"(gmem), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most n of this thread's committed groups are in flight
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(n) : "memory");
}

}  // namespace sed
