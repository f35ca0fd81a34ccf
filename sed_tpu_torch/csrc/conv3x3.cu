// The eval-mode 3x3 convolutions of the conv stack for Hopper (sm_90a): an
// implicit GEMM on the tensor cores (wgmma) in 3xTF32, fp32-accurate.
//
// Replaces no Pallas kernel.  sed_tpu leaves the convolutions
// (sed_tpu/models/blocks.py ConvBlock, flax nn.Conv) to XLA.  Without this
// kernel the port runs them in cuDNN's fp32 FFMA implicit GEMM, whose
// ceiling is the 67 TFLOP/s of fp32 outside the tensor cores.  Same
// function as F.conv2d(x, w, padding=1) in float32:
//
//   x (B, Cin, H, W), w (Cout, Cin, 3, 3), no bias, stride 1, zero padding 1
//   out[b, n, t, f] = sum_{ci, dt, df} w[n, ci, dt, df]
//                                      x[b, ci, t + dt - 1, f + df - 1]
//
// as a GEMM: M = output pixels (B H W), N = Cout, K = 9 Cin.
//
// Precision.  Each operand is split into two TF32 values, v = hi + lo with
// hi = rna(v), lo = rna(v - hi) (mma_sm90.cuh), and each product is
// a_lo b_hi + a_hi b_lo + a_hi b_hi: three TF32 wgmma passes a K step.
// The product's relative error is about 2^-21, below the rounding an fp32
// sum over K = 9..4608 terms carries anyway; one TF32 pass (2^-11) is not
// fp32.  The tensor cores' own sums drop bits at every step, though: summed
// there over all of K = 4608 (the 512-channel layer), the error against
// float64 was 17x cuDNN's fp32 FFMA sum's.  So each stage (72 of K) is
// summed on the tensor cores from zero and added to fp32 sums in
// registers; the error is then below cuDNN's at every layer of the stack.
// The host splits the weights once (ops/conv3x3.py weight_planes); the
// activations are split in registers.
//
// What bounds it on an H100: operations.  A 5 s clip's eight convolutions
// are 12.99 GFLOP against ~50 MB of inputs and outputs; three TF32 passes
// at the 495 TFLOP/s dense TF32 rate give 165 TFLOP/s of fp32-accurate
// work, 79 us a clip.  Behind it the feed: every block streams its slice of
// the weights, twice (hi and lo), through shared memory, 4 / kBM bytes an
// operation, so the output tile is made tall (kBM = 256 pixels); and
// wgmma reads its B operand from shared memory, 1/16 byte a multiply-add.
//
// Design.
//
// * A block owns kBM = 256 consecutive output pixels of a group (rows of
//   H x W, flattened) and kBN = 64 output channels.  A group is one
//   image, or, where an image has at most 128 pixels, `pack` images laid
//   one under another with a zero row between two: pack (H + 1) - 1 rows
//   at the same width (CNN14's 15 x 2 planes pack 8 to a tile, its 31 x 4
//   planes 2, where one image alone would fill 12% and 48% of it).  Each
//   image keeps its own zero halo; the producers map each row of the
//   group to its image and row, the store maps each pixel back and drops
//   the zero rows.  Two consumer warpgroups take 128 pixels each, as two
//   m64n64k8 wgmma row blocks; a producer warpgroup (its registers handed
//   to the consumers by setmaxnreg) feeds them.  K is walked a channel
//   block (kBK = 8 input channels) at a time, nine taps a block: a tap of
//   a channel block is one k8 step.  A 1-channel input (the stack's
//   first convolution) takes the taps as K instead: two k8 steps, taps
//   0-7 and tap 8 (zero-padded).
// * Stages.  A ring of shared-memory stages, each holding one channel
//   block: the weights of all nine taps (hi and lo planes, laid out by the
//   host in wgmma's no-swizzle K-major core matrices, brought by one TMA
//   bulk copy) and the tile's input rows with their halo (the rows above
//   and below, a zero column each side, brought by cp.async, with zeros
//   for rows outside the images).  Full and empty mbarriers hand stages
//   between the producers and the consumers.
// * The activations reach wgmma as its A operand in registers: each
//   thread reads its fragment's pixels from the halo tile at the tap's
//   shift and splits them into hi and lo.  The channel stride of the halo
//   tile is 8 mod 32 words, so a fragment's 32 loads fall in distinct banks
//   where its 8 pixels are contiguous.  Two steps are in flight at a time.
// * Split K.  Where the output tiles are fewer than the SMs (the 62 x 8
//   block at small batch, the stream's batch of 1-5), the wrapper splits
//   the channel blocks over gridDim.z; each split writes its partial sums
//   and a second pass adds them in split order: no atomics, and the result
//   is the same bit for bit from run to run.
// * The epilogue stages the sums through shared memory and stores each
//   output channel's pixels contiguously into NCHW (float4 where the plane
//   allows).
//
// Plain C interface (built with nvcc, loaded with ctypes): no allocation,
// no synchronisation; the launch returns cudaGetLastError() so the caller
// sees a refused launch.

#include <cuda_runtime.h>

#include <cstdint>

#include "bulk_sm90.cuh"
#include "mma_sm90.cuh"

namespace {

constexpr int kBM = 256;                 // output pixels a block
constexpr int kBN = 64;                  // output channels a block
constexpr int kBK = 8;                   // input channels a stage
constexpr int kConsumers = 256;          // two warpgroups
constexpr int kProducers = 128;          // and a producer warpgroup
constexpr int kThreads = kConsumers + kProducers;
// registers a thread after setmaxnreg: 128 x 56 + 256 x 224 = 384 x 168
constexpr int kProducerRegs = 56, kConsumerRegs = 224;
constexpr int kStepFloats = kBN * 8;     // one k8 step of one weight plane
constexpr int kMaxStages = 4;
constexpr int kLD = kBM + 4;             // staged output row, 4 mod 16 words
constexpr int kSmemLimit = 232448;
constexpr int kStageAlign = 128;

struct Params {
  const float* x;
  const float* w;        // (n tiles, channel blocks, 2, steps, kStepFloats)
  float* out;            // (B, Cout, H, W), or the split partials
  int cin, cout, height, width, hw;
  int m_tiles;           // tiles of kBM pixels a group
  int n_cblocks;         // channel blocks (1 for a 1-channel input)
  int cb_per_split;
  int rs;                // halo row stride in floats: width + 8
  int ps;                // halo channel stride in floats
  int halo_floats;       // a stage's halo tile
  int stages;
  int stage_bytes;
  int bar_offset;
  bool vec_in, vec_out;
  long long split_floats;  // B Cout H W: one split's partials
  // packed groups: pack images one under another, vheight = pack (height
  // + 1) - 1 rows and vhw = vheight width pixels, halo rows copied 8 bytes
  // at a time where vec2_in
  int batch, pack, vheight, vhw;
  bool vec2_in;
};

__device__ __forceinline__ void mbar_init_count(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   sed::smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   sed::smem_addr(bar))
               : "memory");
}

// arrive on the barrier once this thread's cp.async copies have landed
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   sed::smem_addr(bar))
               : "memory");
}

// 4-byte global -> shared copy; with src_bytes 0 it writes a zero
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   sed::smem_addr(smem)),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

// 8-byte global -> shared copy; with src_bytes 0 it writes zeros
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(
                   sed::smem_addr(smem)),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

// wgmma descriptor of a no-swizzle K-major operand: 8 x 16-byte core
// matrices of 128 contiguous bytes, the two of a k8 step 128 bytes apart
// (leading byte offset), the next 8 rows 256 bytes on (stride byte offset)
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int n>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(n) : "memory");
}

// keep the compiler from moving accumulator accesses across a wait
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64) = a (64 x 8, registers) * b (8 x 64, shared) + (add ? d : 0),
// TF32
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t b, int add) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(add)
      : "memory");
}

// shift of tap (dt, df) = (tap / 3, tap % 3) in the halo tile
__device__ __forceinline__ int tap_offset(int tap, int rs) {
  return (tap / 3 - 1) * rs + (tap % 3 - 1);
}

// Row v of a packed group whose first image is b0: true and its image b
// and row t, or false for a row of zeros (above or below the group, the
// zero row between two images, an image past the batch).  Row v is row
// v % (height + 1) of image b0 + v / (height + 1).
__device__ __forceinline__ bool packed_row(const Params& p, int b0, int v,
                                           int& b, int& t) {
  if (v < 0 || v >= p.vheight) return false;
  const int i = v / (p.height + 1);
  b = b0 + i;
  t = v - i * (p.height + 1);
  return t < p.height && b < p.batch;
}

// The producer warpgroup's share of a stage: rows t0 - 1 .. t0 + nrows - 2 of
// kChans channels from channel ci0 on, zeros outside the image and past
// cin.  Interior columns start at word 4 of a halo row.
template <int kChans>
__device__ __forceinline__ void load_halo(const Params& p, const float* xb,
                                          float* hb, int ci0, int t0,
                                          int nrows, int pt) {
  if (p.vec_in) {
    const int q4 = p.width >> 2, per_c = nrows * q4, total = kChans * per_c;
    for (int i = pt; i < total; i += kProducers) {
      const int c = i / per_c, rem = i - c * per_c, r = rem / q4,
                q = rem - r * q4;
      const int ci = ci0 + c, t = t0 - 1 + r;
      const bool ok = ci < p.cin && t >= 0 && t < p.height;
      const float* src =
          ok ? xb + (long long)ci * p.hw + (long long)t * p.width + 4 * q
             : p.x;
      sed::cp_async16(hb + c * p.ps + r * p.rs + 4 + 4 * q, src,
                      ok ? 16 : 0);
    }
  } else {
    const int per_c = nrows * p.width, total = kChans * per_c;
    for (int i = pt; i < total; i += kProducers) {
      const int c = i / per_c, rem = i - c * per_c, r = rem / p.width,
                f = rem - r * p.width;
      const int ci = ci0 + c, t = t0 - 1 + r;
      const bool ok = ci < p.cin && t >= 0 && t < p.height;
      const float* src =
          ok ? xb + (long long)ci * p.hw + (long long)t * p.width + f : p.x;
      cp_async4(hb + c * p.ps + r * p.rs + 4 + f, src, ok ? 4 : 0);
    }
  }
}

// load_halo for a packed group, a row at a time: group rows t0 - 1 .. t0 +
// nrows - 2, zeros where packed_row gives none.  A packed group is many
// short rows (2 to 128 floats) over several images; finding each copy's
// image and row by division, load_halo's way, kept the consumers waiting
// (CNN14's block 6 ran at half speed).  Here kProducers / kChans threads
// take a channel's rows in turn, each carrying the image i and row t of
// its group row v = i (height + 1) + t from one row to the next, and copy
// a row in pieces of 16, 8 or 4 bytes.
template <int kChans>
__device__ __forceinline__ void load_halo_packed(const Params& p, int b0,
                                                 float* hb, int ci0, int t0,
                                                 int nrows, int pt) {
  constexpr int kPer = kProducers / kChans;
  const int c = pt / kPer, ci = ci0 + c;
  int r = pt - c * kPer, v = t0 - 1 + r;
  int i = v > 0 ? v / (p.height + 1) : 0, t = v - i * (p.height + 1);
  for (; r < nrows; r += kPer, v += kPer, t += kPer) {
    while (t > p.height) {
      t -= p.height + 1;
      ++i;
    }
    const bool ok = ci < p.cin && v >= 0 && v < p.vheight &&
                    t < p.height && b0 + i < p.batch;
    const float* src =
        ok ? p.x + ((long long)(b0 + i) * p.cin + ci) * p.hw +
                 (long long)t * p.width
           : p.x;
    float* dst = hb + c * p.ps + r * p.rs + 4;
    if (p.vec_in) {
      for (int q = 0; q < p.width; q += 4)
        sed::cp_async16(dst + q, ok ? src + q : p.x, ok ? 16 : 0);
    } else if (p.vec2_in) {
      for (int q = 0; q < p.width; q += 2)
        cp_async8(dst + q, ok ? src + q : p.x, ok ? 8 : 0);
    } else {
      for (int q = 0; q < p.width; ++q)
        cp_async4(dst + q, ok ? src + q : p.x, ok ? 4 : 0);
    }
  }
}

// kTaps: a 1-channel input, K = the 9 taps (two k8 steps).  kPacked: a
// group holds p.pack > 1 images
template <bool kTaps, bool kPacked>
__global__ void __launch_bounds__(kThreads, 1)
    conv3x3_kernel(const __grid_constant__ Params p) {
  constexpr int kSteps = kTaps ? 2 : 9;
  constexpr int kChans = kTaps ? 1 : kBK;
  constexpr uint32_t kWBytes = 2 * kSteps * kStepFloats * 4;
  extern __shared__ __align__(1024) unsigned char smem[];

  const int tid = threadIdx.x;
  const int group = blockIdx.x / p.m_tiles;
  const int b0 = kPacked ? group * p.pack : group;   // its first image
  const int m0 = (blockIdx.x - group * p.m_tiles) * kBM;
  const int n0 = blockIdx.y * kBN;
  const int cb0 = blockIdx.z * p.cb_per_split;
  const int iters = min(p.n_cblocks - cb0, p.cb_per_split);
  const int mpix = kPacked ? p.vhw : p.hw;   // pixels of a group
  const int t0 = m0 / p.width;
  const int nrows = (min(m0 + kBM, mpix) - 1) / p.width - t0 + 3;

  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.bar_offset);
  uint64_t* empty = full + kMaxStages;
  auto wstage = [&](int s) { return smem + s * p.stage_bytes; };
  auto hstage = [&](int s) {
    return reinterpret_cast<float*>(smem + s * p.stage_bytes + kWBytes);
  };

  // the halo's zero columns are never written by a copy
  for (int s = 0; s < p.stages; ++s) {
    float* hb = hstage(s);
    for (int i = tid; i < p.halo_floats; i += kThreads) hb[i] = 0.0f;
  }
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      // the producers' copy arrivals and the TMA's
      mbar_init_count(&full[s], kProducers + 1);
      mbar_init_count(&empty[s], kConsumers);
    }
    sed::fence_mbar_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---------------- producer warpgroup ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    const int pt = tid - kConsumers;
    const float* xb = p.x + (long long)b0 * p.cin * p.hw;
    const float* wsrc =
        p.w + ((long long)blockIdx.y * p.n_cblocks + cb0) * (kWBytes / 4);
    for (int it = 0; it < iters; ++it) {
      const int s = it % p.stages;
      sed::mbar_wait(&empty[s], ((it / p.stages) & 1) ^ 1);
      if (pt == 0) {
        sed::bulk_expect(&full[s], kWBytes);
        sed::bulk_copy(wstage(s), wsrc + (long long)it * (kWBytes / 4),
                       kWBytes, &full[s]);
      }
      if constexpr (kPacked)
        load_halo_packed<kChans>(p, b0, hstage(s), (cb0 + it) * kChans, t0,
                                 nrows, pt);
      else
        load_halo<kChans>(p, xb, hstage(s), (cb0 + it) * kChans, t0, nrows,
                          pt);
      cp_async_mbar_arrive(&full[s]);
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
  } else {
    // ---------------- consumer warpgroups ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int wg = tid >> 7, wq = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, tq = lane & 3;
    // halo offsets of this thread's four pixels (rows of its fragments);
    // pixels past the group read the last one and are not stored
    int roff[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = min(m0 + wg * 128 + j * 64 + wq * 16 + g + 8 * h,
                          mpix - 1);
        const int t = m / p.width;
        roff[j][h] = (t - t0 + 1) * p.rs + (m - t * p.width) + 4;
      }
    // kTaps: this thread's two columns of a step are taps 8 k + tq and
    // 8 k + tq + 4; taps past 8 have zero weights and read any finite word
    int toff[2][2];
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int tap = 8 * k + tq + 4 * c;
        toff[k][c] = tap < 9 ? tap_offset(tap, p.rs) : 0;
      }
    const int coff[2] = {tq * p.ps, (tq + 4) * p.ps};

    // The tensor cores' own accumulation drops bits at every step: summed
    // there over all of K = 4608, the error was 15x an fp32 FFMA sum's.
    // So each stage is summed on the tensor cores from zero and then added
    // to fp32 sums in registers.
    float acc[2][32], sum[2][32];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) sum[j][i] = acc[j][i] = 0.0f;

    for (int it = 0; it < iters; ++it) {
      const int s = it % p.stages;
      sed::mbar_wait(&full[s], (it / p.stages) & 1);
      const float* hb = hstage(s);
      const uint32_t wb = sed::smem_addr(wstage(s));
#pragma unroll
      for (int k = 0; k < kSteps; ++k) {
        // the step that last used this step's registers is done
        if (k >= 2) wgmma_wait<1>();
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float v[4];
          if constexpr (kTaps) {
            v[0] = hb[roff[j][0] + toff[k][0]];
            v[1] = hb[roff[j][1] + toff[k][0]];
            v[2] = hb[roff[j][0] + toff[k][1]];
            v[3] = hb[roff[j][1] + toff[k][1]];
          } else {
            const int to = tap_offset(k, p.rs);
            v[0] = hb[coff[0] + roff[j][0] + to];
            v[1] = hb[coff[0] + roff[j][1] + to];
            v[2] = hb[coff[1] + roff[j][0] + to];
            v[3] = hb[coff[1] + roff[j][1] + to];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
            sed::split_tf32(v[i], ah[j][i], al[j][i]);
        }
        const uint64_t dhi = desc_kmajor(wb + k * kStepFloats * 4);
        const uint64_t dlo =
            desc_kmajor(wb + (kSteps + k) * kStepFloats * 4);
        wgmma_fence();
        // the small terms first
        wgmma_tf32(acc[0], al[0], dhi, k > 0);
        wgmma_tf32(acc[1], al[1], dhi, k > 0);
        wgmma_tf32(acc[0], ah[0], dlo, 1);
        wgmma_tf32(acc[1], ah[1], dlo, 1);
        wgmma_tf32(acc[0], ah[0], dhi, 1);
        wgmma_tf32(acc[1], ah[1], dhi, 1);
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      mbar_arrive(&empty[s]);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 32; ++i) sum[j][i] += acc[j][i];
    }

    // ---------------- epilogue ----------------
    // both warpgroups are done with the ring before it holds the output
    asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
    float* st = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int px = wg * 128 + j * 64 + wq * 16 + g + 8 * ((i >> 1) & 1);
        const int n = (i >> 2) * 8 + 2 * tq + (i & 1);
        st[n * kLD + px] = sum[j][i];
      }
    asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
    float* out = p.out + blockIdx.z * p.split_floats;
    const int mcount = min(kBM, mpix - m0);
    const int ncount = min(kBN, p.cout - n0);
    if constexpr (kPacked) {
      // each pixel back to its image and row; the zero rows are dropped
      const int vec = p.vec_out ? 4 : 1;
      for (int i = tid; i < kBN * kBM / vec; i += kConsumers) {
        const int n = i / (kBM / vec), q = vec * (i - n * (kBM / vec));
        const int v = (m0 + q) / p.width;
        int b = 0, t = 0;
        if (n >= ncount || q >= mcount || !packed_row(p, b0, v, b, t))
          continue;
        float* d = out + ((long long)b * p.cout + n0 + n) * p.hw +
                   (long long)t * p.width + (m0 + q - v * p.width);
        if (vec == 4)
          *reinterpret_cast<float4*>(d) =
              *reinterpret_cast<const float4*>(st + n * kLD + q);
        else
          *d = st[n * kLD + q];
      }
    } else {
      float* dst = out + ((long long)b0 * p.cout + n0) * p.hw + m0;
      if (p.vec_out) {
        for (int i = tid; i < kBN * (kBM / 4); i += kConsumers) {
          const int n = i / (kBM / 4), q = 4 * (i - n * (kBM / 4));
          if (n < ncount && q < mcount)
            *reinterpret_cast<float4*>(dst + (long long)n * p.hw + q) =
                *reinterpret_cast<const float4*>(st + n * kLD + q);
        }
      } else {
        for (int i = tid; i < kBN * kBM; i += kConsumers) {
          const int n = i / kBM, q = i - n * kBM;
          if (n < ncount && q < mcount) dst[(long long)n * p.hw + q] =
              st[n * kLD + q];
        }
      }
    }
  }
}

// out = the splits' partials added in split order
template <bool kVec>
__global__ void __launch_bounds__(256) split_sum_kernel(
    const float* __restrict__ work, float* __restrict__ out, long long n,
    int splits) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < (kVec ? n / 4 : n); i += stride) {
    if constexpr (kVec) {
      const float4* w = reinterpret_cast<const float4*>(work);
      float4 s = __ldg(w + i);
      for (int z = 1; z < splits; ++z) {
        const float4 v = __ldg(w + z * (n / 4) + i);
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
      reinterpret_cast<float4*>(out)[i] = s;
    } else {
      float s = __ldg(work + i);
      for (int z = 1; z < splits; ++z) s += __ldg(work + z * n + i);
      out[i] = s;
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

bool aligned8(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 7) == 0;
}

int round_up(int v, int to) { return (v + to - 1) / to * to; }

// A block's shared memory for this input (ops/conv3x3.py stages() repeats
// the rule): the halo's row and channel strides in floats, the stages and
// their size; stages 0 where two do not fit (a width over ~600).
struct Layout {
  int rs, ps, halo_floats, stage_bytes, stages;
};

Layout layout(int cin, int width) {
  const bool taps = cin == 1;
  // the rows 256 consecutive pixels span, and one above and below
  const int rows = (kBM - 1 + width - 1) / width + 3;
  Layout l;
  l.rs = width + 8;
  l.ps = round_up(rows * l.rs + 24, 32) - 24;   // 8 mod 32
  l.halo_floats = (taps ? 1 : kBK) * l.ps;
  l.stage_bytes = round_up(
      2 * (taps ? 2 : 9) * kStepFloats * 4 + l.halo_floats * 4, kStageAlign);
  // the barriers and alignment slack come off the top
  const int n = (kSmemLimit - 2 * kMaxStages * 8 - 1024) / l.stage_bytes;
  l.stages = n < 2 ? 0 : (n > kMaxStages ? kMaxStages : n);
  return l;
}

template <bool kTaps, bool kPacked>
cudaError_t launch_conv(const dim3& grid, int smem, cudaStream_t s,
                        const Params& p) {
  const cudaError_t err = cudaFuncSetAttribute(
      conv3x3_kernel<kTaps, kPacked>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  conv3x3_kernel<kTaps, kPacked><<<grid, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`.  x (batch, cin, height, width) float32 contiguous;
// w the weight planes of ops/conv3x3.py weight_planes; out (batch, cout,
// height, width); work (splits, batch, cout, height, width) floats when
// splits > 1, else unused.  pack images go to a group, one under another
// with a zero row between two (ops/conv3x3.py images_a_tile; 1 = a group
// an image).  splits divides the channel blocks (ceil(cin / 8), 1 for cin
// 1) into runs of ceil(blocks / splits), none empty.  Returns a
// cudaError_t as int (0 = launched).
int sed_conv3x3(const float* x, const float* w, float* out, float* work,
                int batch, int cin, int cout, int height, int width,
                int pack, int splits, void* stream) {
  const long long hw = (long long)height * width;
  const long long vheight =
      pack > 1 ? (long long)pack * (height + 1) - 1 : height;
  if (batch <= 0 || cin <= 0 || cout <= 0 || height <= 0 || width <= 0 ||
      pack <= 0 || vheight * width >= 0x7fffffffLL || splits < 1 ||
      (splits > 1 && work == nullptr))
    return (int)cudaErrorInvalidValue;
  const Layout l = layout(cin, width);
  const bool taps = cin == 1;
  Params p{};
  p.x = x;
  p.w = w;
  p.batch = batch;
  p.cin = cin;
  p.cout = cout;
  p.height = height;
  p.width = width;
  p.hw = (int)hw;
  p.pack = pack;
  p.vheight = (int)vheight;
  p.vhw = (int)(vheight * width);
  p.m_tiles = (p.vhw + kBM - 1) / kBM;
  p.n_cblocks = taps ? 1 : (cin + kBK - 1) / kBK;
  p.cb_per_split = (p.n_cblocks + splits - 1) / splits;
  const long long groups = (batch + pack - 1) / pack;
  if (l.stages == 0 ||
      (long long)(splits - 1) * p.cb_per_split >= p.n_cblocks ||
      groups * p.m_tiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  p.rs = l.rs;
  p.ps = l.ps;
  p.halo_floats = l.halo_floats;
  p.stages = l.stages;
  p.stage_bytes = l.stage_bytes;
  p.bar_offset = round_up(
      p.stages * p.stage_bytes > kBN * kLD * 4 ? p.stages * p.stage_bytes
                                               : kBN * kLD * 4,
      kStageAlign);
  const int smem = p.bar_offset + 2 * kMaxStages * 8;
  p.split_floats = (long long)batch * cout * hw;
  p.out = splits > 1 ? work : out;
  p.vec_in = width % 4 == 0 && aligned16(x);
  p.vec2_in = pack > 1 && width % 2 == 0 && aligned8(x);
  // a float4 of the tile must land on 4 pixels of one image's row
  p.vec_out = (pack > 1 ? width : hw) % 4 == 0 && aligned16(p.out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)(groups * p.m_tiles),
                  (unsigned)((cout + kBN - 1) / kBN), (unsigned)splits);
  cudaError_t err;
  if (pack > 1)
    err = taps ? launch_conv<true, true>(grid, smem, s, p)
               : launch_conv<false, true>(grid, smem, s, p);
  else
    err = taps ? launch_conv<true, false>(grid, smem, s, p)
               : launch_conv<false, false>(grid, smem, s, p);
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long n = p.split_floats;
  const bool vec = n % 4 == 0 && aligned16(work) && aligned16(out);
  const long long items = vec ? n / 4 : n;
  const unsigned blocks =
      (unsigned)((items + 255) / 256 < 132 * 8 ? (items + 255) / 256
                                               : 132 * 8);
  if (vec)
    split_sum_kernel<true><<<blocks, 256, 0, s>>>(work, out, n, splits);
  else
    split_sum_kernel<false><<<blocks, 256, 0, s>>>(work, out, n, splits);
  return (int)cudaGetLastError();
}

const char* sed_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
