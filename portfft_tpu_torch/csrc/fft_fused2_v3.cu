// K2-v3 `fused2_v3`: batched FUSED transform n = a*128 on the PACKED
// interleaved buffer, bt transforms a block, for the plans whose a has a
// fold (a | 64 or 64 | a).
//
// Replaces portfft_tpu/ops/pallas_fft.py::fused2_raw_v3_call
// (_fused2_raw_v3_kernel), the reference's engine 3.  Same function as K2:
//   A[k1, n2] = sum_n1 x[128*n1 + n2] * w_a^(n1*k1) * w_n^(n2*k1)
//   out[k1 + a*k2] = sum_n2 A[k1, n2] * (scale * w_128^(n2*k2))
// The TPU kernel's ideas kept: the complex pairs are never de-interleaved
// (here float2 from load to store), one scratch buffer, and the scale
// folded into the stage-B table: the kernel multiplies the 128 stage-B
// roots by the scale as it copies them to shared memory, so the bank's
// table serves every scale and the store multiplies nothing.
//
// Design: the block's bt transforms sit in one float2 tile of a rows of 129
// elements (one float2 of padding, so that the digit-reversed store walks
// a column without bank conflicts), updated in place: in stage 1 a warp
// owns G = 32/a columns n2 of one transform (one column when a >= 32; a
// lane holds KA = a/32 outputs), in stage 2 one row k1 of one transform (a
// lane holds 4 outputs); it reads them, keeps its outputs in registers,
// __syncwarp()s and writes them back over its own inputs.  Unlike K2-v2
// no sum is shared across transforms: bt only sets how many transforms a
// block holds (a knob raced by autotune).
//
// Bound on the H100, per complex element: 8*(a + 128) flops against 16
// bytes of device memory: arithmetic (fp32 FMA on the CUDA cores).
#include "fft_common.cuh"

namespace {

constexpr int kPitch = 129;  // float2 a tile row holds (128 + 1 padding)

template <int KA>
__global__ void __launch_bounds__(pfft::kThreads)
    fused2_v3_kernel(const float2* x, float2* y, const float* war,
                     const float* wai, const float* wbr, const float* wbi,
                     const float* ur, const float* ui, int64_t batch, int a,
                     int bt, float scale) {
  extern __shared__ float2 smem[];
  const int n = a * 128;
  const int per = a * kPitch;
  float2* ra = smem;
  float2* rb = ra + a;
  float2* s = rb + 128;
  pfft::load_roots(ra, war, wai, a);
  for (int i = threadIdx.x; i < 128; i += blockDim.x)  // scale folded in
    rb[i] = make_float2(scale * __ldg(wbr + 128 + i), scale * __ldg(wbi + 128 + i));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int G = a < 32 ? 32 / a : 1;
  const int c = a < 32 ? lane / a : 0;
  const int k1_0 = a < 32 ? lane - c * a : lane;
  const int tasks1 = 128 / G;
  const int64_t ntiles = batch / bt;
  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int64_t b0 = tile * bt;
    __syncthreads();  // the roots are in; the last tile's store is done
    for (int e = threadIdx.x; e < bt * n; e += blockDim.x) {
      const int t = e / n;
      const int i = e - t * n;
      s[t * per + (i >> 7) * kPitch + (i & 127)] = x[b0 * n + e];
    }
    __syncthreads();
    // Stage 1: task = (transform t, column group).
    for (int task = warp; task < bt * tasks1; task += nwarps) {
      const int t = task / tasks1;
      const int n2 = (task - t * tasks1) * G + c;
      float2* col = s + t * per + n2;
      float2 acc[KA];
      int r[KA];
#pragma unroll
      for (int j = 0; j < KA; ++j) {
        acc[j] = make_float2(0.f, 0.f);
        r[j] = 0;
      }
      for (int n1 = 0; n1 < a; ++n1) {
        const float2 v = col[n1 * kPitch];
#pragma unroll
        for (int j = 0; j < KA; ++j) {
          const float2 w = ra[r[j]];
          acc[j].x = fmaf(v.x, w.x, acc[j].x);
          acc[j].x = fmaf(-v.y, w.y, acc[j].x);
          acc[j].y = fmaf(v.x, w.y, acc[j].y);
          acc[j].y = fmaf(v.y, w.x, acc[j].y);
          r[j] += k1_0 + 32 * j;  // < 2a: both terms are below a
          if (r[j] >= a) r[j] -= a;
        }
      }
      __syncwarp();  // the warp's columns are read: overwrite them
#pragma unroll
      for (int j = 0; j < KA; ++j) {
        const int k1 = k1_0 + 32 * j;
        const float2 u = make_float2(__ldg(ur + k1 * 128 + n2),
                                     __ldg(ui + k1 * 128 + n2));
        col[k1 * kPitch] = pfft::cmul(acc[j], u);
      }
    }
    __syncthreads();
    // Stage 2: task = (transform t, row k1); lane outputs k2 = lane + 32*j.
    for (int task = warp; task < bt * a; task += nwarps) {
      float2* row = s + (task / a) * per + (task % a) * kPitch;
      float2 acc[4];
      int r[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[j] = make_float2(0.f, 0.f);
        r[j] = 0;
      }
      for (int n2 = 0; n2 < 128; ++n2) {
        const float2 v = row[n2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 w = rb[r[j]];
          acc[j].x = fmaf(v.x, w.x, acc[j].x);
          acc[j].x = fmaf(-v.y, w.y, acc[j].x);
          acc[j].y = fmaf(v.x, w.y, acc[j].y);
          acc[j].y = fmaf(v.y, w.x, acc[j].y);
          r[j] = (r[j] + lane + 32 * j) & 127;
        }
      }
      __syncwarp();  // the warp's row is read: overwrite it
#pragma unroll
      for (int j = 0; j < 4; ++j) row[lane + 32 * j] = acc[j];
    }
    __syncthreads();
    // Natural order: out[k1 + a*k2] = C[k1][k2] (already scaled).
    for (int e = threadIdx.x; e < bt * n; e += blockDim.x) {
      const int t = e / n;
      const int i = e - t * n;
      const int k2 = i / a;
      y[b0 * n + e] = s[t * per + (i - k2 * a) * kPitch + k2];
    }
  }
}

template <int KA>
int launch_v3(const float* x, float* y, const float* war, const float* wai,
              const float* wbr, const float* wbi, const float* ur,
              const float* ui, int64_t batch, int a, int bt, float scale,
              size_t smem, cudaStream_t st) {
  return pfft::launch_tiles(
      fused2_v3_kernel<KA>, smem, batch / bt, st,
      reinterpret_cast<const float2*>(x), reinterpret_cast<float2*>(y), war,
      wai, wbr, wbi, ur, ui, batch, a, bt, scale);
}

}  // namespace

// x (2*batch*n floats) -> y; y may equal x.  Tables as pf_fused2_v1 (the
// stage-B roots unscaled: the kernel folds the scale in).  bt >= 1 must
// divide batch, a must divide 32 or be a multiple of 32 up to 192, and bt
// transforms must fit a block's shared memory.  Returns a cudaError_t.
extern "C" int pf_fused2_v3(const float* x, float* y, const float* war,
                            const float* wai, const float* wbr,
                            const float* wbi, const float* ur, const float* ui,
                            int64_t batch, int a, int bt, float scale,
                            void* stream) {
  if (a < 1 || batch < 1 || bt < 1 || batch % bt) return int(cudaErrorInvalidValue);
  if (a < 32 ? 32 % a : a % 32) return int(cudaErrorInvalidValue);
  const size_t smem = sizeof(float2) * (size_t(a + 128) + size_t(bt) * a * kPitch);
  if (smem > pfft::kSmemMax) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (a < 32 ? 1 : a / 32) {
    case 1:
      return launch_v3<1>(x, y, war, wai, wbr, wbi, ur, ui, batch, a, bt,
                          scale, smem, st);
    case 2:
      return launch_v3<2>(x, y, war, wai, wbr, wbi, ur, ui, batch, a, bt,
                          scale, smem, st);
    case 4:
      return launch_v3<4>(x, y, war, wai, wbr, wbi, ur, ui, batch, a, bt,
                          scale, smem, st);
    case 6:
      return launch_v3<6>(x, y, war, wai, wbr, wbi, ur, ui, batch, a, bt,
                          scale, smem, st);
  }
  return int(cudaErrorInvalidValue);
}
