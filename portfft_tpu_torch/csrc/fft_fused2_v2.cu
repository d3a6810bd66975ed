// K2-v2 `fused2_v2`: batched FUSED transform n = a*128 on the PACKED
// interleaved buffer, a batch tile of BT transforms a block, for the plans
// whose a has a fold (a | 64 or 64 | a: a = 8, 16, 32, 64, 128, 192).
//
// Replaces portfft_tpu/ops/pallas_fft.py::fused2_raw_v2_call
// (_fused2_raw_v2_kernel), the reference's engine 2.  Same function as K2:
//   A[k1, n2] = sum_n1 x[128*n1 + n2] * w_a^(n1*k1) * w_n^(n2*k1)
//   out[k1 + a*k2] = scale * sum_n2 A[k1, n2] * w_128^(n2*k2)
// The TPU kernel's ideas kept: split (re, im) planes, de-interleaved and
// re-interleaved inside the kernel, and both stage products taken over a
// tile of BT transforms, so that each table element serves BT transforms.
// Its k2-fold (dense 128-lane output rows) is a TPU layout rule and is not
// carried over: the store writes natural order directly.
//
// Design: the block's BT transforms sit in shared memory as two planes of
// a rows of 129 floats (one float of padding, so that the digit-reversed
// store walks a column without bank conflicts).  Each stage runs in place:
// a warp owns whole columns (stage 1: G = 32/a columns n2 when a < 32, else
// one) or a whole row k1 (stage 2), reads them, keeps its outputs in
// registers, __syncwarp()s and writes them back over its own inputs.  The
// register micro-tile of a lane is KA (stage 1) or 4 (stage 2) outputs x
// BT transforms: one root read, and one twiddle read, serve BT products.
// KA*BT <= 32 and 4*BT <= 32 complex sums keep it in registers, hence
// BT <= 8.  One copy of the planes, so n = 16384 fits at BT = 1 (129 KiB).
//
// Bound on the H100, per complex element: 8*(a + 128) flops against 16
// bytes of device memory: arithmetic (fp32 FMA on the CUDA cores).
#include "fft_common.cuh"

namespace {

constexpr int kPitch = 129;  // floats a plane row holds (128 + 1 padding)

template <int BT, int KA>
__global__ void __launch_bounds__(pfft::kThreads)
    fused2_v2_kernel(const float2* x, float2* y, const float* war,
                     const float* wai, const float* wbr, const float* wbi,
                     const float* ur, const float* ui, int64_t batch, int a,
                     float scale) {
  extern __shared__ float2 smem[];
  const int n = a * 128;
  const int plane = a * kPitch;  // floats of one transform's plane
  float2* ra = smem;
  float2* rb = ra + a;
  float* pr = reinterpret_cast<float*>(rb + 128);
  float* pi = pr + BT * plane;
  pfft::load_roots(ra, war, wai, a);
  pfft::load_roots(rb, wbr, wbi, 128);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  // Stage 1: a warp task is G columns; lane = (column c, first output k1).
  const int G = a < 32 ? 32 / a : 1;
  const int c = a < 32 ? lane / a : 0;
  const int k1_0 = a < 32 ? lane - c * a : lane;
  const int tasks1 = 128 / G;
  const int64_t ntiles = batch / BT;
  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int64_t b0 = tile * BT;
    __syncthreads();  // the roots are in; the last tile's store is done
    for (int e = threadIdx.x; e < BT * n; e += blockDim.x) {
      const int t = e / n;
      const int i = e - t * n;
      const float2 v = x[b0 * n + e];
      const int o = t * plane + (i >> 7) * kPitch + (i & 127);
      pr[o] = v.x;
      pi[o] = v.y;
    }
    __syncthreads();
    for (int task = warp; task < tasks1; task += nwarps) {
      const int n2 = task * G + c;
      float sr[KA][BT], si[KA][BT];
      int r[KA];
#pragma unroll
      for (int j = 0; j < KA; ++j) {
        r[j] = 0;
#pragma unroll
        for (int t = 0; t < BT; ++t) sr[j][t] = si[j][t] = 0.f;
      }
      for (int n1 = 0; n1 < a; ++n1) {
        float xr[BT], xi[BT];
#pragma unroll
        for (int t = 0; t < BT; ++t) {
          xr[t] = pr[t * plane + n1 * kPitch + n2];
          xi[t] = pi[t * plane + n1 * kPitch + n2];
        }
#pragma unroll
        for (int j = 0; j < KA; ++j) {
          const float2 w = ra[r[j]];
#pragma unroll
          for (int t = 0; t < BT; ++t) {
            sr[j][t] = fmaf(xr[t], w.x, sr[j][t]);
            sr[j][t] = fmaf(-xi[t], w.y, sr[j][t]);
            si[j][t] = fmaf(xr[t], w.y, si[j][t]);
            si[j][t] = fmaf(xi[t], w.x, si[j][t]);
          }
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
#pragma unroll
        for (int t = 0; t < BT; ++t) {
          const float2 v = pfft::cmul(make_float2(sr[j][t], si[j][t]), u);
          pr[t * plane + k1 * kPitch + n2] = v.x;
          pi[t * plane + k1 * kPitch + n2] = v.y;
        }
      }
    }
    __syncthreads();
    // Stage 2: a warp task is one row k1; lane outputs k2 = lane + 32*j.
    for (int k1 = warp; k1 < a; k1 += nwarps) {
      float sr[4][BT], si[4][BT];
      int r[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        r[j] = 0;
#pragma unroll
        for (int t = 0; t < BT; ++t) sr[j][t] = si[j][t] = 0.f;
      }
      for (int n2 = 0; n2 < 128; ++n2) {
        float xr[BT], xi[BT];
#pragma unroll
        for (int t = 0; t < BT; ++t) {
          xr[t] = pr[t * plane + k1 * kPitch + n2];
          xi[t] = pi[t * plane + k1 * kPitch + n2];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 w = rb[r[j]];
#pragma unroll
          for (int t = 0; t < BT; ++t) {
            sr[j][t] = fmaf(xr[t], w.x, sr[j][t]);
            sr[j][t] = fmaf(-xi[t], w.y, sr[j][t]);
            si[j][t] = fmaf(xr[t], w.y, si[j][t]);
            si[j][t] = fmaf(xi[t], w.x, si[j][t]);
          }
          r[j] = (r[j] + lane + 32 * j) & 127;
        }
      }
      __syncwarp();  // the warp's row is read: overwrite it
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int t = 0; t < BT; ++t) {
          pr[t * plane + k1 * kPitch + lane + 32 * j] = sr[j][t];
          pi[t * plane + k1 * kPitch + lane + 32 * j] = si[j][t];
        }
      }
    }
    __syncthreads();
    // Re-interleave in natural order: out[k1 + a*k2] = C[k1][k2].
    for (int e = threadIdx.x; e < BT * n; e += blockDim.x) {
      const int t = e / n;
      const int i = e - t * n;
      const int k2 = i / a;
      const int o = t * plane + (i - k2 * a) * kPitch + k2;
      y[b0 * n + e] = make_float2(scale * pr[o], scale * pi[o]);
    }
  }
}

template <int BT, int KA>
int launch_v2(const float* x, float* y, const float* war, const float* wai,
              const float* wbr, const float* wbi, const float* ur,
              const float* ui, int64_t batch, int a, float scale,
              size_t smem, cudaStream_t st) {
  return pfft::launch_tiles(
      fused2_v2_kernel<BT, KA>, smem, batch / BT, st,
      reinterpret_cast<const float2*>(x), reinterpret_cast<float2*>(y), war,
      wai, wbr, wbi, ur, ui, batch, a, scale);
}

template <int BT>
int launch_ka(int ka, const float* x, float* y, const float* war,
              const float* wai, const float* wbr, const float* wbi,
              const float* ur, const float* ui, int64_t batch, int a,
              float scale, size_t smem, cudaStream_t st) {
  switch (ka) {
    case 1:
      return launch_v2<BT, 1>(x, y, war, wai, wbr, wbi, ur, ui, batch, a,
                              scale, smem, st);
    case 2:
      return launch_v2<BT, 2>(x, y, war, wai, wbr, wbi, ur, ui, batch, a,
                              scale, smem, st);
    case 4:
      return launch_v2<BT, 4>(x, y, war, wai, wbr, wbi, ur, ui, batch, a,
                              scale, smem, st);
    case 6:  // 6 x 8 sums would not stay in registers
      if constexpr (BT <= 4)
        return launch_v2<BT, 6>(x, y, war, wai, wbr, wbi, ur, ui, batch, a,
                                scale, smem, st);
      break;
  }
  return int(cudaErrorInvalidValue);
}

}  // namespace

// x (2*batch*n floats) -> y; y may equal x.  Tables as pf_fused2_v1.  bt
// (1, 2, 4 or 8) must divide batch, a must divide 32 or be a multiple of 32
// up to 192, and bt transforms must fit a block's shared memory.  Returns a
// cudaError_t.
extern "C" int pf_fused2_v2(const float* x, float* y, const float* war,
                            const float* wai, const float* wbr,
                            const float* wbi, const float* ur, const float* ui,
                            int64_t batch, int a, int bt, float scale,
                            void* stream) {
  if (a < 1 || batch < 1 || bt < 1 || batch % bt) return int(cudaErrorInvalidValue);
  if (a < 32 ? 32 % a : a % 32) return int(cudaErrorInvalidValue);
  const int ka = a < 32 ? 1 : a / 32;
  const size_t smem = sizeof(float2) * size_t(a + 128) +
                      sizeof(float2) * size_t(bt) * a * kPitch;
  if (smem > pfft::kSmemMax) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bt) {
    case 1:
      return launch_ka<1>(ka, x, y, war, wai, wbr, wbi, ur, ui, batch, a,
                          scale, smem, st);
    case 2:
      return launch_ka<2>(ka, x, y, war, wai, wbr, wbi, ur, ui, batch, a,
                          scale, smem, st);
    case 4:
      return launch_ka<4>(ka, x, y, war, wai, wbr, wbi, ur, ui, batch, a,
                          scale, smem, st);
    case 8:
      return launch_ka<8>(ka, x, y, war, wai, wbr, wbi, ur, ui, batch, a,
                          scale, smem, st);
  }
  return int(cudaErrorInvalidValue);
}
