// K2-v1 `fused2_v1`: batched FUSED transform n = a*128, any a, on the
// PACKED interleaved buffer.
//
// Replaces portfft_tpu/ops/pallas_fft.py::fused2_raw_call
// (_fused2_raw_kernel), the reference's fallback for every two-stage plan
// (the one its engine chain reaches on plans whose a has no fold).  It
// computes what K2 computes, with x[n1, n2] = x[128*n1 + n2]:
//   1. A[k1, n2] = sum_n1 x[n1, n2] * w_a^(n1*k1) * w_n^(n2*k1)
//   2. C[k1, k2] = sum_n2 A[k1, n2] * w_128^(n2*k2)
//   3. out[k1 + a*k2] = scale * C[k1, k2]
// The TPU kernel's idea is the transposed store: its per-row (2a, 128)
// transpose is at once the digit reversal and the re-interleave.  Here the
// transposes live in shared memory, in rows of a + 1 float2 (one float2 of
// padding): stage 1 writes A as [n2][k1], stage 2 writes C as [k2][k1], so
// the final store walks C in natural order k1 + a*k2 = row-major [k2][k1]
// and every global write is coalesced.  Consecutive threads walk k1 (or
// n2) along a padded row, which keeps the transposed accesses off a single
// bank.
//
// Bound on the H100, per complex element: 8*(a + 128) flops against 16
// bytes of device memory; naive fp32 sums on the CUDA cores, roots in
// shared memory (row 1 of the bank's DFT matrices), so the sums and their
// shared-memory operand reads bound it.
//
// Design: a block holds T whole transforms (two tiles of 128*(a+1) float2
// each), T picked here from the transform's footprint (no knob, as the
// reference picks its own tile); one thread an output element per stage.
// The gate (ops/cuda_fft.fused2_v1_supported) declines a length whose one
// transform does not fit the 227 KB a block may use (a >= 112).
#include "fft_common.cuh"

namespace {

__global__ void __launch_bounds__(pfft::kThreads)
    fused2_v1_kernel(const float2* x, float2* y, const float* war,
                     const float* wai, const float* wbr, const float* wbi,
                     const float* ur, const float* ui, int64_t batch, int a,
                     int T, float scale) {
  extern __shared__ float2 smem[];
  const int n = a * 128;
  const int p = a + 1;      // padded row of the transposed tiles
  const int per = 128 * p;  // float2 of one tile
  float2* ra = smem;
  float2* rb = ra + a;
  float2* s0 = rb + 128;     // x [n1][n2] (pitch 128), later C [k2][k1]
  float2* s1 = s0 + T * per;  // A [n2][k1]
  pfft::load_roots(ra, war, wai, a);
  pfft::load_roots(rb, wbr, wbi, 128);
  const int64_t ntiles = (batch + T - 1) / T;
  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int64_t b0 = tile * T;
    const int tv = batch - b0 < T ? int(batch - b0) : T;
    const int total = tv * n;
    __syncthreads();  // the roots are in; the last tile's store is done
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
      const int t = e / n;
      s0[t * per + (e - t * n)] = x[b0 * n + e];
    }
    __syncthreads();
    // Stage 1: output (t, k1, n2), n2 fastest.
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
      const int t = e / n;
      const int i = e - t * n;
      const int k1 = i >> 7;
      const int n2 = i & 127;
      const float2* col = s0 + t * per + n2;
      float re = 0.f, im = 0.f;
      int r = 0;
      for (int n1 = 0; n1 < a; ++n1) {
        const float2 v = col[n1 * 128];
        const float2 w = ra[r];
        re = fmaf(v.x, w.x, re);
        re = fmaf(-v.y, w.y, re);
        im = fmaf(v.x, w.y, im);
        im = fmaf(v.y, w.x, im);
        r += k1;
        if (r >= a) r -= a;
      }
      const float2 u = make_float2(__ldg(ur + i), __ldg(ui + i));
      s1[t * per + n2 * p + k1] = pfft::cmul(make_float2(re, im), u);
    }
    __syncthreads();
    // Stage 2: output (t, k2, k1), k1 fastest, to C[k2][k1] in s0.
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
      const int t = e / n;
      const int i = e - t * n;
      const int k2 = i / a;
      const int k1 = i - k2 * a;
      const float2* row = s1 + t * per + k1;
      float re = 0.f, im = 0.f;
      int r = 0;
      for (int n2 = 0; n2 < 128; ++n2) {
        const float2 v = row[n2 * p];
        const float2 w = rb[r];
        re = fmaf(v.x, w.x, re);
        re = fmaf(-v.y, w.y, re);
        im = fmaf(v.x, w.y, im);
        im = fmaf(v.y, w.x, im);
        r = (r + k2) & 127;
      }
      s0[t * per + k2 * p + k1] = make_float2(re, im);
    }
    __syncthreads();
    // Natural order: out[k1 + a*k2] is C[k2][k1].
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
      const int t = e / n;
      const int i = e - t * n;
      const int k2 = i / a;
      const float2 v = s0[t * per + i + k2];  // k2*(a+1) + k1 = i + k2
      y[b0 * n + e] = make_float2(scale * v.x, scale * v.y);
    }
  }
}

}  // namespace

// x (2*batch*n floats) -> y; y may equal x.  war/wai: a x a DFT planes;
// wbr/wbi: 128 x 128; ur/ui: the (a, 128) twiddle planes [k1][n2].
// Returns a cudaError_t (cudaErrorInvalidValue where one transform does
// not fit a block's shared memory).
extern "C" int pf_fused2_v1(const float* x, float* y, const float* war,
                            const float* wai, const float* wbr,
                            const float* wbi, const float* ur, const float* ui,
                            int64_t batch, int a, float scale, void* stream) {
  if (a < 1 || batch < 1) return int(cudaErrorInvalidValue);
  const size_t roots = sizeof(float2) * size_t(a + 128);
  const size_t per = sizeof(float2) * 2 * 128 * size_t(a + 1);
  if (roots + per > pfft::kSmemMax) return int(cudaErrorInvalidValue);
  // A few transforms a block where they are small (up to 64 KiB of tiles).
  int64_t T = int64_t(65536 / per);
  if (T < 1) T = 1;
  if (T > 8) T = 8;
  if (T > batch) T = batch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return pfft::launch_tiles(
      fused2_v1_kernel, roots + size_t(T) * per, (batch + T - 1) / T, st,
      reinterpret_cast<const float2*>(x), reinterpret_cast<float2*>(y), war,
      wai, wbr, wbi, ur, ui, batch, a, int(T), scale);
}
