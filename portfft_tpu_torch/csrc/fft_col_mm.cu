// K10-mm `col_mm`: the FFT over a non-contiguous axis of the PACKED
// interleaved buffer viewed as (bpre, L, rest) complex elements, on the
// tensor cores:
//   out[b, k, c] = scale * sum_j x[b, j, c] * w_L^(j*k)
// the same function and contract as K10 (fft_col.cu); y may equal x.
//
// Replaces portfft_tpu/ops/pallas_multidim.py::col_raw_mm_call, the JAX
// package's widened-matmul column kernel (autotuner {"cm": 1}): it
// deinterleaves each (L, 2*tc) tile into planes and runs the lane DFT as
// matrix-unit products at its bf16x3 grade.  Here a block loads T adjacent
// columns of one b (contiguous runs of T float2 per row) into (re, im)
// planes in shared memory and runs the DFT tile of fft_mma.cuh on them:
// DIRECT L <= 512 as one product with the L-point DFT matrix, FUSED
// L = a*128 (a | 128) as stage A over the a-digit (N = 128*T columns),
// the inner twiddle, then stage B over the 128-digit (N = a*T), written in
// natural order from the mma's registers; the TF32 three-term split gives
// fp32-grade sums.  The JAX kernel's output fold and reinterleave
// transposes (pallas_global._fold_scratches, _lane_dft) have no
// counterpart: the mma accumulator's rows are output frequencies, stored
// where they belong.
//
// Bound on the H100, per complex element: 16 bytes of device memory
// against 12 mma products of 8 complex inputs per 8 outputs, 24*L flops
// (DIRECT) or 24*(a + 128) (FUSED) on the TF32 tensor cores (495 TFLOP/s):
// 12288 flops at L = 512, 3264 at [8, 128], so every length is bound by
// operations, at 2.0 to 7.6 times its bytes.  A whole column of up to
// 16384 points fits one tile (the planes of stage A are overwritten in
// place and stage B writes straight to device memory), so unlike K10 no
// length takes two launches.
#include "fft_mma.cuh"

namespace {

struct ColEpi {
  float2* y;
  int L;
  int64_t ncols;
  float scale;
  __device__ void prepare(int64_t, int64_t, float2*) const {}
  __device__ void operator()(int64_t b, int k, int64_t c0, int c, float2 v,
                             const float2*) const {
    y[(b * L + k) * ncols + c0 + c] = make_float2(scale * v.x, scale * v.y);
  }
};

__global__ void __launch_bounds__(pfft_mma::kThreads)
    col_mm_kernel(pfft_mma::Col p, const float2* x, ColEpi epi) {
  pfft_mma::column_pass(p, x, epi);
}

bool shape_ok(int m, int a) {
  if (a == 0) return m >= 2 && m <= 512;
  return a >= 2 && a <= 128 && 128 % a == 0 && m == a * 128;
}

}  // namespace

// x (2*bpre*m*rest floats) -> y; y may equal x.  a = 0: DIRECT, wr/wi the
// m x m DFT planes; a > 0: FUSED m = a*128, a | 128, wr/wi a x a, br/bi
// 128 x 128, ur/ui the (a, 128) twiddle planes.  Returns a cudaError_t.
extern "C" int pf_col_mm(const float* x, float* y, int m, int a,
                         const float* wr, const float* wi, const float* br,
                         const float* bi, const float* ur, const float* ui,
                         int64_t bpre, int64_t rest, float scale,
                         void* stream) {
  if (!shape_ok(m, a) || bpre < 1 || rest < 1)
    return int(cudaErrorInvalidValue);
  pfft_mma::Col p{m, a, pfft_mma::col_tile(a), wr, wi, br, bi, ur, ui,
                  bpre, rest};
  const ColEpi epi{reinterpret_cast<float2*>(y), m, rest, scale};
  const int64_t tiles = bpre * ((rest + p.T - 1) / p.T);
  return pfft_mma::launch(col_mm_kernel, pfft_mma::col_smem_bytes(m, a, 0),
                          tiles, static_cast<cudaStream_t>(stream), p,
                          reinterpret_cast<const float2*>(x), epi);
}
