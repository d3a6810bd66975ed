// K10 `col`: the FFT over a non-contiguous axis of the PACKED interleaved
// buffer viewed as (bpre, L, rest) complex elements, in fp32 (pf_col) or
// fp64 (pf_col_f64):
//   out[b, k, c] = scale * sum_j x[b, j, c] * w_L^(j*k)
// for every b < bpre and column c < rest.  The multi-dimensional path runs
// it once per outer axis; the BATCH_INTERLEAVED 1D layout, (n, batch), is
// one call with bpre = 1.
//
// Replaces portfft_tpu/ops/pallas_multidim.py::col_raw_call, which keeps
// re/im in the TPU's lanes and transforms over sublanes by left matmuls
// with a lane pair-swap.  Here the walk is one pfft::Pass (fft_common.cuh)
// with no twiddle, the same as K3's first pass: a block loads T adjacent
// columns of one b (contiguous runs of T float2 per row), runs the DIRECT or
// FUSED [a, 128] sub-transform in shared memory and stores the tile back at
// the same place, so y may equal x.
//
// Bound on the H100, per complex element: 8*L flops (DIRECT) or
// 8*(a + 128) (FUSED) against 16 bytes of device memory; at L = 128 that is
// 64 flops/byte, so the kernel is bound by arithmetic (in this first
// version by shared-memory operand reads, as K1-K3).
//
// One column in two ping-pong tiles fits the 227 KB a block may use up to
// L = pfft::kTileMax = 8192.  Past it (FUSED [a, 128], a > 64: L = 16384)
// the transform runs as two launches through a scratch buffer of the
// input's size (pfft::launch_column, shared with K12 and K14), as K2 does
// past 8192: with n = 128*n1 + n2,
//   launch 1: for each (b, n2) and column c, the a-point DFT down n1, times
//             w_L^(k1*n2), stored S[b, n2, k1, c];
//   launch 2: for each b and column (k1, c) of S, the 128-point DFT down n2,
//             stored out[b, k1 + a*k2, c].
// That doubles the bytes moved at that length.
#include "fft_common.cuh"

// 1 when pf_col needs a scratch buffer of 2*bpre*m*rest floats.
extern "C" int pf_col_needs_scratch(int m) {
  return m > pfft::kTileMax ? 1 : 0;
}

// x (2*bpre*m*rest scalars) -> y through scratch (the same size, only for
// m > 8192); y may equal x.  a = 0: DIRECT, wr/wi the m x m DFT planes;
// a > 0: FUSED m = a*128, wr/wi a x a, br/bi 128 x 128, ur/ui the (a, 128)
// twiddle planes.  R = double is K10 at fp64: double2 elements, tables and
// FMAs, the same pass; its tile fits the shared memory of a block up to
// m = 4096 (past it the launch returns the error).  Returns a cudaError_t.
namespace {

template <class R>
int col(const R* x, R* y, R* scratch, int m, int a, const R* wr, const R* wi,
        const R* br, const R* bi, const R* ur, const R* ui, int64_t bpre,
        int64_t rest, R scale, void* stream) {
  using C = pfft::cplx<R>;
  if (m < 1 || (a != 0 && a * 128 != m) || (a == 0 && m > pfft::kTileMax) ||
      bpre < 1 || rest < 1)
    return int(cudaErrorInvalidValue);
  pfft::PassT<R> p{};
  p.sub = pfft::SubT<R>{m, a, wr, wi, br, bi, ur, ui};
  p.nbatch = bpre;
  p.ncols = rest;
  p.T = pfft::pick_tile(m, rest, 4096, 32);
  p.ibs = int64_t(m) * rest;
  p.iis = rest;
  p.ics = 1;
  p.obs = p.ibs;
  p.oks = rest;
  p.ocs = 1;
  p.scale = scale;
  return pfft::launch_column(p, reinterpret_cast<const C*>(x),
                             reinterpret_cast<C*>(scratch),
                             reinterpret_cast<C*>(y),
                             static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" int pf_col(const float* x, float* y, float* scratch, int m, int a,
                      const float* wr, const float* wi, const float* br,
                      const float* bi, const float* ur, const float* ui,
                      int64_t bpre, int64_t rest, float scale, void* stream) {
  return col(x, y, scratch, m, a, wr, wi, br, bi, ur, ui, bpre, rest, scale,
             stream);
}

// K10 at fp64: pf_col on double buffers and tables.
extern "C" int pf_col_f64(const double* x, double* y, double* scratch, int m,
                          int a, const double* wr, const double* wi,
                          const double* br, const double* bi, const double* ur,
                          const double* ui, int64_t bpre, int64_t rest,
                          double scale, void* stream) {
  return col(x, y, scratch, m, a, wr, wi, br, bi, ur, ui, bpre, rest, scale,
             stream);
}
