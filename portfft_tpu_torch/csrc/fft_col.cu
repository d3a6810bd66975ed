// K10 `col`: the FFT over a non-contiguous axis of the PACKED interleaved
// buffer viewed as (bpre, L, rest) complex elements:
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
// L = 8192.  Past it (FUSED [a, 128], a > 64: L = 16384) the transform runs
// as two launches through a scratch buffer of the input's size, as K2 does
// past 8192: with n = 128*n1 + n2,
//   launch 1: for each (b, n2) and column c, the a-point DFT down n1, times
//             w_L^(k1*n2), stored S[b, n2, k1, c];
//   launch 2: for each b and column (k1, c) of S, the 128-point DFT down n2,
//             stored out[b, k1 + a*k2, c].
// That doubles the bytes moved at that length.
#include "fft_common.cuh"

namespace {

constexpr int kColMax = 8192;

__global__ void __launch_bounds__(pfft::kThreads)
    col_kernel(pfft::Pass p, const float2* x, float2* y) {
  pfft::run_pass(p, x, y);
}

// Launch 1 of a long column.  Tile t covers columns c0.. of one (b, n2):
// p walks one n2 slice (iis = 128*rest in, oks = rest out) and reads the
// twiddle row k1 of the (a, 128) table at offset n2.
__global__ void __launch_bounds__(pfft::kThreads)
    col_split_kernel(pfft::Pass p, int64_t rest, int a, const float2* x,
                     float2* s) {
  extern __shared__ float2 smem[];
  const pfft::TileSmem sm = pfft::tile_smem(p.sub, p.T, smem);
  pfft::load_sub_roots(p.sub, sm);
  const int64_t per = (rest + p.T - 1) / p.T;
  const int64_t ntiles = p.nbatch * 128 * per;
  const int64_t len = int64_t(a) * 128 * rest;  // one b of the view
  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int64_t bn = tile / per;
    const int64_t b = bn / 128;
    const int64_t n2 = bn - b * 128;
    pfft::Pass q = p;
    q.twr = p.twr + n2;
    q.twi = p.twi + n2;
    pfft::pass_tile(q, 0, (tile - bn * per) * p.T, x + b * len + n2 * rest,
                    s + b * len + n2 * a * rest, sm);
  }
}

}  // namespace

// 1 when pf_col needs a scratch buffer of 2*bpre*m*rest floats.
extern "C" int pf_col_needs_scratch(int m) { return m > kColMax ? 1 : 0; }

// x (2*bpre*m*rest floats) -> y through scratch (the same size, only for
// m > 8192); y may equal x.  a = 0: DIRECT, wr/wi the m x m DFT planes;
// a > 0: FUSED m = a*128, wr/wi a x a, br/bi 128 x 128, ur/ui the (a, 128)
// twiddle planes.  Returns a cudaError_t.
extern "C" int pf_col(const float* x, float* y, float* scratch, int m, int a,
                      const float* wr, const float* wi, const float* br,
                      const float* bi, const float* ur, const float* ui,
                      int64_t bpre, int64_t rest, float scale, void* stream) {
  if (m < 1 || (a != 0 && a * 128 != m) || bpre < 1 || rest < 1)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m > kColMax) {
    if (a == 0 || a > 128 || scratch == nullptr)
      return int(cudaErrorInvalidValue);
    pfft::Pass p1{};
    p1.sub = pfft::Sub{a, 0, wr, wi, nullptr, nullptr, nullptr, nullptr};
    p1.nbatch = bpre;
    p1.ncols = rest;
    p1.T = pfft::pick_tile(a, rest, 4096, 32);
    p1.iis = 128 * rest;
    p1.ics = 1;
    p1.oks = rest;
    p1.ocs = 1;
    p1.twr = ur;
    p1.twi = ui;
    p1.tcs = 0;
    p1.tks = 128;
    p1.scale = 1.f;
    const size_t smem = pfft::pass_smem_bytes(p1.sub, p1.T);
    cudaError_t err = cudaFuncSetAttribute(
        col_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (err != cudaSuccess) return int(err);
    const int64_t tiles = bpre * 128 * ((rest + p1.T - 1) / p1.T);
    const int64_t cap = int64_t(1) << 30;
    const unsigned grid = unsigned(tiles < cap ? tiles : cap);
    col_split_kernel<<<grid, pfft::kThreads, smem, st>>>(
        p1, rest, a, reinterpret_cast<const float2*>(x),
        reinterpret_cast<float2*>(scratch));
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
    pfft::Pass p2{};
    p2.sub = pfft::Sub{128, 0, br, bi, nullptr, nullptr, nullptr, nullptr};
    p2.nbatch = bpre;
    p2.ncols = int64_t(a) * rest;
    p2.T = pfft::pick_tile(128, p2.ncols, 4096, 32);
    p2.ibs = int64_t(m) * rest;
    p2.iis = int64_t(a) * rest;
    p2.ics = 1;
    p2.obs = p2.ibs;
    p2.oks = p2.iis;
    p2.ocs = 1;
    p2.scale = scale;
    return pfft::launch_pass(col_kernel, p2, scratch, y, st);
  }
  pfft::Pass p{};
  p.sub = pfft::Sub{m, a, wr, wi, br, bi, ur, ui};
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
  return pfft::launch_pass(col_kernel, p, x, y, st);
}
