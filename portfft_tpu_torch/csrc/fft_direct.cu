// K1 `direct`: batched DIRECT DFT, n <= 512, on the PACKED interleaved
// buffer.
//
// Replaces portfft_tpu/ops/pallas_fft.py::direct_raw_call
// (_direct_raw_kernel), which multiplies row tiles by a block-diagonal
// interleaved DFT matrix on the TPU's matrix unit.  That matrix exists to
// fill 128-lane tiles; here each block lands a tile of T whole rows, as
// float2, in shared memory (element i of row t at i*(T+1) + t) and runs
//   y[b, k] = scale * sum_j x[b, j] * w^((j*k) mod n)
// as the Stockham stages of fft_radix.cuh (direct_radix_kernel): 16 = 4*4,
// 256 = 8*8*4, 512 = 8*8*8, the odd primes 5 .. 23 in registers
// (pfft_radix::dft_odd), a larger prime factor one generic stage, n = 1 no
// stage (a copy with the scale).  The roots come from row 1 of the bank's
// n x n DFT matrix (pfft::load_sub_roots), the direction from the sign of
// Im root[1]; fp32 FMA, no TF32, so the error grows as log2 n.  The blocks
// stay resident (pfft_radix::launch_resident: two an SM) and stride over
// the tiles; each starts its next tile's loads before this tile's stages
// (pfft_radix::tiles), and stores each row where it was read, times the
// scale (pfft::tile_store), so y may equal x.
//
// Tile width (direct_tile): about kDirectElems = 6144 elements, fewer where
// the tile's shared memory (the n roots and two tiles of n rows at pitch
// T+1) would keep two blocks off an SM, which no n <= 512 does: T = 384 at
// n = 16, 24 at 256, 12 at 512.  On the H100 at bulk's two shapes, 2048
// elements took 1.83 / 2.10 ms, 4096 1.59 / 1.77, 6144 1.52 / 1.68 and 8192
// 1.55 / 1.74 (16 x 8Mi / 256 x 512Ki).
//
// The plain sums stay where the H100 ran them faster (direct_plain; every
// n <= 512 at 2^25 points, both kernels in one call): at 2 and 6 (by 10%
// and 6%) and at each prime from kDirectPlainMin = 29 on, whose one radix
// stage is stage_p's n-term sum at two blocks an SM (by up to 59%; the
// stages led by 1-3% at 103 and 107 alone, which keep the sums for one
// rule).  There direct_kernel runs pfft::run_pass: tiles of about 2048
// elements, one block a tile, 8n flops an element from shared memory.
//
// Bound on the H100, per complex element: 16 bytes of device memory (8
// read, 8 written) against about 5*log2(n) flops of the stages (fp32 peak
// 67 TFLOP/s), so every length is bound by bytes: 0.641 ms for 2^27 points
// at 3.35 TB/s.  Measured (chip_smoke.k1_phase): 1.52-1.59 ms at 16 x 8Mi
// (2.4-2.5x) and 1.69-1.70 at 256 x 512Ki (2.6-2.7x), both directions,
// where the sums took 2.00 and 15.3 (3.1x and 24x).
#include "fft_radix.cuh"

namespace {

// A tile's elements: K13's and K10's (fft_chain.cu, fft_col.cu).
constexpr int kDirectElems = 6144;

// The lengths K1 runs as plain sums (direct_plain): 2, 6, and each prime
// from kDirectPlainMin on (see the header comment).
constexpr int kDirectPlainSmall[] = {2, 6};
constexpr int kDirectPlainMin = 29;

bool direct_plain(int n) {
  for (int s : kDirectPlainSmall)
    if (n == s) return true;
  if (n < kDirectPlainMin) return false;
  for (int p = 2; p * p <= n; ++p)
    if (n % p == 0) return false;
  return true;
}

// y[b, k] = scale * sum_j x[b, j] * w^((j*k) mod n) as pfft::run_pass's
// sums: tiles of about 2048 elements, one block a tile.
__global__ void __launch_bounds__(pfft::kThreads)
    direct_kernel(pfft::Pass p, const float2* x, float2* y) {
  pfft::run_pass(p, x, y);
}

// The tiles of p, each row's n-point DFT on the radix stages, stored where
// it was read, times p.scale.
__global__ void __launch_bounds__(pfft::kThreads, 2)
    direct_radix_kernel(pfft::Pass p, const float2* x, float2* y) {
  extern __shared__ float2 smem[];
  const pfft::TileSmem sm = pfft::tile_smem(p.sub, p.T, smem);
  pfft::load_sub_roots(p.sub, sm);
  pfft_radix::tiles(
      p, sm.b0, [=](int64_t) { return x; },
      [&](const pfft::Pass& q, int64_t b, int64_t c0) {
        const int es = pfft::tile_pitch(q.T);
        const auto row = [](int t) { return t; };
        const float2* res = pfft_radix::dft_odd(
            sm.b0, sm.b1, q.sub.m, q.T, es, sm.ra, row,
            pfft_radix::Strided<decltype(row)>{row, es}, pfft_radix::Keep{});
        pfft::tile_store(q, b, c0, res, y);
      });
}

// Rows a tile of direct_radix_kernel (see the header comment).
int direct_tile(const pfft::Sub& s, int64_t batch) {
  int T = pfft::pick_tile(s.m, batch, kDirectElems, 1 << 20);
  while (T > 1 && pfft::pass_smem_bytes(s, T) > pfft_radix::kBlockSmem) --T;
  return T;
}

}  // namespace

// Rows of x (2*batch*n floats) -> rows of y; y may equal x.  wr/wi: the
// bank's n x n DFT planes for the direction.  Returns a cudaError_t.
extern "C" int pf_direct(const float* x, float* y, const float* wr,
                         const float* wi, int64_t batch, int n, float scale,
                         void* stream) {
  if (n < 1 || n > pfft::kTileMax || batch < 1)
    return int(cudaErrorInvalidValue);
  pfft::Pass p{};
  p.sub = pfft::Sub{n, 0, wr, wi, nullptr, nullptr, nullptr, nullptr};
  // Every row is one column of the pass: batch 1, ncols = batch rows.
  p.nbatch = 1;
  p.ncols = batch;
  p.ibs = 0;
  p.iis = 1;
  p.ics = n;
  p.obs = 0;
  p.oks = 1;
  p.ocs = n;
  p.scale = scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (direct_plain(n)) {
    p.T = pfft::pick_tile(n, batch, 2048, 1 << 20);
    return pfft::launch_pass(direct_kernel, p, x, y, st);
  }
  p.T = direct_tile(p.sub, batch);
  return pfft_radix::launch_resident(
      direct_radix_kernel, pfft::pass_smem_bytes(p.sub, p.T),
      pfft::pass_tiles(p), st, p, reinterpret_cast<const float2*>(x),
      reinterpret_cast<float2*>(y));
}

// Message of a code returned by any pf_* entry.
extern "C" const char* pf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
