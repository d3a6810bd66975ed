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
// with a lane pair-swap.  Here a block takes a tile of T adjacent columns
// of one b (contiguous runs of T elements a row, L rows), runs the L-point
// transform of every column of the tile in shared memory and stores the
// tile back at the same place, times the scale, so y may equal x.
//
// Up to L = pfft::kTileMax = 8192 that is col_radix_kernel, on the radix
// stages of fft_radix.cuh: DIRECT as Stockham stages (90 = 5*3*3*2, 512 =
// 8*8*8; in float the odd primes 5 .. 23 in registers, dft_odd; in double
// on run_stage, dft), FUSED [a, 128] as stage A with the inner twiddle,
// then stage B (sub_fft), between two ping-pong tiles.  The blocks stay
// resident (pfft_radix::launch_resident) and stride over the tiles; each
// starts its next tile's loads before this tile's stages
// (pfft_radix::tiles, kPrefetch = 8 a thread in flight together, the rest
// of the tile as it lands).  The scale is applied on the store
// (pfft::tile_store).
//
// Tile width (col_tile): about kColElems = 6144 elements, fewer where the
// tile's shared memory (roots and two tiles of L rows at pitch T+1) would
// keep two blocks off an SM; where the tiles do not take whole rows, a
// multiple of 32 bytes of a row (4 columns in float, 2 in double), as
// narrow as that many tiles a row allows.  At the benchmark's shapes:
//   (12288, 90, 91) fp32:  T = 48, two tiles a row (48 and 43 columns),
//                          71,280 bytes a block, two blocks an SM;
//   (512, 512, 257) and (1, 512, 131584) fp64:  T = 4, 90,112 bytes a
//                          block, two blocks an SM (T = 5 fits; 4 keeps
//                          whole sectors).
// On the H100 a tile of 2048 elements (T = 20 at 90) took 2.33 ms at
// AFNO's shape, 4096 (T = 32) 2.04 and 6144 (T = 48) 1.87: longer runs of a
// row and fewer tiles a row.
//
// Bound on the H100: bytes.  Each complex element is read once and written
// once, 16 bytes in float and 32 in double, against about 5*log2(L) flops
// of the stages (fp32 peak 67 TFLOP/s, fp64 34): 0.481 ms at AFNO's shape
// and 0.644 ms at each of DNS's two axes at 3.35 TB/s.  The design keeps
// the work per element at a few stages in shared memory (where the plain
// sum took L multiply-adds an element) and the next tile's loads in flight
// during this tile's stages, so the loads and stores, not the sums, set the
// time.  Measured on the H100 (chip_smoke.k10_phase, chip_race.py col):
// 1.83-1.91 ms at AFNO's shape (3.8-4.0x its bound; 4.9 ms on the sums),
// 1.72-1.85 ms at each of DNS's axes (2.7-2.9x; 37.3-38.3 ms on the sums).
// With the stages cut out the same tile walk takes 1.00 ms at AFNO's shape
// and 1.55 / 1.11 ms at DNS's two axes: at 90 the stages (5, 3, 3, 2, a
// barrier each) take about half the time, at 512 the walk of 64-byte runs
// down rows of 257 double2 (every other row starts mid-sector) most of it.
//
// Past 8192 (FUSED [a, 128], a > 64: L = 16384) the transform runs as two
// launches through a scratch buffer of the input's size
// (pfft::launch_column's sliced_kernel, shared with K12 and K14, on plain
// sums), as K2 does past 8192: with n = 128*n1 + n2,
//   launch 1: for each (b, n2) and column c, the a-point DFT down n1, times
//             w_L^(k1*n2), stored S[b, n2, k1, c];
//   launch 2: for each b and column (k1, c) of S, the 128-point DFT down n2,
//             stored out[b, k1 + a*k2, c].
// That doubles the bytes moved at that length.
#include "fft_radix.cuh"

namespace {

using pfft::scalar_of;

// A radix tile's elements: K13's and K15's tile (fft_chain.cu,
// fft_bluestein.cu), the fastest of 2048, 4096 and 6144 at AFNO's shape.
constexpr int kColElems = 6144;

// The L-point DFT of the T columns in b0 (DIRECT); returns the buffer that
// holds the result.  Float runs the odd primes 5 .. 23 in registers.
__device__ inline float2* col_direct(float2* b0, float2* b1, int m, int T,
                                     int es, const float2* root) {
  const auto col = [](int t) { return t; };
  return pfft_radix::dft_odd(b0, b1, m, T, es, root, col,
                             pfft_radix::Strided<decltype(col)>{col, es},
                             pfft_radix::Keep{});
}
__device__ inline double2* col_direct(double2* b0, double2* b1, int m, int T,
                                      int es, const double2* root) {
  const auto col = [](int t) { return t; };
  return pfft_radix::dft(b0, b1, m, T, es, root, col,
                         pfft_radix::Strided<decltype(col)>{col, es},
                         pfft_radix::Keep{});
}

// The tiles of p (m <= kTileMax), each transformed on the radix stages and
// stored in place of where it was read, times p.scale.  C: float2 or
// double2.
template <class C>
__global__ void __launch_bounds__(pfft::kThreads, 2)
    col_radix_kernel(pfft::PassT<scalar_of<C>> p, const C* x, C* y) {
  using R = scalar_of<C>;
  extern __shared__ float2 smem[];
  const pfft::TileSmemT<R> sm =
      pfft::tile_smem(p.sub, p.T, reinterpret_cast<C*>(smem));
  pfft::load_sub_roots(p.sub, sm);
  const int64_t ibs = p.ibs;
  pfft_radix::tiles(
      p, sm.b0, [=](int64_t b) { return x + b * ibs; },
      [&](const pfft::PassT<R>& q, int64_t b, int64_t c0) {
        const int es = pfft::tile_pitch(q.T);
        const C* res =
            q.sub.a == 0
                ? col_direct(sm.b0, sm.b1, q.sub.m, q.T, es, sm.ra)
                : pfft_radix::sub_fft(q.sub, sm.ra, sm.rb, sm.b0, sm.b1, q.T,
                                      es);
        pfft::tile_store(q, b, c0, res, y);
      });
}

// Columns a tile of col_radix_kernel for sub s over rest columns (see the
// header comment).
template <class R>
int col_tile(const pfft::SubT<R>& s, int64_t rest) {
  constexpr int sector = 32 / int(sizeof(pfft::cplx<R>));
  int T = pfft::pick_tile(s.m, rest, kColElems, 1 << 20);
  while (T > 1 && pfft::pass_smem_bytes(s, T) > pfft_radix::kBlockSmem) --T;
  if (T >= rest || T < sector) return T;
  T -= T % sector;
  const int64_t per = (rest + T - 1) / T;  // the fewest tiles a row
  const int even = int((rest + per - 1) / per);
  return (even + sector - 1) / sector * sector;
}

// x (2*bpre*m*rest scalars) -> y through scratch (the same size, only for
// m > 8192); y may equal x.  a = 0: DIRECT, wr/wi the m x m DFT planes;
// a > 0: FUSED m = a*128, wr/wi a x a, br/bi 128 x 128, ur/ui the (a, 128)
// twiddle planes.  R = double is K10 at fp64: double2 elements, tables and
// FMAs; its tile fits the shared memory of a block up to m = 4096 (past it
// the launch returns the error).  Returns a cudaError_t.
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
  p.ibs = int64_t(m) * rest;
  p.iis = rest;
  p.ics = 1;
  p.obs = p.ibs;
  p.oks = rest;
  p.ocs = 1;
  p.scale = scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= pfft::kTileMax) {
    p.T = col_tile(p.sub, rest);
    return pfft_radix::launch_resident(
        col_radix_kernel<C>, pfft::pass_smem_bytes(p.sub, p.T),
        pfft::pass_tiles(p), st, p, reinterpret_cast<const C*>(x),
        reinterpret_cast<C*>(y));
  }
  p.T = pfft::pick_tile(m, rest, 4096, 32);
  return pfft::launch_column(p, reinterpret_cast<const C*>(x),
                             reinterpret_cast<C*>(scratch),
                             reinterpret_cast<C*>(y), st);
}

}  // namespace

// 1 when pf_col needs a scratch buffer of 2*bpre*m*rest floats: the two
// launches past pfft::kTileMax points.
extern "C" int pf_col_needs_scratch(int m) {
  return m > pfft::kTileMax ? 1 : 0;
}

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
