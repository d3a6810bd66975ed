// K13 `chain`: batched DIRECT or FUSED transforms of length n on (re, im)
// float planes (b, n), the leaves of the plane path's executor.
//
// Replaces portfft_tpu/ops/pallas_fft.py::fused_chain (its DIRECT kernel,
// one matmul with the n x n DFT matrix, and its two-stage [a >= 8, 128]
// kernel) and ::_generic_chain_call (any factor chain; the JAX package runs
// it in interpret mode only and leaves such chains to XLA on the TPU).
// Three modes:
//   DIRECT      one n-point DFT per row;
//   [a, 128]    the two-stage transform of K2, one tile per row for
//               n <= 8192, else two launches through a float2 scratch;
//   chain       the Stockham chain of the plan's factors f_0 .. f_{K-1}:
//               stage s views the row as L_s vectors of f_s*m_s elements
//               (L_s = f_0*..*f_{s-1}, m_s = n/(L_s*f_s)) and writes
//                 out[(r + L_s*k)*m_s + n2] = T_s[n2, k] *
//                     sum_n1 in[r*f_s*m_s + n1*m_s + n2] * w_f^(n1*k)
//               with T_s the bank's ("T", f_s, m_s) table (none at the
//               last stage, m = 1); after the last stage the row is in
//               natural order.  This is the JAX package's recursion
//               (xla_fft.exec_chain_xla) with the same tables, run
//               iteratively in shared memory.  Past kChainMax the first
//               factor runs as a column pass into a scratch and the rest
//               of the chain as a second launch on its contiguous vectors,
//               storing out[k + f_0*j].
// The one-launch modes (DIRECT and [a, 128] up to pfft::kTileMax points, a
// chain up to kChainMax) also take a column geometry (pf_chain_cols,
// pf_chain_general_cols): the transform down axis 1 of (bpre, n, trailing)
// planes where they lie, an outer axis of a multi-dimensional transform, in
// place of moving the axis last and back by two copies of the planes.
// The one-launch modes run on the radix stages of fft_radix.cuh, in
// resident blocks that start their next tile's loads before this tile's
// stages (pfft_radix::tiles, as K15): radix_pass_kernel takes DIRECT as
// pfft_radix::dft_odd (368 = 23*4*4: a radix-23 stage in registers, then two
// radix-4 stages) and [a, 128] as pfft_radix::sub_fft, radix_chain_kernel
// each chain factor's f-point DFT as pfft_radix::dft over the factor's root
// table (128 = 8*4*4, 5 one generic stage), T_s on its last radix stage's
// store.  dft_odd runs the odd primes 5 .. 23 as stage_odd, in registers,
// where dft runs them as stage_p's sums: 2x faster at 368 on the H100, and
// slower in the chain kernel, whose registers it pushes into spills.  The
// two-launch modes keep the plain sums of fft_common.cuh (pass_kernel,
// chain_kernel), every sum an fp32 FMA over the root tables on the CUDA
// cores.
//
// Bound on the H100, per complex element: 16 bytes of device memory
// against about 5*log2(n) flops of the radix stages (8*n for the plain
// DIRECT sum, 8*(a + 128) for [a, 128]), so the radix modes are bound by
// bytes and the plain ones by their sums.
#include "fft_radix.cuh"

namespace {

constexpr int kMaxFactors = 12;
constexpr int kChainMax = 12288;   // a chain in one tile: 2 float2 tiles
                                   // of 12288 + roots < 227 KB

// The factors of a chain and, per stage, its f x f DFT planes (row 1: the
// roots) and its (m, f) twiddle planes (nullptr at the last stage).
struct Chain {
  int nf;
  int f[kMaxFactors];
  const float* wr[kMaxFactors];
  const float* wi[kMaxFactors];
  const float* tr[kMaxFactors];
  const float* ti[kMaxFactors];
};

template <class X, class Y>
__global__ void __launch_bounds__(pfft::kThreads)
    pass_kernel(pfft::Pass p, X x, Y y) {
  pfft::run_pass(p, x, y);
}

int roots_of(const Chain& c) {
  int r = 0;
  for (int s = 0; s < c.nf; ++s) r += c.f[s];
  return r;
}

size_t chain_smem_bytes(const Chain& c, int n, int T) {
  return sizeof(float2) *
         (size_t(roots_of(c)) + 2 * size_t(n) * pfft::tile_pitch(T));
}

// The chain on the tiles of pass p (p.sub: DIRECT of the chain's length,
// used only for the tile geometry).
template <class X, class Y>
__global__ void __launch_bounds__(pfft::kThreads)
    chain_kernel(pfft::Pass p, Chain c, X x, Y y) {
  extern __shared__ float2 smem[];
  const int n = p.sub.m;
  const int T = p.T;
  const int es = pfft::tile_pitch(T);
  int off = 0;
  for (int s = 0; s < c.nf; ++s) {
    pfft::load_roots(smem + off, c.wr[s], c.wi[s], c.f[s]);
    off += c.f[s];
  }
  float2* const t0 = smem + off;
  float2* const t1 = t0 + n * es;
  const int64_t per_batch = (p.ncols + T - 1) / T;
  const int64_t ntiles = p.nbatch * per_batch;
  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int64_t b = tile / per_batch;
    const int64_t c0 = (tile - b * per_batch) * T;
    pfft::tile_load(p, b, c0, x, t0);
    float2* src = t0;
    float2* dst = t1;
    int L = 1, rem = n, roff = 0;
    for (int s = 0; s < c.nf; ++s) {
      const int f = c.f[s];
      const int m = rem / f;
      const float* tr = c.tr[s];
      const float* ti = c.ti[s];
      // vector u = (r, n2, t), t fastest
      pfft::dft_stage(
          src, dst, f, L * m * T, m * es, smem + roff,
          [=](int u) {
            const int q = u / T;
            const int r = q / m;
            return (r * f * m + (q - r * m)) * es + (u - q * T);
          },
          [=](int u, int k) {
            const int q = u / T;
            const int r = q / m;
            return ((r + L * k) * m + (q - r * m)) * es + (u - q * T);
          },
          [=](int u, int k, float2 v) {
            if (tr == nullptr) return v;
            const int q = u / T;
            const int i = (q - (q / m) * m) * f + k;
            return pfft::cmul(v, make_float2(__ldg(tr + i), __ldg(ti + i)));
          });
      __syncthreads();
      float2* tmp = src;
      src = dst;
      dst = tmp;
      L *= f;
      rem = m;
      roff += f;
    }
    pfft::tile_store(p, b, c0, src, y);
  }
}

template <class X, class Y>
int launch_chain(const pfft::Pass& p, const Chain& c, X x, Y y,
                 cudaStream_t st) {
  return pfft::launch_tiles(chain_kernel<X, Y>,
                            chain_smem_bytes(c, p.sub.m, p.T),
                            pfft::pass_tiles(p), st, p, c, x, y);
}

template <class X, class Y>
int launch_sub(const pfft::Pass& p, X x, Y y, cudaStream_t st) {
  return pfft::launch_tiles(pass_kernel<X, Y>,
                            pfft::pass_smem_bytes(p.sub, p.T),
                            pfft::pass_tiles(p), st, p, x, y);
}

// A pass over `batch` rows of n: each row one column.
pfft::Pass row_pass(const pfft::Sub& s, int64_t batch) {
  pfft::Pass p{};
  p.sub = s;
  p.nbatch = 1;
  p.ncols = batch;
  p.T = pfft::pick_tile(s.m, batch, 4096, 1 << 20);
  p.iis = 1;
  p.ics = s.m;
  p.oks = 1;
  p.ocs = s.m;
  p.scale = 1.f;
  return p;
}

// The radix kernels' tiles: about kTileElems elements (K15's, raced on the
// H100), fewer where their shared memory (bytes(T)) would keep two blocks
// off an SM.
constexpr int kTileElems = 6144;

template <class Bytes>
int radix_tile(int m, int64_t rows, Bytes bytes) {
  int T = pfft::pick_tile(m, rows, kTileElems, 1 << 20);
  while (T > 1 && bytes(T) > pfft_radix::kBlockSmem) --T;
  return T;
}

// A column pass's tiles: radix_tile's width, cut to a multiple of 8 columns
// where the tiles do not take whole rows, so that the row segment a tile
// reads and writes is whole 32-byte sectors of a plane (640 points over 368
// columns: T = 8, 46 tiles a row, where the row mode takes 9).
template <class Bytes>
int col_tile(int m, int64_t cols, Bytes bytes) {
  const int T = radix_tile(m, cols, bytes);
  return T < cols && T > 8 ? T - T % 8 : T;
}

// A pass down axis 1 of (bpre, m, trailing) planes: each (batch, column) one
// transform of stride trailing, stored where it was read, times scale.
pfft::Pass col_pass(const pfft::Sub& s, int64_t bpre, int64_t trailing,
                    float scale) {
  pfft::Pass p{};
  p.sub = s;
  p.nbatch = bpre;
  p.ncols = trailing;
  p.ibs = p.obs = int64_t(s.m) * trailing;
  p.iis = p.oks = trailing;
  p.ics = p.ocs = 1;
  p.scale = scale;
  return p;
}

// pass_kernel's pass on the radix stages: p.sub, at most pfft::kTileMax
// points, DIRECT by pfft_radix::dft_odd (its odd prime factors up to 23 in
// registers), [a, 128] by pfft_radix::sub_fft.
template <class X, class Y>
__global__ void __launch_bounds__(pfft::kThreads, 2)
    radix_pass_kernel(pfft::Pass p, X x, Y y) {
  extern __shared__ float2 smem[];
  const pfft::TileSmem sm = pfft::tile_smem(p.sub, p.T, smem);
  pfft::load_sub_roots(p.sub, sm);
  const int64_t ibs = p.ibs;
  pfft_radix::tiles(
      p, sm.b0, [=](int64_t b) { return pfft::shift(x, b * ibs); },
      [=](const pfft::Pass& q, int64_t b, int64_t c0) {
        const int es = pfft::tile_pitch(q.T);
        const auto col = [](int t) { return t; };
        const float2* res =
            q.sub.a == 0
                ? pfft_radix::dft_odd(
                      sm.b0, sm.b1, q.sub.m, q.T, es, sm.ra, col,
                      pfft_radix::Strided<decltype(col)>{col, es},
                      pfft_radix::Keep{})
                : pfft_radix::sub_fft(q.sub, sm.ra, sm.rb, sm.b0, sm.b1, q.T,
                                      es);
        pfft::tile_store(q, b, c0, res, y);
      });
}

// chain_kernel's chain on the radix stages: stage s runs the f-point DFT of
// its L*m*T vectors (r, n2, t) as pfft_radix::dft over the factor's roots,
// between the tiles t0 and t1, with T_s on the last radix stage's store.
template <class X, class Y>
__global__ void __launch_bounds__(pfft::kThreads, 2)
    radix_chain_kernel(pfft::Pass p, Chain c, X x, Y y) {
  extern __shared__ float2 smem[];
  const int n = p.sub.m;
  const int T = p.T;
  const int es = pfft::tile_pitch(T);
  float2* const roots = smem;
  int off = 0;
  for (int s = 0; s < c.nf; ++s) {
    pfft::load_roots(roots + off, c.wr[s], c.wi[s], c.f[s]);
    off += c.f[s];
  }
  float2* const t0 = roots + off;
  float2* const t1 = t0 + n * es;
  const int64_t ibs = p.ibs;
  pfft_radix::tiles(
      p, t0, [=](int64_t b) { return pfft::shift(x, b * ibs); },
      [&](const pfft::Pass& q, int64_t b, int64_t c0) {
        float2* cur = t0;
        int L = 1, rem = n, roff = 0;
        for (int s = 0; s < c.nf; ++s) {
          const int f = c.f[s];
          const int m = rem / f;
          const float* tr = c.tr[s];
          const float* ti = c.ti[s];
          // vector u = (r, n2, t), t fastest
          const auto base = [=](int u) {
            const int v = u / T;
            const int r = v / m;
            return (r * f * m + (v - r * m)) * es + (u - v * T);
          };
          cur = pfft_radix::dft(
              cur, cur == t0 ? t1 : t0, f, L * m * T, m * es, roots + roff,
              base,
              [=](int u, int k) {
                const int v = u / T;
                const int r = v / m;
                return ((r + L * k) * m + (v - r * m)) * es + (u - v * T);
              },
              [=](int u, int k, float2 w) {
                if (tr == nullptr) return w;
                const int v = u / T;
                const int i = (v - (v / m) * m) * f + k;
                return pfft::cmul(w, make_float2(__ldg(tr + i), __ldg(ti + i)));
              });
          L *= f;
          rem = m;
          roff += f;
        }
        pfft::tile_store(q, b, c0, cur, y);
      });
}

// pf_chain's one-launch mode: pass p of s (its tile width T set) on the
// radix stages.
int launch_radix(const pfft::Pass& p, pfft::ConstPlanes x, pfft::Planes y,
                 cudaStream_t st) {
  return pfft_radix::launch_resident(
      radix_pass_kernel<pfft::ConstPlanes, pfft::Planes>,
      pfft::pass_smem_bytes(p.sub, p.T), pfft::pass_tiles(p), st, p, x, y);
}

// pf_chain_general's one-launch mode: pass p of the chain c (p.sub.m = n =
// prod(c.f), its tile width T set) on the radix stages.
int launch_radix_chain(const pfft::Pass& p, const Chain& c,
                       pfft::ConstPlanes x, pfft::Planes y, cudaStream_t st) {
  return pfft_radix::launch_resident(
      radix_chain_kernel<pfft::ConstPlanes, pfft::Planes>,
      chain_smem_bytes(c, p.sub.m, p.T), pfft::pass_tiles(p), st, p, c, x, y);
}

pfft::Sub chain_sub(int n) {
  return pfft::Sub{n, 0, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr};
}

// The chain of nf factors and their 4*nf tables (pf_chain_general's);
// returns its length n, or 0 where nf is out of range.
int chain_of(int nf, const int* factors, const float* const* tables,
             Chain& c) {
  if (nf < 2 || nf > kMaxFactors) return 0;
  c = Chain{};
  int n = 1;
  c.nf = nf;
  for (int s = 0; s < nf; ++s) {
    c.f[s] = factors[s];
    c.wr[s] = tables[4 * s];
    c.wi[s] = tables[4 * s + 1];
    c.tr[s] = tables[4 * s + 2];
    c.ti[s] = tables[4 * s + 3];
    n *= factors[s];
  }
  return n;
}

}  // namespace

// 1 when pf_chain of a FUSED [a, 128] transform (a > 0) needs a scratch of
// 2*batch*a*128 floats.
extern "C" int pf_chain_needs_scratch(int a) {
  return a * 128 > pfft::kTileMax ? 1 : 0;
}

// 1 when pf_chain_general of length n needs a scratch of 2*batch*n floats.
extern "C" int pf_chain_general_needs_scratch(int n) {
  return n > kChainMax ? 1 : 0;
}

// Planes (xr, xi) of batch rows of m -> (yr, yi).  a = 0: DIRECT, wr/wi the
// m x m DFT planes; a > 0: FUSED m = a*128, wr/wi a x a, br/bi 128 x 128,
// ur/ui the (a, 128) twiddle planes.  Returns a cudaError_t.
extern "C" int pf_chain(const float* xr, const float* xi, float* yr, float* yi,
                        float* scratch, int m, int a, const float* wr,
                        const float* wi, const float* br, const float* bi,
                        const float* ur, const float* ui, int64_t batch,
                        void* stream) {
  if (m < 1 || batch < 1 || (a != 0 && a * 128 != m))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const pfft::ConstPlanes x{xr, xi};
  const pfft::Planes y{yr, yi};
  const pfft::Sub sub{m, a, wr, wi, br, bi, ur, ui};
  if (m <= pfft::kTileMax) {
    pfft::Pass p = row_pass(sub, batch);
    p.T = radix_tile(m, batch,
                     [&](int T) { return pfft::pass_smem_bytes(sub, T); });
    return launch_radix(p, x, y, st);
  }
  if (a == 0) return launch_sub(row_pass(sub, batch), x, y, st);
  if (scratch == nullptr) return int(cudaErrorInvalidValue);
  float2* s = reinterpret_cast<float2*>(scratch);
  // K2's two launches: the a-point DFT down each column n2 with the
  // twiddle, S[b, n2, k1]; then the 128-point DFT over n2, out[k1 + a*k2].
  pfft::Pass p1{};
  p1.sub = pfft::Sub{a, 0, wr, wi, nullptr, nullptr, nullptr, nullptr};
  p1.nbatch = batch;
  p1.ncols = 128;
  p1.T = pfft::pick_tile(a, 128, 4096, 8);
  p1.ibs = m;
  p1.iis = 128;
  p1.ics = 1;
  p1.obs = m;
  p1.oks = 1;
  p1.ocs = a;
  p1.twr = ur;
  p1.twi = ui;
  p1.tcs = 1;
  p1.tks = 128;
  p1.scale = 1.f;
  int err = launch_sub(p1, x, s, st);
  if (err) return err;
  pfft::Pass p2{};
  p2.sub = pfft::Sub{128, 0, br, bi, nullptr, nullptr, nullptr, nullptr};
  p2.nbatch = batch;
  p2.ncols = a;
  p2.T = pfft::pick_tile(128, a, 4096, 8);
  p2.ibs = m;
  p2.iis = a;
  p2.ics = 1;
  p2.obs = m;
  p2.oks = a;
  p2.ocs = 1;
  p2.scale = 1.f;
  return launch_sub(p2, static_cast<const float2*>(s), y, st);
}

// Planes (xr, xi) of batch rows of n = prod(factors) -> (yr, yi) by the
// Stockham chain.  tables: 4*nf pointers, per stage wr, wi (f x f DFT
// planes), tr, ti ((m, f) twiddle planes; nullptr at the last stage).
// scratch (2*batch*n floats) only when pf_chain_general_needs_scratch says
// so.  Returns a cudaError_t.
extern "C" int pf_chain_general(const float* xr, const float* xi, float* yr,
                                float* yi, float* scratch, int nf,
                                const int* factors,
                                const float* const* tables, int64_t batch,
                                void* stream) {
  Chain c;
  const int n = chain_of(nf, factors, tables, c);
  if (n == 0 || batch < 1) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const pfft::ConstPlanes x{xr, xi};
  const pfft::Planes y{yr, yi};
  if (n <= kChainMax) {
    pfft::Pass p = row_pass(chain_sub(n), batch);
    p.T = radix_tile(n, batch,
                     [&](int T) { return chain_smem_bytes(c, n, T); });
    return launch_radix_chain(p, c, x, y, st);
  }
  if (scratch == nullptr) return int(cudaErrorInvalidValue);
  float2* s = reinterpret_cast<float2*>(scratch);
  const int f0 = c.f[0];
  const int m0 = n / f0;
  if (m0 > kChainMax) return int(cudaErrorInvalidValue);
  // Launch 1: the f0-point DFT down each column n2 < m0, times T_0[n2, k],
  // stored S[b, k, n2] (the Stockham output of stage 0).
  pfft::Pass p1{};
  p1.sub = pfft::Sub{f0, 0, c.wr[0], c.wi[0], nullptr, nullptr, nullptr,
                     nullptr};
  p1.nbatch = batch;
  p1.ncols = m0;
  p1.T = pfft::pick_tile(f0, m0, 4096, 32);
  p1.ibs = n;
  p1.iis = m0;
  p1.ics = 1;
  p1.obs = n;
  p1.oks = m0;
  p1.ocs = 1;
  p1.twr = c.tr[0];
  p1.twi = c.ti[0];
  p1.tcs = f0;
  p1.tks = 1;
  p1.scale = 1.f;
  int err = launch_sub(p1, x, s, st);
  if (err) return err;
  // Launch 2: the rest of the chain on each vector S[b, k, :], stored
  // out[b, k + f0*j].
  Chain rest{};
  rest.nf = nf - 1;
  for (int i = 1; i < nf; ++i) {
    rest.f[i - 1] = c.f[i];
    rest.wr[i - 1] = c.wr[i];
    rest.wi[i - 1] = c.wi[i];
    rest.tr[i - 1] = c.tr[i];
    rest.ti[i - 1] = c.ti[i];
  }
  pfft::Pass p2{};
  p2.sub = pfft::Sub{m0, 0, nullptr, nullptr, nullptr, nullptr, nullptr,
                     nullptr};
  p2.nbatch = batch;
  p2.ncols = f0;
  p2.T = pfft::pick_tile(m0, f0, 4096, 32);
  p2.ibs = n;
  p2.iis = 1;
  p2.ics = m0;
  p2.obs = n;
  p2.oks = f0;
  p2.ocs = 1;
  p2.scale = 1.f;
  return launch_chain(p2, rest, static_cast<const float2*>(s), y, st);
}

// pf_chain's one-launch modes down axis 1 of the planes (xr, xi) viewed as
// (bpre, m, trailing), m <= pfft::kTileMax: each column's m-point transform,
// times scale, stored in the same layout in (yr, yi).  Tables as pf_chain.
// Returns a cudaError_t.
extern "C" int pf_chain_cols(const float* xr, const float* xi, float* yr,
                             float* yi, int m, int a, const float* wr,
                             const float* wi, const float* br, const float* bi,
                             const float* ur, const float* ui, int64_t bpre,
                             int64_t trailing, float scale, void* stream) {
  if (m < 1 || m > pfft::kTileMax || bpre < 1 || trailing < 1 ||
      (a != 0 && a * 128 != m))
    return int(cudaErrorInvalidValue);
  const pfft::Sub sub{m, a, wr, wi, br, bi, ur, ui};
  pfft::Pass p = col_pass(sub, bpre, trailing, scale);
  p.T = col_tile(m, trailing,
                 [&](int T) { return pfft::pass_smem_bytes(sub, T); });
  return launch_radix(p, pfft::ConstPlanes{xr, xi}, pfft::Planes{yr, yi},
                      static_cast<cudaStream_t>(stream));
}

// pf_chain_general's one-launch mode down axis 1 of the planes (xr, xi)
// viewed as (bpre, n, trailing), n = prod(factors) <= kChainMax, times
// scale, stored in the same layout in (yr, yi).  Tables as
// pf_chain_general.  Returns a cudaError_t.
extern "C" int pf_chain_general_cols(const float* xr, const float* xi,
                                     float* yr, float* yi, int nf,
                                     const int* factors,
                                     const float* const* tables, int64_t bpre,
                                     int64_t trailing, float scale,
                                     void* stream) {
  Chain c;
  const int n = chain_of(nf, factors, tables, c);
  if (n == 0 || n > kChainMax || bpre < 1 || trailing < 1)
    return int(cudaErrorInvalidValue);
  pfft::Pass p = col_pass(chain_sub(n), bpre, trailing, scale);
  p.T = col_tile(n, trailing, [&](int T) { return chain_smem_bytes(c, n, T); });
  return launch_radix_chain(p, c, pfft::ConstPlanes{xr, xi},
                            pfft::Planes{yr, yi},
                            static_cast<cudaStream_t>(stream));
}
