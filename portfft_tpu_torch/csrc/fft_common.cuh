// Shared device routines of the FFT kernels (fft_direct.cu, fft_fused2.cu,
// fft_global2.cu, fft_col.cu, fft_md2.cu, and on (re, im) planes
// fft_chain.cu, fft_bluestein.cu, fft_global2_planes.cu and fft_axis.cu).
//
// Every kernel here is one "pass": for each batch b and each column c of an
// (m x ncols) matrix view of the buffer, it takes the m-point transform down
// the column and writes it, optionally multiplied by an inter-factor
// twiddle, and scaled:
//
//   y[k]  = sum_i x[b*ibs + i*iis + c*ics] * w_m^(i*k)
//   out[b*obs + k*oks + c*ocs] = scale * y[k] * tw[c*tcs + k*tks]
//
// A block loads a tile of T adjacent columns into shared memory, runs the
// sub-transform there and writes the tile out.  The sub-transform is either
// DIRECT (one m-point DFT) or FUSED m = a*128 in two stages:
//   stage A  A[k1, n2] = sum_n1 x[128*n1 + n2] * w_a^(n1*k1),  A *= w_m^(n2*k1)
//   stage B  C[k1, k2] = sum_n2 A[k1, n2] * w_128^(n2*k2),     y[k1 + a*k2] = C
// Each DFT is a plain sum on the CUDA cores in FMA: no tensor cores, no
// TF32.  The roots come from the host tables (row 1 of the bank's m-point DFT
// matrix, w^(j*k) = row1[(j*k) mod m]); the device evaluates no sin or cos.
// All global index math is 64-bit.
//
// The pass is written on its scalar R: float (float2 elements) for every
// kernel, and double (double2 elements, double tables, double FMAs) for K10
// at fp64 (fft_col.cu).  Sub and Pass are the float ones.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace pfft {

constexpr int kThreads = 256;

// The complex element of scalar R, and the scalar of a complex element.
template <class R>
struct Complex;
template <>
struct Complex<float> {
  using type = float2;
};
template <>
struct Complex<double> {
  using type = double2;
};
template <class R>
using cplx = typename Complex<R>::type;
template <class C>
using scalar_of = decltype(C::x);

__host__ __device__ __forceinline__ float2 mkc(float re, float im) {
  return make_float2(re, im);
}
__host__ __device__ __forceinline__ double2 mkc(double re, double im) {
  return make_double2(re, im);
}
// a*b + c, rounded once.
__device__ __forceinline__ float mad(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double mad(double a, double b, double c) {
  return fma(a, b, c);
}

// One sub-transform of length m.
template <class R>
struct SubT {
  int m;
  int a;        // 0: DIRECT.  > 0: FUSED, m = a * 128.
  const R* wr;  // DIRECT: m x m DFT planes.  FUSED: a x a.
  const R* wi;
  const R* br;  // FUSED: 128 x 128 DFT planes.
  const R* bi;
  const R* ur;  // FUSED: (a, 128) twiddle planes, [k1][n2] = w_m^(k1*n2).
  const R* ui;
};
using Sub = SubT<float>;

template <class R>
struct PassT {
  SubT<R> sub;
  int64_t nbatch, ncols;
  int T;  // columns per tile
  int64_t ibs, iis, ics;
  int64_t obs, oks, ocs;
  const R* twr;  // nullptr: no twiddle
  const R* twi;
  int64_t tcs, tks;
  R scale;
};
using Pass = PassT<float>;

// Shared-memory tile: element i of column t sits at pos(i)*es + t.  The
// column pitch es = T+1 (odd for even T) and the FUSED row padding
// pos(i) = i + i/128 keep the strided walks of both stages off a single
// bank.
template <class R>
__host__ __device__ inline int tile_rows(const SubT<R>& s) {
  return s.a ? s.m + (s.m >> 7) : s.m;
}
__host__ __device__ inline int tile_pitch(int T) { return T > 1 ? T + 1 : 1; }
template <class R>
__device__ __forceinline__ int tile_pos(const SubT<R>& s, int i) {
  return s.a ? i + (i >> 7) : i;
}

template <class R>
inline size_t pass_smem_bytes(const SubT<R>& s, int T) {
  const int roots = s.a ? s.a + 128 : s.m;
  return sizeof(cplx<R>) *
         (size_t(roots) + 2 * size_t(tile_rows(s)) * tile_pitch(T));
}

// Columns per tile: about `cap` elements, at most `tmax` columns.
inline int pick_tile(int m, int64_t ncols, int cap, int tmax) {
  int64_t t = cap / m;
  if (t < 1) t = 1;
  if (t > tmax) t = tmax;
  if (t > ncols) t = ncols;
  return int(t);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}
__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(fma(a.x, b.x, -a.y * b.y), fma(a.x, b.y, a.y * b.x));
}

// dst[out(u, k)] = post(u, k, sum_j src[in_base(u) + j*in_step] * root[(j*k) mod len])
// for nvec vectors u and len outputs k.  Consecutive threads take
// consecutive vectors at the same k: they read neighbouring words of the
// tile and one shared root.
template <class C, class InBase, class Out, class Post>
__device__ __forceinline__ void dft_stage(const C* src, C* dst, int len,
                                          int nvec, int in_step, const C* root,
                                          InBase in_base, Out out, Post post) {
  using R = scalar_of<C>;
  const int total = len * nvec;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int k = e / nvec;
    const int u = e - k * nvec;
    const C* xs = src + in_base(u);
    R re = 0, im = 0;
    int r = 0;
    for (int j = 0; j < len; ++j) {
      const C x = xs[j * in_step];
      const C w = root[r];
      re = mad(x.x, w.x, re);
      re = mad(-x.y, w.y, re);
      im = mad(x.x, w.y, im);
      im = mad(x.y, w.x, im);
      r += k;
      if (r >= len) r -= len;
    }
    dst[out(u, k)] = post(u, k, mkc(re, im));
  }
}

// Transforms the T columns held in b0; returns the buffer (b0 or b1) that
// holds the result in natural order, at the same tile positions.
// ra: roots of the m-point (DIRECT) or a-point (FUSED) DFT; rb: 128-point.
template <class R>
__device__ inline cplx<R>* sub_dft(const SubT<R>& s, const cplx<R>* ra,
                                   const cplx<R>* rb, cplx<R>* b0,
                                   cplx<R>* b1, int T, int es) {
  using C = cplx<R>;
  if (s.a == 0) {
    dft_stage(
        b0, b1, s.m, T, es, ra, [=](int t) { return t; },
        [=](int t, int k) { return k * es + t; },
        [](int, int, C y) { return y; });
    __syncthreads();
    return b1;
  }
  const int a = s.a;
  const R* ur = s.ur;
  const R* ui = s.ui;
  // Stage A: vector u = (n2, t) over n1, element 128*n1 + n2 at
  // (129*n1 + n2)*es + t; inner twiddle on the way out.
  dft_stage(
      b0, b1, a, T * 128, 129 * es, ra,
      [=](int u) {
        const int n2 = u / T;
        return n2 * es + (u - n2 * T);
      },
      [=](int u, int k1) {
        const int n2 = u / T;
        return (129 * k1 + n2) * es + (u - n2 * T);
      },
      [=](int u, int k1, C y) {
        const int i = k1 * 128 + u / T;
        return cmul(y, mkc(__ldg(ur + i), __ldg(ui + i)));
      });
  __syncthreads();
  // Stage B: vector u = (k1, t) over n2; C[k1, k2] lands at natural index
  // k1 + a*k2.
  dft_stage(
      b1, b0, 128, T * a, es, rb,
      [=](int u) {
        const int k1 = u / T;
        return 129 * k1 * es + (u - k1 * T);
      },
      [=](int u, int k2) {
        const int k1 = u / T;
        const int K = k1 + a * k2;
        return (K + (K >> 7)) * es + (u - k1 * T);
      },
      [](int, int, C y) { return y; });
  __syncthreads();
  return b0;
}

// Copies row 1 of a len x len DFT matrix (its root table) to shared memory.
template <class R>
__device__ inline void load_roots(cplx<R>* dst, const R* wr, const R* wi,
                                  int len) {
  const int row = len > 1 ? len : 0;
  for (int i = threadIdx.x; i < len; i += blockDim.x)
    dst[i] = mkc(__ldg(wr + row + i), __ldg(wi + row + i));
}

// A pass's shared memory: the root tables ra (m-point DIRECT or a-point
// FUSED) and rb (128-point, FUSED only), then the ping-pong tiles b0, b1.
template <class R>
struct TileSmemT {
  cplx<R>* ra;
  cplx<R>* rb;
  cplx<R>* b0;
  cplx<R>* b1;
};
using TileSmem = TileSmemT<float>;

template <class R>
__device__ inline TileSmemT<R> tile_smem(const SubT<R>& s, int T,
                                         cplx<R>* smem) {
  TileSmemT<R> t;
  t.ra = smem;
  t.rb = t.ra + (s.a ? s.a : s.m);
  t.b0 = t.rb + (s.a ? 128 : 0);
  t.b1 = t.b0 + tile_rows(s) * tile_pitch(T);
  return t;
}

// Loads the sub-transform's root tables; the first __syncthreads of the
// next tile makes them visible.
template <class R>
__device__ inline void load_sub_roots(const SubT<R>& s, const TileSmemT<R>& sm) {
  if (s.a) {
    load_roots(sm.ra, s.wr, s.wi, s.a);
    load_roots(sm.rb, s.br, s.bi, 128);
  } else {
    load_roots(sm.ra, s.wr, s.wi, s.m);
  }
}

// The buffers a pass reads and writes: interleaved float2 (a pointer), or
// two float planes (the plane path's kernels).  ld/st take the element
// index.
struct Planes {
  float* re;
  float* im;
};
struct ConstPlanes {
  const float* re;
  const float* im;
};
__device__ __forceinline__ float2 ld(const float2* x, int64_t i) {
  return x[i];
}
__device__ __forceinline__ double2 ld(const double2* x, int64_t i) {
  return x[i];
}
__device__ __forceinline__ float2 ld(const ConstPlanes& x, int64_t i) {
  return make_float2(x.re[i], x.im[i]);
}
__device__ __forceinline__ void st(float2* y, int64_t i, float2 v) {
  y[i] = v;
}
__device__ __forceinline__ void st(double2* y, int64_t i, double2 v) {
  y[i] = v;
}
__device__ __forceinline__ void st(const Planes& y, int64_t i, float2 v) {
  y.re[i] = v.x;
  y.im[i] = v.y;
}
// The buffer that starts o elements further on.
__host__ __device__ inline const float2* shift(const float2* x, int64_t o) {
  return x + o;
}
__host__ __device__ inline float2* shift(float2* x, int64_t o) { return x + o; }
__host__ __device__ inline const double2* shift(const double2* x, int64_t o) {
  return x + o;
}
__host__ __device__ inline double2* shift(double2* x, int64_t o) {
  return x + o;
}
__host__ __device__ inline ConstPlanes shift(const ConstPlanes& x, int64_t o) {
  return ConstPlanes{x.re + o, x.im + o};
}
__host__ __device__ inline Planes shift(const Planes& x, int64_t o) {
  return Planes{x.re + o, x.im + o};
}

// Loads columns c0 .. c0+T-1 of batch b into the tile dst (element i of
// column t at tile_pos(i)*es + t); ends with __syncthreads.  The walk goes
// columns fastest where columns are contiguous in device memory, else
// elements fastest.
template <class R, class X>
__device__ inline void tile_load(const PassT<R>& p, int64_t b, int64_t c0, X x,
                                 cplx<R>* dst) {
  const SubT<R>& s = p.sub;
  const int m = s.m;
  const int T = p.T;
  const int es = tile_pitch(T);
  const int total = m * T;
  const bool cols_fast = p.ics == 1 && T > 1;
  const int64_t left = p.ncols - c0;
  const int tv = left < T ? int(left) : T;
  const int64_t xo = b * p.ibs + c0 * p.ics;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int i = cols_fast ? e / T : e % m;
    const int t = cols_fast ? e - i * T : e / m;
    if (t < tv) dst[tile_pos(s, i) * es + t] = ld(x, xo + i * p.iis + t * p.ics);
  }
  __syncthreads();
}

// Stores the transformed tile res: element k of column t, times the pass's
// twiddle (if any) and scale, to y[b*obs + k*oks + (c0+t)*ocs]; ends with
// __syncthreads, so the block's global writes are visible to all its
// threads afterwards.
template <class R, class Y>
__device__ inline void tile_store(const PassT<R>& p, int64_t b, int64_t c0,
                                  const cplx<R>* res, Y y) {
  const SubT<R>& s = p.sub;
  const int m = s.m;
  const int T = p.T;
  const int es = tile_pitch(T);
  const int total = m * T;
  const bool cols_fast = p.ocs == 1 && T > 1;
  const int64_t left = p.ncols - c0;
  const int tv = left < T ? int(left) : T;
  const int64_t yo = b * p.obs + c0 * p.ocs;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int k = cols_fast ? e / T : e % m;
    const int t = cols_fast ? e - k * T : e / m;
    if (t >= tv) continue;
    cplx<R> v = res[tile_pos(s, k) * es + t];
    if (p.twr) {
      const int64_t ti = (c0 + t) * p.tcs + k * p.tks;
      v = cmul(v, mkc(__ldg(p.twr + ti), __ldg(p.twi + ti)));
    }
    st(y, yo + k * p.oks + t * p.ocs, mkc(p.scale * v.x, p.scale * v.y));
  }
  __syncthreads();
}

// One tile of a pass: columns c0 .. c0+T-1 of batch b, loaded, transformed,
// stored.
template <class R, class X, class Y>
__device__ inline void pass_tile(const PassT<R>& p, int64_t b, int64_t c0, X x,
                                 Y y, const TileSmemT<R>& sm) {
  tile_load(p, b, c0, x, sm.b0);
  const cplx<R>* res =
      sub_dft(p.sub, sm.ra, sm.rb, sm.b0, sm.b1, p.T, tile_pitch(p.T));
  tile_store(p, b, c0, res, y);
}

// The body of every pass kernel: the blocks share out the tiles.  x and y
// may be the same buffer when a tile is read only by the block that writes
// it.  The dynamic shared memory, declared float2 in every kernel, holds
// elements of the pass's own type.
template <class R, class X, class Y>
__device__ inline void run_pass(const PassT<R>& p, X x, Y y) {
  extern __shared__ float2 smem[];
  const TileSmemT<R> sm =
      tile_smem(p.sub, p.T, reinterpret_cast<cplx<R>*>(smem));
  load_sub_roots(p.sub, sm);
  const int64_t per_batch = (p.ncols + p.T - 1) / p.T;
  const int64_t ntiles = p.nbatch * per_batch;
  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int64_t b = tile / per_batch;
    pass_tile(p, b, (tile - b * per_batch) * p.T, x, y, sm);
  }
}

// A pass repeated over n slices of each batch: slice s reads x from s*is
// elements on, writes y from s*os on and reads the twiddle from s*ts on.
// The long column transforms (m = a*128 > 8192) run as two such passes:
// the a-point DFT in each of the 128 slices n2 (twiddle row offset n2),
// then the 128-point DFT in each of the a slices k1.
struct Slices {
  int64_t n, is, os, ts;
};

template <class R, class X, class Y>
__device__ inline void run_sliced(const PassT<R>& p, const Slices& sl, X x,
                                  Y y) {
  extern __shared__ float2 smem[];
  const TileSmemT<R> sm =
      tile_smem(p.sub, p.T, reinterpret_cast<cplx<R>*>(smem));
  load_sub_roots(p.sub, sm);
  const int64_t per = (p.ncols + p.T - 1) / p.T;
  const int64_t ntiles = p.nbatch * sl.n * per;
  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int64_t bs = tile / per;
    const int64_t b = bs / sl.n;
    const int64_t s = bs - b * sl.n;
    PassT<R> q = p;
    if (p.twr) {
      q.twr = p.twr + s * sl.ts;
      q.twi = p.twi + s * sl.ts;
    }
    pass_tile(q, b, (tile - bs * per) * p.T, shift(x, s * sl.is),
              shift(y, s * sl.os), sm);
  }
}

// Launches `kernel(args...)` on `stream` with `smem` bytes of dynamic shared
// memory and one block per tile (at most 2^30 blocks; the kernels stride
// over the rest); returns the CUDA error code (0 = success).
template <class Kernel, class... Args>
inline int launch_tiles(Kernel kernel, size_t smem, int64_t tiles,
                        cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const int64_t cap = int64_t(1) << 30;
  const unsigned grid = unsigned(tiles < cap ? tiles : cap);
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return int(cudaGetLastError());
}

template <class R>
inline int64_t pass_tiles(const PassT<R>& p) {
  return p.nbatch * ((p.ncols + p.T - 1) / p.T);
}

using PassKernel = void (*)(Pass, const float2*, float2*);

// Launches one pass on `stream`; returns the CUDA error code (0 = success).
inline int launch_pass(PassKernel kernel, const Pass& p, const float* x,
                       float* y, cudaStream_t stream) {
  return launch_tiles(kernel, pass_smem_bytes(p.sub, p.T), pass_tiles(p),
                      stream, p, reinterpret_cast<const float2*>(x),
                      reinterpret_cast<float2*>(y));
}

// Longest sub-transform one tile holds: one column in two ping-pong tiles
// plus its roots fits the 227 KB (232,448 bytes) a block may use.
constexpr int kTileMax = 8192;
constexpr size_t kSmemMax = 232448;

// The largest tile width up to T whose shared memory fits.
template <class R>
inline int fit_tile(const SubT<R>& s, int T) {
  while (T > 1 && pass_smem_bytes(s, T) > kSmemMax) --T;
  return T;
}

// Internal linkage: each .cu file that includes this header gets its own
// copy of the kernel and of the functions that launch it.
namespace {

// The scalar of a pass's buffer x (float2 or double2 elements, or float
// planes).
float buffer_scalar(const float2*);
float buffer_scalar(const ConstPlanes&);
float buffer_scalar(const Planes&);
double buffer_scalar(const double2*);
template <class X>
using buffer_scalar_t = decltype(buffer_scalar(std::declval<X>()));

template <class X, class Y>
__global__ void __launch_bounds__(kThreads)
    sliced_kernel(PassT<buffer_scalar_t<X>> p, Slices sl, X x, Y y) {
  run_sliced(p, sl, x, y);
}

template <class R, class X, class Y>
int launch_sliced(const PassT<R>& p, const Slices& sl, X x, Y y,
                  cudaStream_t stream) {
  const int64_t tiles = p.nbatch * sl.n * ((p.ncols + p.T - 1) / p.T);
  return launch_tiles(sliced_kernel<X, Y>, pass_smem_bytes(p.sub, p.T), tiles,
                      stream, p, sl, x, y);
}

// Runs the pass p.  Up to kTileMax points that is one launch.  Past it
// (FUSED m = a*128) it is two launches through the float2 scratch q of
// nbatch*m*ncols elements, laid out q[b][n2][k1][c], with n = 128*n1 + n2:
//   launch 1: per slice n2 < 128, the a-point DFT down n1 of column c,
//             times the sub's inner twiddle U[k1, n2], to q[b][n2][k1][c];
//   launch 2: per slice k1 < a, the 128-point DFT down n2 of q, stored as
//             p stores output k = k1 + a*k2 (its twiddle and scale too).
// That doubles the bytes the pass moves.  Returns a cudaError_t.
template <class R, class X, class Y>
int launch_column(const PassT<R>& p, X x, cplx<R>* q, Y y,
                  cudaStream_t stream) {
  const SubT<R>& s = p.sub;
  if (s.m <= kTileMax) return launch_sliced(p, Slices{1, 0, 0, 0}, x, y, stream);
  if (s.a == 0 || q == nullptr) return int(cudaErrorInvalidValue);
  const int a = s.a;
  const int64_t nc = p.ncols;
  PassT<R> p1 = p;
  p1.sub = SubT<R>{a, 0, s.wr, s.wi, nullptr, nullptr, nullptr, nullptr};
  p1.T = fit_tile(p1.sub, pick_tile(a, nc, 4096, 8));
  p1.iis = 128 * p.iis;
  p1.obs = int64_t(s.m) * nc;
  p1.oks = nc;
  p1.ocs = 1;
  p1.twr = s.ur;
  p1.twi = s.ui;
  p1.tcs = 0;
  p1.tks = 128;
  p1.scale = R(1);
  int err = launch_sliced(p1, Slices{128, p.iis, int64_t(a) * nc, 1}, x, q,
                          stream);
  if (err) return err;
  PassT<R> p2 = p;
  p2.sub = SubT<R>{128, 0, s.br, s.bi, nullptr, nullptr, nullptr, nullptr};
  p2.T = fit_tile(p2.sub, pick_tile(128, nc, 4096, 8));
  p2.ibs = int64_t(s.m) * nc;
  p2.iis = int64_t(a) * nc;
  p2.ics = 1;
  p2.oks = int64_t(a) * p.oks;
  p2.tks = int64_t(a) * p.tks;
  return launch_sliced(p2, Slices{a, nc, p.oks, p.tks},
                       static_cast<const cplx<R>*>(q), y, stream);
}

}  // namespace

}  // namespace pfft
