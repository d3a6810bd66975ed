// Block-level mixed-radix Stockham FFT of the T columns of a tile in shared
// memory: the sub-transform of K10 (fft_col.cu), K11 (fft_md2.cu), K13
// (fft_chain.cu), K15 (fft_bluestein.cu) and K17 (fft_global_fused.cu), in
// place of fft_common.cuh's O(len) sums.
//
// It takes fft_common.cuh's tile and Sub as they are (element i of column t
// at tile_pos(i)*es + t, pitch es = T+1, FUSED rows padded by i/128), so a
// kernel keeps pfft::tile_store and tile_load's walk (here with each
// thread's loads in flight together, Prefetch), and it computes what
// pfft::sub_dft computes:
//   DIRECT  the m-point DFT of each column;
//   FUSED   m = a*128: stage A, the a-point DFT over n1 of element
//           128*n1 + n2, times the inner twiddle U[k1, n2]; stage B, the
//           128-point DFT over n2, output k1 + a*k2 in natural order.
//
// Each len-point DFT runs as Stockham stages (decimation in time, natural
// order in and out) that ping-pong between the tiles b0 and b1.  A stage of
// radix R after stages whose radices multiply to ns takes butterfly j of
// every vector, with k = j mod ns and tw = len/(ns*R):
//   v[r] = src[j + r*len/R] * root[r*k*tw]             (r < R)
//   dst[(j - k)*R + k + q*ns] = sum_r v[r] * w_R^(r*q)  (q < R)
// The radices, in stage order (stages()): each prime factor above 3, then
// the 3s, then the power of two as 8s with one 4, two 4s or one 2
// (128 = 8*4*4, 384 = 3*8*4*4, 508 = 127*4, 512 = 8*8*8).  Radix 2, 3, 4
// and 8 run in registers with exact constants (+-1, +-i) and cos(pi/4),
// sin(pi/3), as fft_global_bf.cuh's Dit snaps them; a prime p > 3 is one
// generic stage, a p-term sum per output whose root index folds in the
// stage twiddle, so a prime length costs what the plain sum costs.
// torch_fft.radix_plain runs the same stages, twiddle indices and orders.
// dft_odd, K13's, runs the odd primes 5 .. 23 in registers instead
// (stage_odd: each input read once, (p-1)^2 real multiply-adds per p
// outputs).
//
// The roots come from the sub's root table in shared memory (row 1 of the
// bank's DFT matrix, w_len^e = root[e]; load_sub_roots); the direction is
// the sign of Im root[1].  The device evaluates no sin or cos.  fp32 FMA
// throughout, no TF32: the error grows as log2 len.  The stages themselves
// (Bfly, stage, stage_p, run_stage, stage_odd) take the element type C,
// float2 or double2 (K9 at fp64, fft_real.cu), and compute in its scalar;
// so do dft, sub_fft and the loads of tiles (PrefetchT, fetch, land), for
// K10 at fp64 (fft_col.cu).  dft_odd and load_tile are float2 alone.
//
// What bounds it: a stage reads and writes each element of the tile once in
// shared memory and does about log2 R complex multiply-adds an element, so
// a 512-point column costs 3 stages where the plain sum costs 512
// multiply-adds an element.  The kernels that run on it are then bound by
// their device-memory bytes rather than by the sums.
#pragma once

#include "fft_common.cuh"

namespace pfft_radix {

// Enough for every length up to pfft::kTileMax (3^8 = 6561: 8 stages).
constexpr int kMaxStages = 12;

struct Stages {
  int n;
  int r[kMaxStages];
};

// The radices of a len-point FFT in stage order (see the header comment).
__host__ __device__ inline Stages stages(int len) {
  Stages s{};
  int twos = 0, threes = 0;
  while (len % 2 == 0) len /= 2, ++twos;
  while (len % 3 == 0) len /= 3, ++threes;
  for (int p = 5; len > 1; p += 2) {
    if (p * p > len) p = len;
    while (len % p == 0) s.r[s.n++] = p, len /= p;
  }
  for (int i = 0; i < threes; ++i) s.r[s.n++] = 3;
  for (int i = 0; i < (twos - (twos % 3 == 1 && twos > 1 ? 3 : 0)) / 3; ++i)
    s.r[s.n++] = 8;
  if (twos % 3 == 2) s.r[s.n++] = 4;
  if (twos % 3 == 1) {
    if (twos > 1) s.r[s.n++] = 4, s.r[s.n++] = 4;
    else s.r[s.n++] = 2;
  }
  return s;
}

__device__ __forceinline__ float2 add(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ double2 add(double2 a, double2 b) {
  return make_double2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 sub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ double2 sub(double2 a, double2 b) {
  return make_double2(a.x - b.x, a.y - b.y);
}
// a * (sg * i)
__device__ __forceinline__ float2 rot(float2 a, float sg) {
  return make_float2(-sg * a.y, sg * a.x);
}
__device__ __forceinline__ double2 rot(double2 a, double sg) {
  return make_double2(-sg * a.y, sg * a.x);
}

// sin(pi/3) and cos(pi/4) in the scalar of the argument.
__device__ __forceinline__ float sin_pi3(float) { return 0.86602540378443865f; }
__device__ __forceinline__ double sin_pi3(double) {
  return 0.86602540378443864676;
}
__device__ __forceinline__ float cos_pi4(float) { return 0.70710678118654752f; }
__device__ __forceinline__ double cos_pi4(double) {
  return 0.70710678118654752440;
}

using pfft::scalar_of;

// v <- the R-point DFT of v, w_R = exp(sg*2*pi*i/R), natural order.
template <int R>
struct Bfly;

template <>
struct Bfly<2> {
  template <class C>
  static __device__ __forceinline__ void run(C (&v)[2], scalar_of<C>) {
    const C a = v[0];
    v[0] = add(a, v[1]);
    v[1] = sub(a, v[1]);
  }
};

template <>
struct Bfly<3> {
  template <class C>
  static __device__ __forceinline__ void run(C (&v)[3], scalar_of<C> sg) {
    using S = scalar_of<C>;
    const S s = sg * sin_pi3(sg);  // Im w_3
    const C t1 = add(v[1], v[2]), t2 = sub(v[1], v[2]);
    const C m = pfft::mkc(pfft::mad(S(-0.5), t1.x, v[0].x),
                          pfft::mad(S(-0.5), t1.y, v[0].y));
    const C r = pfft::mkc(-s * t2.y, s * t2.x);
    v[0] = add(v[0], t1);
    v[1] = add(m, r);
    v[2] = sub(m, r);
  }
};

template <>
struct Bfly<4> {
  template <class C>
  static __device__ __forceinline__ void run(C (&v)[4], scalar_of<C> sg) {
    const C a = add(v[0], v[2]), b = sub(v[0], v[2]);
    const C c = add(v[1], v[3]), d = rot(sub(v[1], v[3]), sg);
    v[0] = add(a, c);
    v[1] = add(b, d);
    v[2] = sub(a, c);
    v[3] = sub(b, d);
  }
};

// Radix 2 over two 4-point DFTs: y[q] = E[q] + w_8^q O[q], y[q+4] = E[q] -
// w_8^q O[q].
template <>
struct Bfly<8> {
  template <class C>
  static __device__ __forceinline__ void run(C (&v)[8], scalar_of<C> sg) {
    using S = scalar_of<C>;
    C e[4] = {v[0], v[2], v[4], v[6]};
    C o[4] = {v[1], v[3], v[5], v[7]};
    Bfly<4>::run(e, sg);
    Bfly<4>::run(o, sg);
    const S c = cos_pi4(sg);
    o[1] = pfft::mkc(c * (o[1].x - sg * o[1].y), c * (o[1].y + sg * o[1].x));
    o[2] = rot(o[2], sg);
    o[3] = pfft::mkc(-c * (o[3].x + sg * o[3].y), c * (sg * o[3].x - o[3].y));
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[q] = add(e[q], o[q]);
      v[q + 4] = sub(e[q], o[q]);
    }
  }
};

// Element i of vector u at base(u) + i*step.
template <class Base>
struct Strided {
  Base base;
  int step;
  __device__ __forceinline__ int operator()(int u, int i) const {
    return base(u) + i * step;
  }
};

struct Keep {
  template <class C>
  __device__ __forceinline__ C operator()(int, int, C v) const {
    return v;
  }
};

// One radix-R stage of nvec len-point vectors, element i of vector u at
// base(u) + i*step in src; output k of vector u to dst[out(u, k)] as
// post(u, k, y).  Consecutive threads take consecutive vectors.
template <int R, class C, class Base, class Out, class Post>
__device__ inline void stage(const C* src, C* dst, int len, int ns, int nvec,
                             int step, const C* root, scalar_of<C> sg,
                             Base base, Out out, Post post) {
  const int m = len / R;
  const int tw = len / (ns * R);
  const int total = m * nvec;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int j = e / nvec;
    const int u = e - j * nvec;
    const int k = j % ns;
    const C* x = src + base(u);
    C v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = x[(j + r * m) * step];
    if (ns > 1) {
#pragma unroll
      for (int r = 1; r < R; ++r) v[r] = pfft::cmul(v[r], root[r * k * tw]);
    }
    Bfly<R>::run(v, sg);
    const int d = (j - k) * R + k;
#pragma unroll
    for (int q = 0; q < R; ++q)
      dst[out(u, d + q * ns)] = post(u, d + q * ns, v[q]);
  }
}

// A generic stage of prime radix p: output o = (jj*p + q)*ns + k of each
// vector is sum_r src[j + r*len/p] * root[(r*(k + q*ns)*tw) mod len], j =
// jj*ns + k, tw = len/(ns*p): the stage twiddle and the p-point DFT in one
// root index.  One output a thread.
template <class C, class Base, class Out, class Post>
__device__ inline void stage_p(const C* src, C* dst, int len, int ns, int nvec,
                               int step, const C* root, int p, Base base,
                               Out out, Post post) {
  using S = scalar_of<C>;
  const int m = len / p;
  const int tw = len / (ns * p);
  const int total = len * nvec;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int o = e / nvec;
    const int u = e - o * nvec;
    const int k = o % ns;
    const int jq = o / ns;
    const int q = jq % p;
    const int j = (jq / p) * ns + k;
    const int de = (k + q * ns) * tw;
    const C* x = src + base(u) + j * step;
    S re = 0, im = 0;
    int ri = 0;
    for (int r = 0; r < p; ++r) {
      const C v = x[r * m * step];
      const C w = root[ri];
      re = pfft::mad(v.x, w.x, re);
      re = pfft::mad(-v.y, w.y, re);
      im = pfft::mad(v.x, w.y, im);
      im = pfft::mad(v.y, w.x, im);
      ri += de;
      if (ri >= len) ri -= len;
    }
    dst[out(u, o)] = post(u, o, pfft::mkc(re, im));
  }
}

template <class C, class Base, class Out, class Post>
__device__ inline void run_stage(int r, const C* src, C* dst, int len, int ns,
                                 int nvec, int step, const C* root,
                                 scalar_of<C> sg, Base base, Out out,
                                 Post post) {
  switch (r) {
    case 2:
      stage<2>(src, dst, len, ns, nvec, step, root, sg, base, out, post);
      break;
    case 3:
      stage<3>(src, dst, len, ns, nvec, step, root, sg, base, out, post);
      break;
    case 4:
      stage<4>(src, dst, len, ns, nvec, step, root, sg, base, out, post);
      break;
    case 8:
      stage<8>(src, dst, len, ns, nvec, step, root, sg, base, out, post);
      break;
    default:
      stage_p(src, dst, len, ns, nvec, step, root, r, base, out, post);
  }
}

// The len-point DFT of nvec vectors (element i of vector u at base(u) +
// i*step) held in cur, stage by stage between cur and other; the last
// stage writes output k of vector u to out(u, k) as post(u, k, y).  Every
// stage ends with __syncthreads.  Returns the buffer that holds the result.
// C: float2, or double2 (K10 at fp64, fft_col.cu).
template <class C, class Base, class Out, class Post>
__device__ inline C* dft(C* cur, C* other, int len, int nvec, int step,
                         const C* root, Base base, Out out, Post post) {
  using S = scalar_of<C>;
  const Stages st = stages(len);
  const S sg = len > 2 && root[1].y < S(0) ? S(-1) : S(1);
  const Strided<Base> mid{base, step};
  int ns = 1;
  for (int s = 0; s < st.n; ++s) {
    const int r = st.r[s];
    if (s + 1 < st.n)
      run_stage(r, cur, other, len, ns, nvec, step, root, sg, base, mid, Keep{});
    else
      run_stage(r, cur, other, len, ns, nvec, step, root, sg, base, out, post);
    __syncthreads();
    C* t = cur;
    cur = other;
    other = t;
    ns *= r;
  }
  return cur;
}

// A stage of odd prime radix P in registers: butterfly j of every vector as
// stage<R> takes it (the stage twiddle root[r*k*tw] on the inputs), then
// the P-point DFT by the pairs a_r = v[r] + v[P-r], b_r = v[r] - v[P-r]
// (r = 1 .. H = (P-1)/2) and w_P^e = c_e + i*s_e = root[e*len/P]:
//   y[q] = v[0] + sum_r a_r*c_(rq) + i*sum_r b_r*s_(rq),  y[P-q] likewise
//   with -i, (rq) taken mod P, c_(P-e) = c_e and s_(P-e) = -s_e.
// That is 4*H*H real multiply-adds per P outputs where stage_p takes 4*P*P,
// and each input is read from the tile once where stage_p reads it P times.
// The same outputs as stage_p, summed in another order.
template <int P, class C, class Base, class Out, class Post>
__device__ inline void stage_odd(const C* src, C* dst, int len, int ns,
                                 int nvec, int step, const C* root, Base base,
                                 Out out, Post post) {
  using S = scalar_of<C>;
  constexpr int H = (P - 1) / 2;
  const int m = len / P;
  const int tw = len / (ns * P);
  const int total = m * nvec;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int j = e / nvec;
    const int u = e - j * nvec;
    const int k = j % ns;
    const C* x = src + base(u);
    const C v0 = x[j * step];
    C a[H], b[H];
    C y0 = v0;
#pragma unroll
    for (int r = 1; r <= H; ++r) {
      C lo = x[(j + r * m) * step];
      C hi = x[(j + (P - r) * m) * step];
      if (ns > 1) {
        lo = pfft::cmul(lo, root[r * k * tw]);
        hi = pfft::cmul(hi, root[(P - r) * k * tw]);
      }
      a[r - 1] = add(lo, hi);
      b[r - 1] = sub(lo, hi);
      y0 = add(y0, a[r - 1]);
    }
    const int d = (j - k) * P + k;
    dst[out(u, d)] = post(u, d, y0);
#pragma unroll
    for (int q = 1; q <= H; ++q) {
      C A = v0, B = pfft::mkc(S(0), S(0));
#pragma unroll
      for (int r = 1; r <= H; ++r) {
        const int e = (r * q) % P;
        const C w = root[(e <= H ? e : P - e) * m];
        const S s = e <= H ? w.y : -w.y;
        A = pfft::mkc(pfft::mad(a[r - 1].x, w.x, A.x),
                      pfft::mad(a[r - 1].y, w.x, A.y));
        B = pfft::mkc(pfft::mad(b[r - 1].x, s, B.x),
                      pfft::mad(b[r - 1].y, s, B.y));
      }
      const int o = d + q * ns;
      const int o2 = d + (P - q) * ns;
      dst[out(u, o)] = post(u, o, pfft::mkc(A.x - B.y, A.y + B.x));
      dst[out(u, o2)] = post(u, o2, pfft::mkc(A.x + B.y, A.y - B.x));
    }
  }
}

// run_stage with the odd primes 5 .. 23 on stage_odd.
template <class Base, class Out, class Post>
__device__ inline void run_stage_odd(int r, const float2* src, float2* dst,
                                     int len, int ns, int nvec, int step,
                                     const float2* root, float sg, Base base,
                                     Out out, Post post) {
  switch (r) {
#define PFFT_ODD_CASE(p)                                                   \
  case p:                                                                  \
    stage_odd<p>(src, dst, len, ns, nvec, step, root, base, out, post);    \
    break;
    PFFT_ODD_CASE(5)
    PFFT_ODD_CASE(7)
    PFFT_ODD_CASE(11)
    PFFT_ODD_CASE(13)
    PFFT_ODD_CASE(17)
    PFFT_ODD_CASE(19)
    PFFT_ODD_CASE(23)
#undef PFFT_ODD_CASE
    default:
      run_stage(r, src, dst, len, ns, nvec, step, root, sg, base, out, post);
  }
}

// dft with the odd prime radices 5 .. 23 in registers (stage_odd) where dft
// runs them as stage_p's sums.
template <class Base, class Out, class Post>
__device__ inline float2* dft_odd(float2* cur, float2* other, int len,
                                  int nvec, int step, const float2* root,
                                  Base base, Out out, Post post) {
  const Stages st = stages(len);
  const float sg = len > 2 && root[1].y < 0.f ? -1.f : 1.f;
  const Strided<Base> mid{base, step};
  int ns = 1;
  for (int s = 0; s < st.n; ++s) {
    const int r = st.r[s];
    if (s + 1 < st.n)
      run_stage_odd(r, cur, other, len, ns, nvec, step, root, sg, base, mid,
                    Keep{});
    else
      run_stage_odd(r, cur, other, len, ns, nvec, step, root, sg, base, out,
                    post);
    __syncthreads();
    float2* t = cur;
    cur = other;
    other = t;
    ns *= r;
  }
  return cur;
}

// pfft::sub_dft's function on the radix stages: transforms the T columns
// held in b0; returns the buffer (b0 or b1) that holds the result in
// natural order at the same tile positions.  ra: roots of the m-point
// (DIRECT) or a-point (FUSED) DFT; rb: 128-point.  R: float, or double
// (K10 at fp64).
template <class R>
__device__ inline pfft::cplx<R>* sub_fft(const pfft::SubT<R>& s,
                                         const pfft::cplx<R>* ra,
                                         const pfft::cplx<R>* rb,
                                         pfft::cplx<R>* b0, pfft::cplx<R>* b1,
                                         int T, int es) {
  using C = pfft::cplx<R>;
  if (s.a == 0) {
    const auto col = [](int t) { return t; };
    return dft(b0, b1, s.m, T, es, ra, col, Strided<decltype(col)>{col, es},
               Keep{});
  }
  const int a = s.a;
  const R* ur = s.ur;
  const R* ui = s.ui;
  // Stage A: vector u = (n2, t) over n1, element 128*n1 + n2 at
  // (129*n1 + n2)*es + t; the inner twiddle on the last stage's store.
  const auto base_a = [=](int u) {
    const int n2 = u / T;
    return n2 * es + (u - n2 * T);
  };
  C* c = dft(b0, b1, a, 128 * T, 129 * es, ra, base_a,
             Strided<decltype(base_a)>{base_a, 129 * es},
             [=](int u, int k1, C y) {
               const int i = k1 * 128 + u / T;
               return pfft::cmul(y, pfft::mkc(__ldg(ur + i), __ldg(ui + i)));
             });
  // Stage B: vector u = (k1, t) over n2; output k2 lands at natural index
  // k1 + a*k2.
  const auto base_b = [=](int u) {
    const int k1 = u / T;
    return 129 * k1 * es + (u - k1 * T);
  };
  return dft(c, c == b0 ? b1 : b0, 128, a * T, es, rb, base_b,
             [=](int u, int k2) {
               const int k1 = u / T;
               const int K = k1 + a * k2;
               return (K + (K >> 7)) * es + (u - k1 * T);
             },
             Keep{});
}

// A tile's loads in flight in registers: fetch() starts the loads of the
// first kPrefetch elements of each thread (element e = threadIdx.x +
// q*blockDim.x), land() stores them to the tile, loads and stores the rest
// kPrefetch at a time, and ends with __syncthreads.  Between the two the
// block can work on another tile, so the loads overlap that work; and each
// thread has kPrefetch loads in flight together, where pfft::tile_load's
// loop waits on each load in turn.  The walk is tile_load's: columns
// fastest where columns are contiguous in device memory, else elements.
constexpr int kPrefetch = 8;

template <class C>
struct PrefetchT {
  C v[kPrefetch];
  int at[kPrefetch];  // tile position of each value, -1 for none
};
using Prefetch = PrefetchT<float2>;

// The pass's scalar R: float, or double (K10 at fp64).
template <class R, class X>
__device__ inline void fetch(PrefetchT<pfft::cplx<R>>& f,
                             const pfft::PassT<R>& p, int64_t b, int64_t c0,
                             X x, int e0) {
  using pfft::ld;
  const pfft::SubT<R>& s = p.sub;
  const int m = s.m;
  const int T = p.T;
  const int es = pfft::tile_pitch(T);
  const int total = m * T;
  const bool cols_fast = p.ics == 1 && T > 1;
  const int64_t left = p.ncols - c0;
  const int tv = left < T ? int(left) : T;
  const int64_t xo = b * p.ibs + c0 * p.ics;
#pragma unroll
  for (int q = 0; q < kPrefetch; ++q) {
    const int e = e0 + q * blockDim.x;
    const int i = cols_fast ? e / T : e % m;
    const int t = cols_fast ? e - i * T : e / m;
    f.at[q] = e < total && t < tv ? pfft::tile_pos(s, i) * es + t : -1;
    if (f.at[q] >= 0) f.v[q] = ld(x, xo + i * p.iis + t * p.ics);
  }
}

template <class R, class X>
__device__ inline void fetch(PrefetchT<pfft::cplx<R>>& f,
                             const pfft::PassT<R>& p, int64_t b, int64_t c0,
                             X x) {
  fetch(f, p, b, c0, x, threadIdx.x);
}

template <class R, class X>
__device__ inline void land(PrefetchT<pfft::cplx<R>>& f,
                            const pfft::PassT<R>& p, int64_t b, int64_t c0,
                            X x, pfft::cplx<R>* dst) {
  const int total = p.sub.m * p.T;
  for (int e0 = threadIdx.x;;) {
#pragma unroll
    for (int q = 0; q < kPrefetch; ++q)
      if (f.at[q] >= 0) dst[f.at[q]] = f.v[q];
    e0 += kPrefetch * blockDim.x;
    if (e0 - int(threadIdx.x) >= total) break;
    fetch(f, p, b, c0, x, e0);
  }
  __syncthreads();
}

// pfft::tile_load's function with the loads of a thread in flight
// together: columns c0 .. c0+T-1 of batch b into the tile dst; ends with
// __syncthreads.
template <class X>
__device__ inline void load_tile(const pfft::Pass& p, int64_t b, int64_t c0,
                                 X x, float2* dst) {
  Prefetch f;
  fetch(f, p, b, c0, x);
  land(f, p, b, c0, x, dst);
}

// The tiles of p over the b rows (x of row b: in(b)): each landed in b0,
// then work(p, b, c0).  The blocks stride over the tiles, and each issues
// its next tile's loads before this tile's work, which never writes what
// they read.
template <class R, class In, class Work>
__device__ void tiles(const pfft::PassT<R>& p, pfft::cplx<R>* b0, In in,
                      Work work) {
  const int64_t per = (p.ncols + p.T - 1) / p.T;
  const int64_t ntiles = p.nbatch * per;
  PrefetchT<pfft::cplx<R>> f;
  if (blockIdx.x < ntiles)
    fetch(f, p, 0, (blockIdx.x % per) * p.T, in(blockIdx.x / per));
  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int64_t b = tile / per;
    const int64_t c0 = (tile - b * per) * p.T;
    land(f, p, 0, c0, in(b), b0);
    const int64_t next = tile + gridDim.x;
    if (next < ntiles) fetch(f, p, 0, (next % per) * p.T, in(next / per));
    work(p, b, c0);
  }
}

// The shared memory a block may take so that two blocks share an SM:
// (228 KiB of an SM, less 1 KiB each block reserves) / 2.
constexpr size_t kBlockSmem = (233472 - 2 * 1024) / 2;

// Launches `kernel(args...)` on `stream` with `smem` bytes of dynamic
// shared memory and as many blocks as the card holds at once, at most one
// a tile (the blocks stride over the tiles, as tiles() does): two an SM
// (the kernels' launch bounds keep their registers to two blocks' share),
// one where the shared memory passes kBlockSmem.  Returns a cudaError_t.
template <class Kernel, class... Args>
int launch_resident(Kernel kernel, size_t smem, int64_t ntiles,
                    cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return int(err);
  const int64_t blocks = int64_t(sms) * (smem <= kBlockSmem ? 2 : 1);
  kernel<<<unsigned(ntiles < blocks ? ntiles : blocks), pfft::kThreads, smem,
           stream>>>(args...);
  return int(cudaGetLastError());
}

}  // namespace pfft_radix
