// Shared device routines of the three FFT kernels (fft_direct.cu,
// fft_fused2.cu, fft_global2.cu).
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
// Each DFT is a plain sum on the CUDA cores in fp32 FMA: no tensor cores, no
// TF32.  The roots come from the host tables (row 1 of the bank's m-point DFT
// matrix, w^(j*k) = row1[(j*k) mod m]); the device evaluates no sin or cos.
// All global index math is 64-bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pfft {

constexpr int kThreads = 256;

// One sub-transform of length m.
struct Sub {
  int m;
  int a;            // 0: DIRECT.  > 0: FUSED, m = a * 128.
  const float* wr;  // DIRECT: m x m DFT planes.  FUSED: a x a.
  const float* wi;
  const float* br;  // FUSED: 128 x 128 DFT planes.
  const float* bi;
  const float* ur;  // FUSED: (a, 128) twiddle planes, [k1][n2] = w_m^(k1*n2).
  const float* ui;
};

struct Pass {
  Sub sub;
  int64_t nbatch, ncols;
  int T;  // columns per tile
  int64_t ibs, iis, ics;
  int64_t obs, oks, ocs;
  const float* twr;  // nullptr: no twiddle
  const float* twi;
  int64_t tcs, tks;
  float scale;
};

// Shared-memory tile: element i of column t sits at pos(i)*es + t.  The
// column pitch es = T+1 (odd for even T) and the FUSED row padding
// pos(i) = i + i/128 keep the strided walks of both stages off a single
// bank.
__host__ __device__ inline int tile_rows(const Sub& s) {
  return s.a ? s.m + (s.m >> 7) : s.m;
}
__host__ __device__ inline int tile_pitch(int T) { return T > 1 ? T + 1 : 1; }
__device__ __forceinline__ int tile_pos(const Sub& s, int i) {
  return s.a ? i + (i >> 7) : i;
}

inline size_t pass_smem_bytes(const Sub& s, int T) {
  const int roots = s.a ? s.a + 128 : s.m;
  return sizeof(float2) *
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

// dst[out(u, k)] = post(u, k, sum_j src[in_base(u) + j*in_step] * root[(j*k) mod len])
// for nvec vectors u and len outputs k.  Consecutive threads take
// consecutive vectors at the same k: they read neighbouring words of the
// tile and one shared root.
template <class InBase, class Out, class Post>
__device__ __forceinline__ void dft_stage(const float2* src, float2* dst,
                                          int len, int nvec, int in_step,
                                          const float2* root, InBase in_base,
                                          Out out, Post post) {
  const int total = len * nvec;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int k = e / nvec;
    const int u = e - k * nvec;
    const float2* xs = src + in_base(u);
    float re = 0.f, im = 0.f;
    int r = 0;
    for (int j = 0; j < len; ++j) {
      const float2 x = xs[j * in_step];
      const float2 w = root[r];
      re = fmaf(x.x, w.x, re);
      re = fmaf(-x.y, w.y, re);
      im = fmaf(x.x, w.y, im);
      im = fmaf(x.y, w.x, im);
      r += k;
      if (r >= len) r -= len;
    }
    dst[out(u, k)] = post(u, k, make_float2(re, im));
  }
}

// Transforms the T columns held in b0; returns the buffer (b0 or b1) that
// holds the result in natural order, at the same tile positions.
// ra: roots of the m-point (DIRECT) or a-point (FUSED) DFT; rb: 128-point.
__device__ inline float2* sub_dft(const Sub& s, const float2* ra,
                                  const float2* rb, float2* b0, float2* b1,
                                  int T, int es) {
  if (s.a == 0) {
    dft_stage(
        b0, b1, s.m, T, es, ra, [=](int t) { return t; },
        [=](int t, int k) { return k * es + t; },
        [](int, int, float2 y) { return y; });
    __syncthreads();
    return b1;
  }
  const int a = s.a;
  const float* ur = s.ur;
  const float* ui = s.ui;
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
      [=](int u, int k1, float2 y) {
        const int i = k1 * 128 + u / T;
        return cmul(y, make_float2(__ldg(ur + i), __ldg(ui + i)));
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
      [](int, int, float2 y) { return y; });
  __syncthreads();
  return b0;
}

// Copies row 1 of a len x len DFT matrix (its root table) to shared memory.
__device__ inline void load_roots(float2* dst, const float* wr,
                                  const float* wi, int len) {
  const int row = len > 1 ? len : 0;
  for (int i = threadIdx.x; i < len; i += blockDim.x)
    dst[i] = make_float2(__ldg(wr + row + i), __ldg(wi + row + i));
}

// A pass's shared memory: the root tables ra (m-point DIRECT or a-point
// FUSED) and rb (128-point, FUSED only), then the ping-pong tiles b0, b1.
struct TileSmem {
  float2* ra;
  float2* rb;
  float2* b0;
  float2* b1;
};

__device__ inline TileSmem tile_smem(const Sub& s, int T, float2* smem) {
  TileSmem t;
  t.ra = smem;
  t.rb = t.ra + (s.a ? s.a : s.m);
  t.b0 = t.rb + (s.a ? 128 : 0);
  t.b1 = t.b0 + tile_rows(s) * tile_pitch(T);
  return t;
}

// Loads the sub-transform's root tables; the first __syncthreads of the
// next tile makes them visible.
__device__ inline void load_sub_roots(const Sub& s, const TileSmem& sm) {
  if (s.a) {
    load_roots(sm.ra, s.wr, s.wi, s.a);
    load_roots(sm.rb, s.br, s.bi, 128);
  } else {
    load_roots(sm.ra, s.wr, s.wi, s.m);
  }
}

// One tile of a pass: columns c0 .. c0+T-1 of batch b, loaded, transformed,
// stored.  Ends with __syncthreads, so the block's global writes are
// visible to all its threads afterwards.
__device__ inline void pass_tile(const Pass& p, int64_t b, int64_t c0,
                                 const float2* x, float2* y,
                                 const TileSmem& sm) {
  const Sub& s = p.sub;
  const int m = s.m;
  const int T = p.T;
  const int es = tile_pitch(T);
  const int total = m * T;
  // Walk the tile with columns fastest where columns are contiguous in
  // device memory, else elements fastest.
  const bool in_cols_fast = p.ics == 1 && T > 1;
  const bool out_cols_fast = p.ocs == 1 && T > 1;
  const int64_t left = p.ncols - c0;
  const int tv = left < T ? int(left) : T;
  const float2* xb = x + b * p.ibs + c0 * p.ics;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int i = in_cols_fast ? e / T : e % m;
    const int t = in_cols_fast ? e - i * T : e / m;
    if (t < tv) sm.b0[tile_pos(s, i) * es + t] = xb[i * p.iis + t * p.ics];
  }
  __syncthreads();
  const float2* res = sub_dft(s, sm.ra, sm.rb, sm.b0, sm.b1, T, es);
  float2* yb = y + b * p.obs + c0 * p.ocs;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int k = out_cols_fast ? e / T : e % m;
    const int t = out_cols_fast ? e - k * T : e / m;
    if (t >= tv) continue;
    float2 v = res[tile_pos(s, k) * es + t];
    if (p.twr) {
      const int64_t ti = (c0 + t) * p.tcs + k * p.tks;
      v = cmul(v, make_float2(__ldg(p.twr + ti), __ldg(p.twi + ti)));
    }
    yb[k * p.oks + t * p.ocs] = make_float2(p.scale * v.x, p.scale * v.y);
  }
  __syncthreads();
}

// The body of every pass kernel: the blocks share out the tiles.  x and y
// may be the same buffer when a tile is read only by the block that writes
// it.
__device__ inline void run_pass(const Pass& p, const float2* x, float2* y) {
  extern __shared__ float2 smem[];
  const TileSmem sm = tile_smem(p.sub, p.T, smem);
  load_sub_roots(p.sub, sm);
  const int64_t per_batch = (p.ncols + p.T - 1) / p.T;
  const int64_t ntiles = p.nbatch * per_batch;
  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int64_t b = tile / per_batch;
    pass_tile(p, b, (tile - b * per_batch) * p.T, x, y, sm);
  }
}

using PassKernel = void (*)(Pass, const float2*, float2*);

// Launches one pass on `stream`; returns the CUDA error code (0 = success).
inline int launch_pass(PassKernel kernel, const Pass& p, const float* x,
                       float* y, cudaStream_t stream) {
  const size_t smem = pass_smem_bytes(p.sub, p.T);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const int64_t tiles = p.nbatch * ((p.ncols + p.T - 1) / p.T);
  const int64_t cap = int64_t(1) << 30;
  const unsigned grid = unsigned(tiles < cap ? tiles : cap);
  kernel<<<grid, kThreads, smem, stream>>>(
      p, reinterpret_cast<const float2*>(x), reinterpret_cast<float2*>(y));
  return int(cudaGetLastError());
}

}  // namespace pfft
