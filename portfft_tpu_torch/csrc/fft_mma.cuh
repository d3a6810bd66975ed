// The tensor-core DFT tile shared by K10-mm (fft_col_mm.cu) and K16
// (fft_global3.cu): a complex DFT Y = W.X of a tile of columns held in
// shared memory, run as mma.sync.aligned.m16n8k8 TF32 products with fp32
// accumulation.
//
// Counterpart of the JAX package's "x3" matmul grade (ops/pallas_fft.py's
// _mm, xla_fft.matmul_x3): a float32 value v is split into hi =
// cvt.rna.tf32(v) and lo = cvt.rna.tf32(v - hi), and each real product is
// hi.hi + hi.lo + lo.hi (lo.lo, below 2^-22 of the product, is dropped).
// Plain TF32 keeps 11 significant bits and would miss the 2*eps*N*log2(N)
// tolerance; the three-term split keeps about 22.  A complex product takes
// four real products (Wr.Xr - Wi.Xi, Wr.Xi + Wi.Xr), twelve mma a tile.
// Each 8-deep step of the contraction is summed in fresh registers by its
// twelve mma and then added to the running sum with ordinary fp32 adds, so
// the tensor cores' own accumulation rounds only sums of 24 products.
//
// W is never stored as a matrix: W[k, j] = root[(k*j) mod len], gathered
// from the len-point root table in shared memory (row 1 of the bank's DFT
// matrix) and split in registers.  The 512-point matrix split into hi/lo
// planes would be 4 MB, read again by every tile from L2; the root table
// is 4 KB.  X is read from shared memory through a functor and split as it
// is loaded into the mma's B fragments.
//
// Fragment layouts of m16n8k8 (PTX ISA; lane = 4*g + t):
//   A (16 x 8, row): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   B (8 x 8, col):  b0 (k = t, n = g), b1 (k = t+4, n = g)
//   C (16 x 8):      c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
// Rows of A and C are output frequencies k, columns of B and C are the
// tile's columns u, and the contraction runs over the inputs j.  Rows and
// depth past len are zero (lengths need not be multiples of 8 or 16).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "fft_common.cuh"

namespace pfft_mma {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo to about 2^-22 of v.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32(v);
  lo = tf32(v - __uint_as_float(hi));
}

// d += a.b
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a.b
__device__ __forceinline__ void mma0(float (&d)[4], const uint32_t (&a)[4],
                                     const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f), "f"(0.f), "f"(0.f), "f"(0.f));
}

// x / len and x mod len by one multiply-high, exact for x < 2^32 / len
// (every product k*j of two indices below len <= 8192 here).  len >= 2.
struct Mod {
  uint32_t len, magic;
  __host__ __device__ explicit Mod(uint32_t l)
      : len(l), magic(0xFFFFFFFFu / l + 1u) {}
  __device__ __forceinline__ uint32_t div(uint32_t x) const {
    return __umulhi(x, magic);
  }
  __device__ __forceinline__ uint32_t operator()(uint32_t x) const {
    return x - div(x) * len;
  }
};

// One warp: Y[k, u] = sum_{j < len} W[k, j] X[j, u] for its rows k in
// [m0, m0 + 16*MT) and columns u in [u0, u0 + 8*NT), W[k, j] =
// root[(k*j) mod len], X[j, u] = ldx(j, u) for u < nu (zero past nu).
// Calls out(k, u, y) for every k < len and u < nu, after the warp has read
// all of its X: a warp may write its outputs over its own columns of X.
template <int MT, int NT, class LdX, class Out>
__device__ __forceinline__ void warp_dft(const float2* root, const Mod& md,
                                         int m0, int u0, int nu, LdX ldx,
                                         Out out) {
  const int len = int(md.len);
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  float yr[MT][NT][4], yi[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) yr[m][n][e] = yi[m][n][e] = 0.f;

  for (int j0 = 0; j0 < len; j0 += 8) {
    uint32_t xrh[NT][2], xrl[NT][2], xih[NT][2], xil[NT][2];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int u = u0 + 8 * n + g;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int j = j0 + t + 4 * q;
        float2 v = make_float2(0.f, 0.f);
        if (j < len && u < nu) v = ldx(j, u);
        split(v.x, xrh[n][q], xrl[n][q]);
        split(v.y, xih[n][q], xil[n][q]);
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m0 + 16 * m >= len) break;  // warp-uniform
      uint32_t wrh[4], wrl[4], wih[4], wil[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = m0 + 16 * m + g + 8 * (e & 1);
        const int j = j0 + t + 4 * (e >> 1);
        float2 w = make_float2(0.f, 0.f);
        if (k < len && j < len) w = root[md(uint32_t(k * j))];
        split(w.x, wrh[e], wrl[e]);
        split(w.y, wih[e], wil[e]);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (u0 + 8 * n >= nu) break;  // warp-uniform
        float p[4], q[4], s[4];  // Wr.Xr, Wi.Xi, Wr.Xi + Wi.Xr
        mma0(p, wrl, xrh[n]);
        mma(p, wrh, xrl[n]);
        mma(p, wrh, xrh[n]);
        mma0(q, wil, xih[n]);
        mma(q, wih, xil[n]);
        mma(q, wih, xih[n]);
        mma0(s, wrl, xih[n]);
        mma(s, wrh, xil[n]);
        mma(s, wrh, xih[n]);
        mma(s, wil, xrh[n]);
        mma(s, wih, xrl[n]);
        mma(s, wih, xrh[n]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          yr[m][n][e] += p[e] - q[e];
          yi[m][n][e] += s[e];
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = m0 + 16 * m + g + 8 * (e >> 1);
        const int u = u0 + 8 * n + 2 * t + (e & 1);
        if (k < len && u < nu) out(k, u, make_float2(yr[m][n][e], yi[m][n][e]));
      }
    }
  }
}

// -- the column tile -------------------------------------------------------
//
// A column pass: for each b < nb and column c < ncols of the (nb, L, ncols)
// complex view of x, the L-point DFT down the column, handed to an epilogue
// epi(b, k, c0, c, y) that stores output k of column c0 + c.  A block
// loads T adjacent columns of one b into two float planes (re, im) in
// shared memory, element i of column c at i*P + (i/128)*8 + c, and runs:
//   DIRECT (L <= 512): one warp_dft over the tile, each warp a 16-row
//     slice of the output, written by the epilogue from its registers;
//   FUSED L = a*128, i = 128*n1 + n2:
//     stage A, in place: each warp takes 8 columns (n2, c) and all a rows,
//       A[k1, n2, c] = sum_n1 W_a[k1, n1] x[n1, n2, c] * U[k1, n2]
//       (U the bank's (a, 128) inner twiddle, read through L1);
//     stage B: C[k2, (k1, c)] = sum_n2 W_128[k2, n2] A[k1, n2, c], output
//       k1 + a*k2, to the epilogue.
// The row padding of 8 floats every 128 rows and the pitch P (T, or T + 8
// for DIRECT's T = 16) keep the B-fragment reads of both stages off a
// single bank.  FUSED takes the largest power-of-two T <= 8 with a*T <=
// 128: one plane of the tile is at most 64 KiB (a 16384-point column in
// two planes is 128 KiB, one block an SM).
struct Col {
  int L, a, T;
  const float *wr, *wi, *br, *bi, *ur, *ui;  // as pfft::Sub
  int64_t nb, ncols;
};

__host__ __device__ inline int col_tile(int a) {
  if (a == 0) return 16;
  int t = 8;
  while (t > 1 && a * t > 128) t >>= 1;
  return t;
}
__host__ __device__ inline int col_pitch(int a, int T) {
  return a ? T : T + 8;
}
__host__ __device__ inline int col_plane(int L, int a, int T) {
  return L * col_pitch(a, T) + (L >> 7) * 8;
}
// Shared memory of a column pass: root tables, two planes, `extra` bytes
// for the epilogue (8-byte aligned).
inline size_t col_smem_bytes(int L, int a, size_t extra) {
  const int T = col_tile(a);
  const int roots = a ? a + 128 : L;
  return sizeof(float2) * size_t(roots) +
         2 * sizeof(float) * size_t(col_plane(L, a, T)) + extra;
}

// The block's part of a column pass; epi.prepare(b, c0, extra) runs at the
// start of each tile (before the loads, whose __syncthreads makes what it
// writes to `extra` visible), epi(b, k, c0, c, y, extra) stores one output.
template <class Epi>
__device__ inline void column_pass(const Col& p, const float2* x, const Epi& epi) {
  extern __shared__ float4 smem4[];
  const int L = p.L, a = p.a, T = p.T;
  float2* ra = reinterpret_cast<float2*>(smem4);
  float2* rb = ra + (a ? a : L);
  float* xr = reinterpret_cast<float*>(rb + (a ? 128 : 0));
  const int P = col_pitch(a, T);
  const int plane = col_plane(L, a, T);
  float* xi = xr + plane;
  float2* extra = reinterpret_cast<float2*>(xi + plane);
  if (a) {
    pfft::load_roots(ra, p.wr, p.wi, a);
    pfft::load_roots(rb, p.br, p.bi, 128);
  } else {
    pfft::load_roots(ra, p.wr, p.wi, L);
  }
  const Mod mA(a ? a : L), mB(128), mT(T > 1 ? T : 2);
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int row = 128 * T + 8;  // FUSED: floats from one n1 (or k1) to the next
  const int64_t per = (p.ncols + T - 1) / T;
  for (int64_t tile = blockIdx.x; tile < p.nb * per; tile += gridDim.x) {
    const int64_t b = tile / per;
    const int64_t c0 = (tile - b * per) * T;
    const int tv = p.ncols - c0 < T ? int(p.ncols - c0) : T;
    __syncthreads();  // the previous tile is done with the planes
    epi.prepare(b, c0, extra);
    const float2* xs = x + b * L * p.ncols + c0;
    for (int e = threadIdx.x; e < L * T; e += blockDim.x) {
      const int i = e / T;
      const int c = e - i * T;
      const float2 v = c < tv ? xs[int64_t(i) * p.ncols + c] : make_float2(0.f, 0.f);
      const int s = i * P + (i >> 7) * 8 + c;
      xr[s] = v.x;
      xi[s] = v.y;
    }
    __syncthreads();
    if (a == 0) {
      auto ld = [&](int j, int u) {
        const int s = j * P + (j >> 7) * 8 + u;
        return make_float2(xr[s], xi[s]);
      };
      auto st = [&](int k, int u, float2 y) { epi(b, k, c0, u, y, extra); };
      for (int item = warp; item < (L + 15) / 16; item += nwarps)
        warp_dft<1, 2>(ra, mA, 16 * item, 0, tv, ld, st);
      continue;
    }
    // stage A, in place, the inner twiddle on the way out
    auto ldA = [&](int j, int u) {
      const int s = j * row + u;
      return make_float2(xr[s], xi[s]);
    };
    auto stA = [&](int k1, int u, float2 y) {
      const int n2 = T > 1 ? int(mT.div(u)) : u;
      const int ti = k1 * 128 + n2;
      y = pfft::cmul(y, make_float2(__ldg(p.ur + ti), __ldg(p.ui + ti)));
      const int s = k1 * row + u;
      xr[s] = y.x;
      xi[s] = y.y;
    };
    for (int item = warp; item < 16 * T; item += nwarps)
      warp_dft<8, 1>(ra, mA, 0, 8 * item, 128 * T, ldA, stA);
    __syncthreads();
    // stage B over columns u = k1*T + c
    auto ldB = [&](int j, int u) {
      const int k1 = T > 1 ? int(mT.div(u)) : u;
      const int s = k1 * row + j * T + (u - k1 * T);
      return make_float2(xr[s], xi[s]);
    };
    auto stB = [&](int k2, int u, float2 y) {
      const int k1 = T > 1 ? int(mT.div(u)) : u;
      const int c = u - k1 * T;
      if (c < tv) epi(b, k1 + a * k2, c0, c, y, extra);
    };
    const int groups = (a * T + 15) / 16;
    for (int item = warp; item < 8 * groups; item += nwarps)
      warp_dft<1, 2>(rb, mB, 16 * (item & 7), 16 * (item >> 3), a * T, ldB, stB);
  }
}

// Launches kernel<<<tiles, kThreads, smem>>>(args...) as pfft::launch_tiles
// does; returns a cudaError_t.
template <class Kernel, class... Args>
inline int launch(Kernel kernel, size_t smem, int64_t tiles,
                  cudaStream_t stream, Args... args) {
  if (smem > pfft::kSmemMax) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const int64_t cap = int64_t(1) << 30;
  const unsigned grid = unsigned(tiles < cap ? tiles : cap);
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return int(cudaGetLastError());
}

}  // namespace pfft_mma
