// The factored pass-1 twiddle of the GLOBAL four-step n = G1*G2, shared by
// K3's factored mode (`global2_ftw`, fft_global2.cu) and K17's
// (`global_fused`, fft_global_fused.cu).
//
// Pass 1 multiplies the G1-point transform of column n2 by w_n^(k1*n2).
// With n2 = 64*ti + n2b and k1 = lo + L*hi,
//   w_n^(k1*n2) = [A1[ti][lo] * B1[n2b][lo]] * [A2[ti][c] * B2[n2b][c]]
// from the JAX package's tables: "Q" for a DIRECT G1 (L = 128, c = hi) and
// "ZQ" for a FUSED [a, 128] G1 (L = a, c = (hi % g)*a + hi/g with g =
// 128/a, the reference's fold order), 64 columns wide (torch_fft.FTW_T1).
// A tile's T columns share ti (T divides 64), so a block forms the per-tile
// factors C1 (L x T) and C2 (H x T) in shared memory before the tile's
// store and streams no dense (G2, G1) twiddle.
#pragma once

#include "fft_common.cuh"

namespace pfft_ftw {

// The tables' width.
constexpr int kT1 = 64;

// The eight table planes: 1r, 1i, 2r, 2i (B1, B2), 3r, 3i, 4r, 4i (A1, A2).
struct Tables {
  const float* q[8];
};

// (L, H) of k1 = lo + L*hi.
__host__ __device__ inline int lo_count(const pfft::Sub& s1) {
  return s1.a ? s1.a : 128;
}
__host__ __device__ inline int hi_count(const pfft::Sub& s1) {
  return s1.a ? 128 : s1.m / 128;
}

// The tables exist for the plan: 64 | G2, and a DIRECT G1 with 128 | G1 or
// a FUSED [a, 128] G1 with a | 128.
inline bool tables_ok(const pfft::Sub& s1, int g2) {
  if (g2 % kT1) return false;
  return s1.a ? 128 % s1.a == 0 : s1.m % 128 == 0;
}

// Shared float2 elements of one tile's factors.
__host__ __device__ inline int factor_elems(const pfft::Sub& s1, int T) {
  return (lo_count(s1) + hi_count(s1)) * T;
}

// C1[t][lo] = A1[ti][lo] * B1[n2b][lo] and C2[t][hi] = A2[ti][c] *
// B2[n2b][c] of the columns c0 .. c0+T-1 into `extra`; the caller's next
// __syncthreads makes them visible.
__device__ inline void prepare(const Tables& tb, const pfft::Sub& s1, int T,
                               int64_t c0, float2* extra) {
  const int L = lo_count(s1), H = hi_count(s1);
  const int ti = int(c0 / kT1), n2b0 = int(c0 % kT1);
  const int a = s1.a, g = a ? 128 / a : 1;
  for (int e = threadIdx.x; e < T * (L + H); e += blockDim.x) {
    const bool lo = e < T * L;
    const int r = lo ? e : e - T * L;
    const int w = lo ? L : H;
    const int t = r / w, k = r - t * w;
    const int c = lo || a == 0 ? k : (k % g) * a + k / g;
    const int cols = lo ? 128 : H;
    const int ia = ti * cols + c, ib = (n2b0 + t) * cols + c;
    const float *ar = tb.q[lo ? 4 : 6], *ai = tb.q[lo ? 5 : 7];
    const float *br = tb.q[lo ? 0 : 2], *bi = tb.q[lo ? 1 : 3];
    extra[e] = pfft::cmul(make_float2(__ldg(ar + ia), __ldg(ai + ia)),
                          make_float2(__ldg(br + ib), __ldg(bi + ib)));
  }
}

// v * w_n^(k1*n2) for element k1 of the tile's column t.
__device__ __forceinline__ float2 apply(float2 v, const float2* extra,
                                        const pfft::Sub& s1, int T, int t,
                                        int k1) {
  const int L = lo_count(s1), H = hi_count(s1);
  const int hi = k1 / L;
  v = pfft::cmul(v, extra[t * L + (k1 - hi * L)]);
  return pfft::cmul(v, extra[T * L + t * H + hi]);
}

}  // namespace pfft_ftw
