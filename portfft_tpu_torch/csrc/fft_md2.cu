// K11 `md2`: batched 2D transform of both trailing axes in one launch, on
// the PACKED interleaved buffer viewed as (batch, n1, n2) complex elements:
//   out[b, k1, k2] = scale * sum_{j1, j2} x[b, j1, j2] w_n1^(j1*k1) w_n2^(j2*k2)
//
// Replaces portfft_tpu/ops/pallas_multidim.py::md2_fused_raw_call.  The TPU
// kernel walks a sequential grid per transform and keeps the intermediate
// in persistent VMEM scratch planes, so that each element crosses HBM once
// each way.  Blocks on Hopper run in no order and hold at most 227 KB of
// shared memory, so here one block owns whole 2D transforms:
//   phase A: n1-point passes down the columns, tiles of T1 adjacent columns
//            read from x and written to y;
//   __syncthreads (it ends every tile): the block's writes to y are visible
//            to all its threads;
//   phase B: n2-point passes along the rows, tiles of T2 rows, in place on
//            y, times scale.
// Each sub-transform is DIRECT or FUSED [a, 128] (pfft::pass_tile, shared
// with K1-K3 and K10).  The intermediate goes through device memory: at
// 128 x 128 it is 128 KiB per transform and the resident blocks' share
// stays in the 50 MB L2; at 512 x 512 (2 MiB) it spills to HBM, so the
// kernel moves up to twice the bytes of its bound there.  A transform
// belongs to one block and each tile is read before it is written, so y
// may equal x.
//
// Bound on the H100, per complex element: 8*(n1' + n2') flops against 16
// bytes (n' = n for DIRECT, a + 128 for FUSED); 512 flops/byte at 512 x 512,
// so the kernel is bound by arithmetic (in this first version by
// shared-memory operand reads).
#include "fft_common.cuh"

namespace {

__global__ void __launch_bounds__(pfft::kThreads)
    md2_kernel(pfft::Pass pa, pfft::Pass pb, int64_t batch, const float2* x,
               float2* y) {
  extern __shared__ float2 smem[];
  const pfft::TileSmem sa = pfft::tile_smem(pa.sub, pa.T, smem);
  const pfft::TileSmem sb = pfft::tile_smem(pb.sub, pb.T, smem);
  for (int64_t b = blockIdx.x; b < batch; b += gridDim.x) {
    pfft::load_sub_roots(pa.sub, sa);
    for (int64_t c0 = 0; c0 < pa.ncols; c0 += pa.T)
      pfft::pass_tile(pa, b, c0, x, y, sa);
    pfft::load_sub_roots(pb.sub, sb);
    for (int64_t r0 = 0; r0 < pb.ncols; r0 += pb.T)
      pfft::pass_tile(pb, b, r0, y, y, sb);
  }
}

bool sub_ok(const pfft::Sub& s) {
  return s.m >= 1 && s.m <= pfft::kTileMax && (s.a == 0 || s.a * 128 == s.m);
}

}  // namespace

// x (2*batch*n1*n2 floats) -> y; y may equal x.  Axis k (k = 1, 2) has
// length mk; ak = 0 for DIRECT (wkr/wki: mk x mk DFT planes) or a for FUSED
// [a, 128] (wkr/wki: a x a, bkr/bki: 128 x 128, ukr/uki: the (a, 128)
// twiddle planes).  Returns a cudaError_t.
extern "C" int pf_md2(const float* x, float* y, int m1, int a1,
                      const float* w1r, const float* w1i, const float* b1r,
                      const float* b1i, const float* u1r, const float* u1i,
                      int m2, int a2, const float* w2r, const float* w2i,
                      const float* b2r, const float* b2i, const float* u2r,
                      const float* u2i, int64_t batch, float scale,
                      void* stream) {
  const pfft::Sub s1{m1, a1, w1r, w1i, b1r, b1i, u1r, u1i};
  const pfft::Sub s2{m2, a2, w2r, w2i, b2r, b2i, u2r, u2i};
  if (!sub_ok(s1) || !sub_ok(s2) || batch < 1)
    return int(cudaErrorInvalidValue);
  const int64_t n = int64_t(m1) * m2;
  // Phase A: columns of one transform, element stride n2.
  pfft::Pass pa{};
  pa.sub = s1;
  pa.ncols = m2;
  pa.T = pfft::pick_tile(m1, m2, 4096, 32);
  pa.ibs = n;
  pa.iis = m2;
  pa.ics = 1;
  pa.obs = n;
  pa.oks = m2;
  pa.ocs = 1;
  pa.scale = 1.f;
  // Phase B: rows of one transform, contiguous.
  pfft::Pass pb{};
  pb.sub = s2;
  pb.ncols = m1;
  pb.T = pfft::pick_tile(m2, m1, 4096, 32);
  pb.ibs = n;
  pb.iis = 1;
  pb.ics = m2;
  pb.obs = n;
  pb.oks = 1;
  pb.ocs = m2;
  pb.scale = scale;
  const size_t sa = pfft::pass_smem_bytes(s1, pa.T);
  const size_t sb = pfft::pass_smem_bytes(s2, pb.T);
  const size_t smem = sa > sb ? sa : sb;
  cudaError_t err = cudaFuncSetAttribute(
      md2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const int64_t cap = int64_t(1) << 30;
  const unsigned grid = unsigned(batch < cap ? batch : cap);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  md2_kernel<<<grid, pfft::kThreads, smem, st>>>(
      pa, pb, batch, reinterpret_cast<const float2*>(x),
      reinterpret_cast<float2*>(y));
  return int(cudaGetLastError());
}
