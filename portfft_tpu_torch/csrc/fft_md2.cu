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
//            read from x;
//   phase B: n2-point passes along the rows, tiles of T2 rows, times scale,
//            written to y.
// Each sub-transform is DIRECT or FUSED [a, 128] and runs on the radix
// stages of fft_radix.cuh in the tiles of fft_common.cuh.  Phase A stores
// to y and phase B works in place on y, so the intermediate goes through
// device memory: at 128 x 128 (128 KiB a transform) the resident blocks'
// share of it stays in the 50 MB L2 and each element crosses HBM once each
// way, as on the TPU; at 512 x 512 (2 MiB) it spills to HBM and the kernel
// moves twice the bytes of its bound.  Keeping a 128 x 128 transform in
// shared memory instead (128 KiB beside the tiles) leaves one block an SM,
// and measured slower on the H100 than this route, whose L2 already holds
// the intermediate.  Phase A's tiles are at least 4 columns (32 bytes) wide,
// so each warp's loads and stores fill whole sectors.  Each tile's loads
// start before the previous tile's stages (pfft_radix::Prefetch), so
// they fly while the block works: the next column tile during a column
// tile, the next row tile during a row tile, the block's next transform
// during its last row tile; they never touch what the tile in work stores.
// Every tile ends with __syncthreads, so the block's writes to y are
// visible to all its threads before phase B reads them.  A transform
// belongs to one block and each tile is read before it is written, so y may
// equal x.
//
// Bound on the H100, per complex element: 16 bytes of device memory (32
// where the intermediate leaves L2) against about 5*log2(n1*n2) flops of
// the radix stages: bound by bytes.
#include "fft_radix.cuh"

namespace {

// Threads a block; two blocks an SM.
constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock, 2)
    md2_kernel(pfft::Pass pa, pfft::Pass pb, int64_t batch, const float2* x,
               float2* y) {
  extern __shared__ float2 smem[];
  const pfft::TileSmem sa = pfft::tile_smem(pa.sub, pa.T, smem);
  const pfft::TileSmem sb = pfft::tile_smem(pb.sub, pb.T, smem);
  const int ea = pfft::tile_pitch(pa.T), eb = pfft::tile_pitch(pb.T);
  pfft_radix::Prefetch f;
  if (blockIdx.x < batch) pfft_radix::fetch(f, pa, blockIdx.x, 0, x);
  for (int64_t b = blockIdx.x; b < batch; b += gridDim.x) {
    pfft::load_sub_roots(pa.sub, sa);
    for (int64_t c0 = 0; c0 < pa.ncols; c0 += pa.T) {
      pfft_radix::land(f, pa, b, c0, x, sa.b0);
      if (c0 + pa.T < pa.ncols) pfft_radix::fetch(f, pa, b, c0 + pa.T, x);
      const float2* res = pfft_radix::sub_fft(pa.sub, sa.ra, sa.rb, sa.b0,
                                              sa.b1, pa.T, ea);
      pfft::tile_store(pa, b, c0, res, y);
    }
    pfft::load_sub_roots(pb.sub, sb);
    pfft_radix::fetch(f, pb, b, 0, y);
    for (int64_t r0 = 0; r0 < pb.ncols; r0 += pb.T) {
      pfft_radix::land(f, pb, b, r0, y, sb.b0);
      if (r0 + pb.T < pb.ncols) pfft_radix::fetch(f, pb, b, r0 + pb.T, y);
      else if (b + gridDim.x < batch)
        pfft_radix::fetch(f, pa, b + gridDim.x, 0, x);
      const float2* res = pfft_radix::sub_fft(pb.sub, sb.ra, sb.rb, sb.b0,
                                              sb.b1, pb.T, eb);
      pfft::tile_store(pb, b, r0, res, y);
    }
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
  const int wide = m2 < 4 ? m2 : 4;
  const int ta = pfft::pick_tile(m1, m2, 4096, 32);
  pa.T = pfft::fit_tile(s1, ta > wide ? ta : wide);
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
  md2_kernel<<<grid, kBlock, smem, st>>>(
      pa, pb, batch, reinterpret_cast<const float2*>(x),
      reinterpret_cast<float2*>(y));
  return int(cudaGetLastError());
}
