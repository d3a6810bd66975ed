// K2 `fused2`: batched FUSED transform n = a*128 (a <= 256 in the plans) on
// the PACKED interleaved buffer.
//
// Replaces portfft_tpu/ops/pallas_fft.py::fused2_raw_mm_call
// (_fused2_raw_mm_kernel).  With x[n1, n2] = x[128*n1 + n2]:
//   1. A[k1, n2] = sum_n1 x[n1, n2] * w_a^(n1*k1)
//   2. A *= w_n^(n2*k1)                      (the bank's (a, 128) table)
//   3. C[k1, k2] = sum_n2 A[k1, n2] * w_128^(n2*k2)
//   4. out[k1 + a*k2] = scale * C[k1, k2]
// Stages 1-3 are pfft::sub_dft (fft_common.cuh), which K3 reuses for its
// FUSED sub-transforms.  The TPU kernel's bf16 Karatsuba and K/M-stacked
// tables are its precision scheme on the matrix unit and are not carried
// over: the sums here are fp32 FMA on the CUDA cores.
//
// Bound on the H100, per complex element: 8*(a + 128) flops against 16
// bytes of device memory; at n = 4096 (a = 32) that is 80 flops/byte, so the
// kernel is bound by arithmetic (in this first version by shared-memory
// reads of the operands).
//
// Design: for n <= 8192 one block holds whole transforms in dynamic shared
// memory (two ping-pong tiles, 8 bytes per element each: 128 KiB plus
// padding at n = 8192, above the default 48 KiB, hence the attribute set in
// launch_pass), so each element is read and written once.  For n > 8192 the
// two tiles no longer fit the 227 KB a block may use, so the transform runs
// as two launches through a scratch buffer of 2*batch*n floats that the
// caller allocates: launch 1 takes stage 1 and the twiddle and writes
// S[b, n2, k1]; launch 2 takes stage 3 and stores the digit-reversed
// result.  That doubles the bytes moved for n = 16384 and 32768.
#include "fft_common.cuh"

namespace {

__global__ void __launch_bounds__(pfft::kThreads)
    fused2_kernel(pfft::Pass p, const float2* x, float2* y) {
  pfft::run_pass(p, x, y);
}

}  // namespace

// 1 when pf_fused2 needs a scratch buffer of 2*batch*a*128 floats.
extern "C" int pf_fused2_needs_scratch(int a) {
  return a * 128 > pfft::kTileMax ? 1 : 0;
}

// x (2*batch*n floats) -> y; y may equal x.  war/wai: a x a DFT planes;
// wbr/wbi: 128 x 128; ur/ui: the (a, 128) twiddle planes.  Returns a
// cudaError_t.
extern "C" int pf_fused2(const float* x, float* y, float* scratch,
                         const float* war, const float* wai, const float* wbr,
                         const float* wbi, const float* ur, const float* ui,
                         int64_t batch, int a, float scale, void* stream) {
  if (a < 1 || batch < 1) return int(cudaErrorInvalidValue);
  const int n = a * 128;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= pfft::kTileMax) {
    pfft::Pass p{};
    p.sub = pfft::Sub{n, a, war, wai, wbr, wbi, ur, ui};
    p.nbatch = 1;
    p.ncols = batch;
    p.T = pfft::pick_tile(n, batch, 4096, 1 << 20);
    p.ibs = 0;
    p.iis = 1;
    p.ics = n;
    p.obs = 0;
    p.oks = 1;
    p.ocs = n;
    p.scale = scale;
    return pfft::launch_pass(fused2_kernel, p, x, y, st);
  }
  if (scratch == nullptr) return int(cudaErrorInvalidValue);
  // Launch 1: a-point DFT down each of the 128 columns n2, twiddle, store
  // S[b, n2, k1].
  pfft::Pass p1{};
  p1.sub = pfft::Sub{a, 0, war, wai, nullptr, nullptr, nullptr, nullptr};
  p1.nbatch = batch;
  p1.ncols = 128;
  p1.T = pfft::pick_tile(a, 128, 4096, 8);
  p1.ibs = n;
  p1.iis = 128;
  p1.ics = 1;
  p1.obs = n;
  p1.oks = 1;
  p1.ocs = a;
  p1.twr = ur;
  p1.twi = ui;
  p1.tcs = 1;
  p1.tks = 128;
  p1.scale = 1.f;
  int err = pfft::launch_pass(fused2_kernel, p1, x, scratch, st);
  if (err) return err;
  // Launch 2: 128-point DFT over n2 for each k1, store out[k1 + a*k2].
  pfft::Pass p2{};
  p2.sub = pfft::Sub{128, 0, wbr, wbi, nullptr, nullptr, nullptr, nullptr};
  p2.nbatch = batch;
  p2.ncols = a;
  p2.T = pfft::pick_tile(128, a, 4096, 8);
  p2.ibs = n;
  p2.iis = a;
  p2.ics = 1;
  p2.obs = n;
  p2.oks = a;
  p2.ocs = 1;
  p2.scale = scale;
  return pfft::launch_pass(fused2_kernel, p2, scratch, y, st);
}
