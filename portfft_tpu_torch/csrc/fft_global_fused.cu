// K17 `global_fused`: batched GLOBAL four-step transform n = G1*G2 on the
// PACKED interleaved buffer, both passes in one cooperative launch whose
// intermediate stays in L2.
//
// Replaces portfft_tpu/ops/pallas_global.py::global_fused_raw_call (the
// tuned engine {"eng": 6}, and {"eng": 6, "ftw": 1} with its factored
// twiddle).  Its function is K3's (fft_global2.cu), on the tiles of
// fft_common.cuh; with the row viewed as x[n1, n2] = x[G2*n1 + n2]:
//   pass 1: for each column n2, the G1-point transform down n1, times the
//           twiddle w_n^(k1*n2), stored as S[b, n2, k1] in a scratch;
//   pass 2: for each k1, the G2-point transform over n2, stored as
//           out[b, k1 + G1*k2] = scale * (...).
// A TPU core keeps the whole (G2, G1) intermediate in VMEM between the two
// passes.  An SM cannot (8 MiB at 2^20 points), so it goes through a ring
// of `ring` scratch slots of one transform each, as many as fit a quarter
// of L2 (cuda_global_bf.bf_chunk), whose reads bypass L1 (__ldcg).  Both
// passes run on the radix stages of fft_radix.cuh, each at its own tile
// width (K3's, rounded down to a power of two).
//
// Scheduling: no grid-wide barrier.  The grid is every block the card holds
// at once with the kernel's shared memory (a cooperative launch); a block
// takes work items, one tile of one pass of one transform each, from one
// global ticket (atomicAdd) until none is left.  The items are handed out in
// groups g = 0, 1, ...: the pass-1 tiles of transform g, then the pass-2
// tiles of transform g - lag.  Per transform two arrival counters: a pass-1
// tile publishes its scratch rows (__syncthreads, then one thread's
// releasing increment of done1[b]); a pass-2 tile of b waits with acquiring
// loads until done1[b] == tiles1, and once its rows are in shared memory
// releases them (done2[b]).  A pass-1 tile of b >= ring first waits until
// done2[b - ring] == tiles2, so that its slot b mod ring is free.  No wait
// can deadlock: every item waits only on items of smaller tickets (lag <
// ring), which blocks that are already running hold, and those wait only on
// smaller ones still.  lag is half the ring (at most the batch), so that
// both waits point as far back as the ring allows: a pass-2 tile lag
// groups, a pass-1 tile ring - lag.  The ring bounds how many transforms
// the grid's items may span at once, so an item stays one tile: runs of 2,
// 4 and 8 tiles measured 1.2-4x slower (more of them waited).
//
// The twiddle: the bank's dense (G2, G1) table ("T", {"eng": 6}), or, in
// the factored mode, the per-tile factors of fft_ftw.cuh (the JAX
// package's "Q" or "ZQ" tables at 64 columns), formed in shared memory
// before each pass-1 tile, so that no dense twiddle is streamed.
//
// Bound on the H100, per complex element: 16 bytes in and out of device
// memory (+ 8 bytes of dense twiddle, an L2 hit once the table is read),
// the scratch round trip in L2, against about 5*log2(n) flops of the radix
// stages: bound by bytes.
#include "fft_ftw.cuh"
#include "fft_radix.cuh"

namespace {

// Threads a block.
constexpr int kBlock = 256;

// Scratch reads: through L2 only (the slots are rewritten during the launch).
struct FromL2 {
  const float2* p;
};
__device__ __forceinline__ float2 ld(const FromL2& x, int64_t i) {
  return __ldcg(x.p + i);
}

struct Fused {
  const float2* x;
  float2* y;
  float2* s;  // scratch: ring slots of n points
  // ticket, then done1[batch], done2[batch]; zero at the launch
  unsigned long long* count;
  pfft::Sub s1, s2;
  int t1, t2;
  const float* twr;  // dense (g2, g1) [n2, k1]; nullptr in the factored mode
  const float* twi;
  pfft_ftw::Tables q;  // factored: tables 1r, 1i, 2r, 2i, 3r, 3i, 4r, 4i
  int64_t batch, ring, lag;
  float scale;
};

__host__ __device__ inline int roots_of(const pfft::Sub& s) {
  return s.a ? s.a + 128 : s.m;
}

__host__ __device__ inline int tile_elems(const pfft::Sub& s, int T) {
  return pfft::tile_rows(s) * pfft::tile_pitch(T);
}

// Shared memory in float2: both passes' root tables (loaded once; a block
// switches pass between items), two tiles of the larger pass, then (the
// factored mode) C1 and C2 of a pass-1 tile from extra_offset on.
__host__ __device__ inline int extra_offset(const Fused& p) {
  const int e1 = tile_elems(p.s1, p.t1), e2 = tile_elems(p.s2, p.t2);
  return roots_of(p.s1) + roots_of(p.s2) + 2 * (e1 > e2 ? e1 : e2);
}
__host__ __device__ inline int smem_elems(const Fused& p) {
  return extra_offset(p) + (p.twr ? 0 : pfft_ftw::factor_elems(p.s1, p.t1));
}

// Pass `second`'s tiles and roots.
__device__ inline pfft::TileSmem pass_smem(const Fused& p, bool second,
                                           float2* smem) {
  const pfft::Sub& s = second ? p.s2 : p.s1;
  pfft::TileSmem t;
  t.ra = smem + (second ? roots_of(p.s1) : 0);
  t.rb = t.ra + (s.a ? s.a : s.m);
  t.b0 = smem + roots_of(p.s1) + roots_of(p.s2);
  t.b1 = t.b0 + tile_elems(s, second ? p.t2 : p.t1);
  return t;
}

// Pass 1's store: S[slot][n2][k1] = res[k1 of column t] * twiddle, elements
// fastest (the scratch rows are k1-contiguous); ends with __syncthreads.
__device__ void store1(const Fused& p, const pfft::Pass& ps, int64_t slot,
                       int64_t c0, const float2* res, const float2* extra) {
  const pfft::Sub& s = ps.sub;
  const int m = s.m, T = ps.T, es = pfft::tile_pitch(T);
  const int64_t left = ps.ncols - c0;
  const int tv = left < T ? int(left) : T;
  for (int e = threadIdx.x; e < m * T; e += blockDim.x) {
    const int k = e % m, t = e / m;
    if (t >= tv) continue;
    float2 v = res[pfft::tile_pos(s, k) * es + t];
    if (p.twr) {
      const int64_t i = (c0 + t) * m + k;
      v = pfft::cmul(v, make_float2(__ldg(p.twr + i), __ldg(p.twi + i)));
    } else {
      v = pfft_ftw::apply(v, extra, p.s1, T, t, k);
    }
    p.s[slot * ps.obs + (c0 + t) * ps.ocs + k] = v;
  }
  __syncthreads();
}

// Waits until *c reaches target: one thread polls with acquiring loads,
// and the barrier hands the ordering to the block.
__device__ inline void wait_for(const unsigned long long* c,
                                unsigned long long target) {
  if (threadIdx.x == 0) {
    unsigned long long v;
    for (;;) {
      asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
                   : "=l"(v) : "l"(c) : "memory");
      if (v >= target) break;
      __nanosleep(64);
    }
  }
  __syncthreads();
}

// Called after a __syncthreads that follows the block's accesses: counts
// one arrival at *c with release semantics, which the barrier extends to
// the whole block's accesses.  Nothing waits for the result.
__device__ inline void arrive(unsigned long long* c) {
  if (threadIdx.x == 0)
    asm volatile("red.release.gpu.global.add.u64 [%0], 1;"
                 :: "l"(c) : "memory");
}

// A ticket's work item: pass (1 or 2), transform b and tile index.
struct Item {
  int pass;
  int64_t b, tile;
};

// Tickets [0, lag*tiles1): the pass-1 tiles of transforms 0 .. lag-1; then
// (batch - lag) groups of tiles1 + tiles2: group g holds the pass-1 tiles of
// transform lag + g, then the pass-2 tiles of transform g; then the pass-2
// tiles of the last lag transforms.
__device__ inline Item item_of(int64_t t, int64_t batch, int64_t lag,
                               int64_t tiles1, int64_t tiles2) {
  const int64_t head = lag * tiles1;
  if (t < head) return Item{1, t / tiles1, t % tiles1};
  t -= head;
  const int64_t per = tiles1 + tiles2, mid = (batch - lag) * per;
  if (t < mid) {
    const int64_t g = t / per, r = t - g * per;
    return r < tiles1 ? Item{1, lag + g, r} : Item{2, g, r - tiles1};
  }
  t -= mid;
  return Item{2, batch - lag + t / tiles2, t % tiles2};
}

__global__ void __launch_bounds__(kBlock) fused_kernel(Fused p) {
  extern __shared__ float2 smem[];
  const int g1 = p.s1.m, g2 = p.s2.m;
  const int64_t n = int64_t(g1) * g2;
  pfft::Pass p1{};
  p1.sub = p.s1;
  p1.ncols = g2;
  p1.T = p.t1;
  p1.ibs = n;
  p1.iis = g2;
  p1.ics = 1;
  p1.obs = n;
  p1.oks = 1;
  p1.ocs = g1;
  p1.scale = 1.f;
  pfft::Pass p2{};
  p2.sub = p.s2;
  p2.ncols = g1;
  p2.T = p.t2;
  p2.ibs = n;
  p2.iis = g1;
  p2.ics = 1;
  p2.obs = n;
  p2.oks = g1;
  p2.ocs = 1;
  p2.scale = p.scale;
  const pfft::TileSmem sm1 = pass_smem(p, false, smem);
  const pfft::TileSmem sm2 = pass_smem(p, true, smem);
  float2* extra = smem + extra_offset(p);
  unsigned long long* done1 = p.count + 1;
  unsigned long long* done2 = done1 + p.batch;
  const int64_t tiles1 = (g2 + p.t1 - 1) / p.t1, tiles2 = (g1 + p.t2 - 1) / p.t2;
  const int64_t items = p.batch * (tiles1 + tiles2);
  pfft::load_sub_roots(p.s1, sm1);
  pfft::load_sub_roots(p.s2, sm2);
  // The ticket passes to the block through the tile, which is free between
  // items: the previous item ended with __syncthreads, and the second
  // barrier keeps this item's loads off it until every thread has read it.
  unsigned long long* const ticket =
      reinterpret_cast<unsigned long long*>(sm1.b0);
  for (;;) {
    if (threadIdx.x == 0) *ticket = atomicAdd(p.count, 1ull);
    __syncthreads();
    const int64_t t = int64_t(*ticket);
    __syncthreads();
    if (t >= items) break;
    const Item it = item_of(t, p.batch, p.lag, tiles1, tiles2);
    const int64_t slot = it.b % p.ring;
    if (it.pass == 1) {
      if (it.b >= p.ring) wait_for(done2 + (it.b - p.ring), tiles2);
      const int64_t c0 = it.tile * p.t1;
      if (!p.twr) pfft_ftw::prepare(p.q, p.s1, p.t1, c0, extra);
      pfft_radix::load_tile(p1, it.b, c0, p.x, sm1.b0);
      const float2* res = pfft_radix::sub_fft(
          p.s1, sm1.ra, sm1.rb, sm1.b0, sm1.b1, p.t1, pfft::tile_pitch(p.t1));
      store1(p, p1, slot, c0, res, extra);
      arrive(done1 + it.b);
    } else {
      wait_for(done1 + it.b, tiles1);
      const int64_t c0 = it.tile * p.t2;
      pfft_radix::load_tile(p2, slot, c0, FromL2{p.s}, sm2.b0);
      arrive(done2 + it.b);  // the tile's rows of the slot are read
      const float2* res = pfft_radix::sub_fft(
          p.s2, sm2.ra, sm2.rb, sm2.b0, sm2.b1, p.t2, pfft::tile_pitch(p.t2));
      pfft::tile_store(p2, it.b, c0, res, p.y);
    }
  }
}

bool sub_ok(const pfft::Sub& s) {
  return s.m >= 1 && (s.a == 0 || s.a * 128 == s.m) &&
         (s.a ? s.a : s.m) <= pfft::kTileMax;
}

bool tile_ok(int t) { return t == 1 || t == 2 || t == 4 || t == 8; }

}  // namespace

// x (2*batch*g1*g2 floats) -> y (may equal x) through the scratch s of
// 2*ring*g1*g2 floats.  Sub k (k = 1, 2) has length gk; ak = 0 for DIRECT
// (wkr/wki: gk x gk DFT planes) or a for FUSED [a, 128] (wkr/wki: a x a,
// bkr/bki: 128 x 128, ukr/uki: the (a, 128) twiddle planes).  t1, t2:
// columns per tile of the two passes (1, 2, 4 or 8).  tr/ti: the dense
// (g2, g1) twiddle planes, or nullptr and q: the factored mode's eight
// table planes ("Q" or "ZQ" at 64 columns).  count: 1 + 2*batch 64-bit
// counters, zeroed here on the stream.  Returns a cudaError_t
// (cudaErrorCooperativeLaunchTooLarge where not one block fits an SM).
extern "C" int pf_global_fused(
    const float* x, float* y, float* s, void* count, int g1, int a1,
    const float* w1r, const float* w1i, const float* b1r, const float* b1i,
    const float* u1r, const float* u1i, int g2, int a2, const float* w2r,
    const float* w2i, const float* b2r, const float* b2i, const float* u2r,
    const float* u2i, int t1, int t2, const float* tr, const float* ti,
    const float* q1r, const float* q1i, const float* q2r, const float* q2i,
    const float* q3r, const float* q3i, const float* q4r, const float* q4i,
    int64_t batch, int64_t ring, float scale, void* stream) {
  Fused p{reinterpret_cast<const float2*>(x),
          reinterpret_cast<float2*>(y),
          reinterpret_cast<float2*>(s),
          static_cast<unsigned long long*>(count),
          pfft::Sub{g1, a1, w1r, w1i, b1r, b1i, u1r, u1i},
          pfft::Sub{g2, a2, w2r, w2i, b2r, b2i, u2r, u2i},
          t1, t2, tr, ti,
          {{q1r, q1i, q2r, q2i, q3r, q3i, q4r, q4i}},
          batch, ring, 0, scale};
  const bool dense = tr != nullptr && ti != nullptr;
  if (!sub_ok(p.s1) || !sub_ok(p.s2) || !tile_ok(t1) || !tile_ok(t2) ||
      batch < 1 || ring < 1 || s == nullptr || count == nullptr ||
      (!dense && (q1r == nullptr || !pfft_ftw::tables_ok(p.s1, g2))))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return int(err);
  // Every block the card holds at once: the grid of the cooperative launch.
  const size_t smem = sizeof(float2) * size_t(smem_elems(p));
  err = cudaFuncSetAttribute(
      fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_kernel,
                                                      kBlock, smem);
  if (err != cudaSuccess) return int(err);
  const int blocks = per_sm * sms;
  if (blocks < 1) return int(cudaErrorCooperativeLaunchTooLarge);
  // Half the ring: a pass-2 tile trails its pass-1 tiles by lag groups,
  // and a pass-1 tile its slot's last pass-2 tiles by ring - lag.
  p.lag = ring / 2 < batch ? ring / 2 : batch;
  err = cudaMemsetAsync(count, 0, sizeof(unsigned long long) * (1 + 2 * batch),
                        st);
  if (err != cudaSuccess) return int(err);
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(fused_kernel),
                                    dim3(unsigned(blocks)), dim3(kBlock),
                                    args, smem, st);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}
