"""K5 ``global_bf``, K5-ov ``global_bf_ov`` and K19 ``global_bf2``:
wrappers of the butterfly-factored single-sweep GLOBAL kernels
(``csrc/fft_global_bf.cu``), their gates, and their plain PyTorch versions.

Counterparts of ``portfft_tpu/ops/pallas_global_bf.py``:
``global_bf_raw_call`` (the tuned engine ``{"eng": 7}``),
``global_bf_ov_raw_call`` (``{"eng": 7, "ov": 1}``) and
``global_bf2_raw_call`` (``{"eng": 7, "bf2": 1}``).  All compute K3's
function, n = G1·G2 on the PACKED interleaved buffer, with each sub
factored as g = A·128 (A a power of two ≤ 16, ``torch_fft.bf_factor``):

* pass 1, for each column n2 of the (G1, G2) view: a radix-A1 butterfly
  over the 128-point slabs (adds and exact ±1/±i constants), the digit
  twiddle U1[kA1, iB1] = w_G1^(kA1·iB1), one 128-point DFT, and the
  inter-factor twiddle w_n^(k1·n2) as the product of GA[kA1, n2] =
  w_n^(kA1·n2) and GB[kB1, n2] = w_{n/A1}^(kB1·n2), k1 = kA1 + A1·kB1;
* pass 2, for each row k1: the same over n2 with A2, U2 and no twiddle,
  out[k1 + G1·k2] = scale · C[k1, k2].

About A + 128 complex multiply-adds per point and pass, where K3 does G.
The kernels hold the pass-1 result of a chunk of the batch in a device
scratch sized to stay in L2 (``bf_chunk``); K5 runs pass 1 and pass 2 of
each chunk between grid-wide barriers, K5-ov overlays pass 1 of chunk r
with pass 2 of chunk r−1 over two scratch slots, and K19 is K5 with GB
not streamed but formed from two factors held in shared memory
(``global_bf2``).  K5 and K5-ov differ in schedule only, so they share one
plain version.  K18 (``cuda_global_ilv``) runs the same machinery over
mixed-radix factors.  Same rule as ``cuda_fft``: CPU tensors go to the
plain version, CUDA tensors to the kernel, and nothing falls back.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import H100_L2_BYTES, H100_SMEM_PER_BLOCK
from ..enums import Level
from ..planner import Plan1D
from ..utils import tracing
from . import _build
from .cuda_fft import check_buffer, interleave, into, require_cuda, stream_of
from .torch_fft import (
    BF2_T1,
    bf_factor,
    complex_matmul,
    complex_mul,
    full_fp32_matmuls,
    ilv_factor,
    mixed_radix_dft,
)

def bf_tile(g: int) -> int:
    """Columns per tile of a K5 pass over sub length ``g``: the widest of
    8, 4, 2, 1 whose two tiles (g rows, padded by one row per 128, pitch
    T + 1 float2) and the 128-point roots fit half of
    ``config.H100_SMEM_PER_BLOCK``, so that two blocks share an SM (2048 points:
    2 columns), else the widest that fits whole; 0 where none fits."""
    def smem(t):
        return 8 * (128 + 2 * (g + g // 128) * (t + 1))

    for budget in (H100_SMEM_PER_BLOCK // 2, H100_SMEM_PER_BLOCK):
        for t in (8, 4, 2, 1):
            if smem(t) <= budget:
                return t
    return 0


def bf2_tile(g: int, g2: int) -> int:
    """Columns per tile of a K19 pass over sub length ``g`` in a plan whose
    second sub is ``g2``: the widest of 8, 4, 2, 1 whose two tiles fit the
    whole of ``config.H100_SMEM_PER_BLOCK`` beside the 128-point roots and
    K19's resident factors of its low twiddle, B1ᵀ (128 × ``BF2_T1``) and
    B2 (G2/BF2_T1 × 128): one block an SM (2048 points: one column).  0
    where none fits."""
    fixed = 128 + 128 * BF2_T1 + g2
    for t in (8, 4, 2, 1):
        if 8 * (fixed + 2 * (g + g // 128) * (t + 1)) <= H100_SMEM_PER_BLOCK:
            return t
    return 0


def global_bf_supported(plan: Plan1D) -> bool:
    """The gate of K5 and K5-ov: a GLOBAL plan whose subs are both A·128
    with A a power of two ≤ 16, each pass's tile within the shared memory
    of a block.  The JAX package's gate (``global_bf_supported``) is the
    same factor rule with its VMEM estimate."""
    if plan.level != Level.GLOBAL:
        return False
    g1, g2 = plan.sub[0].n, plan.sub[1].n
    return bool(bf_factor(g1) and bf_factor(g2) and bf_tile(g1)
                and bf_tile(g2))


def global_bf2_supported(plan: Plan1D) -> bool:
    """K19's gate: K5's (``global_bf_supported``) with K19's tiles beside
    its resident tables (``bf2_tile``).  The JAX package's
    ``global_bf2_raw_call`` takes K5's plans where its VMEM estimate
    (``bf2_est_bytes``) fits; here every plan K5 takes fits."""
    if not global_bf_supported(plan):
        return False
    g1, g2 = plan.sub[0].n, plan.sub[1].n
    return bool(bf2_tile(g1, g2) and bf2_tile(g2, g2))


def bf_chunk(n: int, batch: int) -> int:
    """Transforms per chunk: a scratch slot of 8·n bytes per transform
    within a quarter of the L2 cache (``config.H100_L2_BYTES``), at least
    one transform and at most the batch."""
    return max(1, min(batch, H100_L2_BYTES // 4 // (8 * n)))


@dataclasses.dataclass(frozen=True)
class BfTables:
    """One direction's K5 tables and launch shape: the sub lengths and
    factors, the tile widths of the two passes, the chunk, the sign, and
    the (re, im) planes of the 128-point DFT matrix ``w128``, the digit
    twiddles ``u1`` (A1, 128) and ``u2`` (A2, 128), and the factored
    twiddle ``ga`` (A1, G2) and ``gb`` (128, G2); for K19 ``gb`` is None
    and ``lo`` holds its factors B1ᵀ (128, ``BF2_T1``) [kB1, c] and B2
    (G2/BF2_T1, 128) [s, kB1], GB[kB1, c + BF2_T1·s] =
    B1ᵀ[kB1, c]·B2[s, kB1] (the JAX package's ``G2L`` tables)."""

    g1: int
    g2: int
    t1: int
    t2: int
    chunk: int
    sign: int
    w128: tuple
    u1: tuple
    u2: tuple
    ga: tuple
    gb: tuple | None
    lo: tuple = ()

    @property
    def a1(self) -> int:
        return self.g1 // 128

    @property
    def a2(self) -> int:
        return self.g2 // 128

    def c_args(self) -> list:
        """The arguments of the C entry points after the three buffers."""
        low = (self.gb,) if self.gb is not None else self.lo
        ptrs = [t.data_ptr() for pair in (self.w128, self.u1, self.u2,
                                          self.ga, *low) for t in pair]
        return [self.g1, self.g2, self.t1, self.t2, self.sign, *ptrs]


def bf_tables(plan: Plan1D, sign: int, keys: dict, arrays: dict,
              batch: int, resident: bool = False) -> BfTables:
    """Resolve one direction's tables from the bank
    (``torch_fft.collect_bank_keys``) and the launch shape: K5's and K18's
    (the digit twiddles at ``ilv_factor``, which is ``bf_factor`` on the
    powers of two K5's gate takes), or with ``resident`` K19's (its tiles,
    and the factors of GB in place of GB)."""
    g1, g2 = plan.sub[0].n, plan.sub[1].n

    def pair(key, suffix=""):
        name = keys[key] + suffix
        return (arrays[name + "r"], arrays[name + "i"])

    if resident:
        lo = ("G2L", g2, BF2_T1, sign)
        tiles = (bf2_tile(g1, g2), bf2_tile(g2, g2))
        low = dict(gb=None, lo=(pair(lo, "1t"), pair(lo, "2")))
    else:
        tiles = (bf_tile(g1), bf_tile(g2))
        low = dict(gb=pair(("GB", g1, g2, sign)))
    return BfTables(
        g1, g2, *tiles, bf_chunk(plan.n, batch), sign,
        pair(("W", 128, sign)),
        pair(("U", ilv_factor(g1), 128, sign)),
        pair(("U", ilv_factor(g2), 128, sign)),
        pair(("GA", g1, g2, sign)), **low)


def _slab_dft(slabs: list, t: BfTables, u: tuple, left: bool):
    """Butterfly over the slabs, the digit twiddle ``u`` (A, 128), and the
    128-point DFT of each output slab: over its rows (``left``, slabs of
    (b, 128, m)) or over its columns (slabs of (b, m, 128)).  Returns the
    (re, im) stacks of shape (b, A, 128, m) or (b, A, m, 128)."""
    out_r, out_i = [], []
    for k, (yr, yi) in enumerate(mixed_radix_dft(slabs, t.sign)):
        ur, ui = u[0][k], u[1][k]
        if left:
            yr, yi = complex_mul(yr, yi, ur[:, None], ui[:, None])
            zr, zi = complex_matmul(*t.w128, yr, yi)  # W is symmetric
        else:
            yr, yi = complex_mul(yr, yi, ur, ui)
            zr, zi = complex_matmul(yr, yi, *t.w128)
        out_r.append(zr)
        out_i.append(zi)
    return torch.stack(out_r, 1), torch.stack(out_i, 1)


def bf_low_twiddle(t: BfTables) -> tuple:
    """The low factor GB (128, G2) [kB1, n2] of the inter-factor twiddle as
    the kernel reads it: K5's table, or K19's product B1ᵀ[kB1, n2 mod
    BF2_T1]·B2[n2 div BF2_T1, kB1] in float32."""
    if t.gb is not None:
        return t.gb
    (b1r, b1i), (b2r, b2i) = t.lo
    reps = t.g2 // BF2_T1
    return complex_mul(b1r.repeat(1, reps), b1i.repeat(1, reps),
                       b2r.T.repeat_interleave(BF2_T1, 1),
                       b2i.T.repeat_interleave(BF2_T1, 1))


def global_bf_plain(raw: torch.Tensor, batch: int, t: BfTables, scale: float):
    """Plain version of K5, K5-ov, K18 and K19: their decomposition step by
    step on the whole batch (the chunking is the kernels' schedule only),
    the slab DFT mixed radix, GB from ``bf_low_twiddle``."""
    g1, g2, a1, a2 = t.g1, t.g2, t.a1, t.a2
    x = raw.view(batch, g1, g2, 2)
    with full_fp32_matmuls(raw):
        xr, xi = x[..., 0], x[..., 1]  # [n1, n2], n1 = 128·iA1 + iB1
        slabs = [(xr[:, 128 * j:128 * (j + 1)], xi[:, 128 * j:128 * (j + 1)])
                 for j in range(a1)]
        zr, zi = _slab_dft(slabs, t, t.u1, left=True)  # [kA1, kB1, n2]
        zr, zi = complex_mul(zr, zi, t.ga[0][None, :, None, :],
                             t.ga[1][None, :, None, :])
        zr, zi = complex_mul(zr, zi, *bf_low_twiddle(t))
        # S[k1, n2] with k1 = kA1 + A1·kB1
        sr = zr.transpose(1, 2).reshape(batch, g1, g2)
        si = zi.transpose(1, 2).reshape(batch, g1, g2)
        slabs = [(sr[..., 128 * j:128 * (j + 1)], si[..., 128 * j:128 * (j + 1)])
                 for j in range(a2)]
        cr, ci = _slab_dft(slabs, t, t.u2, left=False)  # [kA2, k1, kB2]
    # out[k1 + G1·k2], k2 = kA2 + A2·kB2
    cr = cr.permute(0, 3, 1, 2).reshape(batch, g1 * g2)
    ci = ci.permute(0, 3, 1, 2).reshape(batch, g1 * g2)
    return interleave(cr, ci, scale)


def launch_sweep(entry: str, raw, batch: int, t: BfTables, scale: float, out,
                 slots: int):
    """One launch of the sweep kernel ``pf_{entry}`` (K5, K5-ov, K18, K19)
    through a scratch of ``slots`` chunk slots, or the plain version on a
    CPU tensor."""
    n = t.g1 * t.g2
    check_buffer(raw, 2 * batch * n, entry)
    if raw.device.type == "cpu":
        return into(out, global_bf_plain(raw, batch, t, scale))
    require_cuda(raw, entry)
    lib = _build.load()
    y = torch.empty_like(raw) if out is None else out
    scratch = torch.empty(2 * slots * t.chunk * n, dtype=torch.float32,
                          device=raw.device)
    with torch.cuda.device(raw.device):
        err = getattr(lib, f"pf_{entry}")(
            raw.data_ptr(), y.data_ptr(), scratch.data_ptr(), *t.c_args(),
            batch, t.chunk, scale, stream_of(raw))
    _build.check(lib, err, f"{entry} kernel")
    return y


@tracing.kernel("K5", ("sweep_kernel",))
def global_bf(raw, batch: int, t: BfTables, scale: float, out=None):
    """K5: ``batch`` GLOBAL transforms of length ``t.g1 · t.g2`` in one
    cooperative launch: per chunk of ``t.chunk`` transforms, pass 1 into
    a scratch slot, a grid-wide barrier, pass 2 into ``out`` (may be
    ``raw``), a barrier.  The wrapper allocates the scratch slot."""
    return launch_sweep("global_bf", raw, batch, t, scale, out, 1)


global_bf.plain = global_bf_plain


@tracing.kernel("K5-ov", ("overlay_kernel",))
def global_bf_ov(raw, batch: int, t: BfTables, scale: float, out=None):
    """K5-ov: K5's function with the phase-overlay schedule: round r runs
    pass 1 of chunk r and pass 2 of chunk r − 1 over two scratch slots,
    one grid-wide barrier a round.  No output is written before its
    transform's pass 2."""
    return launch_sweep("global_bf_ov", raw, batch, t, scale, out, 2)


global_bf_ov.plain = global_bf_plain


@tracing.kernel("K19", ("sweep_kernel",))
def global_bf2(raw, batch: int, t: BfTables, scale: float, out=None):
    """K19: K5's function and schedule with the low twiddle factor GB not
    streamed: each block holds B1ᵀ and B2 (``t.lo``, at ``BF2_T1`` = 128
    columns: 128 KiB + 8·G2 bytes) in shared memory from the start of the
    launch and forms GB[kB1, n2] = B1ᵀ[kB1, n2 mod 128]·B2[n2 div 128, kB1]
    in pass 1's store.  Its tiles (``bf2_tile``) fill what is left of one
    block an SM.  ``t`` comes from ``bf_tables(..., resident=True)``."""
    if t.gb is not None or not t.lo:
        raise ValueError("global_bf2 takes the resident tables "
                         "(bf_tables(..., resident=True))")
    return launch_sweep("global_bf2", raw, batch, t, scale, out, 1)


#: K19's plain version: K5's decomposition with GB formed from its factors.
global_bf2_plain = global_bf_plain
global_bf2.plain = global_bf2_plain
