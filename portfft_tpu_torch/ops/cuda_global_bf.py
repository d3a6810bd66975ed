"""K5 ``global_bf`` and K5-ov ``global_bf_ov``: wrappers of the
butterfly-factored single-sweep GLOBAL kernels (``csrc/fft_global_bf.cu``),
their gate, and their plain PyTorch version.

Counterparts of ``portfft_tpu/ops/pallas_global_bf.py``:
``global_bf_raw_call`` (the tuned engine ``{"eng": 7}``) and
``global_bf_ov_raw_call`` (``{"eng": 7, "ov": 1}``).  Both compute K3's
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
The two kernels hold the pass-1 result of a chunk of the batch in a device
scratch sized to stay in L2 (``bf_chunk``); K5 runs pass 1 and pass 2 of
each chunk between grid-wide barriers, K5-ov overlays pass 1 of chunk r
with pass 2 of chunk r−1 over two scratch slots.  They differ in schedule
only, so they share one plain version.  Same rule as ``cuda_fft``: CPU
tensors go to the plain version, CUDA tensors to the kernel, and nothing
falls back.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..config import H100_L2_BYTES, H100_SMEM_PER_BLOCK
from ..enums import Level
from ..planner import Plan1D
from . import _build
from .cuda_fft import check_buffer, interleave, into, require_cuda, stream_of
from .torch_fft import _snap, bf_factor, complex_matmul, complex_mul, full_fp32_matmuls

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
    twiddle ``ga`` (A1, G2) and ``gb`` (128, G2)."""

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
    gb: tuple

    @property
    def a1(self) -> int:
        return self.g1 // 128

    @property
    def a2(self) -> int:
        return self.g2 // 128

    def c_args(self) -> list:
        """The arguments of the C entry points after the three buffers."""
        ptrs = [t.data_ptr() for pair in (self.w128, self.u1, self.u2,
                                          self.ga, self.gb) for t in pair]
        return [self.g1, self.g2, self.t1, self.t2, self.sign, *ptrs]


def bf_tables(plan: Plan1D, sign: int, keys: dict, arrays: dict,
              batch: int) -> BfTables:
    """Resolve one direction's tables from the bank
    (``torch_fft.collect_bank_keys``) and the launch shape."""
    g1, g2 = plan.sub[0].n, plan.sub[1].n

    def pair(key):
        name = keys[key]
        return (arrays[name + "r"], arrays[name + "i"])

    return BfTables(
        g1, g2, bf_tile(g1), bf_tile(g2), bf_chunk(plan.n, batch), sign,
        pair(("W", 128, sign)),
        pair(("U", bf_factor(g1), 128, sign)),
        pair(("U", bf_factor(g2), 128, sign)),
        pair(("GA", g1, g2, sign)), pair(("GB", g1, g2, sign)))


def _cmul_const(xr, xi, wr: float, wi: float):
    """(xr + i·xi)·(wr + i·wi) with the exact shortcuts for ±1 and ±i."""
    if wi == 0.0:
        return (xr, xi) if wr == 1.0 else (-xr, -xi) if wr == -1.0 else (
            xr * wr, xi * wr)
    if wr == 0.0:
        return (-xi, xr) if wi == 1.0 else (xi, -xr) if wi == -1.0 else (
            -xi * wi, xr * wi)
    return xr * wr - xi * wi, xr * wi + xi * wr


def butterfly(slabs: list, sign: int) -> list:
    """Radix-2 DIT over the ``len(slabs)`` (re, im) slabs: input slab j is
    the high digit iA of i = 128·iA + iB, output slab k the low frequency
    digit kA of k = kA + A·kB, both in natural order
    (``pallas_global_bf._bf_slabs``)."""
    a = len(slabs)
    if a == 1:
        return slabs
    ev, od = butterfly(slabs[0::2], sign), butterfly(slabs[1::2], sign)
    out = [None] * a
    for q in range(a // 2):
        ang = sign * 2.0 * math.pi * q / a
        tr, ti = _cmul_const(*od[q], _snap(math.cos(ang)), _snap(math.sin(ang)))
        er, ei = ev[q]
        out[q] = (er + tr, ei + ti)
        out[q + a // 2] = (er - tr, ei - ti)
    return out


def _slab_dft(slabs: list, t: BfTables, u: tuple, left: bool):
    """Butterfly over the slabs, the digit twiddle ``u`` (A, 128), and the
    128-point DFT of each output slab: over its rows (``left``, slabs of
    (b, 128, m)) or over its columns (slabs of (b, m, 128)).  Returns the
    (re, im) stacks of shape (b, A, 128, m) or (b, A, m, 128)."""
    out_r, out_i = [], []
    for k, (yr, yi) in enumerate(butterfly(slabs, t.sign)):
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


def global_bf_plain(raw: torch.Tensor, batch: int, t: BfTables, scale: float):
    """Plain version of K5 and K5-ov: their decomposition step by step on
    the whole batch (the chunking is the kernels' schedule only)."""
    g1, g2, a1, a2 = t.g1, t.g2, t.a1, t.a2
    x = raw.view(batch, g1, g2, 2)
    with full_fp32_matmuls(raw):
        xr, xi = x[..., 0], x[..., 1]  # [n1, n2], n1 = 128·iA1 + iB1
        slabs = [(xr[:, 128 * j:128 * (j + 1)], xi[:, 128 * j:128 * (j + 1)])
                 for j in range(a1)]
        zr, zi = _slab_dft(slabs, t, t.u1, left=True)  # [kA1, kB1, n2]
        zr, zi = complex_mul(zr, zi, t.ga[0][None, :, None, :],
                             t.ga[1][None, :, None, :])
        zr, zi = complex_mul(zr, zi, *t.gb)
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


def _launch(entry: str, raw, batch: int, t: BfTables, scale: float, out,
            slots: int):
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


def global_bf(raw, batch: int, t: BfTables, scale: float, out=None):
    """K5: ``batch`` GLOBAL transforms of length ``t.g1 · t.g2`` in one
    cooperative launch: per chunk of ``t.chunk`` transforms, pass 1 into
    a scratch slot, a grid-wide barrier, pass 2 into ``out`` (may be
    ``raw``), a barrier.  The wrapper allocates the scratch slot."""
    y = _launch("global_bf", raw, batch, t, scale, out, 1)
    if raw.is_cuda:
        global_bf.launches += 1
    return y


global_bf.launches = 0
global_bf.plain = global_bf_plain


def global_bf_ov(raw, batch: int, t: BfTables, scale: float, out=None):
    """K5-ov: K5's function with the phase-overlay schedule: round r runs
    pass 1 of chunk r and pass 2 of chunk r − 1 over two scratch slots,
    one grid-wide barrier a round.  No output is written before its
    transform's pass 2."""
    y = _launch("global_bf_ov", raw, batch, t, scale, out, 2)
    if raw.is_cuda:
        global_bf_ov.launches += 1
    return y


global_bf_ov.launches = 0
global_bf_ov.plain = global_bf_plain
