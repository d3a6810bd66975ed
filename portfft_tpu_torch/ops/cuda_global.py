"""K3 ``global2`` (and its factored-twiddle mode K3-ftw ``global2_ftw``), K4
``global_sq``, K16 ``global3``, K17 ``global_fused`` and K14
``global2_planes``: wrappers of the CUDA kernels
(``csrc/fft_global2.cu``, ``csrc/fft_global_sq.cu``,
``csrc/fft_global3.cu``, ``csrc/fft_global_fused.cu``,
``csrc/fft_global2_planes.cu``), their plain PyTorch versions, and the
gates of K4, K16, K17 and K14.

Counterparts of ``portfft_tpu/ops/pallas_global.py``: ``global2_raw_call``
(K3, the GLOBAL four-step n = G1·G2 on the PACKED interleaved buffer, in
two passes through a scratch buffer; with ``use_ftw``, K3-ftw, pass 1
forming its twiddle from the resident factored tables ``Q``/``ZQ``, the
tuned engine ``{"eng": 2, "ftw": 1}``), ``global_sq_raw_call`` (K4, the same
function in one pass, the transform held on chip between its stages; the
tuned engine ``{"eng": 5}``), ``pallas_global3.build_call`` (K16, the same
function in two passes on the tensor cores, its twiddle from resident
factored tables; the tuned engine ``{"eng": 3}``), ``global_fused_raw_call``
(K17, K3's function in one cooperative launch on the radix stages of
``csrc/fft_radix.cuh``, whose intermediate stays in L2, its twiddle dense or
factored; ``{"eng": 6}`` and ``{"eng": 6, "ftw": 1}``) and ``global2_call`` (K14, K3's two passes on
(re, im) float32 planes, with an optional ``post`` table multiplied in
pass 2; the plane path's GLOBAL nodes and its Bluestein convolutions).
Same rule as ``cuda_fft``: CPU tensors go to the plain version, CUDA
tensors to the kernel, and nothing falls back.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import H100_CLUSTER, H100_SMEM_PER_BLOCK
from ..enums import Level
from ..exceptions import InvalidConfiguration
from ..planner import Plan1D
from ..utils import tracing
from . import _build
from .cuda_fft import (
    SubTables,
    check_buffer,
    interleave,
    into,
    require_cuda,
    rows_plain,
    stream_of,
    sub_tables,
)
from .cuda_global_bf import bf_chunk
from .cuda_io import check_plane
from .cuda_multidim import _lane_dft_shape, column_dft_x3
from .torch_fft import (
    FTW_T1,
    GLOBAL3_T1,
    complex_mul,
    dft_x3,
    ftw_factors,
    full_fp32_matmuls,
    global3_digits,
    is_two_stage,
    radix_sub_plain,
)


def global2_supported(plan: Plan1D, max_direct: int) -> bool:
    """``pallas_global.global2_supported``: a GLOBAL plan whose subs are
    DIRECT (≤ ``max_direct``, a multiple of 8) or FUSED [a, 128] with
    a | 128 — the plans the JAX package's plane GLOBAL kernel takes, and
    K14 with them.  The reference's ``global2_call`` also declines where
    no lane tile fits its planning VMEM (``_pick_tile``: every FUSED sub of
    2048 points or more, and [8, 128] beside most other subs); that is a
    budget of the TPU's VMEM, and K14's tiles take those subs (a [128, 128]
    sub in two launches), so the port runs K14 there too."""
    if plan.level != Level.GLOBAL:
        return False
    return all(
        (s.n <= max_direct and s.n % 8 == 0) if s.level == Level.DIRECT
        else _lane_dft_shape(s)
        for s in plan.sub
    )


def global2_plain(
    raw: torch.Tensor, batch: int, sub1: SubTables, sub2: SubTables,
    tr: torch.Tensor, ti: torch.Tensor, scale: float,
):
    """Plain version of K3, the same two passes:
    pass 1 ``S[b, n2, k1] = (G1-point transform of x[b, :, n2])[k1] ·
    T[n2, k1]``; pass 2 ``out[b, k1 + G1·k2] = scale ·
    (G2-point transform of S[b, :, k1])[k2]``."""
    g1, g2 = sub1.m, sub2.m
    x = raw.view(batch, g1, g2, 2).transpose(1, 2)  # [b, n2, n1]
    with full_fp32_matmuls(raw):
        sr, si = rows_plain(sub1, x[..., 0], x[..., 1])
        sr, si = complex_mul(sr, si, tr, ti)  # T stored (g2, g1) = [n2, k1]
        cr, ci = rows_plain(sub2, sr.transpose(1, 2), si.transpose(1, 2))
    return interleave(cr.transpose(1, 2), ci.transpose(1, 2), scale)


@tracing.kernel("K3", ("global2_kernel",))
def global2(
    raw, batch: int, sub1: SubTables, sub2: SubTables, tr, ti, scale: float,
    out=None,
):
    """K3: ``batch`` GLOBAL transforms of length ``sub1.m · sub2.m``.
    ``tr``/``ti`` are the bank's (G2, G1) inter-pass twiddle planes.  The
    wrapper allocates the scratch buffer (the size of the input)."""
    check_buffer(raw, 2 * batch * sub1.m * sub2.m, "global2")
    if raw.device.type == "cpu":
        return into(out, global2_plain(raw, batch, sub1, sub2, tr, ti, scale))
    require_cuda(raw, "global2")
    lib = _build.load()
    y = torch.empty_like(raw) if out is None else out
    scratch = torch.empty_like(raw)
    with torch.cuda.device(raw.device):
        err = lib.pf_global2(
            raw.data_ptr(), y.data_ptr(), scratch.data_ptr(),
            sub1.m, sub1.a, *sub1.pointers(), sub2.m, sub2.a, *sub2.pointers(),
            tr.data_ptr(), ti.data_ptr(), batch, scale, stream_of(raw),
        )
    _build.check(lib, err, "global2 kernel")
    return y


global2.plain = global2_plain


# -- K3-ftw global2_ftw ------------------------------------------------------------


def global2_ftw_supported(plan: Plan1D) -> bool:
    """K3-ftw's gate: a plan K3 takes whose factored tables exist
    (``torch_fft.ftw_factors``: a DIRECT G1 with 128 | G1 or a FUSED
    [a, 128] G1 with a | 128, and 64 | G2).  Pass 1's tile then has a
    power-of-two width that divides the tables' 64 columns.  The JAX
    package's ``global2_raw_call`` takes the same plans, falling back to
    its dense twiddle (silently) where the tables are missing."""
    return ftw_factors(plan) is not None


@dataclasses.dataclass(frozen=True)
class Global2FtwTables:
    """One direction's K3-ftw tables: the subs and ``q``, the four (re, im)
    pairs of the factored tables "1" … "4" (the JAX package's ``Q`` for a
    DIRECT G1, ``ZQ`` for a FUSED one, at ``FTW_T1`` columns), with their
    (L, H) ``factors``; no dense twiddle (``tw``), as K17's factored mode."""

    n: int
    sub1: SubTables
    sub2: SubTables
    q: tuple
    factors: tuple
    tw: tuple = ()


def global2_ftw_tables(plan: Plan1D, sign: int, keys: dict,
                       arrays: dict) -> Global2FtwTables:
    """Resolve one direction's K3-ftw tables from the bank
    (``torch_fft.collect_bank_keys``)."""
    g1, g2 = plan.sub
    key = (("Q", g1.n, plan.n, sign, FTW_T1) if g1.level == Level.DIRECT
           else ("ZQ", g1.n, g2.n, sign, FTW_T1))
    q = keys[key]
    return Global2FtwTables(
        plan.n, sub_tables(g1, sign, keys, arrays), sub_tables(g2, sign, keys, arrays),
        tuple((arrays[f"{q}{j}r"], arrays[f"{q}{j}i"]) for j in "1234"),
        ftw_factors(plan))


def global2_ftw_plain(raw: torch.Tensor, batch: int, t: Global2FtwTables,
                      scale: float) -> torch.Tensor:
    """Plain version of K3-ftw: K3's two passes, pass 1's twiddle the
    factors of ``fused_twiddle`` (C1 then C2, each a float32 product of an
    A and a B table) multiplied in turn."""
    g1, g2 = t.sub1.m, t.sub2.m
    x = raw.view(batch, g1, g2, 2).transpose(1, 2)  # [b, n2, n1]
    with full_fp32_matmuls(raw):
        sr, si = rows_plain(t.sub1, x[..., 0], x[..., 1])
        for wr, wi in fused_twiddle(t):
            sr, si = complex_mul(sr, si, wr, wi)
        cr, ci = rows_plain(t.sub2, sr.transpose(1, 2), si.transpose(1, 2))
    return interleave(cr.transpose(1, 2), ci.transpose(1, 2), scale)


@tracing.kernel("K3-ftw", ("global2_ftw_kernel", "global2_kernel"))
def global2_ftw(raw, batch: int, t: Global2FtwTables, scale: float, out=None):
    """K3-ftw: K3 (``global2``) with pass 1's twiddle formed in the kernel
    from the factored tables ``t.q`` (``csrc/fft_ftw.cuh``, shared with
    K17's factored mode); no dense twiddle is read.  The wrapper allocates
    the scratch buffer (the size of the input)."""
    check_buffer(raw, 2 * batch * t.n, "global2_ftw")
    if raw.device.type == "cpu":
        return into(out, global2_ftw_plain(raw, batch, t, scale))
    require_cuda(raw, "global2_ftw")
    lib = _build.load()
    y = torch.empty_like(raw) if out is None else out
    scratch = torch.empty_like(raw)
    with torch.cuda.device(raw.device):
        err = lib.pf_global2_ftw(
            raw.data_ptr(), y.data_ptr(), scratch.data_ptr(),
            t.sub1.m, t.sub1.a, *t.sub1.pointers(),
            t.sub2.m, t.sub2.a, *t.sub2.pointers(),
            *[p.data_ptr() for pair in t.q for p in pair],
            batch, scale, stream_of(raw))
    _build.check(lib, err, "global2_ftw kernel")
    return y


global2_ftw.plain = global2_ftw_plain


# -- K4 global_sq ----------------------------------------------------------------

#: K4's block: 512 threads, each holding up to 32 points of stage A's result
#: in registers, so one block of a cluster holds at most 16384 points.
SQ_THREADS = 512
SQ_BLOCK_POINTS = 16384


def sq_cluster(plan: Plan1D) -> int:
    """The cluster size K4 runs ``plan`` with, or 0 where its gate declines.
    The whole transform stays in the shared memory of one thread-block
    cluster: C blocks (the least power of two with C·16384 ≥ n), each
    holding n/C points, its rows' tail and both root tables.  Declined: a
    plan that is not GLOBAL with two DIRECT subs; C past the portable
    cluster size (``config.H100_CLUSTER``, 8, so n ≤ 2^17); a block's
    share past ``config.H100_SMEM_PER_BLOCK``; shapes whose per-thread
    groups of four outputs do not share their input (512 not a multiple
    of G1/C or G2/C, n/C not a multiple of 2048).  Counterpart of
    ``pallas_global.global_sq_supported``, whose own budget is the TPU's
    VMEM and which also takes FUSED [a, 128] subs."""
    if plan.level != Level.GLOBAL:
        return 0
    g1p, g2p = plan.sub
    if g1p.level != Level.DIRECT or g2p.level != Level.DIRECT:
        return 0
    g1, g2 = g1p.n, g2p.n
    c = 1
    while c * SQ_BLOCK_POINTS < plan.n:
        c *= 2
    if c > H100_CLUSTER or g1 % c or g2 % c:
        return 0
    e, rows, cols = plan.n // c, g1 // c, g2 // c
    if e % (4 * SQ_THREADS) or SQ_THREADS % rows or SQ_THREADS % cols:
        return 0
    return c if 8 * (g1 + g2 + e + rows) <= H100_SMEM_PER_BLOCK else 0


def global_sq_supported(plan: Plan1D) -> bool:
    """K4's gate (``sq_cluster``)."""
    return sq_cluster(plan) > 0


@tracing.kernel("K4", ("global_sq_kernel",))
def global_sq(
    raw, batch: int, sub1: SubTables, sub2: SubTables, tr, ti, scale: float,
    out=None,
):
    """K4: ``batch`` GLOBAL transforms of length ``sub1.m · sub2.m`` in one
    launch, each held whole in one thread-block cluster between its two
    sub-transform stages (``csrc/fft_global_sq.cu``).  The same function
    and arguments as K3 (``global2``), so its plain version is K3's.  The
    subs must be DIRECT; the kernel checks its cluster shape and returns an
    error where the plan is outside ``sq_cluster``'s gate."""
    check_buffer(raw, 2 * batch * sub1.m * sub2.m, "global_sq")
    if raw.device.type == "cpu":
        return into(out, global2_plain(raw, batch, sub1, sub2, tr, ti, scale))
    require_cuda(raw, "global_sq")
    if sub1.a or sub2.a:
        raise InvalidConfiguration("global_sq: the subs must be DIRECT")
    lib = _build.load()
    y = torch.empty_like(raw) if out is None else out
    with torch.cuda.device(raw.device):
        err = lib.pf_global_sq(
            raw.data_ptr(), y.data_ptr(), sub1.m, sub1.wr.data_ptr(),
            sub1.wi.data_ptr(), sub2.m, sub2.wr.data_ptr(), sub2.wi.data_ptr(),
            tr.data_ptr(), ti.data_ptr(), batch, scale, stream_of(raw),
        )
    _build.check(lib, err, "global_sq kernel")
    return y


global_sq.plain = global2_plain


# -- K16 global3 ------------------------------------------------------------------

def global3_supported(plan: Plan1D) -> bool:
    """K16's gate: the JAX package's ``global3_supported`` (G1 DIRECT ≤ 512
    or FUSED [a, 128]; G2 DIRECT ≤ 512; 128 | G1 and 128 | G2).  Both
    passes of every such plan fit the H100's shared memory a block (the
    largest, pass 1 of a FUSED [16, 128] G1, about 141 KiB; the launch
    refuses a block past it)."""
    return global3_digits(plan) is not None


@dataclasses.dataclass(frozen=True)
class Global3Tables:
    """The device tables of one direction of a K16 plan: the subs, the
    twiddle digits (ga, gb), and the bank's pair-expanded factors B1
    (ga, 2·64) and B2 (gb, 2·64), each an (re, im) pair."""

    n: int
    sign: int
    sub1: SubTables
    sub2: SubTables
    ga: int
    gb: int
    b1: tuple
    b2: tuple


def global3_tables(plan: Plan1D, sign: int, keys: dict,
                   arrays: dict) -> Global3Tables:
    """Resolve one direction's K16 tables from the bank
    (``torch_fft.collect_bank_keys``)."""
    g1, g2 = plan.sub
    k = keys[("G3", g1.n, g2.n, sign)]
    return Global3Tables(
        plan.n, sign, sub_tables(g1, sign, keys, arrays),
        sub_tables(g2, sign, keys, arrays), *global3_digits(plan),
        (arrays[k + "1r"], arrays[k + "1i"]), (arrays[k + "2r"], arrays[k + "2i"]))


def global3_twiddle(t: Global3Tables) -> tuple[torch.Tensor, torch.Tensor]:
    """K16's pass-1 twiddle w_n^(k1·n2) as the kernel forms it, (G1, G2)
    [k1, n2]: with n2 = m2 + n2b (n2b < 64) and k1 = k1_lo + ga·k1_hi,
    (A_lo·B1[k1_lo, n2b]) and (A_hi·B2[k1_hi, n2b]) in float32, A_lo =
    w_n^(k1_lo·m2) and A_hi = w_(n/ga)^(k1_hi·m2) from float64 angles of
    the exponents reduced mod the root order (the kernel's per-tile
    factors)."""
    g2 = t.sub2.m
    dev = t.b1[0].device
    n2 = torch.arange(g2, dtype=torch.int64, device=dev)
    m2, n2b = n2 - n2 % GLOBAL3_T1, n2 % GLOBAL3_T1

    def factor(count, root, b):
        k = torch.arange(count, dtype=torch.int64, device=dev)[:, None]
        theta = (2.0 * torch.pi / root) * ((k * m2) % root).to(torch.float64)
        ar = torch.cos(theta).float()
        ai = (t.sign * torch.sin(theta)).float()
        return complex_mul(ar, ai, b[0][:, 0::2][:, n2b], b[1][:, 0::2][:, n2b])

    c1r, c1i = factor(t.ga, t.n, t.b1)  # (ga, G2)
    c2r, c2i = factor(t.gb, t.n // t.ga, t.b2)  # (gb, G2)
    lo = torch.arange(t.sub1.m, device=dev) % t.ga
    hi = torch.arange(t.sub1.m, device=dev) // t.ga
    return (c1r[lo], c1i[lo]), (c2r[hi], c2i[hi])


def global3_plain(raw: torch.Tensor, batch: int, t: Global3Tables,
                  scale: float) -> torch.Tensor:
    """Plain version of K16, its two passes with the TF32 hi/lo rounding
    emulated: pass 1 ``S[b, k1, n2] = (G1-point column transform of
    x[b, :, n2])[k1] · C1 · C2`` (``global3_twiddle``'s factors in turn);
    pass 2 ``out[b, k1 + G1·k2] = scale · (G2-point transform of
    S[b, k1, :])[k2]``."""
    g1, g2 = t.sub1.m, t.sub2.m
    x = raw.view(batch, g1, g2, 2)
    (c1r, c1i), (c2r, c2i) = global3_twiddle(t)
    with full_fp32_matmuls(raw):
        sr, si = column_dft_x3(t.sub1, x[..., 0], x[..., 1])  # [k1, n2]
        sr, si = complex_mul(sr, si, c1r, c1i)
        sr, si = complex_mul(sr, si, c2r, c2i)
        cr, ci = dft_x3(t.sub2.wr, t.sub2.wi, sr.transpose(1, 2),
                        si.transpose(1, 2))  # [k2, k1]
    return interleave(cr, ci, scale)


@tracing.kernel("K16", ("g3_pass1", "g3_pass2"))
def global3(raw, batch: int, t: Global3Tables, scale: float, out=None):
    """K16: ``batch`` GLOBAL transforms of length ``t.n`` in two launches on
    the tensor cores (``csrc/fft_global3.cu``).  The wrapper allocates the
    scratch buffer S (the size of the input); ``out`` may be ``raw``."""
    check_buffer(raw, 2 * batch * t.n, "global3")
    if raw.device.type == "cpu":
        return into(out, global3_plain(raw, batch, t, scale))
    require_cuda(raw, "global3")
    if t.sub2.a:
        raise InvalidConfiguration("global3: the second sub must be DIRECT")
    lib = _build.load()
    y = torch.empty_like(raw) if out is None else out
    scratch = torch.empty_like(raw)
    s1 = t.sub1
    with torch.cuda.device(raw.device):
        err = lib.pf_global3(
            raw.data_ptr(), y.data_ptr(), scratch.data_ptr(), s1.m, s1.a,
            *s1.pointers(), t.sub2.m, t.sub2.wr.data_ptr(),
            t.sub2.wi.data_ptr(), t.b1[0].data_ptr(), t.b1[1].data_ptr(),
            t.b2[0].data_ptr(), t.b2[1].data_ptr(), t.ga, t.gb, t.sign, batch,
            scale, stream_of(raw))
    _build.check(lib, err, "global3 kernel")
    return y


global3.plain = global3_plain


# -- K17 global_fused ------------------------------------------------------------

def fused_tile(m: int, ncols: int) -> int:
    """Columns per tile of a K17 pass of m-point columns over ``ncols``
    columns: K3's width (``pick_tile`` in ``csrc/fft_common.cuh``: about
    4096 elements, at most 8 columns) rounded down to a power of two, so
    that it divides ``FTW_T1``."""
    t = max(1, min(4096 // m, 8, ncols))
    return 1 << (t.bit_length() - 1)


def _pass_elems(sub: Plan1D, t: int) -> tuple[int, int]:
    """(roots, tile elements) of one pass's shared memory, in float2
    (``pass_smem_bytes`` in ``csrc/fft_common.cuh``)."""
    fused = is_two_stage(sub)
    roots = sub.factors[0] + 128 if fused else sub.n
    rows = sub.n + sub.n // 128 if fused else sub.n
    return roots, rows * (t + 1 if t > 1 else 1)


def global_fused_smem(plan: Plan1D, ftw: bool = False) -> int:
    """K17's dynamic shared memory in bytes: both passes' root tables, two
    tiles of the larger pass (each pass at its own width, ``fused_tile``),
    and in the factored mode the per-tile factors C1 and C2, (L + H)·T1
    float2 (``ftw_factors``)."""
    g1, g2 = plan.sub
    r1, e1 = _pass_elems(g1, fused_tile(g1.n, g2.n))
    r2, e2 = _pass_elems(g2, fused_tile(g2.n, g1.n))
    extra = sum(ftw_factors(plan)) * fused_tile(g1.n, g2.n) if ftw else 0
    return 8 * (r1 + r2 + 2 * max(e1, e2) + extra)


def global_fused_supported(plan: Plan1D, ftw: bool = False) -> bool:
    """K17's gate: a GLOBAL plan whose subs are DIRECT or FUSED [a, 128]
    (K3's subs) with both passes' tiles in ``config.H100_SMEM_PER_BLOCK``
    (``global_fused_smem``); the factored mode (``ftw``) also needs the
    factored tables (``torch_fft.ftw_factors``: a DIRECT G1 with 128 | G1
    or a FUSED [a, 128] G1 with a | 128, and 64 | G2).  The JAX package's
    ``global_fused_supported`` asks 128 | G1 and 128 | G2, subs its lane
    DFT solves and its VMEM estimate for the whole (G2, G1) intermediate;
    here the intermediate lives in L2, so none of those applies."""
    if plan.level != Level.GLOBAL:
        return False
    if not all(s.level == Level.DIRECT or is_two_stage(s) for s in plan.sub):
        return False
    if ftw and not ftw_factors(plan):
        return False
    return global_fused_smem(plan, ftw) <= H100_SMEM_PER_BLOCK


@dataclasses.dataclass(frozen=True)
class GlobalFusedTables:
    """One direction's K17 tables and launch shape: the subs, the tile
    widths of the two passes, the chunk, and the pass-1 twiddle: ``tw``,
    the dense (G2, G1) [n2, k1] pair (``{"eng": 6}``), or ``q``, the four
    (re, im) pairs of the factored tables "1" … "4" (the JAX package's
    ``Q`` for a DIRECT G1, ``ZQ`` for a FUSED one, at ``FTW_T1`` columns;
    ``{"eng": 6, "ftw": 1}``)."""

    n: int
    sub1: SubTables
    sub2: SubTables
    t1: int
    t2: int
    chunk: int
    tw: tuple = ()
    q: tuple = ()
    factors: tuple = ()  # (L, H) of ``q``, ``torch_fft.ftw_factors``


def global_fused_tables(plan: Plan1D, sign: int, keys: dict, arrays: dict,
                        batch: int, ftw: bool = False) -> GlobalFusedTables:
    """Resolve one direction's K17 tables from the bank
    (``torch_fft.collect_bank_keys``) and the launch shape."""
    g1, g2 = plan.sub
    subs = (sub_tables(g1, sign, keys, arrays), sub_tables(g2, sign, keys, arrays))
    shape = (fused_tile(g1.n, g2.n), fused_tile(g2.n, g1.n),
             bf_chunk(plan.n, batch))
    if not ftw:
        t = keys[("T", g1.n, g2.n, sign)]
        return GlobalFusedTables(plan.n, *subs, *shape,
                                 tw=(arrays[t + "r"], arrays[t + "i"]))
    key = (("Q", g1.n, plan.n, sign, FTW_T1) if g1.level == Level.DIRECT
           else ("ZQ", g1.n, g2.n, sign, FTW_T1))
    q = keys[key]
    return GlobalFusedTables(plan.n, *subs, *shape, q=tuple(
        (arrays[f"{q}{j}r"], arrays[f"{q}{j}i"]) for j in "1234"),
        factors=ftw_factors(plan))


def fused_twiddle(t) -> list[tuple]:
    """K17's (``GlobalFusedTables``) or K3-ftw's (``Global2FtwTables``)
    pass-1 twiddle as the kernel applies it, a list of (G2, G1)
    [n2, k1] (re, im) factors multiplied in turn: the dense table, or with
    n2 = FTW_T1·ti + n2b and k1 = lo + L·hi the factors C1[n2, lo] =
    A1[ti, lo]·B1[n2b, lo] and C2[n2, hi] = A2[ti, c]·B2[n2b, c], each a
    float32 product (A = tables "3", "4"; B = "1", "2"), where c = hi for a
    DIRECT G1 and c = σ⁻¹(hi) = (hi mod g)·a + hi div g, g = 128/a, for a
    FUSED [a, 128] G1 (the reference's fold order)."""
    if t.tw:
        return [t.tw]
    g1, g2 = t.sub1.m, t.sub2.m
    (b1, b2, a1, a2), (lo_n, hi_n) = t.q, t.factors
    dev = b1[0].device
    n2 = torch.arange(g2, device=dev)
    ti, n2b = n2 // FTW_T1, n2 % FTW_T1
    hi = torch.arange(hi_n, device=dev)
    if t.sub1.a:
        g = 128 // t.sub1.a
        hi = (hi % g) * t.sub1.a + hi // g
    k1 = torch.arange(g1, device=dev)

    def factor(a, b, cols, idx):
        cr, ci = complex_mul(a[0][ti][:, cols], a[1][ti][:, cols],
                             b[0][n2b][:, cols], b[1][n2b][:, cols])
        return cr[:, idx], ci[:, idx]

    lo = torch.arange(lo_n, device=dev)
    return [factor(a1, b1, lo, k1 % lo_n), factor(a2, b2, hi, k1 // lo_n)]


def global_fused_plain(raw: torch.Tensor, batch: int, t: GlobalFusedTables,
                       scale: float) -> torch.Tensor:
    """Plain version of K17 on the radix stages of ``csrc/fft_radix.cuh``
    (``torch_fft.radix_sub_plain``), ``t.chunk`` transforms at a time: pass
    1 ``S[b, n2, k1] = (G1-point transform of x[b, :, n2])[k1]`` times the
    twiddle factors of ``fused_twiddle`` in turn; pass 2 ``out[b, k1 +
    G1·k2] = scale · (G2-point transform of S[b, :, k1])[k2]``."""
    g1, g2 = t.sub1.m, t.sub2.m
    x = torch.view_as_complex(raw.view(batch, g1, g2, 2))
    factors = [torch.complex(wr, wi) for wr, wi in fused_twiddle(t)]
    out = []
    with full_fp32_matmuls(raw):
        for b0 in range(0, batch, t.chunk):
            s = radix_sub_plain(t.sub1, x[b0:b0 + t.chunk].transpose(1, 2))
            for w in factors:  # [n2, k1]
                s = s * w
            c = radix_sub_plain(t.sub2, s.transpose(1, 2)) * scale  # [b, k1, k2]
            out.append(torch.view_as_real(c.transpose(1, 2).contiguous()).reshape(-1))
    return torch.cat(out)


@tracing.kernel("K17", ("fused_kernel",))
def global_fused(raw, batch: int, t: GlobalFusedTables, scale: float, out=None):
    """K17: ``batch`` GLOBAL transforms of length ``t.n`` in one cooperative
    launch (``csrc/fft_global_fused.cu``): K3's pass 1 of each transform
    into one of ``t.chunk`` scratch slots sized to stay in L2, K3's pass 2
    from it into ``out`` (may be ``raw``), scheduled by a ticket and
    per-transform arrival counters instead of grid barriers.  The wrapper
    allocates the scratch and the counters."""
    check_buffer(raw, 2 * batch * t.n, "global_fused")
    if raw.device.type == "cpu":
        return into(out, global_fused_plain(raw, batch, t, scale))
    require_cuda(raw, "global_fused")
    lib = _build.load()
    y = torch.empty_like(raw) if out is None else out
    scratch = torch.empty(2 * t.chunk * t.n, dtype=torch.float32,
                          device=raw.device)
    counters = torch.empty(1 + 2 * batch, dtype=torch.int64, device=raw.device)
    tw = [p.data_ptr() for p in t.tw] if t.tw else [None, None]
    q = ([p.data_ptr() for pair in t.q for p in pair] if t.q else [None] * 8)
    with torch.cuda.device(raw.device):
        err = lib.pf_global_fused(
            raw.data_ptr(), y.data_ptr(), scratch.data_ptr(),
            counters.data_ptr(), t.sub1.m, t.sub1.a, *t.sub1.pointers(),
            t.sub2.m, t.sub2.a, *t.sub2.pointers(), t.t1, t.t2, *tw, *q,
            batch, t.chunk, scale, stream_of(raw))
    _build.check(lib, err, "global_fused kernel")
    return y


global_fused.plain = global_fused_plain


# -- K14 global2_planes --------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Global2Tables:
    """The device tables of one direction of a K14 plan: the two subs and
    the (G2, G1) inter-pass twiddle ``tw`` (an (re, im) pair)."""

    n: int
    sub1: SubTables
    sub2: SubTables
    tw: tuple


def global2_tables(plan: Plan1D, sign: int, keys: dict,
                   arrays: dict) -> Global2Tables:
    """Resolve one direction's tables from the bank
    (``torch_fft.collect_bank_keys``)."""
    g1, g2 = plan.sub
    t = keys[("T", g1.n, g2.n, sign)]
    return Global2Tables(plan.n, sub_tables(g1, sign, keys, arrays),
                         sub_tables(g2, sign, keys, arrays),
                         (arrays[t + "r"], arrays[t + "i"]))


def global2_planes_plain(xr: torch.Tensor, xi: torch.Tensor, t: Global2Tables,
                         scale: float = 1.0, post: tuple | None = None):
    """Plain version of K14, the same two passes as ``global2_plain`` on
    (b, n) planes, with ``post`` (a (G1, G2) [k1, k2] pair) multiplied in
    pass 2 before the scale."""
    g1, g2 = t.sub1.m, t.sub2.m
    b = xr.numel() // t.n
    with full_fp32_matmuls(xr):
        sr, si = rows_plain(t.sub1, xr.reshape(b, g1, g2).transpose(1, 2),
                            xi.reshape(b, g1, g2).transpose(1, 2))
        sr, si = complex_mul(sr, si, *t.tw)  # (b, g2, g1) [n2, k1]
        cr, ci = rows_plain(t.sub2, sr.transpose(1, 2), si.transpose(1, 2))
    if post is not None:
        cr, ci = complex_mul(cr, ci, *post)  # (b, g1, g2) [k1, k2]
    yr = (cr * scale).transpose(1, 2).reshape(b, t.n)
    yi = (ci * scale).transpose(1, 2).reshape(b, t.n)
    return yr.contiguous(), yi.contiguous()


@tracing.kernel("K14", ("sliced_kernel",))
def global2_planes(xr: torch.Tensor, xi: torch.Tensor, t: Global2Tables,
                   scale: float = 1.0, post: tuple | None = None):
    """K14: the ``t.n``-point GLOBAL transform of each row of the (re, im)
    planes, with ``post`` (the (G1, G2) pair the Bluestein convolution
    folds in, or None) and ``scale`` in pass 2; returns new (b, n) planes.
    Two launches through a float2 scratch the size of the input, four when
    a sub is longer than one tile (FUSED [128, 128]: a second scratch)."""
    n = t.n
    b = xr.numel() // n
    check_plane(xr, b * n, "global2_planes")
    check_plane(xi, b * n, "global2_planes")
    if xr.device.type == "cpu":
        return global2_planes_plain(xr, xi, t, scale, post)
    require_cuda(xr, "global2_planes")
    lib = _build.load()
    yr = torch.empty((b, n), dtype=torch.float32, device=xr.device)
    yi = torch.empty_like(yr)
    s = torch.empty(2 * b * n, dtype=torch.float32, device=xr.device)
    q = (torch.empty_like(s)
         if lib.pf_global2_planes_needs_scratch(t.sub1.m, t.sub2.m) else None)
    if post is not None:
        check_plane(post[0], n, "global2_planes post")
        check_plane(post[1], n, "global2_planes post")
    pr, pi = (None, None) if post is None else (post[0].data_ptr(),
                                                post[1].data_ptr())
    with torch.cuda.device(xr.device):
        err = lib.pf_global2_planes(
            xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            s.data_ptr(), None if q is None else q.data_ptr(),
            t.sub1.m, t.sub1.a, *t.sub1.pointers(),
            t.sub2.m, t.sub2.a, *t.sub2.pointers(),
            t.tw[0].data_ptr(), t.tw[1].data_ptr(), pr, pi, b, scale,
            stream_of(xr))
    _build.check(lib, err, "global2_planes kernel")
    return yr, yi


global2_planes.plain = global2_planes_plain
