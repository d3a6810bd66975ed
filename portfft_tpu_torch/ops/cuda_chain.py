"""K13 ``chain``: wrappers of the CUDA kernel (``csrc/fft_chain.cu``), their
plain PyTorch versions, and the JAX package's leaf gates.

Counterpart of ``portfft_tpu/ops/pallas_fft.py`` ``fused_chain`` (a DIRECT
leaf, or a two-stage FUSED [a ≥ 8, 128] leaf) and ``_generic_chain_call``
(any factor chain): the leaves of the plane path's executor, on (re, im)
float32 planes whose last axis is the transform (:func:`chain`), and the
outer axes of the per-axis walk that the column kernel K12 declines, down
axis 1 of (b, n, trailing) planes where they lie (:func:`chain_cols`, the
one-launch modes only; the JAX package moves such an axis last and back).
Same rule as ``cuda_fft``: CPU tensors go to the plain version, CUDA
tensors to the kernel, and nothing falls back.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..enums import Level
from ..exceptions import InvalidConfiguration
from ..planner import Plan1D, stage_shapes
from ..utils import tracing
from . import _build
from .cuda_fft import SubTables, require_cuda, rows_plain, stream_of, sub_tables
from .cuda_io import check_plane
from .torch_fft import complex_matmul, complex_mul, full_fp32_matmuls

#: Longest factor chain the kernel takes (``kMaxFactors`` in fft_chain.cu).
MAX_FACTORS = 12
#: Longest chain the kernel runs in one tile; past it the first factor
#: runs as a launch of its own and the rest must fit (``kChainMax``).
CHAIN_TILE_MAX = 12288
#: Longest DIRECT or [a, 128] leaf the kernel runs in one tile
#: (``pfft::kTileMax``).
TILE_MAX = 8192
#: Fewest points (n · trailing) of the column form's widest tile that it
#: takes: its tiles are at most ``trailing`` columns wide, and below 4 points
#: a thread of a block the SMs hold too few loads in flight, so the walk's
#: copies and the row form on the moved planes cost less (H100: 640 over 2
#: columns 0.97× the walk's time, 100 over 8 1.11×, 368 over 4 0.79×).
COLS_MIN_POINTS = 1024


def leaf_mode(plan: Plan1D) -> str:
    """The JAX package's choice in ``fused_chain`` for a DIRECT or FUSED
    leaf: ``"direct"`` (one factor), ``"two_stage"`` ([a, 128], a ≥ 8) or
    ``"chain"`` (the generic chain)."""
    f = plan.factors
    if len(f) == 1:
        return "direct"
    if len(f) == 2 and f[1] == 128 and f[0] >= 8:
        return "two_stage"
    return "chain"


def chain_fits(plan: Plan1D) -> bool:
    """Whether the kernel's chain mode takes ``plan``'s factors."""
    f = plan.factors
    n = plan.n
    return 2 <= len(f) <= MAX_FACTORS and (
        n <= CHAIN_TILE_MAX or n // f[0] <= CHAIN_TILE_MAX
    )


@dataclasses.dataclass(frozen=True)
class ChainTables:
    """The device tables of one leaf: ``sub`` for the DIRECT and two-stage
    modes; for the chain, per stage ``(wr, wi, tr, ti)`` (the f×f DFT
    planes and the (m, f) twiddle planes, None at the last stage)."""

    n: int
    mode: str
    sub: SubTables | None = None
    factors: tuple = ()
    stages: tuple = ()


def chain_tables(plan: Plan1D, sign: int, keys: dict, arrays: dict) -> ChainTables:
    """Resolve a leaf's tables from the bank (``torch_fft.collect_bank_keys``)."""
    mode = leaf_mode(plan)
    if mode != "chain":
        return ChainTables(plan.n, mode, sub=sub_tables(plan, sign, keys, arrays))
    stages = []
    for f, m in stage_shapes(plan.factors):
        w = keys[("W", f, sign)]
        t = keys[("T", f, m, sign)] if m > 1 else None
        stages.append((arrays[w + "r"], arrays[w + "i"],
                       None if t is None else arrays[t + "r"],
                       None if t is None else arrays[t + "i"]))
    return ChainTables(plan.n, mode, factors=tuple(plan.factors),
                       stages=tuple(stages))


def _chain_plain(xr, xi, factors, stages):
    """The Stockham recursion of ``torch_exec.exec_chain`` on the stage
    tables."""
    (wr, wi, tr, ti), rest = stages[0], stages[1:]
    if not rest:
        return complex_matmul(xr, xi, wr, wi)
    f = factors[0]
    n = xr.shape[-1]
    m = n // f
    lead = xr.shape[:-1]
    ar, ai = complex_matmul(xr.reshape(*lead, f, m).transpose(-2, -1),
                            xi.reshape(*lead, f, m).transpose(-2, -1), wr, wi)
    ar, ai = complex_mul(ar, ai, tr, ti)
    cr, ci = _chain_plain(ar.transpose(-2, -1), ai.transpose(-2, -1),
                          factors[1:], rest)
    return (cr.transpose(-2, -1).reshape(*lead, n),
            ci.transpose(-2, -1).reshape(*lead, n))


def chain_plain(xr: torch.Tensor, xi: torch.Tensor, tabs: ChainTables):
    """Plain version of K13: ``cuda_fft.rows_plain`` (DIRECT, [a, 128]) or
    the Stockham chain, as ``torch.matmul`` calls in full float32."""
    with full_fp32_matmuls(xr):
        if tabs.mode == "chain":
            return _chain_plain(xr, xi, tabs.factors, tabs.stages)
        return rows_plain(tabs.sub, xr, xi)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _path(mode: str, n: int) -> str:
    cap = CHAIN_TILE_MAX if mode == "chain" else TILE_MAX
    return "radix" if n <= cap else "plain"


def path_of(tabs: ChainTables) -> str:
    """The kernel's code path for ``tabs``: ``"radix"`` (one launch on the
    radix stages: a chain up to ``CHAIN_TILE_MAX`` points, DIRECT or [a, 128]
    up to ``TILE_MAX``) or ``"plain"`` (plain sums, past those lengths)."""
    return _path(tabs.mode, tabs.n)


def cols_supported(plan: Plan1D, trailing: int) -> bool:
    """Whether :func:`chain_cols` takes the transform of ``plan`` down axis
    1 of (b, n, ``trailing``) planes: a DIRECT or FUSED leaf that K13 runs
    in one launch on the radix stages (:func:`path_of`), over more than one
    column (over one, the axis is contiguous and the walk copies nothing)
    and at least ``COLS_MIN_POINTS`` points a tile."""
    if (plan.level not in (Level.DIRECT, Level.FUSED) or trailing < 2
            or plan.n * trailing < COLS_MIN_POINTS):
        return False
    mode = leaf_mode(plan)
    return (mode != "chain" or chain_fits(plan)) and _path(mode, plan.n) == "radix"


def _chain_args(tabs: ChainTables) -> tuple:
    """``(nf, factors, tables)`` of a chain for the C entries."""
    nf = len(tabs.factors)
    return (nf, (ctypes.c_int * nf)(*tabs.factors),
            (ctypes.c_void_p * (4 * nf))(
                *[_ptr(t) for stage in tabs.stages for t in stage]))


_K13 = tracing.kernel("K13", ("chain_kernel", "pass_kernel", "radix_chain_kernel",
                              "radix_pass_kernel"))


@_K13
def chain(xr: torch.Tensor, xi: torch.Tensor, tabs: ChainTables):
    """K13: the ``tabs.n``-point transform of the last axis of the planes
    ``(xr, xi)``; returns new planes of the same shape.  Up to
    ``TILE_MAX`` points (DIRECT, [a, 128]) or ``CHAIN_TILE_MAX`` (chain) one
    launch on the radix stages; past them plain sums, [a, 128] and the chain
    as two launches through a scratch the size of the input.  Each launch
    counts on ``tracing.paths("K13")`` by :func:`path_of`."""
    n = tabs.n
    rows = xr.numel() // n
    check_plane(xr, rows * n, "chain")
    check_plane(xi, rows * n, "chain")
    if xr.device.type == "cpu":
        return chain_plain(xr, xi, tabs)
    require_cuda(xr, "chain")
    lib = _build.load()
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    with torch.cuda.device(xr.device):
        if tabs.mode == "chain":
            scratch = (torch.empty(2 * rows * n, dtype=torch.float32,
                                   device=xr.device)
                       if lib.pf_chain_general_needs_scratch(n) else None)
            err = lib.pf_chain_general(
                xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
                _ptr(scratch), *_chain_args(tabs), rows, stream_of(xr))
        else:
            sub = tabs.sub
            scratch = (torch.empty(2 * rows * n, dtype=torch.float32,
                                   device=xr.device)
                       if sub.a and lib.pf_chain_needs_scratch(sub.a) else None)
            err = lib.pf_chain(
                xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
                _ptr(scratch), sub.m, sub.a, *sub.pointers(), rows,
                stream_of(xr))
    _build.check(lib, err, "chain kernel")
    tracing.path("K13", path_of(tabs))
    return yr, yi


chain.plain = chain_plain


def chain_cols_plain(xr: torch.Tensor, xi: torch.Tensor, bpre: int,
                     trailing: int, tabs: ChainTables, scale: float = 1.0):
    """Plain version of K13's column form: move axis 1 of the (bpre, n,
    trailing) view last, :func:`chain_plain`, move it back, scale."""
    shape = (bpre, tabs.n, trailing)
    yr, yi = chain_plain(xr.reshape(shape).transpose(1, 2),
                         xi.reshape(shape).transpose(1, 2), tabs)
    return ((yr * scale).transpose(1, 2).contiguous().reshape(xr.shape),
            (yi * scale).transpose(1, 2).contiguous().reshape(xi.shape))


@_K13
def chain_cols(xr: torch.Tensor, xi: torch.Tensor, bpre: int, trailing: int,
               tabs: ChainTables, scale: float = 1.0):
    """K13 in column geometry: the ``tabs.n``-point transform down axis 1 of
    the (bpre, n, trailing) view of the planes, times ``scale``, in one
    launch on the radix stages (:func:`path_of` must say ``"radix"``);
    returns new planes of the input's shape.  Each launch counts on
    ``tracing.paths("K13")`` as ``"radix_col"``."""
    n = tabs.n
    numel = bpre * n * trailing
    check_plane(xr, numel, "chain_cols")
    check_plane(xi, numel, "chain_cols")
    if path_of(tabs) != "radix":
        raise InvalidConfiguration(
            f"chain_cols: {n} points in mode {tabs.mode} are past K13's one "
            "launch")
    if xr.device.type == "cpu":
        return chain_cols_plain(xr, xi, bpre, trailing, tabs, scale)
    require_cuda(xr, "chain_cols")
    lib = _build.load()
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    with torch.cuda.device(xr.device):
        if tabs.mode == "chain":
            err = lib.pf_chain_general_cols(
                xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
                *_chain_args(tabs), bpre, trailing, scale, stream_of(xr))
        else:
            sub = tabs.sub
            err = lib.pf_chain_cols(
                xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
                sub.m, sub.a, *sub.pointers(), bpre, trailing, scale,
                stream_of(xr))
    _build.check(lib, err, "chain kernel (columns)")
    tracing.path("K13", "radix_col")
    return yr, yi


chain_cols.plain = chain_cols_plain
