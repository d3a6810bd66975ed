"""K13 ``chain``: wrapper of the CUDA kernel (``csrc/fft_chain.cu``), its
plain PyTorch version, and the JAX package's leaf gates.

Counterpart of ``portfft_tpu/ops/pallas_fft.py`` ``fused_chain`` (a DIRECT
leaf, or a two-stage FUSED [a ≥ 8, 128] leaf) and ``_generic_chain_call``
(any factor chain): the leaves of the plane path's executor, on (re, im)
float32 planes whose last axis is the transform.  Same rule as
``cuda_fft``: CPU tensors go to the plain version, CUDA tensors to the
kernel, and nothing falls back.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..planner import Plan1D, stage_shapes
from . import _build
from .cuda_fft import SubTables, require_cuda, rows_plain, stream_of, sub_tables
from .cuda_io import check_plane
from .torch_fft import complex_matmul, complex_mul, full_fp32_matmuls

#: Longest factor chain the kernel takes (``kMaxFactors`` in fft_chain.cu).
MAX_FACTORS = 12
#: Longest chain the kernel runs in one tile; past it the first factor
#: runs as a launch of its own and the rest must fit (``kChainMax``).
CHAIN_TILE_MAX = 12288


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


def chain(xr: torch.Tensor, xi: torch.Tensor, tabs: ChainTables):
    """K13: the ``tabs.n``-point transform of the last axis of the planes
    ``(xr, xi)``; returns new planes of the same shape.  Past 8192 points
    ([a, 128]) or ``CHAIN_TILE_MAX`` (chain) the kernel runs as two launches
    through a scratch the size of the input."""
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
            nf = len(tabs.factors)
            scratch = (torch.empty(2 * rows * n, dtype=torch.float32,
                                   device=xr.device)
                       if lib.pf_chain_general_needs_scratch(n) else None)
            factors = (ctypes.c_int * nf)(*tabs.factors)
            tables = (ctypes.c_void_p * (4 * nf))(
                *[_ptr(t) for stage in tabs.stages for t in stage])
            err = lib.pf_chain_general(
                xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
                _ptr(scratch), nf, factors, tables, rows, stream_of(xr))
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
    chain.launches += 1
    return yr, yi


chain.launches = 0
chain.plain = chain_plain
