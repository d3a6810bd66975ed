"""K10 ``col`` and K11 ``md2``: wrappers of the CUDA kernels
(``csrc/fft_col.cu``, ``csrc/fft_md2.cu``), their plain PyTorch versions,
and the multi-dimensional registry's gates.

Counterparts of ``portfft_tpu/ops/pallas_multidim.py``: ``col_raw_call``
(K10, the FFT over a non-contiguous axis of the PACKED interleaved buffer
viewed as ``(bpre, L, rest)`` complex elements; also the whole
BATCH_INTERLEAVED 1D transform) and ``md2_fused_raw_call`` (K11, both
trailing axes of ``(batch, n1, n2)`` in one launch).  Same rule as
``cuda_fft``: CPU tensors go to the plain version, CUDA tensors to the
kernel, and nothing falls back.

The gates (``col_axis_supported``, ``md2_supported`` and the tile
estimates under them) are the JAX package's own, copied here so that the
port routes every descriptor as the reference does and the parity tests
compare the same kernel sequence.  Their byte counts are the TPU kernels'
VMEM working sets against the reference's 16 MiB planning VMEM
(``config.DeviceConfig.vmem_bytes``): a routing rule, not a property of the
card.  Re-deriving the gate for Hopper is ROADMAP Queue 1 item 3.
"""

from __future__ import annotations

import torch

from ..enums import Level
from ..planner import Plan1D
from . import _build
from .cuda_fft import (
    SubTables,
    check_buffer,
    interleave,
    into,
    require_cuda,
    rows_plain,
    stream_of,
)
from .torch_fft import full_fp32_matmuls

# -- gates (pallas_multidim.py, pallas_global.py) -----------------------------


def _lane_dft_shape(plan: Plan1D) -> bool:
    """DIRECT, or FUSED [a, 128] with a | 128."""
    if plan.level == Level.DIRECT:
        return True
    f = plan.factors
    return (
        plan.level == Level.FUSED and len(f) == 2 and f[1] == 128
        and 128 % f[0] == 0
    )


def col_axis_supported(plan: Plan1D, max_direct: int = 512) -> bool:
    """The column kernel takes DIRECT up to ``max_direct`` and FUSED
    [a, 128] with a | 128 (``pallas_multidim.col_axis_supported``)."""
    if plan.level == Level.DIRECT:
        return plan.n <= max_direct
    return _lane_dft_shape(plan)


def pass_est_bytes(sub_lane: Plan1D, n_lane: int, t: int) -> int:
    """``pallas_global.pass_est_bytes``: the reference's VMEM estimate of
    one pass at tile width ``t``."""
    e = t * n_lane * 4
    if sub_lane.level != Level.DIRECT:
        a = sub_lane.factors[0]
        return 18 * e + 2 * 128 * a * max(t, 128) * 4
    return 14 * e


def pick_tile(g_other: int, sub_lane: Plan1D, n_lane: int, vmem: int,
              cap: int, step: int) -> int:
    """``pallas_global._pick_tile``: the largest multiple of ``step`` up to
    ``cap`` dividing ``g_other`` (else ``g_other`` itself) whose estimate
    fits ``vmem``; 0 when none does."""
    t = min(cap, g_other)
    t -= t % step
    while t >= step:
        if g_other % t == 0 and pass_est_bytes(sub_lane, n_lane, t) <= vmem:
            return t
        t -= step
    if pass_est_bytes(sub_lane, n_lane, g_other) <= vmem:
        return g_other
    return 0


def md2_est_bytes(plan1: Plan1D, plan2: Plan1D, t1: int, t2: int) -> int:
    """``pallas_multidim.md2_est_bytes``: the (n2, n1) scratch planes plus
    the larger phase's working set."""
    planes = 2 * plan1.n * plan2.n * 4
    return planes + max(
        pass_est_bytes(plan1, plan1.n, t1), pass_est_bytes(plan2, plan2.n, t2)
    )


def md2_pick_tiles(plan1: Plan1D, plan2: Plan1D, config):
    """``pallas_multidim.md2_pick_tiles`` on its default path (slack 1,
    tile caps of at least 128; the smaller caps are its autotuner's): the
    first (t1, t2) pair whose joint estimate fits the VMEM, or None."""
    n1, n2 = plan1.n, plan2.n
    vmem = config.vmem_bytes
    for cap1, cap2 in ((256, 128), (128, 128)):
        t1 = pick_tile(n2, plan1, n1, vmem, cap1, 64)
        t2 = pick_tile(n1, plan2, n2, vmem, cap2, 64)
        if t1 and t2 and md2_est_bytes(plan1, plan2, t1, t2) <= vmem:
            return t1, t2
    return None


def md2_supported(plan1: Plan1D, plan2: Plan1D, config) -> bool:
    """``pallas_multidim.md2_supported`` at the default slack: both axes
    DIRECT or FUSED [a, 128] with a | 128, both lengths multiples of 128,
    and a tile pair that fits."""
    for plan in (plan1, plan2):
        if not _lane_dft_shape(plan) or plan.n % 128:
            return False
    return md2_pick_tiles(plan1, plan2, config) is not None


# -- K10 col -------------------------------------------------------------------


def col_plain(raw: torch.Tensor, bpre: int, rest: int, sub: SubTables,
              scale: float):
    """Plain version of K10: move L to the last axis, ``rows_plain``,
    move it back, scale and interleave."""
    x = raw.view(bpre, sub.m, rest, 2).transpose(1, 2)  # [b, c, j]
    with full_fp32_matmuls(raw):
        yr, yi = rows_plain(sub, x[..., 0], x[..., 1])
    return interleave(yr.transpose(1, 2), yi.transpose(1, 2), scale)


def col(raw, bpre: int, rest: int, sub: SubTables, scale: float, out=None):
    """K10: the ``sub.m``-point transform over axis 1 of the ``(bpre,
    sub.m, rest)`` complex view of ``raw``.  ``out`` (may be ``raw``
    itself) receives the result; otherwise a new tensor.  Past 8192 points
    the kernel runs as two launches through a scratch buffer the size of
    the input (see ``csrc/fft_col.cu``)."""
    check_buffer(raw, 2 * bpre * sub.m * rest, "col")
    if raw.device.type == "cpu":
        return into(out, col_plain(raw, bpre, rest, sub, scale))
    require_cuda(raw, "col")
    lib = _build.load()
    y = torch.empty_like(raw) if out is None else out
    scratch = torch.empty_like(raw) if lib.pf_col_needs_scratch(sub.m) else None
    with torch.cuda.device(raw.device):
        err = lib.pf_col(
            raw.data_ptr(), y.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            sub.m, sub.a, *sub.pointers(), bpre, rest, scale, stream_of(raw),
        )
    _build.check(lib, err, "col kernel")
    col.launches += 1
    return y


col.launches = 0
col.plain = col_plain


# -- K11 md2 -------------------------------------------------------------------


def md2_plain(raw: torch.Tensor, batch: int, sub1: SubTables, sub2: SubTables,
              scale: float):
    """Plain version of K11: ``rows_plain`` along n2, then along n1
    (transposed), scaled and interleaved."""
    x = raw.view(batch, sub1.m, sub2.m, 2)
    with full_fp32_matmuls(raw):
        ar, ai = rows_plain(sub2, x[..., 0], x[..., 1])
        cr, ci = rows_plain(sub1, ar.transpose(1, 2), ai.transpose(1, 2))
    return interleave(cr.transpose(1, 2), ci.transpose(1, 2), scale)


def md2(raw, batch: int, sub1: SubTables, sub2: SubTables, scale: float,
        out=None):
    """K11: ``batch`` 2D transforms of shape ``(sub1.m, sub2.m)``.  ``out``
    (may be ``raw`` itself) receives the result; otherwise a new tensor."""
    check_buffer(raw, 2 * batch * sub1.m * sub2.m, "md2")
    if raw.device.type == "cpu":
        return into(out, md2_plain(raw, batch, sub1, sub2, scale))
    require_cuda(raw, "md2")
    lib = _build.load()
    y = torch.empty_like(raw) if out is None else out
    with torch.cuda.device(raw.device):
        err = lib.pf_md2(
            raw.data_ptr(), y.data_ptr(), sub1.m, sub1.a, *sub1.pointers(),
            sub2.m, sub2.a, *sub2.pointers(), batch, scale, stream_of(raw),
        )
    _build.check(lib, err, "md2 kernel")
    md2.launches += 1
    return y


md2.launches = 0
md2.plain = md2_plain
