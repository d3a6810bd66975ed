"""K12 ``axis_m2``: wrapper of the CUDA kernel (``csrc/fft_axis.cu``), its
plain PyTorch version, and the JAX package's gates.

Counterpart of ``portfft_tpu/ops/pallas_global.py`` ``fft_axis_m2_call``
(DIRECT, L1 ≤ 256, L1 % 8 == 0) and ``fft_axis_m2_fused_call`` (FUSED
[a, 128], a ≥ 8): the FFT over axis L1 of (re, im) float32 planes viewed as
(b, L1, L2), the outer axes of the multi-dimensional plane path.  Same rule
as ``cuda_fft``: CPU tensors go to the plain version, CUDA tensors to the
kernel, and nothing falls back.
"""

from __future__ import annotations

import torch

from ..enums import Level
from ..planner import Plan1D
from ..utils import tracing
from . import _build
from .cuda_fft import SubTables, require_cuda, rows_plain, stream_of
from .cuda_io import check_plane
from .torch_fft import full_fp32_matmuls, is_two_stage


def _trailing_tile_ok(l2: int, cap: int) -> bool:
    """The reference's lane tile over L2: the largest power-of-two
    fraction of ``min(cap, l2)`` dividing L2, declined below 128 when
    L2 ≥ 128."""
    t = min(cap, l2)
    while l2 % t:
        t //= 2
    return not (t < 128 and l2 >= 128)


def axis_m2_mode(plan: Plan1D, l2: int) -> str | None:
    """Which of the reference's column kernels takes the transform of
    ``plan`` over axis L1 of (b, L1, L2): ``"direct"``
    (``fft_axis_m2_call``), ``"fused"`` (``fft_axis_m2_fused_call``, tried
    when the first declines) or None (the executor after a ``movedim``)."""
    l1 = plan.n
    if (plan.level == Level.DIRECT and l1 % 8 == 0 and l1 <= 256
            and _trailing_tile_ok(l2, 512)):
        return "direct"
    if is_two_stage(plan) and plan.factors[0] >= 8 and _trailing_tile_ok(l2, 256):
        return "fused"
    return None


def axis_m2_plain(xr: torch.Tensor, xi: torch.Tensor, bpre: int, rest: int,
                  sub: SubTables, scale: float = 1.0):
    """Plain version of K12: move L1 to the last axis, ``rows_plain``, move
    it back, scale."""
    shape = (bpre, sub.m, rest)
    with full_fp32_matmuls(xr):
        yr, yi = rows_plain(sub, xr.reshape(shape).transpose(1, 2),
                            xi.reshape(shape).transpose(1, 2))
    return ((yr * scale).transpose(1, 2).contiguous().reshape(xr.shape),
            (yi * scale).transpose(1, 2).contiguous().reshape(xi.shape))


@tracing.kernel("K12", ("sliced_kernel",))
def axis_m2(xr: torch.Tensor, xi: torch.Tensor, bpre: int, rest: int,
            sub: SubTables, scale: float = 1.0):
    """K12: the ``sub.m``-point transform over axis 1 of the (bpre, sub.m,
    rest) view of the planes, times ``scale``; returns new planes of the
    input's shape.  Past 8192 points the kernel runs as two launches
    through a float2 scratch the size of the input."""
    numel = bpre * sub.m * rest
    check_plane(xr, numel, "axis_m2")
    check_plane(xi, numel, "axis_m2")
    if xr.device.type == "cpu":
        return axis_m2_plain(xr, xi, bpre, rest, sub, scale)
    require_cuda(xr, "axis_m2")
    lib = _build.load()
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    q = (torch.empty(2 * numel, dtype=torch.float32, device=xr.device)
         if lib.pf_axis_m2_needs_scratch(sub.m) else None)
    with torch.cuda.device(xr.device):
        err = lib.pf_axis_m2(
            xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            None if q is None else q.data_ptr(), sub.m, sub.a, *sub.pointers(),
            bpre, rest, scale, stream_of(xr))
    _build.check(lib, err, "axis_m2 kernel")
    return yr, yi


axis_m2.plain = axis_m2_plain
