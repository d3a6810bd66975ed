"""K10 ``col``, K10-mm ``col_mm`` and K11 ``md2``: wrappers of the CUDA
kernels (``csrc/fft_col.cu``, ``csrc/fft_col_mm.cu``, ``csrc/fft_md2.cu``),
their plain PyTorch versions, and the multi-dimensional registry's gates.

Counterparts of ``portfft_tpu/ops/pallas_multidim.py``: ``col_raw_call``
(K10, the FFT over a non-contiguous axis of the PACKED interleaved buffer
viewed as ``(bpre, L, rest)`` complex elements; also the whole
BATCH_INTERLEAVED 1D transform), ``col_raw_mm_call`` (K10-mm, the same
function on the tensor cores at a three-term TF32 grade; the tuned
``{"cm": 1}``) and ``md2_fused_raw_call`` (K11, both trailing axes of
``(batch, n1, n2)`` in one launch).  Same rule as ``cuda_fft``: CPU tensors
go to the plain version, CUDA tensors to the kernel, and nothing falls
back.

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

from ..config import H100_L2_BYTES, H100_SM_COUNT
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
    stream_of,
)
from .torch_fft import complex_mul, dft_x3, full_fp32_matmuls, radix_sub_plain

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


#: Longest axis K10 takes in float64: its tile (the roots and two ping-pong
#: tiles of double2, ``pfft::pass_smem_bytes``) passes the shared memory of
#: a block at a FUSED 8192, and the two-launch lengths past it are not
#: ported in float64.
COL_F64_MAX = 4096


def col_f64_supported(plan: Plan1D, max_direct: int = 512) -> bool:
    """K10's gate in float64: ``col_axis_supported`` up to
    ``COL_F64_MAX``."""
    return plan.n <= COL_F64_MAX and col_axis_supported(plan, max_direct)


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
    """Plain version of K10 in the kernel's stages: the ``sub.m``-point
    transform of each column of the ``(bpre, sub.m, rest)`` complex view by
    ``torch_fft.radix_sub_plain`` (the radix stages of
    ``csrc/fft_radix.cuh``), times ``scale``, in the input's precision."""
    x = torch.view_as_complex(raw.view(bpre, sub.m, rest, 2))
    with full_fp32_matmuls(raw):
        y = radix_sub_plain(sub, x.transpose(1, 2)).transpose(1, 2) * scale
    return torch.view_as_real(y).reshape(-1)


@tracing.kernel("K10", ("sliced_kernel", "col_radix_kernel"))
def col(raw, bpre: int, rest: int, sub: SubTables, scale: float, out=None):
    """K10: the ``sub.m``-point transform over axis 1 of the ``(bpre,
    sub.m, rest)`` complex view of ``raw``, in its precision: float32, or
    float64 with float64 tables (the double kernel, ``pf_col_f64``, whose
    tile holds up to ``COL_F64_MAX`` points).  ``out`` (may be ``raw``
    itself) receives the result; otherwise a new tensor.  Up to 8192 points
    one launch on the radix stages (``col_radix_kernel``), counted on
    ``tracing.paths("K10")`` as ``"radix"`` or ``"radix_f64"``; past it two
    launches of plain sums through a scratch buffer the size of the input
    (see ``csrc/fft_col.cu``), counted as ``"f32"`` (``"f64"`` in
    double)."""
    check_buffer(raw, 2 * bpre * sub.m * rest, "col", (torch.float32, torch.float64))
    if raw.device.type == "cpu":
        return into(out, col_plain(raw, bpre, rest, sub, scale))
    require_cuda(raw, "col")
    f64 = raw.dtype == torch.float64
    if any(t is not None and t.dtype != raw.dtype for t in (sub.wr, sub.br, sub.ur)):
        raise InvalidConfiguration(f"col: the tables are not {raw.dtype}")
    lib = _build.load()
    y = torch.empty_like(raw) if out is None else out
    two = lib.pf_col_needs_scratch(sub.m)
    scratch = torch.empty_like(raw) if two else None
    with torch.cuda.device(raw.device):
        err = (lib.pf_col_f64 if f64 else lib.pf_col)(
            raw.data_ptr(), y.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            sub.m, sub.a, *sub.pointers(), bpre, rest, scale, stream_of(raw),
        )
    _build.check(lib, err, "col kernel")
    tracing.path("K10", ("f64" if f64 else "f32") if two else
                 ("radix_f64" if f64 else "radix"))
    return y


col.plain = col_plain


# -- K10-mm col_mm --------------------------------------------------------------


def col_mm_supported(plan: Plan1D) -> bool:
    """K10-mm's gate: the JAX package's ``col_raw_mm_call`` and
    ``col_mm_table_names`` shapes (128 | L; DIRECT up to 512, or FUSED
    [a, 128] with a | 128).  Every such length fits the H100's shared
    memory a block, a 16384-point column in one tile (the launch refuses a
    block past it).  The reference also declines where its VMEM estimate
    finds no lane tile (L >= 3072 at its planning 16 MiB) or the trailing
    extent is no multiple of 64; K10-mm takes those (ROADMAP Queue 3)."""
    if plan.n % 128 or not _lane_dft_shape(plan):
        return False
    return plan.level != Level.DIRECT or plan.n <= 512


def column_dft_x3(sub: SubTables, xr: torch.Tensor, xi: torch.Tensor):
    """The tensor-core column pass on (..., L, N) planes, as the kernels run
    it (``pfft_mma::column_pass``): DIRECT one ``dft_x3`` product with the
    L-point DFT matrix; FUSED stage A over the a-digit, the inner twiddle,
    stage B over the 128-digit and the output k1 + a·k2.  Returns (..., L,
    N) planes in natural order."""
    if sub.a == 0:
        return dft_x3(sub.wr, sub.wi, xr, xi)
    a, lead, n = sub.a, xr.shape[:-2], xr.shape[-1]
    ar, ai = dft_x3(sub.wr, sub.wi, xr.reshape(*lead, a, 128 * n),
                    xi.reshape(*lead, a, 128 * n))  # [k1, (n2, c)]
    ar, ai = complex_mul(ar.view(*lead, a, 128, n), ai.view(*lead, a, 128, n),
                         sub.ur[..., None], sub.ui[..., None])

    def by_n2(p):  # [k1, n2, c] -> [n2, (k1, c)]
        return p.transpose(-3, -2).reshape(*lead, 128, a * n)

    cr, ci = dft_x3(sub.br, sub.bi, by_n2(ar), by_n2(ai))  # [k2, (k1, c)]
    return cr.reshape(*lead, 128 * a, n), ci.reshape(*lead, 128 * a, n)


def col_mm_plain(raw: torch.Tensor, bpre: int, rest: int, sub: SubTables,
                 scale: float):
    """Plain version of K10-mm: ``column_dft_x3`` down axis 1 of the
    ``(bpre, L, rest)`` view (the TF32 hi/lo rounding emulated), scaled and
    interleaved."""
    x = raw.view(bpre, sub.m, rest, 2)
    with full_fp32_matmuls(raw):
        yr, yi = column_dft_x3(sub, x[..., 0], x[..., 1])
    return interleave(yr, yi, scale)


@tracing.kernel("K10-mm", ("col_mm_kernel",))
def col_mm(raw, bpre: int, rest: int, sub: SubTables, scale: float, out=None):
    """K10-mm: K10's function (the ``sub.m``-point transform over axis 1 of
    the ``(bpre, sub.m, rest)`` complex view of ``raw``) on the tensor
    cores, in one launch at every length ``col_mm_supported`` takes.
    ``out`` (may be ``raw`` itself) receives the result; otherwise a new
    tensor."""
    check_buffer(raw, 2 * bpre * sub.m * rest, "col_mm")
    if raw.device.type == "cpu":
        return into(out, col_mm_plain(raw, bpre, rest, sub, scale))
    require_cuda(raw, "col_mm")
    lib = _build.load()
    y = torch.empty_like(raw) if out is None else out
    with torch.cuda.device(raw.device):
        err = lib.pf_col_mm(raw.data_ptr(), y.data_ptr(), sub.m, sub.a,
                            *sub.pointers(), bpre, rest, scale, stream_of(raw))
    _build.check(lib, err, "col_mm kernel")
    return y


col_mm.plain = col_mm_plain


# -- K11 md2 -------------------------------------------------------------------

#: K11's resident blocks an SM (``__launch_bounds__(kBlock, 2)`` in
#: ``csrc/fft_md2.cu``).
MD2_BLOCKS_PER_SM = 2


def md2_path(n1: int, n2: int) -> str:
    """K11's regime at an (n1, n2) plane, by its kernel's header:
    ``"resident"`` where the intermediate planes of the resident blocks (two
    an SM on ``H100_SM_COUNT`` SMs, 8 bytes an element) fit the H100's L2,
    so that each element crosses HBM once each way; else ``"spill"``, where
    phase A's stores leave the L2 and the kernel moves about twice the bytes
    of its bound.  From the Hopper constants, not the card's properties, so
    that a CPU commit counts the same."""
    blocks = MD2_BLOCKS_PER_SM * H100_SM_COUNT
    return "resident" if blocks * n1 * n2 * 8 <= H100_L2_BYTES else "spill"



def md2_plain(raw: torch.Tensor, batch: int, sub1: SubTables, sub2: SubTables,
              scale: float):
    """Plain version of K11 in the kernel's order and stages: phase A, the
    n1-point transform down each column, then phase B along each row, times
    ``scale`` (``torch_fft.radix_sub_plain``, the radix stages of
    ``csrc/fft_radix.cuh``)."""
    x = torch.view_as_complex(raw.view(batch, sub1.m, sub2.m, 2))
    with full_fp32_matmuls(raw):
        a = radix_sub_plain(sub1, x.transpose(1, 2)).transpose(1, 2)
        c = radix_sub_plain(sub2, a) * scale
    return torch.view_as_real(c).reshape(-1)


@tracing.kernel("K11", ("md2_kernel",))
def md2(raw, batch: int, sub1: SubTables, sub2: SubTables, scale: float,
        out=None):
    """K11: ``batch`` 2D transforms of shape ``(sub1.m, sub2.m)``, one block
    a transform, on the radix stages (``csrc/fft_md2.cu``).  ``out`` (may be
    ``raw`` itself) receives the result; otherwise a new tensor.  Each launch
    counts on ``tracing.paths("K11")`` under :func:`md2_path`."""
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
    tracing.path("K11", md2_path(sub1.m, sub2.m))
    return y


md2.plain = md2_plain
