"""K1 ``direct``, K2 ``fused2`` and the FUSED engines K2-v1 ``fused2_v1``,
K2-v2 ``fused2_v2`` and K2-v3 ``fused2_v3``: wrappers of the CUDA kernels
(``csrc/fft_direct.cu``, ``csrc/fft_fused2.cu``,
``csrc/fft_fused2_v{1,2,3}.cu``), their gates and their plain PyTorch
versions.

Counterparts of ``portfft_tpu/ops/pallas_fft.py``: ``direct_raw_call``
(K1), ``fused2_raw_mm_call`` (K2, the FUSED static route, the reference's
engine 4), ``fused2_raw_call`` (K2-v1), ``fused2_raw_v2_call`` (K2-v2,
engine 2) and ``fused2_raw_v3_call`` (K2-v3, engine 3).  The four FUSED
kernels compute the same function; which one a plan runs is fixed at
commit from the tuning table (``fastpath``).  Every function takes and
returns the PACKED interleaved buffer as a flat float32 tensor of
``2·batch·n`` scalars.

The rule of every wrapper: a tensor on the CPU goes to the plain version; a
tensor on a CUDA device goes to the kernel, and a failed build or launch
raises.  Nothing falls back.  The plain versions are the same decomposition
as ``torch.matmul`` calls against the bank's DFT matrices, in full float32;
tests and ``chip_smoke.py`` call them on the card to hold the kernels to.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import H100_SMEM_PER_BLOCK
from ..exceptions import InvalidConfiguration
from ..planner import Plan1D, two_stage_smem_bytes
from ..utils import tracing
from . import _build
from .torch_fft import (
    complex_matmul,
    complex_mul,
    fold_factor,
    full_fp32_matmuls,
    fused2_v1_plain,
    fused2_v2_plain,
    fused2_v3_plain,
    is_two_stage,
)


@dataclasses.dataclass(frozen=True)
class SubTables:
    """The device tables of one DIRECT or FUSED [a, 128] transform of
    length ``m``: ``wr``/``wi`` the m×m DFT planes (DIRECT) or a×a (FUSED);
    FUSED also ``br``/``bi`` (128×128) and ``ur``/``ui`` (the (a, 128)
    inner twiddle)."""

    m: int
    a: int  # 0 for DIRECT
    wr: torch.Tensor
    wi: torch.Tensor
    br: torch.Tensor | None = None
    bi: torch.Tensor | None = None
    ur: torch.Tensor | None = None
    ui: torch.Tensor | None = None

    def pointers(self) -> list:
        """The six table pointers (None where unused) in the order of the C
        entry points: wr, wi, br, bi, ur, ui."""
        tabs = (self.wr, self.wi, self.br, self.bi, self.ur, self.ui)
        return [None if t is None else t.data_ptr() for t in tabs]


def sub_tables(plan: Plan1D, sign: int, keys: dict, arrays: dict) -> SubTables:
    """Resolve the tables of a DIRECT or two-stage FUSED plan from the bank
    (``keys`` from ``torch_fft.collect_bank_keys``)."""
    if is_two_stage(plan):
        a = plan.factors[0]
        wa, wb = keys[("W", a, sign)], keys[("W", 128, sign)]
        u = keys[("U", a, 128, sign)]
        return SubTables(
            plan.n, a, arrays[wa + "r"], arrays[wa + "i"],
            arrays[wb + "r"], arrays[wb + "i"], arrays[u + "r"], arrays[u + "i"],
        )
    w = keys[("W", plan.n, sign)]
    return SubTables(plan.n, 0, arrays[w + "r"], arrays[w + "i"])


def rows_plain(sub: SubTables, xr: torch.Tensor, xi: torch.Tensor):
    """The m-point transform of the last axis of the (re, im) planes, in
    natural output order.  DIRECT: one complex matmul with the DFT matrix.
    FUSED: stage A (W_a from the left over n1), the inner twiddle, stage B
    (W_128 over n2), and the digit reversal out[k1 + a·k2] = C[k1, k2]."""
    if sub.a == 0:
        return complex_matmul(xr, xi, sub.wr, sub.wi)
    lead = xr.shape[:-1]
    xr = xr.reshape(*lead, sub.a, 128)
    xi = xi.reshape(*lead, sub.a, 128)
    ar, ai = complex_matmul(sub.wr, sub.wi, xr, xi)  # DFT matrices are symmetric
    ar, ai = complex_mul(ar, ai, sub.ur, sub.ui)
    cr, ci = complex_matmul(ar, ai, sub.br, sub.bi)
    return (
        cr.transpose(-1, -2).reshape(*lead, sub.m),
        ci.transpose(-1, -2).reshape(*lead, sub.m),
    )


def interleave(yr: torch.Tensor, yi: torch.Tensor, scale: float) -> torch.Tensor:
    return (torch.stack((yr, yi), dim=-1) * scale).reshape(-1)


def rows_plain_raw(raw: torch.Tensor, batch: int, sub: SubTables, scale: float):
    """Plain version of K1 and K2: ``rows_plain`` on each of the ``batch``
    rows of the raw buffer — one matmul with the DFT matrix (DIRECT) or the
    two-stage [a, 128] decomposition (FUSED) — scaled and interleaved."""
    x = raw.view(batch, sub.m, 2)
    with full_fp32_matmuls(raw):
        return interleave(*rows_plain(sub, x[..., 0], x[..., 1]), scale)


def check_buffer(raw: torch.Tensor, numel: int, what: str,
                 dtypes: tuple = (torch.float32,)) -> None:
    """The kernels take a flat, contiguous tensor of exactly ``numel``
    scalars of one of ``dtypes`` (float32; K9 and K10 also float64) whose
    address is aligned to a complex element (float2, double2)."""
    if raw.dtype not in dtypes or raw.dim() != 1 or not raw.is_contiguous():
        names = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
        raise InvalidConfiguration(
            f"{what}: expected a flat contiguous {names} tensor, got "
            f"{raw.dtype} of shape {tuple(raw.shape)}"
        )
    if raw.numel() != numel:
        raise InvalidConfiguration(
            f"{what}: expected {numel} scalars, got {raw.numel()}"
        )
    align = 2 * raw.element_size()
    if raw.is_cuda and raw.data_ptr() % align:
        raise InvalidConfiguration(f"{what}: buffer is not {align}-byte aligned")


def require_cuda(raw: torch.Tensor, what: str) -> None:
    if not raw.is_cuda:
        raise InvalidConfiguration(
            f"{what}: tensors on {raw.device.type} are not supported"
        )


def into(out: torch.Tensor | None, y: torch.Tensor) -> torch.Tensor:
    """Return ``y``, or copy it into ``out`` and return ``out``."""
    if out is None:
        return y
    out.copy_(y)
    return out


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


@tracing.kernel("K1", ("direct_kernel",))
def direct(raw, batch: int, sub: SubTables, scale: float, out=None):
    """K1: ``batch`` DIRECT transforms of length ``sub.m``.  ``out`` (may
    be ``raw`` itself) receives the result; otherwise a new tensor."""
    check_buffer(raw, 2 * batch * sub.m, "direct")
    if raw.device.type == "cpu":
        return into(out, rows_plain_raw(raw, batch, sub, scale))
    require_cuda(raw, "direct")
    lib = _build.load()
    y = torch.empty_like(raw) if out is None else out
    with torch.cuda.device(raw.device):  # launch on the tensor's card
        err = lib.pf_direct(
            raw.data_ptr(), y.data_ptr(), *sub.pointers()[:2],
            batch, sub.m, scale, stream_of(raw),
        )
    _build.check(lib, err, "direct kernel")
    return y


direct.plain = rows_plain_raw


@tracing.kernel("K2", ("fused2_kernel",))
def fused2(raw, batch: int, sub: SubTables, scale: float, out=None):
    """K2: ``batch`` FUSED [a, 128] transforms of length ``sub.m``.  For
    n > 8192 the kernel runs as two launches through a scratch buffer the
    size of the input (see ``csrc/fft_fused2.cu``)."""
    check_buffer(raw, 2 * batch * sub.m, "fused2")
    if raw.device.type == "cpu":
        return into(out, rows_plain_raw(raw, batch, sub, scale))
    require_cuda(raw, "fused2")
    lib = _build.load()
    y = torch.empty_like(raw) if out is None else out
    scratch = (
        torch.empty_like(raw) if lib.pf_fused2_needs_scratch(sub.a) else None
    )
    with torch.cuda.device(raw.device):
        err = lib.pf_fused2(
            raw.data_ptr(), y.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            *sub.pointers(), batch, sub.a, scale, stream_of(raw),
        )
    _build.check(lib, err, "fused2 kernel")
    return y


fused2.plain = rows_plain_raw


# -- the FUSED engines K2-v1, K2-v2, K2-v3 -------------------------------------

#: Batch tiles K2-v2 takes: a lane's register tile holds 4·bt (stage 2) and
#: ceil(a/32)·bt (stage 1) complex sums, at most 32 (csrc/fft_fused2_v2.cu).
V2_TILES = (1, 2, 4, 8)
#: Batch tiles K2-v3 takes (no register tile: shared memory alone limits it).
V3_TILES = (1, 2, 4, 8, 16, 32)


def _fits(a: int, bt: int, engine: str) -> bool:
    return two_stage_smem_bytes(a, bt, engine) <= H100_SMEM_PER_BLOCK


def fused2_v1_supported(plan: Plan1D) -> bool:
    """K2-v1 takes every [a, 128] plan whose one transform fits a block's
    shared memory (a ≤ 96 of the planned a; it picks its own tile)."""
    return is_two_stage(plan) and _fits(plan.factors[0], 1, "fused2_v1")


def _tile_ok(engine: str, a: int, batch: int, bt: int) -> bool:
    tiles = V2_TILES if engine == "fused2_v2" else V3_TILES
    if bt not in tiles or batch % bt or not _fits(a, bt, engine):
        return False
    return engine == "fused2_v3" or (1 if a < 32 else a // 32) * bt <= 32


def _folded_supported(engine: str, plan: Plan1D, batch: int, bt: int) -> bool:
    """The gate of K2-v2 and K2-v3: a two-stage plan whose a has the JAX
    package's fold (``fold_factor(a) > 0``), at the batch tile ``bt`` (0:
    at any tile the kernel takes, which bt = 1 is wherever one is)."""
    if not is_two_stage(plan) or fold_factor(plan.factors[0]) == 0:
        return False
    return _tile_ok(engine, plan.factors[0], batch, bt or 1)


def fused2_v2_supported(plan: Plan1D, batch: int, bt: int = 0) -> bool:
    return _folded_supported("fused2_v2", plan, batch, bt)


def fused2_v3_supported(plan: Plan1D, batch: int, bt: int = 0) -> bool:
    return _folded_supported("fused2_v3", plan, batch, bt)


def pick_tile(engine: str, a: int, batch: int) -> int:
    """The batch tile K2-v2 or K2-v3 takes where none is given: the largest
    of 8, 4, 2, 1 the gate takes (0 where none is)."""
    return next((bt for bt in (8, 4, 2, 1) if _tile_ok(engine, a, batch, bt)), 0)


def _launch_fused(name: str, raw, batch: int, sub: SubTables, tail: tuple,
                  out):
    """Launch ``pf_<name>`` on ``raw`` (CUDA) into ``out`` or a new tensor;
    ``tail`` is what follows ``batch`` and ``a`` in the C signature."""
    require_cuda(raw, name)
    lib = _build.load()
    y = torch.empty_like(raw) if out is None else out
    with torch.cuda.device(raw.device):
        err = getattr(lib, f"pf_{name}")(
            raw.data_ptr(), y.data_ptr(), *sub.pointers(), batch, sub.a,
            *tail, stream_of(raw))
    _build.check(lib, err, f"{name} kernel")
    return y


@tracing.kernel("K2-v1", ("fused2_v1_kernel",))
def fused2_v1(raw, batch: int, sub: SubTables, scale: float, out=None):
    """K2-v1: ``batch`` FUSED [a, 128] transforms of length ``sub.m``, any
    a whose transform fits a block (``fused2_v1_supported``), in one
    launch.  ``out`` (may be ``raw``) receives the result; otherwise a new
    tensor."""
    check_buffer(raw, 2 * batch * sub.m, "fused2_v1")
    if not _fits(sub.a, 1, "fused2_v1"):
        raise InvalidConfiguration(
            f"fused2_v1: a = {sub.a} does not fit a block's shared memory")
    if raw.device.type == "cpu":
        return into(out, fused2_v1_plain(raw, batch, sub, scale))
    return _launch_fused("fused2_v1", raw, batch, sub, (scale,), out)


fused2_v1.plain = fused2_v1_plain


def _folded(engine: str, raw, batch: int, sub: SubTables, bt: int) -> int:
    """The batch tile of a K2-v2 or K2-v3 call (``pick_tile`` where ``bt``
    is 0); raises where the gate declines."""
    check_buffer(raw, 2 * batch * sub.m, engine)
    if fold_factor(sub.a) == 0:
        raise InvalidConfiguration(f"{engine}: a = {sub.a} has no fold")
    bt = bt or pick_tile(engine, sub.a, batch)
    if not _tile_ok(engine, sub.a, batch, bt):
        raise InvalidConfiguration(
            f"{engine}: batch tile {bt} does not suit a = {sub.a}, batch {batch}")
    return bt


@tracing.kernel("K2-v2", ("fused2_v2_kernel",))
def fused2_v2(raw, batch: int, sub: SubTables, bt: int, scale: float,
              out=None):
    """K2-v2: ``batch`` FUSED [a, 128] transforms (a with a fold), ``bt``
    of them a block (0: ``pick_tile``)."""
    bt = _folded("fused2_v2", raw, batch, sub, bt)
    if raw.device.type == "cpu":
        return into(out, fused2_v2_plain(raw, batch, sub, bt, scale))
    return _launch_fused("fused2_v2", raw, batch, sub, (bt, scale), out)


fused2_v2.plain = fused2_v2_plain


@tracing.kernel("K2-v3", ("fused2_v3_kernel",))
def fused2_v3(raw, batch: int, sub: SubTables, bt: int, scale: float,
              out=None):
    """K2-v3: ``batch`` FUSED [a, 128] transforms (a with a fold), ``bt``
    of them a block (0: ``pick_tile``); the scale rides in the stage-B
    roots."""
    bt = _folded("fused2_v3", raw, batch, sub, bt)
    if raw.device.type == "cpu":
        return into(out, fused2_v3_plain(raw, batch, sub, bt, scale))
    return _launch_fused("fused2_v3", raw, batch, sub, (bt, scale), out)


fused2_v3.plain = fused2_v3_plain
