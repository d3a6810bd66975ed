"""Raw-I/O registry: which kernel runs a committed plan.

The 1D C2C fp32 INTERLEAVED PACKED transform with zero offsets — the
contract ``bench.py`` measures — runs as one kernel call on the raw
interleaved buffer, chosen by plan level:

| plan level | kernel (``ops``) | JAX counterpart |
|---|---|---|
| DIRECT | ``cuda_fft.direct`` (K1) | ``pallas_fft.direct_raw_call`` |
| FUSED [a, 128] | ``cuda_fft.fused2`` (K2) | ``pallas_fft.fused2_raw_mm_call`` |
| GLOBAL, DIRECT or FUSED [a, 128] subs | ``cuda_global.global2`` (K3) | ``pallas_global.global2_raw_call`` |

Registration happens at commit.  Anything outside this slice raises
:class:`RawFastUnavailable` (an :class:`UnsupportedConfiguration`) naming
the ROADMAP Queue 1 item that will port it; no configuration is quietly
sent down another path.
"""

from __future__ import annotations

from .enums import ComplexStorage, Direction, Domain, Layout, Level
from .enums import inv as _inv
from .exceptions import UnsupportedConfiguration
from .ops import cuda_fft, cuda_global
from .ops.torch_fft import is_two_stage
from .utils.layout import get_layout


class RawFastUnavailable(UnsupportedConfiguration):
    """No kernel of this package covers the descriptor (declined at
    commit)."""


_SIGNS = {Direction.FORWARD: -1, Direction.BACKWARD: +1}

#: Longest sub-transform a GLOBAL pass holds in one tile: one column in two
#: ping-pong tiles of float2 plus its root table (``pass_smem_bytes`` in
#: csrc/fft_common.cuh) fits the 227 KB of shared memory a block may use up
#: to this length.  The C side checks no length; a launch past it fails.
GLOBAL_SUB_MAX = 8192


def _leaf_ok(plan) -> bool:
    return plan.level == Level.DIRECT or is_two_stage(plan)


def _entry_1d(plan0, batch: int, sign: int, scale: float):
    """The entry of one 1D PACKED transform: ``(kind, plan, batch, sign,
    scale)``."""
    if plan0.level == Level.DIRECT:
        return ("direct", plan0, batch, sign, scale)
    if is_two_stage(plan0):
        return ("fused2", plan0, batch, sign, scale)
    if plan0.level == Level.GLOBAL:
        g1, g2 = plan0.sub
        if _leaf_ok(g1) and _leaf_ok(g2) and max(g1.n, g2.n) <= GLOBAL_SUB_MAX:
            return ("global2", plan0, batch, sign, scale)
        raise RawFastUnavailable(
            f"GLOBAL plan {plan0.describe()} has a sub-transform that is "
            f"neither DIRECT nor FUSED [a, 128] of length <= {GLOBAL_SUB_MAX}; "
            "the torch executor that runs such plans is ROADMAP Queue 1 item 4"
        )
    if plan0.level == Level.BLUESTEIN:
        raise RawFastUnavailable(
            f"BLUESTEIN plan {plan0.describe()} is not ported yet "
            "(ROADMAP Queue 1 item 11)"
        )
    raise RawFastUnavailable(
        f"FUSED plan {plan0.describe()} is not the two-stage [a, 128] shape; "
        "the torch executor that runs it is ROADMAP Queue 1 item 4"
    )


def register(committed) -> dict:
    """The per-direction entry table of a committed plan.  Raises
    :class:`RawFastUnavailable` for every descriptor outside the slice."""
    d = committed.descriptor
    if committed.precision.name != "float32":
        raise RawFastUnavailable(
            "fp64 transforms are not ported yet (ROADMAP Queue 1 item 12)"
        )
    if d.domain != Domain.COMPLEX:
        raise RawFastUnavailable(
            "REAL-domain transforms are not ported yet (ROADMAP Queue 1 item 9)"
        )
    if len(d.lengths) >= 2:
        raise RawFastUnavailable(
            "multi-dimensional transforms are not ported yet "
            "(ROADMAP Queue 1 item 10)"
        )
    if d.complex_storage != ComplexStorage.INTERLEAVED_COMPLEX:
        raise RawFastUnavailable(
            "SPLIT_COMPLEX storage is not ported yet (ROADMAP Queue 1 item 8)"
        )
    out: dict = {}
    n0 = d.lengths[0]
    plan0 = committed.plans[n0]
    for direction, sign in _SIGNS.items():
        out_dir = _inv(direction)
        if d.get_offset(direction) or d.get_offset(out_dir):
            raise RawFastUnavailable(
                "buffer offsets are not ported yet (ROADMAP Queue 1 item 8)"
            )
        if (
            get_layout(d, direction) != Layout.PACKED
            or get_layout(d, out_dir) != Layout.PACKED
        ):
            raise RawFastUnavailable(
                "strided and BATCH_INTERLEAVED layouts are not ported yet "
                "(ROADMAP Queue 1 item 8)"
            )
        out[direction] = _entry_1d(
            plan0, d.number_of_transforms, sign, float(d.get_scale(direction))
        )
    return out


def kernel_args(committed, entry):
    """``(kernel, args)`` of an entry: the wrapper (``cuda_fft.direct``,
    ``cuda_fft.fused2`` or ``cuda_global.global2``) and the arguments that
    follow the raw buffer, with the committed plan's device tables."""
    kind, plan0, batch, sign, scale = entry
    keys, arrays = committed._bank_keys, committed._bank_arrays
    if kind == "global2":
        g1, g2 = plan0.sub
        t = keys[("T", g1.n, g2.n, sign)]
        return cuda_global.global2, (
            batch,
            cuda_fft.sub_tables(g1, sign, keys, arrays),
            cuda_fft.sub_tables(g2, sign, keys, arrays),
            arrays[t + "r"], arrays[t + "i"], scale,
        )
    kernel = cuda_fft.direct if kind == "direct" else cuda_fft.fused2
    return kernel, (batch, cuda_fft.sub_tables(plan0, sign, keys, arrays), scale)


def build_fn(committed, entry):
    """``fn(raw, out=None) -> tensor`` for an entry: ``raw`` is the flat
    float32 buffer of exactly 2·batch·n scalars on the plan's device; ``out``
    (may be ``raw``) receives the result."""
    kernel, args = kernel_args(committed, entry)

    def fn(raw, out=None):
        return kernel(raw, *args, out=out)

    return fn
