"""Raw-I/O registry: which kernel runs a committed plan.

The 1D C2C fp32 INTERLEAVED PACKED transform with zero offsets — the
contract ``bench.py`` measures — runs as one kernel call on the raw
interleaved buffer, chosen by plan level:

| plan level | kernel (``ops``) | JAX counterpart |
|---|---|---|
| DIRECT | ``cuda_fft.direct`` (K1) | ``pallas_fft.direct_raw_call`` |
| FUSED [a, 128] | ``cuda_fft.fused2`` (K2) | ``pallas_fft.fused2_raw_mm_call`` |
| GLOBAL, DIRECT or FUSED [a, 128] subs | ``cuda_global.global2`` (K3) | ``pallas_global.global2_raw_call`` |

The 1D REAL fp32 transform (R2C forward, C2R backward, INTERLEAVED PACKED,
out-of-place) runs, for even n ≤ ``SMALL_REAL_MAX_N``, as one call of
``cuda_real.small_real`` (K9, entries ``realsf``/``realsb``); for longer
even n as the C2C kernel of the h = n/2 plan at scale 1 on the real buffer
viewed as h complex pairs, followed (forward, ``realf``) by
``cuda_real.untangle`` (K8a) or preceded (backward, ``realb``) by
``cuda_real.retangle`` (K8b), which apply the direction's scale.  The JAX
package declines some of these shapes to its plane path (h not a multiple
of 128, h ≥ 2^15, 512 < n < 1024, batches that do not group); the kernels
here take them all.

Multi-dimensional C2C fp32 (rank >= 2, INTERLEAVED PACKED, zero offsets)
runs as an ``("multidim", md2, steps)`` entry: the kernels in the order they
run, the first out of place (or into the caller's buffer in place) and the
rest in place on its result.  Route as the JAX package's
``_register_multidim``:

| route | kernels, in order |
|---|---|
| md2 (``cuda_multidim.md2_supported`` of the two trailing plans) | ``cuda_multidim.md2`` (K11) on the trailing 2D transforms, then ``cuda_multidim.col`` (K10) for axes −3 … 0 |
| per axis | the last axis's 1D kernel (K1, K2 or K3) at batch B·prod(lengths[:-1]), then K10 for axes −2 … 0 |

Length-1 axes are skipped; the direction's scale goes into the last kernel
that runs.  Every outer axis must be one K10 takes (DIRECT ≤ 512 or FUSED
[a, 128] with a | 128, so up to 16384).  The 1D BATCH_INTERLEAVED
layout (stride = batch, distance 1, both domains) is one K10 call with
bpre = 1: the ``bi_col`` entry.

Registration happens at commit.  Anything outside this slice raises
:class:`RawFastUnavailable` (an :class:`UnsupportedConfiguration`) naming
the ROADMAP Queue 1 item that will port it; no configuration is quietly
sent down another path.
"""

from __future__ import annotations

import math

from .enums import ComplexStorage, Direction, Domain, Layout, Level, Placement
from .enums import inv as _inv
from .exceptions import UnsupportedConfiguration
from .ops import cuda_fft, cuda_global, cuda_multidim, cuda_real
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

#: Longest REAL transform K9 takes whole; longer even lengths run the
#: half-length path.  The JAX package's limit (``pallas_real``) too.
SMALL_REAL_MAX_N = 512


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


def _check_packed(d, layout: Layout = Layout.PACKED) -> None:
    """Zero offsets, and ``layout`` in both domains."""
    for direction in _SIGNS:
        out_dir = _inv(direction)
        if d.get_offset(direction) or d.get_offset(out_dir):
            raise RawFastUnavailable(
                "buffer offsets are not ported yet (ROADMAP Queue 1 item 8)"
            )
        if get_layout(d, direction) != layout or get_layout(d, out_dir) != layout:
            raise RawFastUnavailable(
                "strided layouts, and BATCH_INTERLEAVED in one domain only, "
                "are not ported yet (ROADMAP Queue 1 item 8)"
            )


def _check_col_axis(plan, config, what: str) -> None:
    """Raise unless K10 takes a transform of ``plan`` over ``what``."""
    if not cuda_multidim.col_axis_supported(plan, config.direct_threshold):
        raise RawFastUnavailable(
            f"{what} of plan {plan.describe()} is not one the column kernel "
            "K10 takes (DIRECT <= 512 or FUSED [a, 128] with a | 128); it "
            "needs the torch executor, ROADMAP Queue 1 item 4, with the "
            "plane column kernel K12"
        )


def _register_multidim(committed) -> dict:
    """Entries of a multi-dimensional C2C transform: ``("multidim", md2,
    steps)``, the steps in the order they run (see the module docstring).
    A column step is ``("col", bpre, plan, rest, sign, scale)``, the K11
    step ``("md2", batch, plan1, plan2, sign, scale)``, a row step a 1D
    entry."""
    d = committed.descriptor
    lengths, plans = list(d.lengths), committed.plans
    for ln in lengths[:-1]:
        if ln > 1:
            _check_col_axis(plans[ln], committed.config, "an outer axis")
    batch = d.number_of_transforms
    total = batch * math.prod(lengths)
    plan_last = plans[lengths[-1]]
    plan_a = plans[lengths[-2]] if lengths[-2] > 1 else None
    md2 = plan_a is not None and cuda_multidim.md2_supported(
        plan_a, plan_last, committed.config
    )
    first = len(lengths) - (3 if md2 else 2)
    cols = [
        (plans[lengths[ax]], batch * math.prod(lengths[:ax]),
         math.prod(lengths[ax + 1:]))
        for ax in range(first, -1, -1)
        if lengths[ax] > 1
    ]
    out: dict = {}
    for direction, sign in _SIGNS.items():
        scale = float(d.get_scale(direction))
        # the scale goes into the last kernel that runs
        head_scale = 1.0 if cols else scale
        if md2:
            n2d = lengths[-2] * lengths[-1]
            head = ("md2", total // n2d, plan_a, plan_last, sign, head_scale)
        else:
            head = _entry_1d(plan_last, total // lengths[-1], sign, head_scale)
        steps = [head] + [
            ("col", bpre, plan, rest, sign, scale if i == len(cols) - 1 else 1.0)
            for i, (plan, bpre, rest) in enumerate(cols)
        ]
        out[direction] = ("multidim", md2, tuple(steps))
    return out


def _register_real(committed) -> dict:
    """Entries of a 1D REAL transform: ``(kind, n, batch, sign, scale)``
    for the small path, ``(kind, c2c_entry, h, batch, sign, scale)`` for
    the half-length path, whose C2C entry runs at scale 1."""
    d = committed.descriptor
    if len(d.lengths) >= 2:
        raise RawFastUnavailable(
            "multi-dimensional REAL transforms are not ported yet "
            "(ROADMAP Queue 1 item 9, with multi-dim item 10)"
        )
    if d.placement == Placement.IN_PLACE:
        raise RawFastUnavailable(
            "in-place REAL transforms (the FFTW padded layout) are not "
            "ported yet (ROADMAP Queue 1 item 9)"
        )
    if d.complex_storage != ComplexStorage.INTERLEAVED_COMPLEX:
        raise RawFastUnavailable(
            "SPLIT_COMPLEX REAL transforms are not ported yet "
            "(ROADMAP Queue 1 item 9)"
        )
    _check_packed(d)
    n, batch = d.lengths[0], d.number_of_transforms
    out: dict = {}
    for direction, sign in _SIGNS.items():
        scale = float(d.get_scale(direction))
        forward = direction == Direction.FORWARD
        if n <= SMALL_REAL_MAX_N:
            out[direction] = ("realsf" if forward else "realsb", n, batch,
                              sign, scale)
        else:
            h = n // 2
            sub = _entry_1d(committed.plans[h], batch, sign, 1.0)
            out[direction] = ("realf" if forward else "realb", sub, h, batch,
                              sign, scale)
    return out


def register(committed) -> dict:
    """The per-direction entry table of a committed plan.  Raises
    :class:`RawFastUnavailable` for every descriptor outside the slice."""
    d = committed.descriptor
    if committed.precision.name != "float32":
        raise RawFastUnavailable(
            "fp64 transforms are not ported yet (ROADMAP Queue 1 item 12)"
        )
    if d.domain == Domain.REAL:
        return _register_real(committed)
    if d.complex_storage != ComplexStorage.INTERLEAVED_COMPLEX:
        raise RawFastUnavailable(
            "SPLIT_COMPLEX storage is not ported yet (ROADMAP Queue 1 item 8)"
        )
    if len(d.lengths) >= 2:
        _check_packed(d)
        return _register_multidim(committed)
    plan0 = committed.plans[d.lengths[0]]
    if get_layout(d, Direction.FORWARD) == Layout.BATCH_INTERLEAVED:
        # the (n, batch) buffer is one column transform with bpre = 1
        _check_packed(d, Layout.BATCH_INTERLEAVED)
        _check_col_axis(plan0, committed.config,
                        "a BATCH_INTERLEAVED transform")
        batch = d.number_of_transforms
        return {
            direction: ("bi_col", 1, plan0, batch, sign,
                        float(d.get_scale(direction)))
            for direction, sign in _SIGNS.items()
        }
    _check_packed(d)
    return {
        direction: _entry_1d(
            plan0, d.number_of_transforms, sign, float(d.get_scale(direction))
        )
        for direction, sign in _SIGNS.items()
    }


def kernel_args(committed, entry):
    """``(kernel, args)`` of an entry: the wrapper (``cuda_fft.direct``,
    ``cuda_fft.fused2``, ``cuda_global.global2``, ``cuda_real.small_real``,
    ``cuda_multidim.col`` for ``bi_col`` and a column step,
    ``cuda_multidim.md2`` for a K11 step, or for the half-length REAL
    entries ``cuda_real.untangle``/``retangle``) and the arguments that
    follow the buffer, with the committed plan's device tables.  A
    half-length REAL entry's C2C kernel is ``kernel_args(committed,
    entry[1])``; a multi-dim entry's are those of its steps,
    ``entry[2]``."""
    kind = entry[0]
    keys, arrays = committed._bank_keys, committed._bank_arrays
    if kind in ("col", "bi_col"):
        _, bpre, plan, rest, sign, scale = entry
        return cuda_multidim.col, (
            bpre, rest, cuda_fft.sub_tables(plan, sign, keys, arrays), scale
        )
    if kind == "md2":
        _, batch, plan1, plan2, sign, scale = entry
        return cuda_multidim.md2, (
            batch, cuda_fft.sub_tables(plan1, sign, keys, arrays),
            cuda_fft.sub_tables(plan2, sign, keys, arrays), scale,
        )
    if kind in ("realsf", "realsb"):
        _, n, batch, sign, scale = entry
        w, m = keys[("W", n, sign)], keys[("RM", n, sign)]
        return cuda_real.small_real, (batch, cuda_real.SmallRealTables(
            n, sign, scale, arrays[w + "r"], arrays[w + "i"], arrays[m + "m"]
        ))
    if kind in ("realf", "realb"):
        _, _, h, batch, sign, scale = entry
        r = keys[("R", 2 * h, sign)]
        kernel = cuda_real.untangle if kind == "realf" else cuda_real.retangle
        return kernel, (batch, h, arrays[r + "r"], arrays[r + "i"], scale)
    _, plan0, batch, sign, scale = entry
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
    float32 input buffer on the plan's device, of exactly the entry's input
    count; ``out`` (C2C only; may be ``raw``) receives the result."""
    kind = entry[0]
    if kind == "multidim":
        (head, head_args), *rest = [kernel_args(committed, s) for s in entry[2]]

        def fn(raw, out=None):
            x = head(raw, *head_args, out=out)
            for kernel, args in rest:
                x = kernel(x, *args, out=x)
            return x

        return fn
    kernel, args = kernel_args(committed, entry)
    if kind in ("realf", "realb"):
        c2c, c2c_args = kernel_args(committed, entry[1])
        if kind == "realf":

            def fn(raw):
                # the real rows are the h-point input z = x_even + i·x_odd
                return kernel(c2c(raw, *c2c_args), *args)

        else:

            def fn(raw):
                z = kernel(raw, *args)
                # the h-point transform of Z, in place, is the real rows
                return c2c(z, *c2c_args, out=z)

        return fn
    if kind in ("realsf", "realsb"):

        def fn(raw):
            return kernel(raw, *args)

        return fn

    def fn(raw, out=None):
        return kernel(raw, *args, out=out)

    return fn
