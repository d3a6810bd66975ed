"""The steps of a multi-dim C2C call, for the per-step roofline metrics
(``metrics/plane_axes_roofline_pct.py``,
``metrics/c2c_outer_axes_roofline_pct.py``): each step's work from the
call's shapes alone, which kernels ran it, and their device time in a
traced segment.

A step is what the program's tracer records as one ``portfft.axis`` span of
a call, as ``steps.py`` reads it: its note gives the axes the step
transforms and its kernels in the order they ran (``"1,2 K11"``, ``"0
K10"``, ``"2 K1"``).  A step whose axes hold one of the call's two trailing
axes belongs to the plane; the others transform the outer axes.

Work of one call of ``batch`` transforms of N points whose two trailing
axes are n₋₂ and n₋₁, the same both ways:

- the plane: the two trailing axes as one 2D transform of b·∏outer planes,
  16·b·N bytes (read and written once) and 5·b·N·log2(n₋₂·n₋₁) flops;
- the outer axes: for each outer axis L > 1, 16·b·N bytes and
  5·b·N·log2 L flops.

A step's least time is the larger of its bytes over 3.35 TB/s and its flops
over 67 TFLOP/s (``work.py``).  Its device time is the union of the
intervals of the traced operations that ``tracing.kernels_of`` maps to one
of its kernels, whatever kernels a later program puts on the step.
"""

from __future__ import annotations

import dataclasses
import math

from port_bench import work

PLANE, OUTER = "plane", "outer"


def step_work(step: str, lengths, batch: int) -> tuple[int, float]:
    """``(bytes, flops)`` of the ``step`` (``PLANE`` or ``OUTER``) of one
    call of ``batch`` C2C transforms of ``lengths``."""
    points = batch * math.prod(lengths)
    if step == PLANE:
        return 16 * points, 5.0 * points * math.log2(math.prod(lengths[-2:]))
    axes = [ln for ln in lengths[:-2] if ln > 1]
    return 16 * points * len(axes), sum(5.0 * points * math.log2(ln) for ln in axes)


def least_s(step: str, lengths, batch: int) -> float:
    nbytes, flops = step_work(step, lengths, batch)
    return max(nbytes / work.HBM_BYTES_PER_S, flops / work.FP32_FLOPS_PER_S)


def step_kernels(calls) -> dict | None:
    """``{PLANE: K-numbers, OUTER: K-numbers}`` of the steps of ``calls``
    (the tracer's ``Call`` records), from their ``portfft.axis`` notes;
    None where a call has no such note, a note names no kernel or carries a
    precision mark, or one kernel ran steps of both groups."""
    kernels: dict = {PLANE: set(), OUTER: set()}
    for call in calls:
        notes = [s.note.split(" ") for s in call.named("portfft.axis")]
        if not notes or any(len(n) != 2 or not n[1] for n in notes):
            return None
        axes = [{int(a) for a in n[0].split(",")} for n in notes]
        last = max(max(a) for a in axes)
        for a, (_, names) in zip(axes, notes):
            kernels[PLANE if a & {last - 1, last} else OUTER].update(names.split("+"))
    if not calls or kernels[PLANE] & kernels[OUTER]:
        return None
    return kernels


def roofline_pct(run, step: str):
    """The traced segment's calls' least time of ``step`` over the device
    time of that step's kernels, in percent; None where the program has no
    tracer, the trace holds no device operation of the step, or the notes
    cannot tell the steps apart (``step_kernels``)."""
    try:
        from portfft_tpu_torch.utils import tracing
    except ImportError:
        return None
    trc = run.trace
    if trc is None or not trc.ops or not hasattr(tracing, "kernels_of"):
        return None
    n = sum(s[0].startswith("compute_") for s in trc.spans)
    kernels = step_kernels(tracing.calls(n))
    if kernels is None or not kernels[step]:
        return None
    mine = [op for op in trc.ops if set(tracing.kernels_of(op[0])) & kernels[step]]
    busy = dataclasses.replace(trc, ops=mine).busy_s()
    if not busy:
        return None
    least = trc.rounds * sum(least_s(step, spec.lengths, spec.batch) for spec in run.specs)
    return least / busy * 100
