"""The steps of a multi-dim REAL call in double precision, for the fp64
per-step roofline metrics (``metrics/f64_real_axis_roofline_pct.py``,
``metrics/f64_outer_axes_roofline_pct.py``): each step's work from the
call's shapes alone at 8 bytes a real and 16 a complex element, and its
device time in a traced segment.

A step is one ``portfft.axis`` span of a call, as ``steps.py`` reads it, but
only one whose note is marked as run in double: its axes, its kernels in
the order they ran and ``f64`` (``"2 K9 f64"``, ``"0 K10 f64"``).  A call
with a step that carries no such mark reads nothing: the counts below hold
for double alone.

Work of one call of ``batch`` transforms of N points whose last axis is n,
bins = N/n·(n/2 + 1) a transform, the same both ways:

- the REAL step: 8·b·N + 16·b·bins bytes (reals read once, half spectrum
  written once) and 2.5·n·log2 n flops a row of n;
- the outer axes: for each outer axis L > 1, 32·b·bins bytes (the half
  spectrum read and written) and 5·bins·log2 L flops a transform.

A step's least time is the larger of its bytes over 3.35 TB/s and its flops
over the fp64 peak outside the tensor cores, 34 TFLOP/s (an H100 SXM at its
full 700 W, NVIDIA's data sheet).  Its device time is the union of the
intervals of the traced operations that ``tracing.kernels_of`` maps to one
of its kernels.
"""

from __future__ import annotations

import dataclasses
import math

from port_bench import steps, work

REAL, OUTER = steps.REAL, steps.OUTER
FP64_FLOPS_PER_S = 34e12
MARK = "f64"


def step_work(step: str, lengths, batch: int) -> tuple[int, float]:
    """``(bytes, flops)`` of the ``step`` (``REAL`` or ``OUTER``) of one call
    of ``batch`` fp64 REAL transforms of ``lengths``."""
    *outer, n = lengths
    points = math.prod(lengths)
    bins = math.prod(outer) * (n // 2 + 1)
    if step == REAL:
        return 8 * batch * points + 16 * batch * bins, 2.5 * batch * points * math.log2(n)
    axes = [ln for ln in outer if ln > 1]
    return (32 * batch * bins * len(axes),
            sum(5.0 * batch * bins * math.log2(ln) for ln in axes))


def least_s(step: str, lengths, batch: int) -> float:
    nbytes, flops = step_work(step, lengths, batch)
    return max(nbytes / work.HBM_BYTES_PER_S, flops / FP64_FLOPS_PER_S)


def step_kernels(calls) -> dict | None:
    """``{REAL: K-numbers, OUTER: K-numbers}`` of the steps of ``calls``
    (the tracer's ``Call`` records) from their ``portfft.axis`` notes; None
    where a call has no such note, a note is not marked ``f64`` or names no
    kernel, or one kernel ran both kinds of step."""
    kernels: dict = {REAL: set(), OUTER: set()}
    for call in calls:
        notes = [s.note.split(" ") for s in call.named("portfft.axis")]
        if not notes or any(len(n) != 3 or n[2] != MARK or not n[1] for n in notes):
            return None
        axes = [[int(a) for a in n[0].split(",")] for n in notes]
        last = max(max(a) for a in axes)
        for a, n in zip(axes, notes):
            kernels[REAL if last in a else OUTER].update(n[1].split("+"))
    if not calls or kernels[REAL] & kernels[OUTER]:
        return None
    return kernels


def roofline_pct(run, step: str):
    """The traced segment's calls' least time of ``step`` in double over
    the device time of that step's kernels, in percent; None where the
    program has no tracer, the trace holds no device operation of the step,
    or the notes do not mark every step ``f64`` or cannot tell the steps
    apart (``step_kernels``)."""
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
