"""The device's idle time in a traced segment, split by the program's span
the host was in: each instant of the segment at which no operation ran on
the device goes to the innermost of the program's spans open on the host
then, seen through ``portfft.axis`` and ``portfft.glue`` (the tracer's
``WITHIN``), and through it to its layer:

- ``call``: ``portfft.call`` itself (validation, conversion, the entry's
  Python);
- ``exec``: ``portfft.exec`` itself (the plane executor's walk);
- ``wrapper``: a kernel wrapper's ``portfft.<K>`` outside its launch
  (checks, allocation, the library's load, tables);
- ``launch``: ``portfft.launch``, the call of a library entry point.

Idle outside every span is no layer's: the harness, the wake-up from a
wait, the device's start after a launch returned.

The program stamps its spans on ``time.time_ns()`` (``tracing.CLOCK``),
the Unix time onto which the profiler maps its own clock, so a span lies at
``(ns - origin) / 1e9`` on the trace's clock (:class:`devtrace.Trace`),
with no fit, the origin being the profile's ``trace_start_ns()``
(:func:`origin_ns`).  The segment's calls are the last N ``portfft.call`` roots the
program's tracer kept, N the harness's compute spans in the trace.

That the profiler keeps the device's stamps on the same clock is checked,
not assumed: on one clock a kernel that found the device idle starts after
the launch that queued it began, and soon after that launch returned.
Where a kernel of the port breaks either (:func:`disagreements`), the
device's stamps have drifted from the host's within the segment, and
there is no split."""

import bisect
import sys
import time

#: The shortest idle stretch whose closing kernel is held to the launches:
#: a kernel queued behind another starts a few µs after that one ends (25
#: at the most seen on an H100), so a shorter stretch may close with a
#: kernel launched long before it.
MIN_GAP_S = 50e-6
#: How far a kernel may seem to start before the launch that queued it
#: began, the two stamps' own error.
EARLY_S = 10e-6
#: How long after its launch returned an idle device may take to start a
#: kernel.
LATE_S = 50e-6


def profile_origin_ns(prof):
    """The Unix ns at which the clock of ``prof``'s trace reads 0, or None
    where the profile does not say."""
    try:
        return prof.profiler.kineto_results.trace_start_ns()
    except AttributeError:
        return None


def origin_ns(trc):
    """The Unix ns at which ``trc``'s clock reads 0, or None.  A
    :class:`devtrace.Trace` keeps no origin (its times count from the
    profile's start), so one that carries none as ``origin_ns`` takes it
    from the profile it was collected from: the nearest caller whose locals
    hold ``trc`` as ``trc`` beside that profile as ``prof``, as
    ``run.run_cell`` does while it calls the readers."""
    if getattr(trc, "origin_ns", None) is not None:
        return trc.origin_ns
    frame = sys._getframe(1)
    while frame is not None:
        local = frame.f_locals
        if local.get("trc") is trc and "prof" in local:
            return profile_origin_ns(local["prof"])
        frame = frame.f_back
    return None


def disagreements(trc, launches: list, lo: float, hi: float) -> tuple:
    """``(early, late)``: the device operations ``(name, start, end)`` of
    the port's kernels that start in ``[lo, hi]`` after an idle stretch of
    at least ``MIN_GAP_S`` and start before the last launch that began by
    then (give or take ``EARLY_S``) was open in the stretch (early: they
    began before the launch that queued them), or more than ``LATE_S``
    after that launch returned (late).  ``launches``: the ``(start,
    end)`` of the ``portfft.launch`` spans on the trace's clock, in order;
    ``trc``: a :class:`devtrace.Trace`."""
    from portfft_tpu_torch.utils import tracing

    starts = [a for a, _ in launches]
    early, late = [], []
    reach = trc.start  # the end of the device's busy time so far
    for op in sorted(trc.ops, key=lambda op: op[1]):
        name, a, b = op
        gap_start, reach = reach, max(reach, b)
        if a - gap_start < MIN_GAP_S or not lo <= a <= hi or not tracing.kernels_of(name):
            continue
        i = bisect.bisect_right(starts, a + EARLY_S) - 1
        if i < 0 or launches[i][1] + EARLY_S < gap_start:
            early.append(op)
        elif a > launches[i][1] + LATE_S:
            late.append(op)
    return early, late


def split(run):
    """``{layer: percent of the segment}`` for each layer some span of the
    segment's calls belongs to, on the base of ``device_idle_pct``; None
    where the program has no tracer on the trace's clock, the trace holds
    no device operation or has no clock origin, the tracer kept fewer
    calls than the segment made, or the device's stamps disagree with the
    launches (:func:`disagreements`)."""
    try:
        from portfft_tpu_torch.utils import tracing
    except ImportError:
        return None
    trc = run.trace
    if (trc is None or not trc.ops or getattr(tracing, "CLOCK", None) is not time.time_ns):
        return None
    origin = origin_ns(trc)
    if origin is None:
        return None
    n = sum(s[0].startswith("compute_") for s in trc.spans)
    calls = tracing.calls(n)
    if not calls or len(calls) != n:
        return None
    def clock(ns: int) -> float:
        return (ns - origin) / 1e9

    launches = sorted((clock(s.start_ns), clock(s.end_ns))
                      for c in calls for s in c.spans if s.name == tracing.LAUNCH)
    if any(disagreements(trc, launches, clock(calls[0].root.start_ns),
                         clock(calls[-1].root.end_ns))):
        return None
    layers = {tracing.PREFIX + "call": "call", tracing.PREFIX + "exec": "exec",
              tracing.LAUNCH: "launch"}
    layers.update((tracing.PREFIX + k, "wrapper") for k in tracing.KERNELS)

    idle, t = [], trc.start
    for lo, hi in trc.busy() + [[trc.end, trc.end]]:
        if lo > t:
            idle.append((t, lo))
        t = max(t, hi)
    starts = [lo for lo, _ in idle]

    def idle_in(lo_ns: int, hi_ns: int) -> float:
        lo, hi = clock(lo_ns), clock(hi_ns)
        i, total = max(bisect.bisect_right(starts, lo) - 1, 0), 0.0
        while i < len(idle) and idle[i][0] < hi:
            total += max(0.0, min(hi, idle[i][1]) - max(lo, idle[i][0]))
            i += 1
        return total

    out: dict = {}
    for call in calls:
        for span in call.spans:
            layer = layers.get(span.name)
            if layer is None:
                continue
            own, t = 0.0, span.start_ns
            for child in sorted(call.children(span), key=lambda s: s.start_ns):
                if child.start_ns > t:
                    own += idle_in(t, child.start_ns)
                t = max(t, child.end_ns)
            if span.end_ns > t:
                own += idle_in(t, span.end_ns)
            out[layer] = out.get(layer, 0.0) + own
    return {layer: s / trc.window_s * 100 for layer, s in out.items()}
