"""idle_in_program_pct (device, program span): the share of the traced
segment in which the device ran nothing while the host was inside a call
of the program (a ``portfft.call`` span), in percent: the part of
``device_idle_pct`` that the program's own host path holds, on the same
base, so never above it.

The program's spans are on ``time.perf_counter_ns()``, the trace on the
profiler's clock: each of the segment's calls (the last N ``portfft.call``
roots, N the harness's compute spans) is paired with the compute span that
encloses it, and the median of the start offsets places every root on the
profiler's clock.  None where the program has no tracer, the trace holds
no device operation, or the offsets' interquartile range passes
``MAX_SPREAD_S``, so that a bad alignment cannot pass as a reading."""

import statistics

#: The widest interquartile range of the calls' clock offsets accepted.
MAX_SPREAD_S = 20e-6


def read(run):
    try:
        from portfft_tpu_torch.utils import tracing
    except ImportError:
        return None
    trc = run.trace
    if trc is None or not trc.ops:
        return None
    computes = sorted((s for s in trc.spans if s[0].startswith("compute_")),
                      key=lambda s: s[1])
    calls = tracing.calls(len(computes))
    if not calls or len(calls) != len(computes):
        return None
    offsets = [c.root.start_ns / 1e9 - s[1] for c, s in zip(calls, computes)]
    if len(offsets) > 1:
        q1, _, q3 = statistics.quantiles(offsets, n=4)
        if q3 - q1 > MAX_SPREAD_S:
            return None
    shift = statistics.median(offsets)
    inside = sorted((c.root.start_ns / 1e9 - shift, c.root.end_ns / 1e9 - shift)
                    for c in calls)
    idle, t = [], trc.start
    for lo, hi in trc.busy() + [[trc.end, trc.end]]:
        if lo > t:
            idle.append((t, lo))
        t = max(t, hi)
    both, i = 0.0, 0
    for lo, hi in idle:  # both lists sorted; calls do not overlap
        while i < len(inside) and inside[i][1] <= lo:
            i += 1
        j = i
        while j < len(inside) and inside[j][0] < hi:
            both += max(0.0, min(hi, inside[j][1]) - max(lo, inside[j][0]))
            j += 1
    return both / trc.window_s * 100
