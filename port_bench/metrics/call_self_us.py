"""call_self_us (registry and call, program span): the median over the
traced segment's calls of the host time inside ``portfft.call`` that no
child span covers (validation, buffer conversion, the entry's own Python),
in microseconds.  The segment's calls are the last N ``portfft.call`` roots
the program's tracer kept, N the harness's compute spans in the trace.
None where the program has no tracer."""

import statistics


def read(run):
    try:
        from portfft_tpu_torch.utils import tracing
    except ImportError:
        return None
    if run.trace is None:
        return None
    n = sum(s[0].startswith("compute_") for s in run.trace.spans)
    calls = tracing.calls(n)
    if not calls:
        return None
    return statistics.median(c.self_ns(c.root) for c in calls) / 1e3
