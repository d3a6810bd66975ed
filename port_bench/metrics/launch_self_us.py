"""launch_self_us (kernels, program span): the median over the traced
segment's calls of the host time inside the kernel wrappers' spans
(``portfft.K1``, ``portfft.K2-v2``, ...: argument checks, allocation, the
library load, the launch and its error check), summed over the call, in
microseconds.  The segment's calls are the last N ``portfft.call`` roots
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
    return statistics.median(c.kernel_ns() for c in calls) / 1e3
