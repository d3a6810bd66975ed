"""exec_self_us (plane executor, program span): the median over the traced
segment's calls on the plane path of the host time inside
``portfft.exec`` (the executor's walk of the plan tree and its glue) that
no kernel span covers, in microseconds.  The segment's calls are the last
N ``portfft.call`` roots the program's tracer kept, N the harness's
compute spans in the trace.  None where the program has no tracer or no
call ran the executor."""

import statistics


def read(run):
    try:
        from portfft_tpu_torch.utils import tracing
    except ImportError:
        return None
    if run.trace is None:
        return None
    n = sum(s[0].startswith("compute_") for s in run.trace.spans)
    own = [c.self_ns(s) for c in tracing.calls(n) for s in c.named("portfft.exec")]
    return statistics.median(own) / 1e3 if own else None
