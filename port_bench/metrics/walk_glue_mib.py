"""walk_glue_mib (plane executor, program counter): the bytes the plane
executor's copies and multiplies wrote outside the port's kernels, a call,
averaged over the traced segment's calls, in MiB (2^20 bytes).  The
program counts them at each copy (``tracing.glue_bytes``), and under the
profiler marks each in its call (``Call.glue_bytes``).  The segment's
calls are the last N ``portfft.call`` roots, N the harness's compute spans
in the trace.  None where the program has no such counter or no tracer."""


def read(run):
    try:
        from portfft_tpu_torch.utils import tracing
    except ImportError:
        return None
    if run.trace is None or not hasattr(tracing, "glue_bytes"):
        return None
    n = sum(s[0].startswith("compute_") for s in run.trace.spans)
    calls = tracing.calls(n)
    if not calls:
        return None
    return sum(c.glue_bytes() for c in calls) / len(calls) / 2**20
