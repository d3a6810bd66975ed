"""tuned_pct (tuning, program counter): the share of the tuning table's
outcomes at the run's commits that were hits, hits / (hits + misses +
declined), in percent.  A miss is a tuned kind with no entry, declined a
tuned engine whose gate refused the plan (the static route then runs).
The counters are the process's, and a run's only commits are its cell's.
None where the program has no tracer or the commits looked nothing up."""


def read(run):
    try:
        from portfft_tpu_torch.utils import tracing
    except ImportError:
        return None
    counts = tracing.tuning_outcomes()
    total = sum(counts.values())
    return counts["hit"] / total * 100 if total else None
