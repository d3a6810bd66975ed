"""roofline_pct (kernels, device trace): the least time of every call in the
traced segment (``work.least_time``: the function's bytes over 3.35 TB/s or
its flops over 67 TFLOP/s, whichever is longer), over the time the device
was busy in it (the union of its operations' intervals), in percent.  It
reads the function's work, whatever kernels run it."""


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    least = run.trace.rounds * sum(spec.least_s for spec in run.specs)
    return least / run.trace.busy_s() * 100
