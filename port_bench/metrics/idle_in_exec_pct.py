"""idle_in_exec_pct (plane executor, program span): the share of the traced
segment in which the device ran nothing while the host's innermost program
span was ``portfft.exec`` itself (the plane executor's walk, seen through
its ``portfft.axis`` spans), in percent, on the base of
``device_idle_pct``; the spans on the trace's own clock
(``port_bench/idle_by_span.py``).  None where the program has no tracer on
that clock, the trace holds no device operation or no clock origin, its
device stamps disagree with the launches, or no call of the segment ran
the executor."""

from port_bench import idle_by_span


def read(run):
    return (idle_by_span.split(run) or {}).get("exec")
