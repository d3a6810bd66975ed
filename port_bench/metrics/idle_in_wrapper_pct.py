"""idle_in_wrapper_pct (kernels, program span): the share of the traced
segment in which the device ran nothing while the host's innermost program
span was a kernel wrapper's ``portfft.<K>`` outside its ``portfft.launch``
(checks, allocation, the library's load, tables), in percent, on the base
of ``device_idle_pct``; the spans on the trace's own clock
(``port_bench/idle_by_span.py``).  None where the program has no tracer on
that clock, the trace holds no device operation or no clock origin, or its
device stamps disagree with the launches."""

from port_bench import idle_by_span


def read(run):
    return (idle_by_span.split(run) or {}).get("wrapper")
