"""outer_axes_roofline_pct (kernels, device trace): the least time of the
outer axes' C2C steps of every multi-dim REAL call in the traced segment
(16·b·bins bytes and 5·bins·log2 L flops a transform for each outer axis L,
at 3.35 TB/s and 67 TFLOP/s), over the device time of the kernels that ran
those steps (``steps.py``: the ``portfft.axis`` notes name them), in
percent.  None where the notes are missing or one kernel ran both kinds of
step."""

from port_bench import steps


def read(run):
    return steps.roofline_pct(run, steps.OUTER)
