"""real_axis_roofline_pct (kernels, device trace): the least time of the
REAL step of every multi-dim REAL call in the traced segment (the last
axis's R2C or C2R: 4·b·N + 8·b·bins bytes, 2.5·n·log2 n flops a row of n,
at 3.35 TB/s and 67 TFLOP/s), over the device time of the kernels that ran
that step (``steps.py``: the ``portfft.axis`` notes name them), in
percent.  None where the notes are missing or one kernel ran both steps."""

from port_bench import steps


def read(run):
    return steps.roofline_pct(run, steps.REAL)
