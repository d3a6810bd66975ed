"""f64_real_axis_roofline_pct (kernels, device trace): the least time of the
REAL step of every fp64 multi-dim REAL call in the traced segment (the last
axis's R2C or C2R in double: 8·b·N + 16·b·bins bytes, 2.5·n·log2 n flops a
row of n, at 3.35 TB/s and 34 TFLOP/s), over the device time of the kernels
that ran that step (``steps_f64.py``: the ``portfft.axis`` notes marked
``f64`` name them), in percent.  None where the notes are missing or not
marked ``f64``, or one kernel ran both steps."""

from port_bench import steps_f64


def read(run):
    return steps_f64.roofline_pct(run, steps_f64.REAL)
