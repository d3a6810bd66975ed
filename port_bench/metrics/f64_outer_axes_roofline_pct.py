"""f64_outer_axes_roofline_pct (kernels, device trace): the least time of
the outer axes' C2C steps of every fp64 multi-dim REAL call in the traced
segment (32·b·bins bytes and 5·bins·log2 L flops a transform for each outer
axis L, at 3.35 TB/s and 34 TFLOP/s), over the device time of the kernels
that ran those steps (``steps_f64.py``: the ``portfft.axis`` notes marked
``f64`` name them), in percent.  None where the notes are missing or not
marked ``f64``, or one kernel ran both kinds of step."""

from port_bench import steps_f64


def read(run):
    return steps_f64.roofline_pct(run, steps_f64.OUTER)
