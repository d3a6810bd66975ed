"""c2c_outer_axes_roofline_pct (kernels, device trace): the least time of
the outer axes of every multi-dim C2C call in the traced segment (for each
outer axis L > 1, 16·b·N bytes and 5·b·N·log2 L flops, at 3.35 TB/s and
67 TFLOP/s), over the device time of the kernels whose steps'
``portfft.axis`` notes name those axes (``steps_c2c.py``), in percent.  None
where the notes are missing or one kernel ran steps of both groups."""

from port_bench import steps_c2c


def read(run):
    return steps_c2c.roofline_pct(run, steps_c2c.OUTER)
