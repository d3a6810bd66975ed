"""plane_axes_roofline_pct (kernels, device trace): the least time of the
two trailing axes of every multi-dim C2C call in the traced segment, as one
2D transform of b·∏outer planes (16·b·N bytes and 5·b·N·log2(n₋₂·n₋₁)
flops, at 3.35 TB/s and 67 TFLOP/s), over the device time of the kernels
whose steps' ``portfft.axis`` notes name axis −1 or −2
(``steps_c2c.py``), in percent.  None where the notes are missing or one
kernel ran steps of both groups."""

from port_bench import steps_c2c


def read(run):
    return steps_c2c.roofline_pct(run, steps_c2c.PLANE)
