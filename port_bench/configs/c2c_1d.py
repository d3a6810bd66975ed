"""Plain reference of the ``c2c_1d`` configuration: complex fp32 transforms,
INTERLEAVED, PACKED, out of place, forward_scale and backward_scale 1.

The reference is ``torch.fft`` in float64 (complex128), which shares no code
with the program under test.  Its control is the same transform computed
as a TF32 pipeline would keep it: input and output rounded to TF32's 10-bit
mantissa, with fp32 arithmetic between, which is the least error any TF32
kernel can have (``lowprec.round_tf32``).

A call spec is a dict with ``lengths``, ``batch`` and ``direction``.
"""

from __future__ import annotations

import math

import torch

from port_bench.lowprec import round_tf32

DIRECTIONS = ("forward", "backward")


def _points(spec) -> int:
    return math.prod(spec["lengths"])


def _dims(spec) -> tuple[int, ...]:
    return tuple(range(1, 1 + len(spec["lengths"])))


def make_pool(gen: torch.Generator, spec, count: int, device) -> torch.Tensor:
    """``count`` inputs of one call, as one complex64 tensor
    ``[count, batch·N]``: real and imaginary parts uniform in [-1, 1)."""
    raw = torch.empty(count, 2 * spec["batch"] * _points(spec), device=device)
    raw.uniform_(-1.0, 1.0, generator=gen)
    return torch.view_as_complex(raw.view(count, -1, 2))


def in_rows(x: torch.Tensor, spec, rows: torch.Tensor) -> torch.Tensor:
    """The transforms ``rows`` of one call's input, ``[r, N]``."""
    return x.view(spec["batch"], -1).index_select(0, rows)


def out_rows(y: torch.Tensor, spec, rows: torch.Tensor) -> torch.Tensor:
    """The transforms ``rows`` of one call's output (complex64), ``[r, N]``,
    copied."""
    return y.view(spec["batch"], -1).index_select(0, rows)


def reference(x_rows: torch.Tensor, spec) -> torch.Tensor:
    """The transforms of ``x_rows`` in complex128: the unnormalized DFT,
    forward with the sign -1, backward with +1."""
    x = x_rows.to(torch.complex128).view(-1, *spec["lengths"])
    if spec["direction"] == "forward":
        y = torch.fft.fftn(x, dim=_dims(spec))
    else:
        y = torch.fft.ifftn(x, dim=_dims(spec), norm="forward")
    return y.reshape(x_rows.shape[0], -1)


def control(x: torch.Tensor, spec) -> torch.Tensor:
    """The reference in TF32, put in the program's place: one call's output
    from its input ``x``, in the program's format."""
    xs = round_tf32(x).view(-1, *spec["lengths"])
    if spec["direction"] == "forward":
        y = torch.fft.fftn(xs, dim=_dims(spec))
    else:
        y = torch.fft.ifftn(xs, dim=_dims(spec), norm="forward")
    return round_tf32(y.reshape(-1))
