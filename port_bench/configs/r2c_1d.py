"""Plain reference of the ``r2c_1d`` configuration: real fp32 forward
transforms (R2C), 1D, PACKED, out of place, forward_scale 1.

The program takes ``batch·n`` reals and returns the ``n/2 + 1`` bins of each
transform as raw float32 (re, im) pairs.  The reference is ``torch.fft.rfft``
in float64, which shares no code with the program under test; its control
is the same transform computed as a TF32 pipeline would keep it (input and
output rounded to TF32's 10-bit mantissa, fp32 between).

A call spec is a dict with ``lengths`` (one length), ``batch`` and
``direction`` (``forward`` only).
"""

from __future__ import annotations

import torch

from port_bench.lowprec import round_tf32

DIRECTIONS = ("forward",)


def _n(spec) -> int:
    (n,) = spec["lengths"]
    return n


def make_pool(gen: torch.Generator, spec, count: int, device) -> torch.Tensor:
    """``count`` inputs of one call, as one float32 tensor ``[count,
    batch·n]`` uniform in [-1, 1)."""
    x = torch.empty(count, spec["batch"] * _n(spec), device=device)
    return x.uniform_(-1.0, 1.0, generator=gen)


def in_rows(x: torch.Tensor, spec, rows: torch.Tensor) -> torch.Tensor:
    """The transforms ``rows`` of one call's input, ``[r, n]``."""
    return x.view(spec["batch"], _n(spec)).index_select(0, rows)


def out_rows(y: torch.Tensor, spec, rows: torch.Tensor) -> torch.Tensor:
    """The bins of the transforms ``rows`` of one call's output, complex64
    ``[r, n/2 + 1]``, copied."""
    bins = y.view(spec["batch"], _n(spec) // 2 + 1, 2).index_select(0, rows)
    return torch.view_as_complex(bins)


def reference(x_rows: torch.Tensor, spec) -> torch.Tensor:
    """The half spectra of ``x_rows`` in complex128."""
    return torch.fft.rfft(x_rows.to(torch.float64), dim=1)


def control(x: torch.Tensor, spec) -> torch.Tensor:
    """The reference in TF32, put in the program's place: one call's output
    from its input ``x``, as raw float32 pairs."""
    y = torch.fft.rfft(round_tf32(x).view(spec["batch"], _n(spec)), dim=1)
    return torch.view_as_real(round_tf32(y)).reshape(-1)
