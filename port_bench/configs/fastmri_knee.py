"""Plain reference of the ``fastmri_knee`` configuration: complex fp32 2D
transforms of 640 × 368 (fastMRI multi-coil knee k-space), INTERLEAVED,
PACKED, out of place, forward_scale and backward_scale 1/√(640·368): the
orthonormal ``fft2c`` and ``ifft2c`` of ``fastmri/fftc.py``.

The reference is ``torch.fft.fftn`` / ``ifftn`` in float64 (complex128) over
the two axes of each transform with ``norm="ortho"``, which shares no code
with the program under test.  One departure from ``fftc.py``: its
``ifftshift`` before and ``fftshift`` after the transform are the
caller's ``torch.roll`` and stay outside the library call here, as they
stay outside ``torch.fft`` in fastMRI.  The control is the same transform
as a TF32 pipeline would keep it: input and output rounded to TF32's
10-bit mantissa, fp32 between (``lowprec.round_tf32``, as ``c2c_1d.py``).

A call spec is a dict with ``lengths``, ``batch`` and ``direction``; a call
holds ``batch`` transforms (slices × coils) of ``lengths``.
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


def _transform(x: torch.Tensor, spec) -> torch.Tensor:
    """The orthonormal transform of ``x`` ``[r, *lengths]`` in the spec's
    direction: sign -1 forward, +1 backward, 1/√N either way."""
    fn = torch.fft.fftn if spec["direction"] == "forward" else torch.fft.ifftn
    return fn(x, dim=_dims(spec), norm="ortho")


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
    """The transforms of ``x_rows`` in complex128."""
    x = x_rows.to(torch.complex128).view(-1, *spec["lengths"])
    return _transform(x, spec).reshape(x_rows.shape[0], -1)


def control(x: torch.Tensor, spec) -> torch.Tensor:
    """The reference in TF32, put in the program's place: one call's output
    from its input ``x``, in the program's format."""
    y = _transform(round_tf32(x).view(-1, *spec["lengths"]), spec)
    return round_tf32(y.reshape(-1))
