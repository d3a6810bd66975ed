"""Plain reference of the ``fourcastnet_afno`` configuration: real fp32 2D
transforms of 90 × 180 (FourCastNet's token grid), R2C forward and C2R
backward, INTERLEAVED, PACKED, out of place, forward_scale and
backward_scale 1/√(90·180): the ``torch.fft.rfft2`` and ``irfft2(s=(90,
180))`` with ``norm="ortho"`` of AFNO2D's token mixer
(``networks/afnonet.py`` in NVlabs/FourCastNet).

The reference is ``torch.fft.rfft2`` / ``irfft2`` in float64 over the last
two axes of each transform with ``norm="ortho"``, with TF32 off, which
shares no code with the program under test.  Departures from AFNO2D: its
activations are channels last, (B, 90, 180, 768), and its FFTs run over
``dim=(1, 2)``; here each channel's 90 × 180 grid is one contiguous
transform, the permute being the caller's, outside the call.  The
block-diagonal complex MLP and the softshrink between the two transforms
are left out: the backward input is drawn as such a spectrum would be,
with no Hermitian symmetry.  The control is the same transform as a TF32
pipeline would keep it: input and output rounded to TF32's 10-bit mantissa,
fp32 between (``lowprec.round_tf32``, as ``c2c_1d.py``).

A call spec is a dict with ``lengths``, ``batch`` and ``direction``; a call
holds ``batch`` transforms (members × channels).  Forward, the program
takes ``batch·90·180`` reals and returns the half spectra as raw float32
(re, im) pairs, ``batch·90·91`` bins; backward, it takes the half spectra
(complex64) and returns ``batch·90·180`` float32 reals.
"""

from __future__ import annotations

import math

import torch

from port_bench.lowprec import round_tf32

DIRECTIONS = ("forward", "backward")


def _bins(spec) -> tuple[int, ...]:
    """The half spectrum's shape of one transform: the last axis n/2 + 1."""
    *outer, n = spec["lengths"]
    return (*outer, n // 2 + 1)


def _dims(spec) -> tuple[int, ...]:
    return tuple(range(1, 1 + len(spec["lengths"])))


def _transform(x: torch.Tensor, spec) -> torch.Tensor:
    """The orthonormal R2C of reals ``x`` ``[r, *lengths]`` forward, or the
    C2R of half spectra ``x`` ``[r, *bins]`` backward (``irfftn``: the
    imaginary parts of the last axis's bins 0 and n/2 read as 0)."""
    if spec["direction"] == "forward":
        return torch.fft.rfftn(x, dim=_dims(spec), norm="ortho")
    return torch.fft.irfftn(x, s=spec["lengths"], dim=_dims(spec), norm="ortho")


def make_pool(gen: torch.Generator, spec, count: int, device) -> torch.Tensor:
    """``count`` inputs of one call: forward a float32 tensor ``[count,
    batch·N]`` of reals uniform in [-1, 1); backward a complex64 tensor
    ``[count, batch·bins]`` of half spectra whose real and imaginary parts
    are uniform in [-1, 1)."""
    if spec["direction"] == "forward":
        x = torch.empty(count, spec["batch"] * math.prod(spec["lengths"]), device=device)
        return x.uniform_(-1.0, 1.0, generator=gen)
    raw = torch.empty(count, 2 * spec["batch"] * math.prod(_bins(spec)), device=device)
    raw.uniform_(-1.0, 1.0, generator=gen)
    return torch.view_as_complex(raw.view(count, -1, 2))


def in_rows(x: torch.Tensor, spec, rows: torch.Tensor) -> torch.Tensor:
    """The transforms ``rows`` of one call's input, ``[r, N]`` reals or
    ``[r, bins]`` complex."""
    return x.view(spec["batch"], -1).index_select(0, rows)


def out_rows(y: torch.Tensor, spec, rows: torch.Tensor) -> torch.Tensor:
    """The transforms ``rows`` of one call's output, copied: forward the
    half spectra as complex64 ``[r, bins]``, backward float32 ``[r, N]``.
    An output of another size or kind than the program's reads as infinite
    there, so that the check fails instead of the run."""
    forward = spec["direction"] == "forward"
    width = 2 * math.prod(_bins(spec)) if forward else math.prod(spec["lengths"])
    if y.dtype != torch.float32 or y.numel() != spec["batch"] * width:
        shape = (rows.numel(), width // 2 if forward else width)
        return torch.full(shape, math.inf, dtype=torch.complex64 if forward
                          else torch.float32, device=rows.device)
    got = y.view(spec["batch"], width).index_select(0, rows)
    return torch.view_as_complex(got.view(rows.numel(), -1, 2)) if forward else got


def reference(x_rows: torch.Tensor, spec) -> torch.Tensor:
    """The transforms of ``x_rows`` in float64 (complex128 half spectra
    forward, float64 reals backward), ``[r, -1]``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shape = spec["lengths"] if spec["direction"] == "forward" else _bins(spec)
    wide = torch.float64 if spec["direction"] == "forward" else torch.complex128
    x = x_rows.to(wide).view(-1, *shape)
    return _transform(x, spec).reshape(x_rows.shape[0], -1)


def control(x: torch.Tensor, spec) -> torch.Tensor:
    """The reference in TF32, put in the program's place: one call's output
    from its input ``x``, in the program's format."""
    forward = spec["direction"] == "forward"
    shape = spec["lengths"] if forward else _bins(spec)
    y = round_tf32(_transform(round_tf32(x).view(-1, *shape), spec))
    return (torch.view_as_real(y) if forward else y).reshape(-1)
