"""Plain reference of the ``pynx_bcdi`` configuration: complex fp32 3D
transforms of 512^3 (a Bragg CDI object and its diffraction-space
wavefield), INTERLEAVED, PACKED, out of place, forward_scale and
backward_scale 512^-1.5: the L2-preserving FT and IFT that every ER, HIO
and RAAR cycle of PyNX's ``pynx.cdi`` runs (Favre-Nicolin et al., J. Appl.
Cryst. 53, 2020), NumPy's ``norm="ortho"``.

The reference is ``torch.fft.fftn`` / ``ifftn`` in complex128 over the three
axes of each transform with ``norm="ortho"`` and TF32 off, which shares no
code with the program under test.  Departure from a PyNX cycle: the modulus
projection between the two transforms and the support projection after
them are left out of the call (``er_cycle`` below holds them); the input of
either direction is drawn as uniform complex numbers, since after the
modulus projection the spectrum has no symmetry.  The control is the same
transform as a TF32 pipeline would keep it: input and output rounded to
TF32's 10-bit mantissa, fp32 between (``lowprec.round_tf32``, as
``fourcastnet_afno.py``).

A call spec is a dict with ``lengths``, ``batch`` and ``direction``; a call
holds ``batch`` objects of ``lengths``.

The module also holds one cycle of error reduction (ER, Fienup 1982, as
PyNX's ``ER`` operator runs it), written against a pair of transform
functions, so that a test can run the same cycles through the program's
plans and through ``torch.fft``.
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
    copied.  An output of another size or kind than the program's reads as
    infinite there, so that the check fails instead of the run."""
    n = _points(spec)
    if y.dtype != torch.complex64 or y.numel() != spec["batch"] * n:
        return torch.full((rows.numel(), n), math.inf, dtype=torch.complex64,
                          device=rows.device)
    return y.view(spec["batch"], -1).index_select(0, rows)


def reference(x_rows: torch.Tensor, spec) -> torch.Tensor:
    """The transforms of ``x_rows`` in complex128, ``[r, N]``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x = x_rows.to(torch.complex128).view(-1, *spec["lengths"])
    return _transform(x, spec).reshape(x_rows.shape[0], -1)


def control(x: torch.Tensor, spec) -> torch.Tensor:
    """The reference in TF32, put in the program's place: one call's output
    from its input ``x``, in the program's format."""
    y = _transform(round_tf32(x).view(-1, *spec["lengths"]), spec)
    return round_tf32(y.reshape(-1))


# -- one cycle of error reduction -------------------------------------------


def er_cycle(rho: torch.Tensor, amp: torch.Tensor, support: torch.Tensor,
             fft, ifft) -> tuple[torch.Tensor, float]:
    """One ER cycle of the object ``rho`` against the measured amplitudes
    ``amp`` (√I_obs) inside the boolean ``support``: ψ = FT(ρ), the modulus
    projection ψ' = amp·ψ/|ψ| (ψ' = amp where ψ = 0), ρ' = IFT(ψ'), and ρ'
    set to 0 outside the support.  ``fft`` and ``ifft`` are the
    orthonormal 3D transforms of one object.  Returns ``(ρ'', error)``,
    the error being Σ(|ψ| − amp)² / Σ amp², PyNX's Fourier-space χ² of the
    object the cycle started from; with L2-preserving transforms ER never
    raises it from one cycle to the next (Fienup 1982)."""
    psi = fft(rho)
    mod = psi.abs()
    err = float((mod - amp).square().sum() / amp.square().sum())
    phase = torch.where(mod > 0, psi / torch.where(mod > 0, mod, 1), 1)
    rho = ifft(amp * phase)
    return torch.where(support, rho, 0), err
