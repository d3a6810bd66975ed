"""Plain reference of the ``taylor_green_dns`` configuration: real fp64 3D
transforms of 512^3 (one velocity or vorticity component of the
Taylor-Green vortex at Re = 1600), R2C forward and C2R backward,
INTERLEAVED, PACKED, out of place, forward_scale 1 and backward_scale
1/N^3: the ``rfftn`` and ``irfftn`` of the pseudo-spectral Navier-Stokes
solver of spectralDNS (Mortensen & Langtangen, "High performance Python for
direct numerical simulations of turbulent flows", Comput. Phys. Commun. 203,
2016), NumPy's default normalization, in float64.

The reference is ``torch.fft.rfftn`` / ``irfftn(s=lengths)`` in complex128
over the last three axes with ``norm="backward"`` and TF32 off, which shares
no code with the program under test.  The control is the same transform
computed in float32 (complex64) from the same inputs and returned in the
program's format: the step down in precision that would tempt a later
program.

A call spec is a dict with ``lengths``, ``batch`` and ``direction``; a call
holds ``batch`` transforms (components).  Forward, the program takes
``batch·N`` float64 reals and returns the half spectra as raw float64 (re,
im) pairs, ``batch·bins`` bins with bins = N/n·(n/2 + 1); backward, it takes
the half spectra (complex128) and returns ``batch·N`` float64 reals.

The module also holds one time step of the solver's classical RK4 (the
listing's ``computeRHS`` four times, ``rk4_step``) on (3, n, n, n//2 + 1)
spectra, written against a pair of transform functions, so that a test can
run the same step through the program's plans and through ``torch.fft``:
the Taylor-Green initial condition, ``curl``, ``cross``, the 2/3 dealias and
the pressure projection.
"""

from __future__ import annotations

import math

import torch

DIRECTIONS = ("forward", "backward")

#: The listing's viscosity at Re = 1600 (V0 = 1, L = 1: nu = 1/Re).
NU = 1.0 / 1600
#: RK4's weights of the four stages and the steps of the inner updates.
RK_A = (1 / 6, 1 / 3, 1 / 3, 1 / 6)
RK_B = (0.5, 0.5, 1.0)


def _bins(spec) -> tuple[int, ...]:
    """The half spectrum's shape of one transform: the last axis n/2 + 1."""
    *outer, n = spec["lengths"]
    return (*outer, n // 2 + 1)


def _dims(spec) -> tuple[int, ...]:
    return tuple(range(1, 1 + len(spec["lengths"])))


def _transform(x: torch.Tensor, spec) -> torch.Tensor:
    """The unnormalized R2C of reals ``x`` ``[r, *lengths]`` forward, or the
    C2R of half spectra ``x`` ``[r, *bins]`` times 1/N backward
    (``irfftn``: the imaginary parts of the last axis's bins 0 and n/2 read
    as 0 after the outer axes' transforms)."""
    if spec["direction"] == "forward":
        return torch.fft.rfftn(x, dim=_dims(spec), norm="backward")
    return torch.fft.irfftn(x, s=spec["lengths"], dim=_dims(spec), norm="backward")


def make_pool(gen: torch.Generator, spec, count: int, device) -> torch.Tensor:
    """``count`` inputs of one call: forward a float64 tensor ``[count,
    batch·N]`` of reals uniform in [-1, 1); backward a complex128 tensor
    ``[count, batch·bins]``, the float64 ``rfftn`` of such reals (a
    Hermitian-consistent half spectrum, as the solver's U_hat)."""
    n = spec["batch"] * math.prod(spec["lengths"])
    x = torch.empty(count, n, dtype=torch.float64, device=device)
    x.uniform_(-1.0, 1.0, generator=gen)
    if spec["direction"] == "forward":
        return x
    shape = (count * spec["batch"], *spec["lengths"])
    half = torch.fft.rfftn(x.view(shape), dim=_dims(spec))
    return half.reshape(count, -1)


def in_rows(x: torch.Tensor, spec, rows: torch.Tensor) -> torch.Tensor:
    """The transforms ``rows`` of one call's input, ``[r, N]`` reals or
    ``[r, bins]`` complex."""
    return x.view(spec["batch"], -1).index_select(0, rows)


def out_rows(y: torch.Tensor, spec, rows: torch.Tensor) -> torch.Tensor:
    """The transforms ``rows`` of one call's output, copied: forward the
    half spectra as complex128 ``[r, bins]``, backward float64 ``[r, N]``.
    An output of another size or kind than the program's reads as infinite
    there, so that the check fails instead of the run."""
    forward = spec["direction"] == "forward"
    width = 2 * math.prod(_bins(spec)) if forward else math.prod(spec["lengths"])
    if y.dtype != torch.float64 or y.numel() != spec["batch"] * width:
        shape = (rows.numel(), width // 2 if forward else width)
        return torch.full(shape, math.inf, dtype=torch.complex128 if forward
                          else torch.float64, device=rows.device)
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
    """The reference in float32 (complex64) put in the program's place: one
    call's output from its input ``x``, in the program's format (raw
    float64 pairs forward, float64 reals backward)."""
    forward = spec["direction"] == "forward"
    shape = spec["lengths"] if forward else _bins(spec)
    narrow = torch.float32 if forward else torch.complex64
    y = _transform(x.to(narrow).view(-1, *shape), spec)
    y = y.to(torch.complex128 if forward else torch.float64)
    return (torch.view_as_real(y) if forward else y).reshape(-1)


# -- one RK4 step of the pseudo-spectral solver -----------------------------


def wavenumbers(n: int, device=None) -> dict:
    """The listing's wavenumber arrays on the (n, n, n//2 + 1) half
    spectrum: ``K`` (3, ...) integer wavenumbers (the last axis's Nyquist
    taken as -n/2, ``kz[-1] *= -1``), ``K2`` = |K|^2, ``K_over_K2`` = K/K2
    (K2 = 0 read as 1) and ``dealias``, the 2/3 rule's mask (|K_i| < 2/3 ·
    (n/2 + 1) on every axis)."""
    kx = torch.fft.fftfreq(n, 1.0 / n, dtype=torch.float64, device=device)
    kz = kx[: n // 2 + 1].clone()
    kz[-1] *= -1
    K = torch.stack(torch.meshgrid(kx, kx, kz, indexing="ij"))
    K2 = (K * K).sum(0)
    kmax = 2.0 / 3.0 * (n // 2 + 1)
    return {"K": K, "K2": K2, "K_over_K2": K / torch.where(K2 == 0, 1.0, K2),
            "dealias": (K.abs() < kmax).all(0)}


def taylor_green(n: int, device=None) -> torch.Tensor:
    """The Taylor-Green initial velocity (3, n, n, n) on the 2π-periodic
    grid: u = sin x cos y cos z, v = -cos x sin y cos z, w = 0."""
    x = torch.arange(n, dtype=torch.float64, device=device) * (2 * math.pi / n)
    X = torch.meshgrid(x, x, x, indexing="ij")
    return torch.stack([torch.sin(X[0]) * torch.cos(X[1]) * torch.cos(X[2]),
                        -torch.cos(X[0]) * torch.sin(X[1]) * torch.cos(X[2]),
                        torch.zeros_like(X[0])])


def kinetic_energy(U: torch.Tensor) -> float:
    """The listing's k = 0.5·mean(U·U) of a (3, n, n, n) velocity."""
    return float(0.5 * (U * U).sum(0).mean())


def curl(U_hat: torch.Tensor, K: torch.Tensor, ifftn) -> torch.Tensor:
    """The vorticity in physical space, ``ifftn`` of i K × U_hat, one
    component a call (the listing's ``Curl``)."""
    return torch.stack([
        ifftn(1j * (K[1] * U_hat[2] - K[2] * U_hat[1])),
        ifftn(1j * (K[2] * U_hat[0] - K[0] * U_hat[2])),
        ifftn(1j * (K[0] * U_hat[1] - K[1] * U_hat[0])),
    ])


def cross(a: torch.Tensor, b: torch.Tensor, fftn) -> torch.Tensor:
    """``fftn`` of a × b, one component a call (the listing's ``Cross``)."""
    return torch.stack([fftn(a[1] * b[2] - a[2] * b[1]),
                        fftn(a[2] * b[0] - a[0] * b[2]),
                        fftn(a[0] * b[1] - a[1] * b[0])])


def compute_rhs(U_hat: torch.Tensor, waves: dict, fftn, ifftn,
                nu: float = NU) -> torch.Tensor:
    """The listing's ``computeRHS``: the velocity (3 C2R) and vorticity (3
    C2R) in physical space, the nonlinear term U × curl back (3 R2C),
    dealiased, the pressure projected out and the viscous term added."""
    K = waves["K"]
    U = torch.stack([ifftn(U_hat[i]) for i in range(3)])
    dU = cross(U, curl(U_hat, K, ifftn), fftn) * waves["dealias"]
    P_hat = (dU * waves["K_over_K2"]).sum(0)
    return dU - P_hat * K - nu * waves["K2"] * U_hat


def rk4_step(U_hat: torch.Tensor, dt: float, fftn, ifftn, nu: float = NU) -> torch.Tensor:
    """One time step of classical RK4 from the spectra ``U_hat`` (3, n, n,
    n//2 + 1), as the listing's time loop: four ``compute_rhs`` stages.
    ``fftn`` takes an (n, n, n) float64 field to its complex128 half
    spectrum, unnormalized; ``ifftn`` the reverse, times 1/n^3."""
    waves = wavenumbers(U_hat.shape[1], U_hat.device)
    U_hat0, U_hat1 = U_hat, U_hat.clone()
    cur = U_hat
    for rk in range(4):
        dU = compute_rhs(cur, waves, fftn, ifftn, nu)
        if rk < 3:
            cur = U_hat0 + RK_B[rk] * dt * dU
        U_hat1 = U_hat1 + RK_A[rk] * dt * dU
    return U_hat1
