"""One time step of the Taylor-Green DNS through portfft_tpu_torch's fp64 REAL
plans, on the CPU (the kernels' plain versions in float64).

The solver is the benchmark configuration's plain one
(``port_bench/configs/taylor_green_dns.py``: the spectralDNS listing's
``computeRHS`` four times, classical RK4), run at N = 16 from the
Taylor-Green initial condition once with the port's ``compute_forward`` /
``compute_backward`` as its ``fftn`` / ``ifftn`` (36 transforms of one
component) and once with ``torch.fft.rfftn`` / ``irfftn``.  The two steps
agree within the fp64 oracle bound 2·eps·N·log2N (absolute or relative,
``tests/oracle.py``); the initial kinetic energy is 1/8, the step loses it
at the vortex's initial dissipation rate, and the velocity stays
divergence-free.
"""

import math

import numpy as np
import pytest
import torch

import portfft_tpu_torch as pt
from oracle import tolerance
from port_bench import run
from port_bench.tests.conftest import ROOT

N = 16
DT = 0.01


@pytest.fixture(scope="module")
def solver():
    return run.Bench(ROOT).config("taylor_green_dns")[1]


@pytest.fixture(scope="module")
def plan():
    return pt.Descriptor(lengths=[N, N, N], domain=pt.Domain.REAL, precision="fp64",
                         backward_scale=1.0 / N**3).commit(device="cpu")


def _port(plan):
    """``(fftn, ifftn)`` of one (N, N, N) component through the plan,
    counting the calls."""
    calls = []

    def fftn(u):
        calls.append("forward")
        y = plan.compute_forward(u.reshape(-1))
        assert y.dtype == torch.float64
        return torch.view_as_complex(y.view(N, N, N // 2 + 1, 2))

    def ifftn(u_hat):
        calls.append("backward")
        y = plan.compute_backward(u_hat.reshape(-1))
        assert y.dtype == torch.float64
        return y.view(N, N, N)

    return fftn, ifftn, calls


def _torch():
    return (lambda u: torch.fft.rfftn(u),
            lambda u_hat: torch.fft.irfftn(u_hat, s=(N, N, N)))


def test_the_initial_kinetic_energy_is_an_eighth(solver, plan):
    fftn, ifftn, _ = _port(plan)
    U = solver.taylor_green(N)
    assert solver.kinetic_energy(U) == pytest.approx(1 / 8, abs=1e-15)
    U_hat = torch.stack([fftn(U[i]) for i in range(3)])
    back = torch.stack([ifftn(U_hat[i]) for i in range(3)])
    assert solver.kinetic_energy(back) == pytest.approx(1 / 8, abs=1e-14)


def test_an_rk4_step_through_the_port_matches_torch_fft(solver, plan):
    fftn, ifftn, calls = _port(plan)
    U = solver.taylor_green(N)
    start = torch.fft.rfftn(U, dim=(1, 2, 3))
    got = solver.rk4_step(start, DT, fftn, ifftn)
    want = solver.rk4_step(start, DT, *_torch())
    # four stages of 6 C2R and 3 R2C, one component a call
    assert calls.count("backward") == 24 and calls.count("forward") == 12
    diff = (got - want).abs().numpy()
    tol = tolerance(plan.descriptor)
    assert tol == pytest.approx(2 * np.finfo(np.float64).eps * N**3 * math.log2(N**3))
    assert np.all((diff <= tol) | (diff <= tol * want.abs().numpy())), diff.max()
    # the step is a step of the flow: the energy falls at the Taylor-Green
    # vortex's initial dissipation rate 2·nu·k^2·E = 3·nu/4 (k^2 = 3), and
    # the velocity stays divergence-free
    U1 = torch.stack([torch.fft.irfftn(got[i], s=(N, N, N)) for i in range(3)])
    rate = (1 / 8 - solver.kinetic_energy(U1)) / DT
    assert rate == pytest.approx(3 * solver.NU / 4, rel=1e-4)
    K = solver.wavenumbers(N)["K"]
    assert (K * got).sum(0).abs().max() < 1e-9 * got.abs().max()
