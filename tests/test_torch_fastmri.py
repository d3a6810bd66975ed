"""The fastMRI multi-coil knee transform on the port's per-axis walk, on the
CPU (the kernels' plain versions), against the benchmark's plain reference
``port_bench/configs/fastmri_knee.py`` (``torch.fft`` in complex128,
``norm="ortho"``).

At the published lengths 640 × 368 and at 640 × 23, which takes the same
route, the plan commits on the ``core`` entry with no column kernel
(``k12 == ()``: K12's trailing tile declines 368 and 23) and K13 on both
axes, and both directions at the orthonormal scale 1/√N match the
reference.  Tolerance: the widest |error| at most ``TOL`` of the
reference's root mean square.  The port's fp32 path reads 1.6e-6–2.1e-6
(about 18 radix stages and two scalings at eps = 6e-8); ``TOL`` is five
times that, and a TF32 pipeline (10-bit mantissa, the configuration's
``control``) reads about 1e-3, a hundred times above it.
"""

import math

import pytest
import torch

import portfft_tpu_torch as pt
from portfft_tpu_torch import fastpath
from port_bench import run
from port_bench.tests.conftest import ROOT

TOL = 1e-5
CASES = [([640, 368], 2), ([640, 23], 16)]


@pytest.fixture(scope="module")
def reference():
    return run.Bench(ROOT).config("fastmri_knee")[1]


def _scale(lengths) -> float:
    return 1 / math.sqrt(math.prod(lengths))


def _plan(lengths, batch):
    s = _scale(lengths)
    return pt.Descriptor(lengths=lengths, number_of_transforms=batch, forward_scale=s,
                         backward_scale=s).commit(device="cpu")


def _input(lengths, batch, seed):
    gen = torch.Generator().manual_seed(seed)
    raw = torch.empty(batch * math.prod(lengths), 2).uniform_(-1.0, 1.0, generator=gen)
    return torch.view_as_complex(raw)


def _error(got, want) -> float:
    """The widest |error| as a share of ``want``'s root mean square, as the
    benchmark's check reads it."""
    want = want.reshape(-1)
    rms = want.abs().square().mean().sqrt()
    return float((got.reshape(-1).to(want.dtype) - want).abs().max() / rms)


def test_the_published_scale_is_orthonormal():
    spec = run.Bench(ROOT).config("fastmri_knee")[0]["descriptor"]
    assert spec["forward_scale"] == spec["backward_scale"] == _scale([640, 368])


@pytest.mark.parametrize("lengths,batch", CASES)
def test_the_plan_takes_the_per_axis_walk(lengths, batch):
    plan = _plan(lengths, batch)
    for direction in pt.Direction:
        entry = plan._raw_fast[direction]
        assert isinstance(entry, fastpath.Core)
        assert entry.split is False and entry.batch == batch
        assert entry.scale == _scale(lengths)
        assert entry.k12 == ()
        assert entry.routes == {640: "chain", lengths[1]: "direct"}


@pytest.mark.parametrize("direction", ["forward", "backward"])
@pytest.mark.parametrize("lengths,batch", CASES)
def test_both_directions_match_the_reference(reference, lengths, batch, direction):
    plan = _plan(lengths, batch)
    spec = {"lengths": lengths, "batch": batch, "direction": direction}
    x = _input(lengths, batch, seed=batch + len(direction))
    fn = plan.compute_forward if direction == "forward" else plan.compute_backward
    y = fn(x)
    assert y.dtype == torch.complex64 and y.shape == x.shape
    want = reference.reference(x.view(batch, -1), spec)
    assert _error(y, want) <= TOL
    # the control, a TF32 pipeline in the program's place, fails the same
    # tolerance by far
    assert _error(reference.control(x, spec), want) > 20 * TOL
