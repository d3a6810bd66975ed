"""Multi-dimensional REAL transforms of portfft_tpu_torch (R2C forward, C2R
backward) on the CPU (the kernels' plain versions): the route, FourCastNet's
AFNO transform against the benchmark's plain reference
(``port_bench/configs/fourcastnet_afno.py``: ``torch.fft.rfft2``/``irfft2``
in float64, ``norm="ortho"``), parity with portfft_tpu
(``commit(use_pallas=True)``), the C2R bin rule, what still raises, and the
``portfft.axis`` span of each step.

Tolerances.  Against the plain reference the widest |error| is at most
``TOL`` of the reference's root mean square, as the benchmark's check reads
it: the port's fp32 route reads 0.6e-6–2.4e-6 (K9's 180-term sums and K10's
90-term sums at eps = 6e-8, and one scaling); ``TOL`` is four times the
largest, and the TF32 ``control`` (10-bit mantissa) reads about 1e-3, a
hundred times above it.  Against the JAX package, which runs the same
mathematics by other kernels in fp32: max|Δ| ≤ ``PARITY`` · max|y_ref|, as
``test_torch_real.py``.
"""

import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import portfft_tpu as ref
import portfft_tpu_torch as pt
from port_bench import run
from port_bench.tests.conftest import ROOT
from portfft_tpu_torch import fastpath
from portfft_tpu_torch.utils import tracing

TOL = 1e-5
PARITY = 5e-5
AFNO = [90, 180]
SCALE = 1 / math.sqrt(90 * 180)


@pytest.fixture(scope="module")
def reference():
    return run.Bench(ROOT).config("fourcastnet_afno")[1]


def _plan(lengths, batch, fs=SCALE, bs=SCALE, **kw):
    return pt.Descriptor(lengths=lengths, number_of_transforms=batch, domain=pt.Domain.REAL,
                         forward_scale=fs, backward_scale=bs, **kw).commit(device="cpu")


def _bins(lengths) -> int:
    return math.prod(lengths[:-1]) * (lengths[-1] // 2 + 1)


def _reals(lengths, batch, seed) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return torch.empty(batch * math.prod(lengths)).uniform_(-1.0, 1.0, generator=gen)


def _spectra(lengths, batch, seed) -> torch.Tensor:
    """Half spectra with no Hermitian symmetry: every part uniform in
    [-1, 1), as AFNO's MLP leaves them."""
    gen = torch.Generator().manual_seed(seed)
    raw = torch.empty(batch * _bins(lengths), 2).uniform_(-1.0, 1.0, generator=gen)
    return torch.view_as_complex(raw)


def _error(got, want) -> float:
    """The widest |error| as a share of ``want``'s root mean square."""
    want = want.reshape(-1)
    rms = want.abs().square().mean().sqrt()
    return float((got.reshape(-1).to(want.dtype) - want).abs().max() / rms)


def test_the_published_scale_is_orthonormal():
    spec = run.Bench(ROOT).config("fourcastnet_afno")[0]["descriptor"]
    assert spec["forward_scale"] == spec["backward_scale"] == SCALE


def test_the_afno_plan_takes_k9_then_k10():
    """At the cell's batch: K9 over batch·90 rows of 180, then K10 over the
    90 axis of the (batch, 90, 91) half spectrum with the scale; backward
    the reverse, the scale in K9."""
    batch = 12288
    plan = _plan(AFNO, batch)
    p90 = plan.plans[90]
    fwd, bwd = plan._raw_fast[pt.Direction.FORWARD], plan._raw_fast[pt.Direction.BACKWARD]
    assert fwd == fastpath.MultiDim((fastpath.SmallReal(180, batch * 90, -1, 1.0),
                                     fastpath.Col("col", batch, p90, 91, -1, SCALE)))
    assert bwd == fastpath.MultiDim((fastpath.Col("col", batch, p90, 91, +1, 1.0),
                                     fastpath.SmallReal(180, batch * 90, +1, SCALE)))
    assert fastpath.step_notes(plan, fwd) == ["1 K9", "0 K10"]
    assert fastpath.step_notes(plan, bwd) == ["0 K10", "1 K9"]


@pytest.mark.parametrize("lengths,notes", [
    ([4, 6, 180], (["2 K9", "1 K10", "0 K10"], ["1 K10", "0 K10", "2 K9"])),
    ([6, 1024], (["1 K1+K8a", "0 K10"], ["0 K10", "1 K8b+K1"])),
    ([1, 180], (["1 K9"], ["1 K9"])),  # no outer axis to run: K9 takes the scale
])
def test_other_shapes_route_and_note(lengths, notes):
    plan = _plan(lengths, 2)
    for direction, want in zip(pt.Direction, notes):
        entry = plan._raw_fast[direction]
        assert isinstance(entry, fastpath.MultiDim)
        assert fastpath.step_notes(plan, entry) == want
        assert entry.steps[-1].scale == SCALE
        assert all(s.scale == 1.0 for s in entry.steps[:-1])


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_afno_matches_the_plain_reference(reference, direction):
    batch = 3
    plan = _plan(AFNO, batch)
    spec = {"lengths": AFNO, "batch": batch, "direction": direction}
    if direction == "forward":
        x = _reals(AFNO, batch, seed=20)
        y = plan.compute_forward(x)
        assert y.dtype == torch.float32 and y.shape == (2 * batch * _bins(AFNO),)
    else:
        x = _spectra(AFNO, batch, seed=21)
        y = plan.compute_backward(x)
        assert y.dtype == torch.float32 and y.shape == (batch * 90 * 180,)
    rows = torch.arange(batch)
    want = reference.reference(reference.in_rows(x, spec, rows), spec)
    assert _error(reference.out_rows(y, spec, rows), want) <= TOL
    # the control, a TF32 pipeline in the program's place, fails the same
    # tolerance by far
    control = reference.out_rows(reference.control(x, spec), spec, rows)
    assert _error(control, want) > 20 * TOL


@pytest.mark.parametrize("lengths,batch", [(AFNO, 3), ([4, 6, 180], 2), ([6, 1024], 2)])
def test_parity_with_the_jax_package(lengths, batch):
    """Both directions against portfft_tpu on the same inputs; the backward
    input has nonzero imaginary parts at the last axis's bins 0 and n/2,
    which both packages drop below n = 1024 and use from there on."""
    fs, bs = 0.5, 3.0 / math.prod(lengths)
    plan = _plan(lengths, batch, fs, bs)
    rplan = ref.Descriptor(lengths=lengths, number_of_transforms=batch, domain=ref.Domain.REAL,
                           forward_scale=fs, backward_scale=bs).commit(use_pallas=True)
    x = _reals(lengths, batch, seed=len(lengths)).numpy()
    y, y_ref = plan.compute_forward(x), np.asarray(rplan.compute_forward(x))
    assert y.dtype == np.complex64 and y.shape == y_ref.shape == (batch * _bins(lengths),)
    assert np.abs(y - y_ref).max() <= PARITY * np.abs(y_ref).max()
    spec = _spectra(lengths, batch, seed=len(lengths) + 1).numpy()
    b, b_ref = plan.compute_backward(spec), np.asarray(rplan.compute_backward(spec))
    assert b.dtype == np.float32 and b.shape == b_ref.shape == (batch * math.prod(lengths),)
    assert np.abs(b - b_ref).max() <= PARITY * np.abs(b_ref).max()


@pytest.mark.parametrize("lengths", [[6, 180], [6, 1024]])
def test_the_c2r_bin_rule(lengths):
    """Half spectra of real signals plus imaginary parts at the last axis's
    bins 0 and n/2: below ``REAL_KEEP_MIN_N`` the C2R drops them, as
    ``torch.fft.irfftn``; from it on it uses them, as the JAX package."""
    batch, n = 2, lengths[-1]
    dims = (1, 2)
    plan = _plan(lengths, batch, 1.0, 1.0)
    x = _reals(lengths, batch, seed=n).double().view(batch, *lengths)
    spec = torch.fft.rfftn(x, dim=dims)
    spec[..., 0] += 0.5j
    spec[..., n // 2] -= 0.25j
    spec64 = spec.to(torch.complex64).reshape(-1)
    got = plan.compute_backward(spec64).view(batch, *lengths).double()
    irfftn = math.prod(lengths) * torch.fft.irfftn(spec, s=lengths, dim=dims)
    if n < fastpath.REAL_KEEP_MIN_N:
        assert _error(got, irfftn) <= TOL
        return
    assert _error(got, irfftn) > 100 * TOL  # the two bins are used
    rplan = ref.Descriptor(lengths=lengths, number_of_transforms=batch,
                           domain=ref.Domain.REAL).commit(use_pallas=True)
    want = np.asarray(rplan.compute_backward(spec64.numpy())).reshape(got.shape)
    assert np.abs(got.numpy() - want).max() <= PARITY * np.abs(want).max()


def test_the_column_rule_is_the_c2c_one():
    """Under the ``multidim`` tuning parameters ``{"cm": 1}`` the column step
    takes K10-mm where its gate takes the axis (128), as a C2C route does;
    the values stay within the tensor-core kernel's three-term TF32 grade."""
    lengths, batch = [128, 64], 2
    plan = _plan(lengths, batch, 1.0, 1.0)
    x = _reals(lengths, batch, seed=5)
    for direction in pt.Direction:
        entry = fastpath.with_engine(plan, plan._raw_fast[direction], {"cm": 1})
        cols = [s for s in entry.steps if isinstance(s, fastpath.Col)]
        assert [c.kernel for c in cols] == ["col_mm"]
    tuned = fastpath.build_fn(plan, fastpath.with_engine(
        plan, plan._raw_fast[pt.Direction.FORWARD], {"cm": 1}))
    c2c = pt.Descriptor(lengths=lengths, number_of_transforms=batch).commit(device="cpu")
    c2c_cols = [s for s in fastpath.with_engine(
        c2c, c2c._raw_fast[pt.Direction.FORWARD], {"cm": 1}).steps if isinstance(s, fastpath.Col)]
    assert [c.kernel for c in c2c_cols] == ["col_mm"]
    assert _error(tuned(x), plan.compute_forward(x)) <= 1e-5


@pytest.mark.parametrize("kw,error,match", [
    # an outer axis K10 declines (FUSED [5, 128]): no per-axis walk for REAL
    (dict(lengths=[640, 16]), pt.UnsupportedConfiguration, "multi-dim.*item 9"),
    (dict(lengths=[8, 16], complex_storage=pt.ComplexStorage.SPLIT_COMPLEX),
     pt.UnsupportedConfiguration, "SPLIT_COMPLEX REAL.*item 9"),
    (dict(lengths=[8, 16], forward_offset=4), pt.UnsupportedConfiguration, "offsets.*item 9"),
    # the reference's own rules, in its validation: in-place REAL is 1D, and
    # multi-dim transforms take the packed layout
    (dict(lengths=[8, 16], placement=pt.Placement.IN_PLACE), pt.UnsupportedConfiguration,
     "1D only"),
    (dict(lengths=[8, 16], forward_strides=[32, 2], backward_strides=[9, 1]),
     pt.UnsupportedConfiguration, "default data layout"),
])
def test_what_is_not_ported_raises_at_commit(kw, error, match):
    with pytest.raises(error, match=match):
        pt.Descriptor(domain=pt.Domain.REAL, **kw).commit(device="cpu")


def test_the_k10_gap_is_a_registry_raise():
    with pytest.raises(fastpath.RawFastUnavailable, match="fused.n=640"):
        _plan([640, 16], 1)


def test_out_buffers_raise_at_the_call():
    plan = _plan([8, 16], 2)
    with pytest.raises(pt.UnsupportedConfiguration, match="item 9"):
        plan.compute_forward(torch.zeros(2 * 128), out=torch.zeros(2 * 2 * 8 * 9))


def test_each_step_is_an_axis_span_under_a_profiler():
    plan = _plan(AFNO, 2)
    x = _reals(AFNO, 2, seed=3)
    plan.compute_forward(x)
    kept = tracing.spans()
    y = plan.compute_forward(x)
    assert tracing.spans() == kept  # no profiler: no span
    for fn, arg, notes in ((plan.compute_forward, x, ["1 K9", "0 K10"]),
                           (plan.compute_backward, y, ["0 K10", "1 K9"])):
        with profile(activities=[ProfilerActivity.CPU]):
            fn(arg)
        (call,) = tracing.calls(1)
        axes = sorted(call.named("portfft.axis"), key=lambda s: s.start_ns)
        assert [s.note for s in axes] == notes
        assert all(s.parent == call.root.id for s in axes)
        for axis, note in zip(axes, notes):
            assert [c.name for c in call.children(axis)] == [f"portfft.{note.split()[1]}"]
        # the axis spans are no layer: the call's children are the kernels
        assert sorted(c.name for c in call.children(call.root)) == ["portfft.K10",
                                                                    "portfft.K9"]
