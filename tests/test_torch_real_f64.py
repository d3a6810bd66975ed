"""fp64 REAL transforms of portfft_tpu_torch (R2C forward, C2R backward) on
the CPU, the kernels' plain versions in float64: the routes whose every step
has a double kernel (K9, and K10 on the outer axes), against ``np.fft`` and
against portfft_tpu in float64 (x64 on the CPU, ``tests/conftest.py``), the
C2R bin rule, each step's plain version, the call's types, and what fp64
still raises.

Tolerances: every element within the fp64 oracle bound 2·eps·N·log2N,
absolute or relative (``tests/oracle.py``), of ``np.fft`` in float64; against
the JAX package, which runs the same mathematics by other kernels in double,
max|Δ| ≤ ``PARITY`` · max|y_ref|.  A float32 route reads about 1e-7 there.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import portfft_tpu as ref
import portfft_tpu_torch as pt
from oracle import tolerance
from portfft_tpu_torch import fastpath
from portfft_tpu_torch.ops import cuda_multidim, cuda_real

PARITY = 1e-12
SHAPES = [[32], [180], [512], [8, 12, 16], [6, 10, 32], [4, 6, 180]]


def _plan(lengths, batch, fs=1.0, bs=None, **kw):
    bs = 1.0 / math.prod(lengths) if bs is None else bs
    return pt.Descriptor(lengths=lengths, number_of_transforms=batch, domain=pt.Domain.REAL,
                         precision="fp64", forward_scale=fs, backward_scale=bs,
                         **kw).commit(device="cpu")


def _axes(lengths):
    return tuple(range(1, 1 + len(lengths)))


def _reals(lengths, batch, seed):
    return np.random.default_rng(seed).uniform(-1, 1, (batch, *lengths))


def _assert_oracle(plan, got, want):
    """Every element within 2·eps·N·log2N of ``want``, absolute or
    relative."""
    got = np.asarray(got).reshape(want.shape)
    diff = np.abs(got - want)
    tol = tolerance(plan.descriptor)
    assert tol < 1e-9  # the float64 bound, not float32's
    assert np.all((diff <= tol) | (diff <= tol * np.abs(want))), diff.max()


@pytest.mark.parametrize("lengths", SHAPES)
def test_both_directions_match_numpy_and_the_jax_package(lengths):
    """Forward at scale 0.5 and backward at 3/N, complex128 and float64 out
    for numpy in, against ``np.fft.rfftn``/``irfftn`` and portfft_tpu's fp64
    plan on the same seeded input."""
    batch, fs, bs = 3, 0.5, 3.0 / math.prod(lengths)
    plan = _plan(lengths, batch, fs, bs)
    rplan = ref.Descriptor(lengths=lengths, number_of_transforms=batch, domain=ref.Domain.REAL,
                           precision="fp64", forward_scale=fs, backward_scale=bs).commit()
    x = _reals(lengths, batch, seed=len(lengths) * 100 + lengths[-1])
    y = plan.compute_forward(x.reshape(-1))
    assert y.dtype == np.complex128
    want = np.fft.rfftn(x, axes=_axes(lengths)) * fs
    _assert_oracle(plan, y, want)
    y_ref = np.asarray(rplan.compute_forward(x.reshape(-1)))
    assert y_ref.dtype == np.complex128
    assert np.abs(y - y_ref).max() <= PARITY * np.abs(y_ref).max()
    spec = np.fft.rfftn(_reals(lengths, batch, seed=7), axes=_axes(lengths))
    b = plan.compute_backward(spec.reshape(-1))
    assert b.dtype == np.float64 and b.shape == (batch * math.prod(lengths),)
    want = np.fft.irfftn(spec, s=lengths, axes=_axes(lengths)) * math.prod(lengths) * bs
    _assert_oracle(plan, b, want)
    b_ref = np.asarray(rplan.compute_backward(spec.reshape(-1)))
    assert np.abs(b - b_ref).max() <= PARITY * np.abs(b_ref).max()


@pytest.mark.parametrize("lengths", [[180], [8, 12, 16], [4, 6, 180]])
def test_the_c2r_bin_rule(lengths):
    """Half spectra with imaginary parts at the last axis's bins 0 and n/2:
    below ``REAL_KEEP_MIN_N`` the C2R reads them as 0 after the outer axes'
    transforms, as ``np.fft.irfftn`` and the JAX package in double."""
    batch, n = 2, lengths[-1]
    plan = _plan(lengths, batch, bs=1.0)
    spec = np.fft.rfftn(_reals(lengths, batch, seed=n), axes=_axes(lengths))
    spec[..., 0] += 0.5j
    spec[..., n // 2] -= 0.25j
    got = plan.compute_backward(spec.reshape(-1))
    want = np.fft.irfftn(spec, s=lengths, axes=_axes(lengths)) * math.prod(lengths)
    _assert_oracle(plan, got, want)
    rplan = ref.Descriptor(lengths=lengths, number_of_transforms=batch, domain=ref.Domain.REAL,
                           precision="fp64", backward_scale=1.0).commit()
    b_ref = np.asarray(rplan.compute_backward(spec.reshape(-1)))
    assert np.abs(got - b_ref).max() <= PARITY * np.abs(b_ref).max()


@pytest.mark.parametrize("lengths", SHAPES)
def test_each_step_runs_its_plain_version_in_double(lengths):
    """Every step of both routes is K9 or K10 on float64 tables, and its
    plain version keeps float64 through the step."""
    batch = 2
    plan = _plan(lengths, batch)
    for direction in pt.Direction:
        entry = plan._raw_fast[direction]
        steps = entry.steps if isinstance(entry, fastpath.MultiDim) else (entry,)
        for step in steps:
            kernel, args = step.kernel_args(plan)
            assert kernel in (cuda_real.small_real, cuda_multidim.col)
            fields = [getattr(a, f.name) for a in args if dataclasses.is_dataclass(a)
                      for f in dataclasses.fields(a)]
            tables = [t for t in [*args, *fields] if isinstance(t, torch.Tensor)]
            assert tables and all(t.dtype == torch.float64 for t in tables)
            real_in = isinstance(step, fastpath.SmallReal) and direction == pt.Direction.FORWARD
            *outer, n = lengths
            numel = batch * (math.prod(lengths) if real_in
                             else 2 * math.prod(outer) * (n // 2 + 1))
            y = kernel.plain(torch.rand(numel, dtype=torch.float64), *args)
            assert y.dtype == torch.float64


def test_the_dns_descriptor_takes_k9_then_k10_in_double():
    """The Taylor-Green DNS call (one 512^3 component, backward scale
    2^-27): K9 over 262,144 rows of 512, then K10 down axis 1 of (512, 512,
    257) and axis 0 of (1, 512, 131584), the scale 1 forward; backward the
    same two columns, then K9 with the scale; no K10-mm whatever the tuning
    table says."""
    plan = _plan([512, 512, 512], 1, bs=2.0**-27)
    p512 = plan.plans[512]
    fwd, bwd = plan._raw_fast[pt.Direction.FORWARD], plan._raw_fast[pt.Direction.BACKWARD]
    assert fwd == fastpath.MultiDim((fastpath.SmallReal(512, 262144, -1, 1.0),
                                     fastpath.Col("col", 512, p512, 257, -1, 1.0),
                                     fastpath.Col("col", 1, p512, 131584, -1, 1.0)))
    assert bwd == fastpath.MultiDim((fastpath.Col("col", 512, p512, 257, +1, 1.0),
                                     fastpath.Col("col", 1, p512, 131584, +1, 1.0),
                                     fastpath.SmallReal(512, 262144, +1, 2.0**-27)))
    assert fastpath.step_notes(plan, fwd) == ["2 K9 f64", "1 K10 f64", "0 K10 f64"]
    assert fastpath.step_notes(plan, bwd) == ["1 K10 f64", "0 K10 f64", "2 K9 f64"]
    assert all(t.dtype == torch.float64 for t in plan._bank_arrays.values())


def test_the_call_keeps_its_types_and_raises_as_fp32_does():
    """A tensor in gives a float64 tensor out (raw pairs forward); float32
    input is widened; a complex forward input, a short buffer and ``out=``
    raise as they do at fp32."""
    lengths, batch = [6, 10, 32], 2
    plan = _plan(lengths, batch)
    x = torch.from_numpy(_reals(lengths, batch, seed=1).reshape(-1))
    y = plan.compute_forward(x)
    assert y.dtype == torch.float64 and y.shape == (2 * batch * 6 * 10 * 17,)
    back = plan.compute_backward(torch.view_as_complex(y.view(-1, 2)))
    assert back.dtype == torch.float64 and torch.allclose(back, x, atol=1e-13)
    assert torch.allclose(plan.compute_backward(y), back, atol=0)
    narrow = plan.compute_forward(x.float())
    assert narrow.dtype == torch.float64
    assert torch.equal(narrow, plan.compute_forward(x.float().double()))
    with pytest.raises(pt.InvalidConfiguration, match="real buffer"):
        plan.compute_forward(torch.zeros(x.numel(), dtype=torch.complex128))
    with pytest.raises(pt.InvalidConfiguration, match="needs"):
        plan.compute_forward(x[:-1])
    with pytest.raises(pt.UnsupportedConfiguration, match="item 9"):
        plan.compute_forward(x, out=torch.zeros_like(y))


@pytest.mark.parametrize("kw,match", [
    # HalfReal: K8a/K8b around a C2C of n/2
    (dict(lengths=[1024], domain=pt.Domain.REAL), "longer than 512.*item 12.*HalfReal"),
    (dict(lengths=[4, 640], domain=pt.Domain.REAL), "longer than 512.*item 12.*HalfReal"),
    # every C2C route: 1D, multi-dim, BATCH_INTERLEAVED, SPLIT
    (dict(lengths=[16]), "C2C.*item 12"),
    (dict(lengths=[8, 16]), "C2C.*item 12"),
    (dict(lengths=[16], complex_storage=pt.ComplexStorage.SPLIT_COMPLEX), "C2C.*item 12"),
    # an outer axis K10 takes in float32 only: its double tile passes the
    # shared memory of a block
    (dict(lengths=[8192, 16], domain=pt.Domain.REAL), "only in float32.*item 12"),
    # REAL layouts, as at fp32
    (dict(lengths=[16], domain=pt.Domain.REAL, placement=pt.Placement.IN_PLACE), "item 9"),
    (dict(lengths=[16], domain=pt.Domain.REAL, forward_offset=4), "item 9"),
])
def test_what_fp64_lacks_raises_at_commit(kw, match):
    with pytest.raises(fastpath.RawFastUnavailable, match=match):
        pt.Descriptor(precision="fp64", **kw).commit(device="cpu")


def test_k10_mm_at_fp64_raises():
    """``{"cm": 1}`` puts K10-mm on the column steps at fp32; at fp64 it
    raises (its three-term TF32 split is a float32 method), and autotune
    races no such variant."""
    plan = _plan([128, 64], 2)
    entry = plan._raw_fast[pt.Direction.FORWARD]
    with pytest.raises(fastpath.RawFastUnavailable, match="K10-mm at fp64.*item 12"):
        fastpath.with_engine(plan, entry, {"cm": 1})
    assert [s.kernel for s in fastpath.with_engine(plan, entry, {}).steps
            if isinstance(s, fastpath.Col)] == ["col"]
    from portfft_tpu_torch import race

    assert race._variants_for_entry(plan, entry) == [{}]


def test_the_tuning_table_puts_no_k10_mm_on_an_fp64_route(monkeypatch):
    """A ``multidim`` table entry of ``{"cm": 1}`` for the shape takes
    K10-mm at fp32; at fp64 the commit reads no table and runs K10."""
    from portfft_tpu_torch import tuning

    monkeypatch.setattr(tuning, "lookup", lambda dev, kind, key: (
        {"cm": 1} if kind == "multidim" else None))
    narrow = pt.Descriptor(lengths=[128, 64], domain=pt.Domain.REAL).commit(device="cpu")
    wide = _plan([128, 64], 1)
    for plan, kernel in ((narrow, "col_mm"), (wide, "col")):
        entry = plan._raw_fast[pt.Direction.FORWARD]
        assert [s.kernel for s in entry.steps if isinstance(s, fastpath.Col)] == [kernel]
