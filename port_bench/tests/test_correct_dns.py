"""The fp64 DNS configuration's check and its per-step metrics, on the CPU.

The cell's own traffic at a small size (its lengths cut to ``SMALL``, the
limits as committed) driven through whole runs: the program passes; the
control (the reference in float32) and the faults that only an fp64 3D real
transform can have, planted under the timed path, read not correct: float32
tables under double data, the scale in the wrong direction, an outer axis
skipped, and one outer axis run in the conjugate direction.  The steps'
work and the two ``f64`` step metrics on synthetic traces.
"""

import importlib.util
import json
import math
import os

import pytest
import torch

from port_bench import devtrace, run, steps_f64
from port_bench.tests.conftest import ROOT, small_copy
from port_bench.tests.test_correct import FAULTS as COMMON, _run
from portfft_tpu_torch.utils import tracing
from portfft_tpu_torch.utils.tracing import Span

CELL = "taylor_green_dns.stage"
#: The lengths the CPU runs take in place of 512^3: two outer axes K10 runs
#: (8, 12) and a last axis K9 runs (16); the backward scale is 1/N of these,
#: as the configuration's is of 512^3.
SMALL = [8, 12, 16]


@pytest.fixture(scope="module")
def dns_root(tmp_path_factory):
    """A small copy of the benchmark whose DNS cell takes ``SMALL``."""
    root = small_copy(str(tmp_path_factory.mktemp("dns")))
    path = os.path.join(root, "port_bench", "traffic", f"{CELL}.json")
    traffic = json.load(open(path))
    for call in traffic["calls"]:
        call["lengths"] = SMALL
    traffic["ahead_calls"] = 2
    json.dump(traffic, open(path, "w"))
    cfg = os.path.join(root, "port_bench", "configs", "taylor_green_dns.json")
    data = json.load(open(cfg))
    data["descriptor"]["backward_scale"] = 1.0 / math.prod(SMALL)
    json.dump(data, open(cfg, "w"))
    return root


def _halves(y, spec):
    """The program's forward output as complex half spectra ``[b, *bins]``."""
    *outer, n = spec["lengths"]
    return torch.view_as_complex(y.view(-1, 2)).view(spec["batch"], *outer, n // 2 + 1)


def _float32_tables(fn, spec, ref):
    """The plan's double tables rounded to float32 under double data."""
    for table in fn.__self__._bank_arrays.values():
        table.copy_(table.float().double())
    return fn


def _scale_swapped(fn, spec, ref):
    """The 1/N of the backward direction put on the forward one."""
    n = math.prod(spec["lengths"])
    if spec["direction"] == "forward":
        return lambda x: fn(x) / n
    return lambda x: fn(x) * n


def _outer_axis_skipped(fn, spec, ref):
    """Axis 0 left untransformed: forward the program's output with that
    axis taken back; backward the program run on an input whose axis 0 was
    transformed first, so that its own C2C there undoes it."""
    if spec["direction"] == "forward":
        def broken(x):
            y = torch.fft.ifft(_halves(fn(x), spec), dim=1)
            return torch.view_as_real(y).reshape(-1)
        return broken
    *outer, n = spec["lengths"]
    shape = (spec["batch"], *outer, n // 2 + 1)
    return lambda x: fn(torch.fft.fft(x.view(shape), dim=1).reshape(-1))


def _outer_axis_conjugate(fn, spec, ref):
    """Axis 0 transformed with the other direction's root: its frequency k
    read at -k (forward the output, backward the input, reversed along axis
    0 but for its first element)."""
    def flip(c):
        return torch.roll(torch.flip(c, dims=[1]), 1, dims=1)

    if spec["direction"] == "forward":
        return lambda x: torch.view_as_real(flip(_halves(fn(x), spec))).reshape(-1)
    *outer, n = spec["lengths"]
    shape = (spec["batch"], *outer, n // 2 + 1)
    return lambda x: fn(flip(x.view(shape)).reshape(-1))


FAULTS = {"float32_tables": _float32_tables, "scale_swapped": _scale_swapped,
          "outer_axis_skipped": _outer_axis_skipped,
          "outer_axis_conjugate": _outer_axis_conjugate}


def test_the_program_is_correct_in_double(dns_root, program):
    result = _run(dns_root, program, CELL)
    assert result["correct"] and result["failed"] == 0, result["checks"]
    # fp64 rounding, far under the committed limits
    assert all(c["value"] < 1e-3 * c["limit"] for c in result["checks"].values())


def test_the_float32_control_is_not_correct(dns_root, program):
    result = _run(dns_root, program, CELL, lambda fn, spec, ref: (
        lambda x: ref.control(x, spec)))
    assert not result["correct"]
    assert all(c["value"] > c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("fault", FAULTS)
def test_each_fp64_3d_fault_is_not_correct(dns_root, program, fault):
    result = _run(dns_root, program, CELL, FAULTS[fault])
    assert not result["correct"], result["checks"]
    assert all(c["value"] > c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("fault", COMMON)
def test_the_common_faults_are_not_correct(dns_root, program, fault):
    result = _run(dns_root, program, CELL, COMMON[fault])
    assert not result["correct"], result["checks"]


def test_the_reference_is_double_and_the_control_single(dns_root, program):
    """The reference reads the program's float64 output; the control is the
    float32 transform widened back to the program's format."""
    bench = run.Bench(dns_root)
    _, ref = bench.config("taylor_green_dns")
    gen = torch.Generator().manual_seed(3)
    for direction in ("forward", "backward"):
        spec = {"lengths": SMALL, "batch": 1, "direction": direction}
        (x,) = ref.make_pool(gen, spec, 1, "cpu")
        assert x.dtype == (torch.float64 if direction == "forward" else torch.complex128)
        rows = torch.tensor([0])
        want = ref.reference(ref.in_rows(x, spec, rows), spec)
        got = ref.out_rows(ref.control(x, spec), spec, rows)
        assert got.dtype == want.dtype
        err = float((got - want).abs().max() / want.abs().square().mean().sqrt())
        assert 1e-8 < err < 1e-5
        # a float32 output of the program's size reads infinite
        bad = torch.zeros(2 * 8 * 12 * 9 if direction == "forward" else math.prod(SMALL))
        assert ref.out_rows(bad, spec, rows).isinf().all()


def test_the_backward_pool_is_hermitian(program):
    """The backward input is the rfftn of seeded reals: its C2R gives them
    back, and its last axis's bins 0 and n/2 are real after the outer
    axes' inverse transforms, as a DNS's U_hat."""
    _, ref = run.Bench(ROOT).config("taylor_green_dns")
    spec = {"lengths": SMALL, "batch": 2, "direction": "backward"}
    (x,) = ref.make_pool(torch.Generator().manual_seed(5), spec, 1, "cpu")
    planes = torch.fft.ifftn(x.view(2, 8, 12, 9), dim=(1, 2))
    assert planes[..., 0].imag.abs().max() < 1e-12
    assert planes[..., 8].imag.abs().max() < 1e-12
    reals = ref.reference(x.view(2, -1), spec)
    assert reals.dtype == torch.float64 and reals.abs().max() <= 1.0


# -- the fp64 per-step metrics on synthetic traces ------------------------------

US = 1000
K9_OP = ("void (anonymous namespace)::small_real_fwd_f64_kernel<1>((anonymous "
         "namespace)::SmallRealT<double>, double2 const*, double2*, double const*, "
         "double const*)")
K10_OP = ("void pfft::(anonymous namespace)::sliced_kernel<double2 const*, double2*>"
          "(pfft::PassT<double>, pfft::Slices, double2 const*, double2*)")


def _reader(name):
    path = os.path.join(ROOT, "port_bench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"reader_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _record(notes_of_calls, ops, monkeypatch, lengths=(512, 512, 512), batch=1):
    ids = iter(range(1000))
    calls = []
    for call_id, notes in enumerate(notes_of_calls, 1):
        root = Span("portfft.call", 0, 100 * US, -1, call_id, next(ids), "forward")
        kids = [Span("portfft.axis", i * US, (i + 1) * US, root.id, call_id, next(ids), note)
                for i, note in enumerate(notes or ())]
        calls.append(tracing.Call(root, [root, *kids]))
    monkeypatch.setattr(tracing, "calls", lambda n: calls[len(calls) - n:] if n else [])
    trace = devtrace.Trace(ops=ops, spans=[("compute_forward", 0.0, 1e-3)] * len(calls)
                           + [("traced_window", 0.0, 1.0)], start=0.0, end=1.0, rounds=1)
    spec = run.Spec(name="rfftn", lengths=list(lengths), batch=batch, direction="forward",
                    limit=1.0, bytes=0, least_s=0.0)
    return run.Record(specs=[spec], setup_s=0.0, commit_s=[], calls=[], window_s=1.0,
                      peak_bytes=0, trace=trace)


def test_the_step_work_of_the_dns_call():
    b, points, bins = 1, 512**3, 512 * 512 * 257
    assert steps_f64.step_work(steps_f64.REAL, [512, 512, 512], b) == (
        8 * points + 16 * bins, 2.5 * points * 9)
    assert steps_f64.step_work(steps_f64.OUTER, [512, 512, 512], b) == (
        2 * 32 * bins, 2 * 5.0 * bins * 9)
    # both bound by bytes at 3.35 TB/s against the fp64 34 TFLOP/s
    assert steps_f64.least_s(steps_f64.REAL, [512, 512, 512], b) == pytest.approx(
        (8 * points + 16 * bins) / 3.35e12)
    assert steps_f64.least_s(steps_f64.OUTER, [512, 512, 512], b) == pytest.approx(
        64 * bins / 3.35e12)


def test_each_f64_step_reads_its_own_kernels(monkeypatch):
    ops = [(K9_OP, 0.000, 0.002), (K10_OP, 0.002, 0.050), (K10_OP, 0.050, 0.100),
           ("Memset (Device)", 0.2, 0.21)]
    rec = _record([["2 K9 f64", "1 K10 f64", "0 K10 f64"]], ops, monkeypatch)
    real = steps_f64.least_s(steps_f64.REAL, [512, 512, 512], 1)
    outer = steps_f64.least_s(steps_f64.OUTER, [512, 512, 512], 1)
    assert _reader("f64_real_axis_roofline_pct").read(rec) == pytest.approx(real / 0.002 * 100)
    assert _reader("f64_outer_axes_roofline_pct").read(rec) == pytest.approx(outer / 0.098 * 100)


@pytest.mark.parametrize("notes", [
    [None],                                   # no axis spans: the parent's program
    [["2 K9", "1 K10", "0 K10"]],             # fp32 notes, unmarked
    [["2 K9 f64", "1 K9 f64", "0 K9 f64"]],   # one kernel ran both kinds of step
    [["2 K9 f64", "1 f64", "0 K10 f64"]],     # a note that names no kernel
])
def test_both_read_none_without_f64_notes(notes, monkeypatch):
    rec = _record(notes, [(K9_OP, 0.0, 0.001), (K10_OP, 0.001, 0.002)], monkeypatch)
    for name in ("f64_real_axis_roofline_pct", "f64_outer_axes_roofline_pct"):
        assert _reader(name).read(rec) is None
