"""The BCDI configuration's check and its per-step metrics, on the CPU.

The cell's own traffic at a small size (its lengths cut to ``SMALL``, the
scale 1/√N of these, the limits as committed) driven through whole runs:
the program passes; the control (the reference in TF32) and the faults
that a 3D complex transform at the orthonormal scale can have, planted
under the timed path, read not correct: the scale left out, axis 0 left
untransformed, the other direction's sign, and the two trailing axes
transposed.  The steps' work and the two C2C step metrics on synthetic
traces.
"""

import importlib.util
import json
import math
import os

import pytest
import torch

from port_bench import devtrace, run, steps_c2c, work
from port_bench.tests.conftest import ROOT, small_copy
from port_bench.tests.test_correct import FAULTS as COMMON, _run
from portfft_tpu_torch.utils import tracing
from portfft_tpu_torch.utils.tracing import Span

CELL = "pynx_bcdi.cycle"
#: The lengths the CPU runs take in place of 512^3: square trailing planes
#: K11 runs (128 x 128) and an axis 0 K10 runs (8), as the committed
#: route at 512^3.
SMALL = [8, 128, 128]


@pytest.fixture(scope="module")
def bcdi_root(tmp_path_factory):
    """A small copy of the benchmark whose BCDI cell takes ``SMALL``."""
    root = small_copy(str(tmp_path_factory.mktemp("bcdi")))
    path = os.path.join(root, "port_bench", "traffic", f"{CELL}.json")
    traffic = json.load(open(path))
    for call in traffic["calls"]:
        call["lengths"] = SMALL
    traffic["ahead_calls"] = 2
    json.dump(traffic, open(path, "w"))
    cfg = os.path.join(root, "port_bench", "configs", "pynx_bcdi.json")
    data = json.load(open(cfg))
    scale = 1.0 / math.sqrt(math.prod(SMALL))
    data["descriptor"]["forward_scale"] = data["descriptor"]["backward_scale"] = scale
    json.dump(data, open(cfg, "w"))
    return root


def _objects(x, spec):
    """A call's buffer as complex objects ``[b, *lengths]``."""
    return x.view(spec["batch"], *spec["lengths"])


def _scale_left_out(fn, spec, ref):
    """An orthonormal transform returned without its scale 1/√N."""
    return lambda x: fn(x) * math.sqrt(math.prod(spec["lengths"]))


def _axis0_skipped(fn, spec, ref):
    """Axis 0 left untransformed: forward the program's output with that
    axis taken back; backward the program run on an input whose axis 0 was
    transformed first, so that its own transform there undoes it."""
    if spec["direction"] == "forward":
        return lambda x: torch.fft.ifft(_objects(fn(x), spec), dim=1,
                                        norm="ortho").reshape(-1)
    return lambda x: fn(torch.fft.fft(_objects(x, spec), dim=1, norm="ortho").reshape(-1))


def _sign_flipped(fn, spec, ref):
    """The other direction's root at the same scale: the conjugate of the
    transform of the conjugate input."""
    return lambda x: fn(x.conj().resolve_conj()).conj().resolve_conj()


def _planes_transposed(fn, spec, ref):
    """The two trailing axes of each output swapped, as a K11 that stored
    its column pass's tiles across the rows would leave them."""
    return lambda x: _objects(fn(x), spec).transpose(-1, -2).contiguous().reshape(-1)


FAULTS = {"scale_left_out": _scale_left_out, "axis0_skipped": _axis0_skipped,
          "sign_flipped": _sign_flipped, "planes_transposed": _planes_transposed}


def test_the_program_is_correct(bcdi_root, program):
    result = _run(bcdi_root, program, CELL)
    assert result["correct"] and result["failed"] == 0, result["checks"]
    assert all(c["value"] < 0.2 * c["limit"] for c in result["checks"].values())


def test_the_tf32_control_is_not_correct(bcdi_root, program):
    result = _run(bcdi_root, program, CELL, lambda fn, spec, ref: (
        lambda x: ref.control(x, spec)))
    assert not result["correct"]
    assert all(c["value"] > c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("fault", FAULTS)
def test_each_3d_c2c_fault_is_not_correct(bcdi_root, program, fault):
    result = _run(bcdi_root, program, CELL, FAULTS[fault])
    assert not result["correct"], result["checks"]
    assert all(c["value"] > c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("fault", COMMON)
def test_the_common_faults_are_not_correct(bcdi_root, program, fault):
    result = _run(bcdi_root, program, CELL, COMMON[fault])
    assert not result["correct"], result["checks"]


def test_the_reference_is_double_and_reads_a_foreign_output_as_infinite(program):
    _, ref = run.Bench(ROOT).config("pynx_bcdi")
    gen = torch.Generator().manual_seed(3)
    for direction in ("forward", "backward"):
        spec = {"lengths": SMALL, "batch": 1, "direction": direction}
        (x,) = ref.make_pool(gen, spec, 1, "cpu")
        assert x.dtype == torch.complex64 and x.numel() == math.prod(SMALL)
        rows = torch.tensor([0])
        want = ref.reference(ref.in_rows(x, spec, rows), spec)
        assert want.dtype == torch.complex128
        # orthonormal: the reference keeps the input's norm
        assert float(want.abs().square().sum()) == pytest.approx(
            float(x.to(torch.complex128).abs().square().sum()), rel=1e-12)
        # a float32 output of the program's element count, or a complex
        # output of another size, reads infinite
        assert ref.out_rows(torch.zeros(math.prod(SMALL)), spec, rows).isinf().all()
        assert ref.out_rows(x[:-1], spec, rows).isinf().all()


# -- the C2C per-step metrics on synthetic traces --------------------------------

US = 1000
K11_OP = ("(anonymous namespace)::md2_kernel(pfft::Pass, pfft::Pass, long, "
          "float2 const*, float2*)")
K10_OP = ("void (anonymous namespace)::col_radix_kernel<float2>(pfft::PassT<float>, "
          "float2 const*, float2*)")
K1_OP = "void (anonymous namespace)::direct_radix_kernel(pfft::Sub, float2 const*, float2*)"


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
    spec = run.Spec(name="ft", lengths=list(lengths), batch=batch, direction="forward",
                    limit=1.0, bytes=0, least_s=0.0)
    return run.Record(specs=[spec], setup_s=0.0, commit_s=[], calls=[], window_s=1.0,
                      peak_bytes=0, trace=trace)


def test_the_step_work_of_the_bcdi_call():
    points = 512**3
    assert steps_c2c.step_work(steps_c2c.PLANE, [512, 512, 512], 1) == (
        16 * points, 5.0 * points * 18)
    assert steps_c2c.step_work(steps_c2c.OUTER, [512, 512, 512], 1) == (
        16 * points, 5.0 * points * 9)
    # both bound by bytes: 2 GiB at 3.35 TB/s, 0.641 ms a step
    for step in (steps_c2c.PLANE, steps_c2c.OUTER):
        assert steps_c2c.least_s(step, [512, 512, 512], 1) == pytest.approx(16 * points / 3.35e12)
        assert steps_c2c.least_s(step, [512, 512, 512], 1) * 1e3 == pytest.approx(0.641, abs=1e-3)
    # the two steps' least times make the call's twice over: each moves the
    # call's bytes once
    assert 2 * work.least_time("COMPLEX", [512] * 3, 1)[0] == pytest.approx(
        steps_c2c.least_s(steps_c2c.PLANE, [512] * 3, 1)
        + steps_c2c.least_s(steps_c2c.OUTER, [512] * 3, 1))


def test_the_step_work_counts_each_outer_axis_and_the_batch():
    # a length-1 outer axis is no step; two outer axes are two; a 2D call has none
    assert steps_c2c.step_work(steps_c2c.OUTER, [1, 64, 64], 3) == (0, 0)
    assert steps_c2c.step_work(steps_c2c.OUTER, [4, 8, 64, 64], 2) == (
        2 * 16 * 2 * 4 * 8 * 64 * 64, 5.0 * 2 * 4 * 8 * 64 * 64 * (2 + 3))
    assert steps_c2c.step_work(steps_c2c.OUTER, [256, 512], 8) == (0, 0)
    assert steps_c2c.step_work(steps_c2c.PLANE, [256, 512], 8) == (
        16 * 8 * 256 * 512, 5.0 * 8 * 256 * 512 * 17)


def test_each_c2c_step_reads_its_own_kernels(monkeypatch):
    # a forward and a backward call: K11 busy 7 ms in all, K10 3 ms, with a
    # 1 ms overlap of the two that counts for both
    ops = [(K11_OP, 0.000, 0.004), (K10_OP, 0.004, 0.005), (K11_OP, 0.010, 0.013),
           (K10_OP, 0.012, 0.014), ("Memset (Device)", 0.2, 0.21)]
    rec = _record([["1,2 K11", "0 K10"], ["1,2 K11", "0 K10"]], ops, monkeypatch)
    plane = steps_c2c.least_s(steps_c2c.PLANE, [512, 512, 512], 1)
    outer = steps_c2c.least_s(steps_c2c.OUTER, [512, 512, 512], 1)
    assert _reader("plane_axes_roofline_pct").read(rec) == pytest.approx(plane / 0.007 * 100)
    assert _reader("c2c_outer_axes_roofline_pct").read(rec) == pytest.approx(outer / 0.003 * 100)


def test_a_raw_last_axis_counts_in_the_plane_when_its_kernel_runs_nothing_else(monkeypatch):
    # the per-axis route of a 2D call: the last axis on K1, axis 0 on K10
    ops = [(K1_OP, 0.0, 0.002), (K10_OP, 0.002, 0.005)]
    rec = _record([["1 K1", "0 K10"]], ops, monkeypatch, lengths=(256, 512), batch=8)
    plane = steps_c2c.least_s(steps_c2c.PLANE, [256, 512], 8)
    assert _reader("plane_axes_roofline_pct").read(rec) == pytest.approx(plane / 0.005 * 100)
    # a 2D call has no outer axis: nothing to read
    assert _reader("c2c_outer_axes_roofline_pct").read(rec) is None


@pytest.mark.parametrize("notes", [
    [None],                             # no axis spans
    [["2 K1", "1 K10", "0 K10"]],       # K10 ran axis -2 and axis 0: both groups
    [["1,2 K11 f64", "0 K10 f64"]],     # a precision mark: not a C2C fp32 call
    [["1,2 K11", "0"]],                 # a note that names no kernel
])
def test_both_read_none_without_telling_notes(notes, monkeypatch):
    rec = _record(notes, [(K11_OP, 0.0, 0.001), (K10_OP, 0.001, 0.002)], monkeypatch)
    for name in ("plane_axes_roofline_pct", "c2c_outer_axes_roofline_pct"):
        assert _reader(name).read(rec) is None


def test_both_read_none_without_a_trace_or_device_operations(monkeypatch):
    rec = _record([["1,2 K11", "0 K10"]], [], monkeypatch)
    for name in ("plane_axes_roofline_pct", "c2c_outer_axes_roofline_pct"):
        assert _reader(name).read(rec) is None
        assert _reader(name).read(run.Record(specs=[], setup_s=0.0, commit_s=[], calls=[],
                                             window_s=1.0, peak_bytes=0, trace=None)) is None
