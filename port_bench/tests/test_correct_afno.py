"""The multi-dim REAL configuration's check and its per-step metrics, on the
CPU.  Faults that only a 2D real transform at the orthonormal scale can
have, planted under the timed path of each of its cells and driven through
a whole run as ``test_correct.py`` drives the faults every cell can have:
each run is not correct.  ``test_correct.py``'s own faults read not correct
here through ``out_rows``' size rule.  ``real_axis_roofline_pct`` and
``outer_axes_roofline_pct`` on synthetic traces."""

import importlib.util
import json
import math
import os

import pytest
import torch

from port_bench import devtrace, run, steps
from port_bench.tests.conftest import ROOT
from port_bench.tests.test_correct import FAULTS as COMMON, _run
from portfft_tpu_torch.utils import tracing
from portfft_tpu_torch.utils.tracing import Span

CELLS = [w["name"] for w in json.load(open(os.path.join(ROOT, "BENCHMARK.json")))["workloads"]
         if w["config"] == "fourcastnet_afno"]


def _halves(y, spec):
    """The program's forward output as complex half spectra ``[b, *bins]``."""
    *outer, n = spec["lengths"]
    return torch.view_as_complex(y.view(-1, 2)).view(spec["batch"], *outer, n // 2 + 1)


def _scale_left_out(fn, spec, ref):
    """An orthonormal transform returned without its scale 1/√N."""
    return lambda x: fn(x) * math.sqrt(math.prod(spec["lengths"]))


def _outer_axis_untransformed(fn, spec, ref):
    """The outer (90) axis left as it was: forward the program's output with
    that axis taken back; backward the program run on an input whose outer
    axis was transformed first, so that its own C2C there undoes it."""
    if spec["direction"] == "forward":
        def broken(x):
            y = torch.fft.ifft(_halves(fn(x), spec), dim=1, norm="ortho")
            return torch.view_as_real(y).reshape(-1)
        return broken
    *outer, n = spec["lengths"]
    shape = (spec["batch"], *outer, n // 2 + 1)
    return lambda x: fn(torch.fft.fft(x.view(shape), dim=1, norm="ortho").reshape(-1))


def _other_direction(fn, spec, ref):
    """The other direction's sign at the same scale: forward the conjugate
    half spectrum, backward the C2R of the conjugate input."""
    if spec["direction"] == "forward":
        return lambda x: torch.view_as_real(
            _halves(fn(x), spec).conj().resolve_conj()).reshape(-1)
    return lambda x: fn(x.conj().resolve_conj())


def _nyquist_dropped(fn, spec, ref):
    """The half spectrum cut to n/2 bins a row, as a kernel that keeps only
    the bins of a C2C of n/2 would: bin n/2 zero in the output forward,
    read as zero backward."""
    *outer, n = spec["lengths"]
    if spec["direction"] == "forward":
        def broken(x):
            y = fn(x)
            _halves(y, spec)[..., n // 2] = 0
            return y
        return broken

    def cut(x):
        x = x.clone()
        x.view(spec["batch"], *outer, n // 2 + 1)[..., n // 2] = 0
        return fn(x)
    return cut


FAULTS = {"scale_left_out": _scale_left_out,
          "outer_axis_untransformed": _outer_axis_untransformed,
          "other_direction": _other_direction, "nyquist_dropped": _nyquist_dropped}


@pytest.mark.parametrize("cell,fault", [(cell, fault) for cell in CELLS for fault in FAULTS])
def test_each_real_2d_fault_is_not_correct(small_root, program, cell, fault):
    result = _run(small_root, program, cell, FAULTS[fault])
    assert not result["correct"], result["checks"]
    assert all(c["value"] > c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("cell,fault", [(cell, fault) for cell in CELLS for fault in COMMON])
def test_the_common_faults_are_not_correct(small_root, program, cell, fault):
    """Every cell's faults, ``input_returned`` too: an output of the input's
    size and kind reads infinite (``out_rows``), and the run still ends."""
    result = _run(small_root, program, cell, COMMON[fault])
    assert not result["correct"], result["checks"]
    if fault == "input_returned":
        assert all(c["value"] == math.inf for c in result["checks"].values())


# -- the per-step metrics on synthetic traces -----------------------------------

US = 1000
K9_OP = "small_real_fwd_kernel(float const*, float2*, float const*, float const*, long)"
K10_OP = "void pfft::sliced_kernel<float2 const*, float2*>(pfft::Pass, pfft::Slices)"


def _reader(name):
    path = os.path.join(ROOT, "port_bench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"reader_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _calls(notes_of_calls):
    """Tracer calls whose steps carry ``notes`` (None: no axis span)."""
    out, ids = [], iter(range(1000))
    for call_id, notes in enumerate(notes_of_calls, 1):
        root = Span("portfft.call", 0, 100 * US, -1, call_id, next(ids), "forward")
        kids = [Span("portfft.axis", i * US, (i + 1) * US, root.id, call_id, next(ids), note)
                for i, note in enumerate(notes or ())]
        out.append(tracing.Call(root, [root, *kids]))
    return out


def _record(notes_of_calls, ops, monkeypatch, lengths=(90, 180), batch=12288):
    calls = _calls(notes_of_calls)
    monkeypatch.setattr(tracing, "calls", lambda n: calls[len(calls) - n:] if n else [])
    computes = [("compute_forward", 0.0, 1e-3)] * len(calls)
    trace = devtrace.Trace(ops=ops, spans=computes + [("traced_window", 0.0, 1.0)],
                           start=0.0, end=1.0, rounds=1)
    spec = run.Spec(name="rfft2", lengths=list(lengths), batch=batch, direction="forward",
                    limit=1.0, bytes=0, least_s=0.0)
    return run.Record(specs=[spec], setup_s=0.0, commit_s=[], calls=[], window_s=1.0,
                      peak_bytes=0, trace=trace)


def test_the_step_work_of_the_afno_call():
    b, points, bins = 12288, 90 * 180, 90 * 91
    assert steps.step_work(steps.REAL, [90, 180], b) == (
        4 * b * points + 8 * b * bins, 2.5 * b * points * math.log2(180))
    assert steps.step_work(steps.OUTER, [90, 180], b) == (
        16 * b * bins, 5.0 * b * bins * math.log2(90))
    # a length-1 outer axis is no step; two outer axes are two
    assert steps.step_work(steps.OUTER, [1, 180], 2) == (0, 0)
    assert steps.step_work(steps.OUTER, [4, 6, 180], 2)[0] == 2 * 16 * 2 * 24 * 91
    # both are bound by bytes at the cell's shape
    assert steps.least_s(steps.REAL, [90, 180], b) == pytest.approx(1601372160 / 3.35e12)


def test_each_step_reads_its_own_kernels(monkeypatch):
    # two calls, forward and backward; K9 busy 6 ms in all, K10 4 ms, with a
    # 1 ms overlap of the two that counts for both
    ops = [(K9_OP, 0.000, 0.003), (K10_OP, 0.003, 0.005), (K10_OP, 0.010, 0.012),
           (K9_OP, 0.011, 0.014), ("Memset (Device)", 0.020, 0.021)]
    rec = _record([["1 K9", "0 K10"], ["0 K10", "1 K9"]], ops, monkeypatch)
    real = steps.least_s(steps.REAL, [90, 180], 12288)
    outer = steps.least_s(steps.OUTER, [90, 180], 12288)
    assert _reader("real_axis_roofline_pct").read(rec) == pytest.approx(real / 0.006 * 100)
    assert _reader("outer_axes_roofline_pct").read(rec) == pytest.approx(outer / 0.004 * 100)


def test_a_half_length_step_counts_its_c2c_and_tangle(monkeypatch):
    k1, k8a = "direct_kernel<1>(float2 const*)", "untangle_kernel(float2 const*)"
    ops = [(k1, 0.0, 0.002), (k8a, 0.002, 0.003), (K10_OP, 0.003, 0.004)]
    rec = _record([["1 K1+K8a", "0 K10"]], ops, monkeypatch, lengths=(6, 1024), batch=64)
    least = steps.least_s(steps.REAL, [6, 1024], 64)
    assert _reader("real_axis_roofline_pct").read(rec) == pytest.approx(least / 0.003 * 100)


@pytest.mark.parametrize("notes", [
    [None],                        # no axis spans: an older program, or no notes
    [["1 K9", "0 K9"]],            # one kernel ran both steps
    [["1 K9", "0"]],               # a note that names no kernel
])
def test_both_read_none_without_telling_notes(notes, monkeypatch):
    rec = _record(notes, [(K9_OP, 0.0, 0.001), (K10_OP, 0.001, 0.002)], monkeypatch)
    for name in ("real_axis_roofline_pct", "outer_axes_roofline_pct"):
        assert _reader(name).read(rec) is None


def test_both_read_none_without_a_trace_or_device_operations(monkeypatch):
    rec = _record([["1 K9", "0 K10"]], [], monkeypatch)
    for name in ("real_axis_roofline_pct", "outer_axes_roofline_pct"):
        assert _reader(name).read(rec) is None
        assert _reader(name).read(run.Record(specs=[], setup_s=0.0, commit_s=[], calls=[],
                                             window_s=1.0, peak_bytes=0, trace=None)) is None
