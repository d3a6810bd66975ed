"""The tracer of portfft_tpu_torch (``utils/tracing.py``) on the CPU: spans
only while a profiler records and never on its timeline, one root a call
with its children nested inside it, the launch registry and its CUDA
symbols, the tuning outcomes at commit, and the benchmark's readers of
spans and counters (``port_bench/metrics``) on synthetic traces and on a
traced run of each cell at small batches."""

import ctypes
import importlib.util
import itertools
import os
import re
import sys
import time
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import portfft_tpu_torch as pf
from port_bench import devtrace, idle_by_span, run
from port_bench.tests.conftest import ROOT, small_copy
from portfft_tpu_torch import tuning
from portfft_tpu_torch.utils import tracing
from portfft_tpu_torch.utils.tracing import Span

READERS = ("call_self_us", "launch_self_us", "exec_self_us", "idle_in_program_pct",
           "tuned_pct", "glue_pct", "walk_glue_mib", "idle_in_call_pct", "idle_in_exec_pct",
           "idle_in_wrapper_pct", "idle_in_launch_pct")
#: Readers of the device's operations, which a CPU run has not.
DEVICE_READERS = {"idle_in_program_pct", "glue_pct", "idle_in_call_pct", "idle_in_exec_pct",
                  "idle_in_wrapper_pct", "idle_in_launch_pct"}


def _reader(name):
    path = os.path.join(ROOT, "port_bench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"reader_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _forbid_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the tracer entered record_function")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)


# Calls of each kind the table of spans names: (descriptor, input, the span
# names of its call in order of their start).
def _k1():
    return pf.Descriptor(lengths=[16], number_of_transforms=4), torch.randn(2 * 4 * 16)


def _r2c():
    desc = pf.Descriptor(lengths=[8192], number_of_transforms=2, domain=pf.Domain.REAL)
    return desc, torch.randn(2 * 8192)


def _bluestein():
    return pf.Descriptor(lengths=[20011], number_of_transforms=1), torch.randn(2 * 20011)


CALLS = {
    "K1": (_k1, ["portfft.call", "portfft.K1"]),
    "R2C": (_r2c, ["portfft.call", "portfft.K2", "portfft.K8a"]),
    "Bluestein": (_bluestein, ["portfft.call", "portfft.K6-de", "portfft.exec",
                               "portfft.K15", "portfft.K6-in"]),
}


class _Entry:
    """An entry point of a stand-in kernel library: returns 0, as a launch
    that succeeded."""

    def __call__(self, *args):
        return 0


def _library():
    """A stand-in kernel library, declared as ``_build.load`` declares the
    real one (a CPU run reaches no launch of its own)."""
    from portfft_tpu_torch.ops import _build

    return _build.declare(types.SimpleNamespace(**{n: _Entry() for n in _build._SIGNATURES}))


class _Launching:
    """A stand-in descriptor whose plan's call asks the library a question
    and launches through it."""

    def commit(self, device):
        lib = _library()
        return types.SimpleNamespace(
            compute_forward=lambda x: (lib.pf_fused2_needs_scratch(1), lib.pf_direct(*x)))


#: Launches through a declared library: (descriptor, input), as ``CALLS``.
LAUNCHES = {"launch": (lambda: (_Launching(), [0] * 8), [])}


@pytest.mark.parametrize("kind", list(CALLS) + list(LAUNCHES))
def test_no_profiler_no_span_and_no_record_function(kind, monkeypatch):
    """With no profiler a call or a launch records nothing, and the tracer
    never enters ``record_function``; the counters count all the same (the
    R2C commit looks up its half length's FUSED entry)."""
    make, _ = {**CALLS, **LAUNCHES}[kind]
    _forbid_record_function(monkeypatch)
    desc, x = make()
    before = sum(tracing.tuning_outcomes().values())
    plan = desc.commit(device="cpu")
    assert sum(tracing.tuning_outcomes().values()) == before + (kind == "R2C")
    kept = tracing.spans()
    for _ in range(2):
        plan.compute_forward(x)
    assert tracing.spans() == kept


@pytest.mark.parametrize("kind", list(CALLS))
def test_a_traced_call_is_one_root_with_nested_children(kind, monkeypatch):
    make, names = CALLS[kind]
    desc, x = make()
    plan = desc.commit(device="cpu")
    plan.compute_forward(x)
    _forbid_record_function(monkeypatch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        plan.compute_forward(x)
    (call,) = tracing.calls(1)
    root = call.root
    assert root.name == "portfft.call" and root.parent == -1 and root.note == "forward"
    assert [s.name for s in sorted(call.spans, key=lambda s: s.start_ns)] == names
    by_id = {s.id: s for s in call.spans}
    for s in call.spans:
        assert s.call_id == root.call_id
        if s is not root:
            parent = by_id[s.parent]
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    assert len([s for s in call.spans if s.parent == -1]) == 1
    assert not [e.name for e in prof.events() if e.name.startswith("portfft.")]


def test_spans_follow_the_profilers_switch():
    desc, x = _k1()
    plan = desc.commit(device="cpu")
    prof = profile(activities=[ProfilerActivity.CPU])
    count = len(tracing.spans())
    prof.start()
    assert tracing.PROFILER._is_profiler_enabled
    plan.compute_forward(x)
    prof.stop()
    assert not tracing.PROFILER._is_profiler_enabled
    plan.compute_forward(x)
    assert len(tracing.spans()) == min(count + 2, tracing.RING)


def test_a_launch_is_a_span_of_its_entry_point_inside_its_wrapper(monkeypatch):
    monkeypatch.setattr(tracing, "KERNELS", dict(tracing.KERNELS))
    monkeypatch.setattr(tracing, "_launches", dict(tracing._launches))
    lib = _library()

    @tracing.kernel("Ktest", ("direct_kernel",))
    def launch(x):
        lib.pf_fused2_needs_scratch(1)  # a question: no span
        return lib.pf_direct(*[0] * 8)

    _forbid_record_function(monkeypatch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert launch(torch.zeros(2)) == 0
    last = tracing.spans()[-1]
    wrapper, entry = [s for s in tracing.spans() if s.call_id == last.call_id]
    assert (wrapper.name, wrapper.parent) == ("portfft.Ktest", -1)
    assert (entry.name, entry.note, entry.parent) == (tracing.LAUNCH, "pf_direct", wrapper.id)
    assert wrapper.start_ns <= entry.start_ns <= entry.end_ns <= wrapper.end_ns
    assert not [e.name for e in prof.events() if e.name.startswith("portfft.")]


def test_every_entry_point_that_launches_is_spanned_and_no_question():
    from portfft_tpu_torch.ops import _build

    lib = _library()
    questions = {n for n in _build._SIGNATURES if isinstance(getattr(lib, n), _Entry)}
    assert questions == _build._QUERIES == {
        "pf_error_string", "pf_fused2_needs_scratch", "pf_col_needs_scratch",
        "pf_chain_needs_scratch", "pf_chain_general_needs_scratch",
        "pf_global2_planes_needs_scratch", "pf_axis_m2_needs_scratch"}
    for name in set(_build._SIGNATURES) - questions:
        assert getattr(lib, name).__name__ == name


def test_a_launch_with_no_open_span_is_a_root_and_pushes_nothing():
    lib = _library()
    with profile(activities=[ProfilerActivity.CPU]):
        assert lib.pf_direct(*[0] * 8) == 0
    last = tracing.spans()[-1]
    assert (last.name, last.note, last.parent) == (tracing.LAUNCH, "pf_direct", -1)
    assert last.start_ns <= last.end_ns
    assert not getattr(tracing._local, "stack", [])


def test_a_launch_that_raises_records_no_span_and_its_wrapper_closes(monkeypatch):
    from portfft_tpu_torch.ops import _build

    monkeypatch.setattr(tracing, "KERNELS", dict(tracing.KERNELS))
    monkeypatch.setattr(tracing, "_launches", dict(tracing._launches))

    def refuse(*args):
        raise ctypes.ArgumentError("argument 1: wrong type")

    entries = {n: _Entry() for n in _build._SIGNATURES}
    lib = _build.declare(types.SimpleNamespace(**{**entries, "pf_direct": refuse}))

    @tracing.kernel("Ktest", ("direct_kernel",))
    def launch(x):
        return lib.pf_direct(*[0] * 8)

    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ctypes.ArgumentError):
            launch(torch.zeros(2))
    last = tracing.spans()[-1]
    assert (last.name, last.parent) == ("portfft.Ktest", -1)
    assert not getattr(tracing._local, "stack", [])


def _traced_calls(plan, x, count):
    """``count`` calls of ``plan``, each inside a harness-style
    ``compute_forward`` span in one ``traced_window``, under a CPU profiler:
    the profile, its trace, the calls' spans and the trace's origin, found
    as the readers find it beside the harness's profile."""
    from torch.profiler import record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("traced_window"):
            for _ in range(count):
                with record_function("compute_forward"):
                    plan.compute_forward(x)
    trc = devtrace.collect(prof, rounds=count)
    return prof, trc, tracing.calls(count), idle_by_span.origin_ns(trc)


def _on_trace_clock(span, origin):
    return (span.start_ns - origin) / 1e9, (span.end_ns - origin) / 1e9


@pytest.mark.parametrize("kind", list(CALLS))
def test_calls_lie_inside_their_compute_spans_on_the_trace_clock(kind):
    make, _ = CALLS[kind]
    desc, x = make()
    plan = desc.commit(device="cpu")
    plan.compute_forward(x)
    prof, trc, calls, origin = _traced_calls(plan, x, 5)
    computes = sorted((s for s in trc.spans if s[0] == "compute_forward"), key=lambda s: s[1])
    assert origin == prof.profiler.kineto_results.trace_start_ns()
    assert origin is not None and len(calls) == len(computes) == 5
    for call, (_, lo, hi) in zip(calls, computes):
        start, end = _on_trace_clock(call.root, origin)
        assert lo <= start < end <= hi


@pytest.mark.parametrize("kind", list(CALLS))
def test_the_plain_paths_operations_lie_inside_their_call(kind):
    make, _ = CALLS[kind]
    desc, x = make()
    plan = desc.commit(device="cpu")
    plan.compute_forward(x)
    prof, trc, calls, origin = _traced_calls(plan, x, 3)
    computes = sorted((s for s in trc.spans if s[0] == "compute_forward"), key=lambda s: s[1])
    ops = [(e.time_range.start / 1e6, e.time_range.end / 1e6) for e in prof.events()
           if e.name.startswith("aten::")]
    for call, (_, lo, hi) in zip(calls, computes):
        start, end = _on_trace_clock(call.root, origin)
        mine = [op for op in ops if lo <= op[0] < hi]
        assert mine and all(start <= a <= b <= end for a, b in mine)


def test_the_ring_keeps_the_newest_spans(monkeypatch):
    monkeypatch.setattr(tracing, "RING", 8)
    monkeypatch.setattr(tracing, "_ring", [None] * 8)
    for i in range(13):
        tracing.run(f"portfft.t{i}", lambda: None)
    names = [s.name for s in tracing.spans()]
    assert names == [f"portfft.t{i}" for i in range(5, 13)]


def test_a_kernel_counts_calls_that_reach_the_card(monkeypatch):
    monkeypatch.setattr(tracing, "KERNELS", dict(tracing.KERNELS))
    monkeypatch.setattr(tracing, "_launches", dict(tracing._launches))

    @tracing.kernel("Ktest", ("direct_kernel",))
    def launch(x, out=None):
        """A wrapper."""
        return x

    class OnCard:
        is_cuda = True

    assert launch.kernel == "Ktest" and launch.__doc__ == "A wrapper."
    launch(torch.zeros(2))  # the plain version: nothing launched
    assert tracing.launches("Ktest") == 0
    launch(OnCard())
    launch((OnCard(), OnCard()), out=None)
    assert tracing.launches("Ktest") == 2
    assert tracing.launches()["Ktest"] == 2
    with pytest.raises(ValueError, match="twice"):
        tracing.kernel("Ktest", ())
    tracing.reset_launches()
    assert set(tracing.launches().values()) == {0}


def test_launches_count_by_path_and_reset(monkeypatch):
    """``tracing.path`` counts a kernel's launches by code path; K13's
    plain versions (row and column forms) on the CPU count none; ``reset_launches`` clears them."""
    from portfft_tpu_torch.ops import cuda_chain

    monkeypatch.setattr(tracing, "_paths", {})
    assert tracing.paths("K13") == {} and tracing.paths() == {}
    for which in ("radix", "radix", "plain"):
        tracing.path("Ktest", which)
    assert tracing.paths("Ktest") == {"radix": 2, "plain": 1}
    assert tracing.paths() == {"Ktest": {"radix": 2, "plain": 1}}
    plan = pf.Descriptor(lengths=[368]).commit(device="cpu")
    tabs = cuda_chain.chain_tables(plan.plans[368], -1, plan._bank_keys,
                                   plan._bank_arrays)
    assert cuda_chain.path_of(tabs) == "radix"
    cuda_chain.chain(torch.zeros(2, 368), torch.zeros(2, 368), tabs)
    cuda_chain.chain_cols(torch.zeros(2, 368, 8), torch.zeros(2, 368, 8), 2, 8, tabs)
    assert tracing.paths("K13") == {}
    tracing.reset_launches()
    assert tracing.paths() == {}


def test_every_wrapper_is_registered_once_with_a_k_number():
    from portfft_tpu_torch.ops import (cuda_axis, cuda_bluestein, cuda_chain, cuda_fft,
                                       cuda_global, cuda_global_bf, cuda_global_ilv,
                                       cuda_io, cuda_multidim, cuda_real, cuda_stride)

    wrappers = [f for m in (cuda_axis, cuda_bluestein, cuda_chain, cuda_fft, cuda_global,
                            cuda_global_bf, cuda_global_ilv, cuda_io, cuda_multidim,
                            cuda_real, cuda_stride)
                for f in vars(m).values() if callable(getattr(f, "plain", None))]
    names = [f.kernel for f in wrappers]
    # 31 wrappers under 30 K-numbers: K13's row and column forms share one
    # registration
    assert len(names) == 31 and sorted(set(names)) == sorted(tracing.KERNELS)
    assert sorted(n for n in names if names.count(n) > 1) == ["K13", "K13"]
    assert all(re.fullmatch(r"K\d+[a-z]?(-[a-z0-9]+)?", n) for n in names)
    assert not any(hasattr(f, "launches") for f in wrappers)


def test_every_registered_symbol_is_a_global_function_of_csrc():
    csrc = os.path.join(ROOT, "portfft_tpu_torch", "csrc")
    text = "".join(open(os.path.join(csrc, f)).read() for f in sorted(os.listdir(csrc)))
    found = set(re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(", text))
    for k in tracing.KERNELS.values():
        assert k.symbols and set(k.symbols) <= found, (k.name, set(k.symbols) - found)
    assert found <= {s for k in tracing.KERNELS.values() for s in k.symbols}


@pytest.mark.parametrize("op,kernels", [
    # device operations as the benchmark's breakdown names them
    ("_anonymous_namespace_::direct_kernel_pfft::Pass__float2_const___", ("K1",)),
    ("void__anonymous_namespace_::fused2_v2_kernel_2__1__float2_const_", ("K2-v2",)),
    ("_anonymous_namespace_::fused_kernel__anonymous_namespace_::Fused", ("K17",)),
    ("_anonymous_namespace_::small_real_fwd_kernel_float_const___float", ("K9",)),
    ("_anonymous_namespace_::untangle_kernel_float2_const___float2___f", ("K8a",)),
    ("_anonymous_namespace_::blue_pass2_pfft::Pass__pfft::Sub__float_c", ("K15",)),
    ("_anonymous_namespace_::deinterleave_kernel_float2_const___float_", ("K6-de",)),
    ("_anonymous_namespace_::radix_pass_kernel_pfft::ConstPlanes__pfft:", ("K13",)),
    ("_anonymous_namespace_::radix_chain_kernel_pfft::ConstPlanes__pfft", ("K13",)),
    ("_anonymous_namespace_::chain_kernel_float2_const___pfft::Planes__", ("K13",)),
    ("_anonymous_namespace_::interleave_kernel_float_const___float_con", ("K6-in",)),
    # as the profiler names them
    ("void pfft_bf::sweep_kernel<false>(pfft_bf::Bf)", ("K5", "K19", "K18")),
    ("(anonymous namespace)::global2_kernel(pfft::Pass, float2 const*, float2*)",
     ("K3", "K3-ftw")),
    ("void (anonymous namespace)::radix_pass_kernel<pfft::ConstPlanes, pfft::Planes>"
     "(pfft::Pass, pfft::ConstPlanes, pfft::Planes)", ("K13",)),
    # the fp64 instantiations of K9 and K10 (one sliced kernel, shared by K12
    # and K14 in float32)
    ("void__anonymous_namespace_::small_real_fwd_f64_kernel_1___anonymous_", ("K9",)),
    ("void (anonymous namespace)::small_real_bwd_f64_kernel<1>((anonymous namespace)::"
     "SmallRealT<double>, double2 const*, double2*, double const*, double const*)", ("K9",)),
    ("void pfft::(anonymous namespace)::sliced_kernel<double2 const*, double2*>(pfft::PassT"
     "<decltype (buffer_scalar((std::declval<double2 const*>)()))>, pfft::Slices, double2 "
     "const*, double2*)", ("K10", "K14", "K12")),
    # K10 on the radix stages, both precisions
    ("void (anonymous namespace)::col_radix_kernel<double2>(pfft::PassT<double>, "
     "double2 const*, double2*)", ("K10",)),
    ("void__anonymous_namespace_::col_radix_kernel_float2__pfft::PassT_float__", ("K10",)),
    ("Memset (Device)", ()),
])
def test_device_operation_names_map_to_k_numbers(op, kernels):
    assert tracing.kernels_of(op) == kernels


# -- the per-axis walk: axis spans and glue bytes -----------------------------


def _points(lengths) -> int:
    return int(torch.tensor(lengths).prod())


@pytest.mark.parametrize("lengths,notes", [
    ([640, 23], [("1 exec", "K13"), ("0 K13col", "K13")]),  # fastMRI's route
    ([16, 640, 16], [("2 exec", "K13"), ("1 K13col", "K13"), ("0 K12", "K12")]),
    # a GLOBAL outer axis, which no column kernel takes: moved
    ([65536, 2], [("1 exec", "K13"), ("0 movedim", "K14")]),
])
def test_the_walk_records_one_axis_span_an_axis(lengths, notes, monkeypatch):
    plan = pf.Descriptor(lengths=lengths, number_of_transforms=2).commit(device="cpu")
    x = torch.randn(2 * 2 * _points(lengths))
    plan.compute_forward(x)
    _forbid_record_function(monkeypatch)
    kept = tracing.spans()
    plan.compute_forward(x)
    assert tracing.spans() == kept  # no profiler: no span, no glue mark
    with profile(activities=[ProfilerActivity.CPU]):
        plan.compute_forward(x)
    (call,) = tracing.calls(1)
    (walk,) = call.named("portfft.exec")
    axes = sorted(call.named("portfft.axis"), key=lambda s: s.start_ns)
    assert [s.note for s in axes] == [note for note, _ in notes]
    assert all(s.parent == walk.id for s in axes)
    for axis, (_, kernel) in zip(axes, notes):
        assert [c.name for c in call.children(axis)] == [f"portfft.{kernel}"]
    # the axis spans split the walk and are no layer: its children are the
    # kernels inside them
    assert sorted(c.name for c in call.children(walk)) == sorted(
        f"portfft.{kernel}" for _, kernel in notes)


def test_self_time_is_seen_through_axis_spans(monkeypatch):
    # exec 60 µs: axis 0 of 25 µs holding K13 20 µs, axis 1 of 25 µs holding
    # K13 15 µs and a glue mark; 10 µs of exec outside its axes
    kids = [("portfft.exec", 0, 60, [("portfft.axis", 5, 25), ("portfft.axis", 30, 25)])]
    spans = _call(1, 0, 0, 10, kids)
    axis0, axis1 = [s for s in spans if s.name == "portfft.axis"]
    spans += [Span("portfft.K13", axis0.start_ns + 2 * US, axis0.start_ns + 22 * US,
                   axis0.id, 1, 90),
              Span("portfft.K13", axis1.start_ns + 5 * US, axis1.start_ns + 20 * US,
                   axis1.id, 1, 91),
              Span("portfft.glue", axis1.end_ns - US, axis1.end_ns - US, axis1.id, 1, 92,
                   str(3 << 20))]
    rec = _record(spans, [(0.0, 1e-3)], [], 0.0, 1e-3, monkeypatch)
    assert _reader("exec_self_us").read(rec) == pytest.approx(60.0 - 35.0)
    assert _reader("call_self_us").read(rec) == pytest.approx(10.0)
    assert _reader("launch_self_us").read(rec) == pytest.approx(35.0)
    assert _reader("walk_glue_mib").read(rec) == pytest.approx(3.0)


def _split_walk(lengths, batch):
    s = 1 / _points(lengths) ** 0.5
    desc = pf.Descriptor(lengths=lengths, number_of_transforms=batch, forward_scale=s,
                         backward_scale=s, complex_storage=pf.ComplexStorage.SPLIT_COMPLEX)
    n = batch * _points(lengths)
    return desc, (torch.randn(n), torch.randn(n))


@pytest.mark.parametrize("lengths,batch,planes,split", [
    ([640, 368], 1, 0, False),  # fastMRI: axis 0 on K13's column form, where it lies
    ([640, 23], 3, 0, False),
    ([16, 640, 16], 1, 0, False),  # K12 and K13's column form copy nothing
    ([640, 23], 2, 0, True),  # SPLIT: the scale in K13's column launch
    ([256, 256], 1, 0, False),  # the raw multi-dim route: no walk
    ([20011], 1, 0, False),  # a 1D plane call: K6, K15, K6
    # an outer Bluestein axis, which no column kernel takes: its chirp reads
    # the moved view, and the result is put back by a copy
    ([1031, 4], 3, 2, False),
    # SPLIT, tiles of 800 points, under cuda_chain.COLS_MIN_POINTS: axis 0's
    # rows made contiguous, put back, and the scale after K13, one multiply a plane
    ([100, 8], 2, 6, True),
])
def test_glue_bytes_count_the_walks_copies(lengths, batch, planes, split):
    n = batch * _points(lengths)
    if split:
        desc, x = _split_walk(lengths, batch)
    else:
        desc, x = pf.Descriptor(lengths=lengths, number_of_transforms=batch), torch.randn(2 * n)
    plan = desc.commit(device="cpu")
    args = x if split else (x,)
    tracing.reset_glue()
    assert tracing.glue_bytes() == 0
    plan.compute_forward(*args)
    plan.compute_backward(*args)
    assert tracing.glue_bytes() == 2 * planes * n * 4
    with profile(activities=[ProfilerActivity.CPU]):
        plan.compute_forward(*args)
    (call,) = tracing.calls(1)
    assert call.glue_bytes() == planes * n * 4
    assert tracing.glue_bytes() == 3 * planes * n * 4


# -- tuning outcomes at commit ------------------------------------------------


@pytest.fixture
def tmp_cache(tmp_path, monkeypatch):
    monkeypatch.delenv("PORTFFT_NO_TUNING", raising=False)
    monkeypatch.setattr(tuning, "_USER_PATH", str(tmp_path / "port.json"))
    tuning._reset_for_tests()
    yield
    tuning._reset_for_tests()


def _bi(n, batch):
    return dict(forward_strides=[batch], backward_strides=[batch], forward_distance=1,
                backward_distance=1)


@pytest.mark.parametrize("outcome,lengths,batch,kw,kind,params", [
    ("hit", [4096], 2, {}, "fused2", {}),
    ("miss", [4096], 2, {}, None, None),
    ("declined", [1 << 18], 1, {}, "global2", {"eng": 5}),  # past K4's cluster
    ("hit", [512, 512], 1, {}, "multidim", {"m2": 0}),
    ("miss", [4096], 4, _bi(4096, 4), None, None),  # the bi_col kind
])
def test_tuning_outcomes_are_counted_once_a_commit(tmp_cache, outcome, lengths, batch,
                                                   kw, kind, params):
    desc = pf.Descriptor(lengths=lengths, number_of_transforms=batch, **kw)
    if kind is not None:
        key = tuning._entry_key(desc.commit(device="cpu"), kind)
        tuning.record("cpu", kind, key, params)
    before = tracing.tuning_outcomes()
    desc.commit(device="cpu")
    after = tracing.tuning_outcomes()
    rose = {k: after[k] - before[k] for k in after}
    assert rose == {k: int(k == outcome) for k in after}


def test_a_direct_or_plane_commit_looks_nothing_up(tmp_cache):
    before = tracing.tuning_outcomes()
    for n in (16, 20011):
        pf.Descriptor(lengths=[n], number_of_transforms=1).commit(device="cpu")
    assert tracing.tuning_outcomes() == before


# -- the benchmark's readers ----------------------------------------------------

US = 1000  # ns


def _call(call_id, first_id, t0, self_us, children=(), offset_s=0.0):
    """The spans of one call: a root at ``t0`` (µs, on the program's clock
    less ``offset_s``) lasting ``self_us`` plus its children's time;
    ``children`` are ``(name, start_us, us, grandchildren)``, a child's
    start relative to the root's and a grandchild's to its parent's."""
    base = int(offset_s * 1e9) + t0 * US
    spans, ids = [], iter(range(first_id, first_id + 100))
    rid = next(ids)
    end = base + self_us * US + sum(c[2] for c in children) * US

    def add(name, start, length, parent, kids):
        sid = next(ids)
        spans.append(Span(name, base + start * US, base + (start + length) * US, parent,
                          call_id, sid))
        for k in kids:
            add(k[0], start + k[1], k[2], sid, ())

    for name, start, length, kids in children:
        add(name, start, length, rid, kids)
    spans.insert(0, Span("portfft.call", base, end, -1, call_id, rid, "forward"))
    return spans


def _record(spans_prog, computes, ops, start, end, monkeypatch, origin_ns=None):
    monkeypatch.setattr(tracing, "spans", lambda: sorted(spans_prog, key=lambda s: s.id))
    trace = devtrace.Trace(ops=ops, spans=[("compute_forward", lo, hi) for lo, hi in computes]
                           + [("traced_window", start, end)], start=start, end=end, rounds=1)
    if origin_ns is not None:  # a synthetic trace's clock: no profile to read it from
        trace.origin_ns = origin_ns
    return run.Record(specs=[], setup_s=0.0, commit_s=[], calls=[], window_s=1.0,
                      peak_bytes=0, trace=trace)


def test_self_times_with_nested_children(monkeypatch):
    # root 100 µs: K1 20 µs, exec 50 µs holding K15 30 µs, 30 µs its own
    kids = [("portfft.K1", 10, 20, ()),
            ("portfft.exec", 40, 50, [("portfft.K15", 10, 30)])]
    spans = _call(1, 0, 0, 30, kids)
    rec = _record(spans, [(0.0, 1e-3)], [], 0.0, 1e-3, monkeypatch)
    assert _reader("call_self_us").read(rec) == pytest.approx(30.0)
    assert _reader("exec_self_us").read(rec) == pytest.approx(20.0)
    assert _reader("launch_self_us").read(rec) == pytest.approx(50.0)


def test_exec_self_us_needs_an_executor_walk(monkeypatch):
    spans = _call(1, 0, 0, 10, [("portfft.K1", 2, 5, ())])
    rec = _record(spans, [(0.0, 1e-3)], [], 0.0, 1e-3, monkeypatch)
    assert _reader("exec_self_us").read(rec) is None
    assert _reader("launch_self_us").read(rec) == pytest.approx(5.0)


def _idle_case(offset_s, jitter_us, monkeypatch):
    """A 10 ms segment: device busy 0–1, 2–5.5 and 7.5–10 ms; the harness's
    compute spans 1–3 and 5–7 ms; the program's calls 1–2.8 and 5–6.8 ms,
    on a clock ``offset_s`` ahead, the second start ``jitter_us`` late.
    Idle 3 ms (30%), 2.3 ms of it inside a call (23%)."""
    spans = (_call(1, 0, 1000, 1800, offset_s=offset_s)
             + _call(2, 10, 5000 + jitter_us, 1800 - jitter_us, offset_s=offset_s))
    ms = 1e-3
    ops = [("k", 0.0, 1 * ms), ("k", 2 * ms, 5.5 * ms), ("k", 7.5 * ms, 10 * ms)]
    return _record(spans, [(1 * ms, 3 * ms), (5 * ms, 7 * ms)], ops, 0.0, 10 * ms,
                   monkeypatch)


@pytest.mark.parametrize("offset_s", [0.0, 123.456789])
def test_idle_in_program_splits_a_gap_at_a_planted_offset(offset_s, monkeypatch):
    rec = _idle_case(offset_s, 0, monkeypatch)
    idle = _reader("idle_in_program_pct").read(rec)
    assert idle == pytest.approx(23.0, abs=1e-6)
    device = (1 - rec.trace.busy_s() / rec.trace.window_s) * 100
    assert device == pytest.approx(30.0) and idle <= device


def test_idle_in_program_refuses_a_wide_offset_spread(monkeypatch):
    assert _reader("idle_in_program_pct").read(_idle_case(5.0, 10, monkeypatch)) is not None
    assert _reader("idle_in_program_pct").read(_idle_case(5.0, 50, monkeypatch)) is None


def test_idle_in_program_needs_device_operations(monkeypatch):
    spans = _call(1, 0, 0, 10)
    rec = _record(spans, [(0.0, 1e-3)], [], 0.0, 1e-3, monkeypatch)
    assert _reader("idle_in_program_pct").read(rec) is None


def test_readers_take_the_last_segments_calls_after_a_retake(monkeypatch):
    # three calls of an earlier segment (1 ms of their own), then the two
    # of the segment the trace holds (10 µs)
    old = [s for i in range(3) for s in _call(i + 1, 10 * i, 1000 * i, 1000)]
    new = [s for i in range(2) for s in _call(i + 4, 100 + 10 * i, 10000 + 100 * i, 10)]
    rec = _record(old + new, [(0.010, 0.0101), (0.0101, 0.0102)], [], 0.010, 0.0102,
                  monkeypatch)
    assert _reader("call_self_us").read(rec) == pytest.approx(10.0)


#: A Unix time in ns: the origin of the synthetic traces' clock.
ORIGIN = 1_789_012_345_678_901_234


def _tree(node, call_id, ids, parent=-1):
    """The spans of ``node``, ``(name, start_us, end_us, children)`` with
    every time in µs on the trace's clock from ``ORIGIN``."""
    name, lo, hi, kids = node
    sid = next(ids)
    out = [Span(name, ORIGIN + lo * US, ORIGIN + hi * US, parent, call_id, sid,
                "forward" if parent == -1 else "")]
    for kid in kids:
        out += _tree(kid, call_id, ids, sid)
    return out


def _split_case(inner, monkeypatch, ops=True, origin_ns=ORIGIN):
    """A 10 ms segment, the device busy 0–1 and 6–10 ms: idle 1–6 ms (50%),
    across the harness's compute span 0.5–6 ms and the call 2–5.5 ms that
    holds ``inner``."""
    spans = _tree(("portfft.call", 2000, 5500, [inner]), 1, itertools.count())
    busy = [("k", 0.0, 1e-3), ("k", 6e-3, 10e-3)] if ops else []
    return _record(spans, [(0.5e-3, 6e-3)], busy, 0.0, 10e-3, monkeypatch, origin_ns)


#: A wrapper 2.5–5 ms with its launch 3–4.5 ms.
_WRAPPED = ("portfft.K1", 2500, 5000, [("portfft.launch", 3000, 4500, [])])
#: The executor 2.2–5.3 ms, an axis 2.3–5.2 ms in it holding the wrapper.
_WALKED = ("portfft.exec", 2200, 5300, [
    ("portfft.axis", 2300, 5200, [("portfft.K13", 2500, 5000,
                                   [("portfft.launch", 3000, 4500, [])])])])

IDLE = ("idle_in_call_pct", "idle_in_exec_pct", "idle_in_wrapper_pct", "idle_in_launch_pct")


@pytest.mark.parametrize("inner,want", [
    # call 2–2.5 and 5–5.5 ms, wrapper 2.5–3 and 4.5–5, launch 3–4.5; the
    # harness's 1–2 and 5.5–6 ms are no layer's
    (_WRAPPED, (10.0, None, 10.0, 15.0)),
    # call 2–2.2 and 5.3–5.5; the executor 2.2–2.5 and 5–5.3, through its axis
    (_WALKED, (4.0, 6.0, 10.0, 15.0)),
])
def test_idle_splits_a_gap_by_the_hosts_innermost_span(inner, want, monkeypatch):
    rec = _split_case(inner, monkeypatch)
    got = tuple(_reader(name).read(rec) for name in IDLE)
    for g, w in zip(got, want):
        assert g == (None if w is None else pytest.approx(w, abs=1e-9))
    device = (1 - rec.trace.busy_s() / rec.trace.window_s) * 100
    assert device == pytest.approx(50.0)
    # the harness's 1.5 ms: left to none of them
    assert device - sum(g for g in got if g is not None) == pytest.approx(15.0)


@pytest.mark.parametrize("name", IDLE)
def test_idle_by_span_needs_device_operations_a_clock_origin_and_the_tracers_clock(
        name, monkeypatch):
    assert _reader(name).read(_split_case(_WALKED, monkeypatch)) is not None
    assert _reader(name).read(_split_case(_WALKED, monkeypatch, ops=False)) is None
    assert _reader(name).read(_split_case(_WALKED, monkeypatch, origin_ns=None)) is None
    # a program whose spans are on another clock (``perf_counter_ns``)
    monkeypatch.setattr(tracing, "CLOCK", time.perf_counter_ns)
    assert _reader(name).read(_split_case(_WALKED, monkeypatch)) is None


def _drift_case(ops_ms, monkeypatch):
    """``_split_case`` with ``_WRAPPED`` (its launch 3–4.5 ms) and the
    device operations ``(name, start_ms, end_ms)`` besides."""
    rec = _split_case(_WRAPPED, monkeypatch)
    rec.trace.ops = sorted(rec.trace.ops + [(n, a * 1e-3, b * 1e-3) for n, a, b in ops_ms],
                           key=lambda op: op[1])
    return rec


#: A kernel of the port, as a profiler names it.
_K1_OP = "(anonymous namespace)::direct_kernel(float2 const*, float2*)"


@pytest.mark.parametrize("ops_ms,agree", [
    # the kernel starts 5 µs after its launch returned, on an idle card
    ([(_K1_OP, 4.505, 4.6)], True),
    # 5 µs before its launch began: within the stamps' own error
    ([(_K1_OP, 2.995, 3.1)], True),
    # 50 µs before its launch began: the device's stamps run early
    ([(_K1_OP, 2.95, 3.1)], False),
    # 200 µs after its launch returned, the card idle all along: late
    ([(_K1_OP, 4.7, 4.8)], False),
    # 30 µs after another operation ended, with no launch open: queued
    # behind it, so not held to the launches
    ([("k", 2.3, 2.47), (_K1_OP, 2.5, 2.6)], True),
    # an operation of no kernel of the port is not held to them
    ([("k", 2.5, 2.6)], True),
])
def test_idle_by_span_gives_no_split_where_the_device_and_the_launches_disagree(
        ops_ms, agree, monkeypatch):
    rec = _drift_case(ops_ms, monkeypatch)
    got = [_reader(name).read(rec) for name in IDLE if name != "idle_in_exec_pct"]
    assert all((g is not None) == agree for g in got)


def test_disagreements_finds_early_and_late_kernels():
    from port_bench import idle_by_span

    ops = [("k", 0.0, 1e-3), (_K1_OP, 2.95e-3, 3.1e-3), (_K1_OP, 4.7e-3, 4.8e-3),
           (_K1_OP, 6.0e-3, 6.1e-3)]
    trc = devtrace.Trace(ops=ops, spans=[], start=0.0, end=10e-3, rounds=1)
    launches = [(3.0e-3, 3.05e-3), (4.5e-3, 4.55e-3), (5.99e-3, 6.0e-3)]
    assert idle_by_span.disagreements(trc, launches, 0.0, 10e-3) == ([ops[1]], [ops[2]])
    # outside ``[lo, hi]`` nothing is held to them
    assert idle_by_span.disagreements(trc, launches, 5e-3, 10e-3) == ([], [])


def test_a_launch_span_leaves_the_self_times_as_they_were(monkeypatch):
    def call(launches):
        inner = [("portfft.launch", 15, 25, [])] if launches else []
        walked = [("portfft.launch", 55, 75, [])] if launches else []
        return _tree(("portfft.call", 0, 100, [
            ("portfft.K1", 10, 30, inner),
            ("portfft.exec", 40, 90, [("portfft.axis", 45, 85, [
                ("portfft.K15", 50, 80, walked)])])]), 1, itertools.count())

    read = {}
    for launches in (False, True):
        rec = _record(call(launches), [(0.0, 1e-3)], [], 0.0, 1e-3, monkeypatch, ORIGIN)
        read[launches] = [_reader(n).read(rec)
                          for n in ("call_self_us", "launch_self_us", "exec_self_us")]
    assert read[True] == read[False] == [pytest.approx(30.0), pytest.approx(50.0),
                                         pytest.approx(20.0)]


@pytest.mark.parametrize("name", READERS)
def test_readers_return_none_without_the_tracer(name, monkeypatch):
    import portfft_tpu_torch.utils as utils

    rec = _idle_case(0.0, 0, monkeypatch)
    monkeypatch.delattr(utils, "tracing")
    monkeypatch.setitem(sys.modules, "portfft_tpu_torch.utils.tracing", None)
    assert _reader(name).read(rec) is None


# device operations of one walk as a profiler names them: K6, K13 and PyTorch's
# copy and multiply kernels, which map to no kernel of the port
_COPY = ("void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_impl_nocast"
         "<at::native::direct_copy_kernel_cuda(at::TensorIteratorBase&)")
_MUL = ("void at::native::vectorized_elementwise_kernel<4, at::native::AUnaryFunctor<float, "
        "float, float, at::native::binary_internal::MulFunctor<float> >")


def test_glue_pct_reads_the_busy_share_of_operations_of_no_kernel(monkeypatch):
    ms = 1e-3
    ops = [("(anonymous namespace)::deinterleave_kernel(float2 const*, float*, float*)",
            0.0, 1 * ms),
           ("(anonymous namespace)::chain_kernel(pfft::Chain, float const*)", 1 * ms, 5 * ms),
           (_COPY, 5 * ms, 6 * ms),
           (_COPY, 5.5 * ms, 6.5 * ms),  # overlapping: counted once
           ("(anonymous namespace)::pass_kernel(pfft::Chain)", 7 * ms, 9 * ms),
           (_MUL, 9 * ms, 9.5 * ms),
           ("(anonymous namespace)::interleave_kernel(float const*, float const*)",
            9.5 * ms, 10 * ms)]
    rec = _record([], [(0.0, 10 * ms)], ops, 0.0, 10 * ms, monkeypatch)
    # busy 9.5 ms (idle 6.5–7), glue 1.5 + 0.5 ms
    assert _reader("glue_pct").read(rec) == pytest.approx(2.0 / 9.5 * 100)
    kernels = [op for op in ops if op[0] not in (_COPY, _MUL)]
    rec = _record([], [(0.0, 10 * ms)], kernels, 0.0, 10 * ms, monkeypatch)
    assert _reader("glue_pct").read(rec) == 0.0
    rec = _record([], [(0.0, 10 * ms)], [], 0.0, 10 * ms, monkeypatch)
    assert _reader("glue_pct").read(rec) is None


def test_walk_glue_mib_averages_the_segments_calls(monkeypatch):
    spans = []
    for i, mib in enumerate((4, 2)):
        call = _call(i + 1, 10 * i, 1000 * i, 10)
        root = call[0]
        call.append(Span("portfft.glue", root.start_ns, root.start_ns, root.id, i + 1,
                         10 * i + 5, str(mib << 20)))
        spans += call
    rec = _record(spans, [(0.0, 1e-3), (1e-3, 2e-3)], [], 0.0, 2e-3, monkeypatch)
    assert _reader("walk_glue_mib").read(rec) == pytest.approx(3.0)
    # a program without the counter (the tracer of an older program) reads None
    monkeypatch.delattr(tracing, "glue_bytes")
    assert _reader("walk_glue_mib").read(rec) is None


def test_tuned_pct_reads_the_counters(monkeypatch):
    monkeypatch.setattr(tracing, "_tuning", {"hit": 3, "miss": 1, "declined": 0})
    assert _reader("tuned_pct").read(None) == pytest.approx(75.0)
    monkeypatch.setattr(tracing, "_tuning", {"hit": 0, "miss": 0, "declined": 0})
    assert _reader("tuned_pct").read(None) is None


@pytest.fixture(scope="module")
def small_bench(tmp_path_factory):
    return run.Bench(small_copy(str(tmp_path_factory.mktemp("small"))))


def test_the_readers_find_the_harness_profiles_origin(small_bench, monkeypatch):
    profiles, seen = [], []
    collect = devtrace.collect

    def keep(prof, rounds):
        profiles.append(prof)
        return collect(prof, rounds)

    monkeypatch.setattr(devtrace, "collect", keep)
    monkeypatch.setattr(idle_by_span, "split",
                        lambda rec: seen.append(idle_by_span.origin_ns(rec.trace)))
    run.run_cell(small_bench, pf, "r2c_1d.bulk", 2**31 + 11, 1.0, True, "cpu", {},
                 time.perf_counter())
    origin = profiles[-1].profiler.kineto_results.trace_start_ns()
    assert seen and origin is not None and set(seen) == {origin}
    # away from the harness's frame there is none to find
    assert idle_by_span.origin_ns(devtrace.Trace(ops=[], spans=[], start=0.0, end=1.0,
                                                 rounds=1)) is None


@pytest.mark.parametrize("cell", ["c2c_1d.bulk", "r2c_1d.bulk", "c2c_1d.nonsmooth",
                                  "fastmri_knee.volume", "fourcastnet_afno.ensemble"])
def test_a_traced_run_reports_the_cells_new_metrics(cell, small_bench, monkeypatch):
    env = dict(os.environ)
    run.pin_environment(env)
    for key in [k for k in os.environ if k.startswith("PORTFFT_") and k not in env]:
        monkeypatch.delenv(key)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    monkeypatch.setattr(tracing, "_tuning", {"hit": 0, "miss": 0, "declined": 0})
    result = run.run_cell(small_bench, pf, cell, 2**31 + 7, 3.0, True, "cpu", {},
                          time.perf_counter())
    assert result["correct"]
    listed = {m["name"] for m in small_bench.spec["per_layer"]
              if m["name"] in READERS and cell in m["workloads"]}
    # the CPU run has no device operations to be idle between
    assert set(result["metrics"]) & set(READERS) == listed - DEVICE_READERS
    for name in listed - DEVICE_READERS:
        assert result["metrics"][name]["value"] >= 0
    if cell == "fastmri_knee.volume":  # the 640 axis where it lies: no plane copied
        assert result["metrics"]["walk_glue_mib"]["value"] == 0
