"""The reduction of a trace to busy time, idle gaps, lost events and the
breakdown, on made-up events."""

import types

import pytest

from port_bench import devtrace


def _event(name, lo_us, hi_us, device):
    return types.SimpleNamespace(
        name=name, device_type=types.SimpleNamespace(name=device),
        time_range=types.SimpleNamespace(start=lo_us, end=hi_us))


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def _trace():
    cpu, cuda = "CPU", "CUDA"
    return devtrace.collect(_Prof([
        _event("traced_window", 0, 100, cpu),
        _event("compute_forward", 0, 10, cpu),
        _event("compute_forward", 0, 40, cuda),  # the span's annotation on the device
        _event("kern_a", 5, 20, cuda),
        _event("kern_b", 15, 30, cuda),
        _event("synchronize", 10, 40, cpu),
        _event("rotate", 40, 60, cpu),
        _event("Memset (Device)", 44, 50, cuda),
        _event("compute_forward", 60, 70, cpu),
        _event("kern_a", 65, 80, cuda),
        _event("at::native::fill", 80, 85, cuda),
        _event("synchronize", 70, 90, cpu),
        _event("kern_a", 95, 130, cuda),         # clipped at the segment's end
    ]), rounds=1)


def test_ops_exclude_span_annotations():
    names = [op[0] for op in _trace().ops]
    assert names == ["kern_a", "kern_b", "Memset (Device)", "kern_a", "at::native::fill",
                     "kern_a"]
    assert [op[0] for op in _trace().kernels()] == [n for n in names if n[0] != "M"]


def test_busy_is_the_union_of_intervals_clipped_to_the_segment():
    trc = _trace()
    assert trc.busy() == [[5e-6, 30e-6], [44e-6, 50e-6], [65e-6, 85e-6], [95e-6, 100e-6]]
    assert trc.busy_s() == pytest.approx(56e-6)
    assert trc.window_s == pytest.approx(100e-6)


def test_gaps_are_labelled_by_the_span_the_host_was_in():
    gaps = _trace().gaps()
    labels = [g[0] for g in gaps]
    assert labels == ["compute_forward", "synchronize", "rotate", "synchronize"]
    assert sum(g[1] for g in gaps) == pytest.approx(44e-6)


def test_lost_events_is_a_count_not_a_multiple_of_the_rounds():
    trc = _trace()
    assert not trc.lost_events()
    trc.rounds = 2
    assert trc.lost_events()  # kern_b and the fill ran once in "two" rounds
    trc.ops = []
    assert trc.lost_events()  # nothing traced at all


def test_breakdown():
    bd = _trace().breakdown()
    assert bd["device_ops"][0][0] == "kern_a"
    assert bd["device_ops"][0][1] == pytest.approx(65e-6)  # unclipped
    assert bd["idle_gaps"][0] == ["all:synchronize", pytest.approx(24e-6)]
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10


def test_a_trace_needs_its_one_window_span():
    with pytest.raises(RuntimeError):
        devtrace.collect(_Prof([_event("kern_a", 0, 1, "CUDA")]), rounds=1)
