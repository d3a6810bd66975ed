"""What decides ``correct``, driven through a whole run of each cell on the
CPU (the program's plain versions) at its own lengths and limits, with at
most two transforms a call: the program passes; the control, the
configuration's reference in TF32 put in the program's place, fails; and
so does the program with each fault a cell can have planted under the
timed path."""

import json
import os
import time

import pytest
import torch

from port_bench import run
from port_bench.tests.conftest import ROOT

CELLS = [w["name"] for w in json.load(open(os.path.join(ROOT, "BENCHMARK.json")))["workloads"]]
SECONDS = 0.3


def _run(root, pf, cell, wrap=None, trace=False):
    return run.run_cell(run.Bench(root), pf, cell, 2**31 + 5, SECONDS, trace, "cpu",
                        {}, time.perf_counter(), wrap)


def _over(result) -> list:
    return [name for name, c in result["checks"].items() if c["value"] > c["limit"]]


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_is_correct(small_root, program, cell):
    result = _run(small_root, program, cell)
    assert result["correct"] and result["failed"] == 0 and not _over(result)
    assert result["attempted"] > 0
    assert list(result)[-1] == "checks"


def _control(fn, spec, ref):
    return lambda x: ref.control(x, spec)


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(small_root, program, cell):
    result = _run(small_root, program, cell, _control)
    assert not result["correct"]
    assert _over(result)


def _unwritten(fn, spec, ref):
    """A step that leaves its output as it was made: never written."""
    return lambda x: torch.zeros_like(fn(x))


def _input_returned(fn, spec, ref):
    """A C2C step that returns its input unchanged."""
    return lambda x: x.clone()


def _half_batch(fn, spec, ref):
    """The second half of the batch left out."""
    def broken(x):
        y = fn(x)
        y.view(spec["batch"], -1)[spec["batch"] // 2:] = 0
        return y
    return broken


def _answer_altered(fn, spec, ref):
    """One element of the last transform altered where it is produced."""
    def broken(x):
        y = fn(x)
        (torch.view_as_real(y) if y.is_complex() else y).view(-1)[-2] += 1.0
        return y
    return broken


FAULTS = {"unwritten": _unwritten, "input_returned": _input_returned,
          "half_batch": _half_batch, "answer_altered": _answer_altered}


@pytest.mark.parametrize("cell,fault", [
    (cell, fault) for cell in CELLS for fault in FAULTS
    # an R2C output has another size than its input
    if not (fault == "input_returned" and cell.startswith("r2c"))])
def test_each_fault_is_not_correct(small_root, program, cell, fault):
    result = _run(small_root, program, cell, FAULTS[fault])
    assert not result["correct"], result["checks"]


def test_a_call_that_raises_in_the_window_is_not_correct(small_root, program):
    def raises_after_warmup(fn, spec, ref):
        calls = [0]

        def broken(x):
            calls[0] += 1
            if calls[0] > run.WARMUP_CALLS:
                raise RuntimeError("planted")
            return fn(x)
        return broken
    result = _run(small_root, program, CELLS[0], raises_after_warmup)
    assert not result["correct"] and result["failed"] >= 1


def test_a_traced_run_checks_the_same(small_root, program):
    ok = _run(small_root, program, CELLS[0], trace=True)
    bad = _run(small_root, program, CELLS[0], _half_batch, trace=True)
    assert ok["correct"] and not bad["correct"]
    assert "breakdown" in ok and "busy_s" in ok["device"]


@pytest.mark.parametrize("ahead", [1, 3, 100000])
def test_a_pipelined_window_counts_every_call_sent(tmp_path, program, ahead):
    """With ``ahead_calls`` in its traffic the window keeps calls in flight,
    and still waits for and counts every call it sent, those in flight at
    its close too; the check sees the same outputs."""
    from port_bench.tests.conftest import small_copy

    root = small_copy(str(tmp_path))
    cell = CELLS[0]
    path = os.path.join(root, "port_bench", "traffic", f"{cell}.json")
    traffic = json.load(open(path))
    traffic["ahead_calls"] = ahead
    json.dump(traffic, open(path, "w"))
    sent = [0]

    def counting(fn, spec, ref):
        def counted(x):
            sent[0] += 1
            return fn(x)
        return counted
    result = _run(root, program, cell, counting)
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] == sent[0] - run.WARMUP_CALLS * len(traffic["calls"])
    bad = _run(root, program, cell, _half_batch)
    assert not bad["correct"]
