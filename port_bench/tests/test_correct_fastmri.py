"""Faults that only the orthonormal 2D configuration can have, planted under
the timed path of each of its cells and driven through a whole run on the
CPU as ``test_correct.py`` drives the faults every cell can have: each run
is not correct."""

import json
import math
import os

import pytest
import torch

from port_bench.tests.conftest import ROOT
from port_bench.tests.test_correct import _run

CELLS = [w["name"] for w in json.load(open(os.path.join(ROOT, "BENCHMARK.json")))["workloads"]
         if w["config"] == "fastmri_knee"]


def _scale_left_out(fn, spec, ref):
    """An orthonormal transform returned without its scale 1/√N."""
    return lambda x: fn(x) * math.sqrt(math.prod(spec["lengths"]))


def _one_axis_only(fn, spec, ref):
    """A 2D transform that leaves its first axis untransformed: the
    program's output with that axis taken back."""
    undo = torch.fft.ifft if spec["direction"] == "forward" else torch.fft.fft

    def broken(x):
        y = fn(x).view(-1, *spec["lengths"])
        return undo(y, dim=1, norm="ortho").reshape(-1)
    return broken


def _other_direction(fn, spec, ref):
    """The other direction's sign, at the same scale: conj(F(conj x))."""
    return lambda x: fn(x.conj().resolve_conj()).conj().resolve_conj()


FAULTS = {"scale_left_out": _scale_left_out, "one_axis_only": _one_axis_only,
          "other_direction": _other_direction}


@pytest.mark.parametrize("cell,fault", [(cell, fault) for cell in CELLS for fault in FAULTS])
def test_each_orthonormal_fault_is_not_correct(small_root, program, cell, fault):
    result = _run(small_root, program, cell, FAULTS[fault])
    assert not result["correct"], result["checks"]
