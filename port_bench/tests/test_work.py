"""The function-level work of a call and its least time on the card."""

import json
import math
import os

import pytest

from port_bench import work

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_c2c_bytes_and_flops():
    nbytes, flops = work.work("COMPLEX", [65536], 2048)
    assert nbytes == 16 * 2**27 == 2**31
    assert flops == 5 * 2**27 * 16


def test_r2c_bytes_and_flops():
    nbytes, flops = work.work("REAL", [32], 2 << 20)
    assert nbytes == 4 * 2**26 + 8 * (2 << 20) * 17
    assert flops == 2.5 * 2**26 * 5


def test_any_rank_counts_its_total_points():
    assert work.work("COMPLEX", [512, 512], 256) == work.work("COMPLEX", [2**18], 256)
    nbytes, _ = work.work("REAL", [64, 128], 4)
    assert nbytes == 4 * 4 * 64 * 128 + 8 * 4 * 64 * 65


def test_input_bytes():
    assert work.input_bytes("COMPLEX", [16], 8 << 20) == 2**30
    assert work.input_bytes("REAL", [131072], 1024) == 2**29


def test_least_time_of_2_27_complex_points_is_its_bytes():
    seconds, by = work.least_time("COMPLEX", [65536], 2048)
    assert seconds == pytest.approx(2**31 / 3.35e12)
    assert seconds * 1e3 == pytest.approx(0.641, abs=1e-3)
    assert by == "bytes"


def test_flops_bound_a_long_enough_transform():
    # 5·log2 N flops against 16 bytes a point: past log2 N = 64 the fp32
    # rate binds, never at a length a cell uses
    assert work.least_time("COMPLEX", [2**20], 1)[1] == "bytes"
    bytes_per_s, flops_per_s = work.HBM_BYTES_PER_S, work.FP32_FLOPS_PER_S
    crossover = 16 * flops_per_s / (5 * bytes_per_s)
    assert 63 < crossover < 65


@pytest.mark.parametrize("cell", [w["name"] for w in json.load(
    open(os.path.join(ROOT, "BENCHMARK.json")))["workloads"]])
def test_every_cell_is_bound_by_bytes(cell):
    traffic = json.load(open(os.path.join(ROOT, "port_bench", "traffic", f"{cell}.json")))
    domain = "REAL" if cell.startswith("r2c") else "COMPLEX"
    for call in traffic["calls"]:
        assert work.least_time(domain, call["lengths"], call["batch"])[1] == "bytes"
        assert math.prod(call["lengths"]) * call["batch"] > 0
