"""A later change adds a cell, a traffic mix and a per-layer metric by adding
files and entries alone: in a copy of the benchmark, a new traffic file and
a new metric file are found by name and run, and no file that was already
there is edited."""

import hashlib
import json
import os
import subprocess
import sys
import time

from port_bench import run
from port_bench.tests.conftest import ROOT, small_copy


def _digests(root: str) -> dict:
    out = {}
    for dirpath, dirs, files in os.walk(os.path.join(root, "port_bench")):
        dirs[:] = [d for d in dirs if d not in ("__pycache__", "tests")]
        for f in files:
            path = os.path.join(dirpath, f)
            out[os.path.relpath(path, root)] = hashlib.sha256(open(path, "rb").read()).hexdigest()
    out["BENCHMARK.json"] = hashlib.sha256(
        open(os.path.join(root, "BENCHMARK.json"), "rb").read()).hexdigest()
    return out


def test_a_new_cell_and_metric_are_found_by_name(tmp_path, program):
    root = small_copy(str(tmp_path))
    before = _digests(root)
    with open(os.path.join(root, "port_bench", "traffic", "c2c_1d.roundtrip_small.json"), "w") as f:
        json.dump({"why": "forward then backward", "pool_bytes": 0, "calls": [
            {"lengths": [256], "batch": 2, "direction": "forward", "limit": 1e-4},
            {"name": "n256.back", "lengths": [256], "batch": 2, "direction": "backward",
             "limit": 1e-4}]}, f)
    with open(os.path.join(root, "port_bench", "metrics", "calls_per_s.py"), "w") as f:
        f.write("def read(run):\n    return len(run.calls) / run.window_s\n")
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    bench["workloads"].append({"name": "c2c_1d.roundtrip_small", "config": "c2c_1d",
                               "traffic": "roundtrip_small", "chips": 1, "why": "a new cell"})
    bench["per_layer"].append({"name": "calls_per_s", "unit": "1/s", "better": "higher",
                               "source": "host_clock", "layer": "registry and call",
                               "moves": "setup_s",
                               "workloads": ["c2c_1d.roundtrip_small"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    after = _digests(root)
    edited = [p for p in before if p != "BENCHMARK.json" and before[p] != after[p]]
    assert not edited

    traced = run.run_cell(run.Bench(root), program, "c2c_1d.roundtrip_small", 7, 0.3, True,
                          "cpu", {}, time.perf_counter())
    assert traced["correct"]
    assert traced["metrics"]["calls_per_s"]["value"] > 0
    assert set(traced["checks"]) == {"n256", "n256.back"}
    plain = run.run_cell(run.Bench(root), program, "c2c_1d.roundtrip_small", 7, 0.3, False,
                         "cpu", {}, time.perf_counter())
    # setup_s has no workloads key, so every cell reports it; peak_mem_gib
    # reads the card's allocator, which the CPU has not
    assert set(plain["metrics"]) == {"setup_s"}
    assert "calls_per_s" not in plain["metrics"]
    # the new metric is read in its own cell alone
    other = run.run_cell(run.Bench(root), program, "c2c_1d.bulk", 7, 0.3, True,
                         "cpu", {}, time.perf_counter())
    assert "calls_per_s" not in other["metrics"]


def test_without_a_cuda_device_the_run_exits_non_zero_and_prints_no_result():
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "port_bench", "run.py"), "--workload",
         "c2c_1d.bulk", "--seed", "3", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert proc.stdout == ""
