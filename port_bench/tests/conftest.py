"""CPU tests of the benchmark harness: ``python -m pytest port_bench/tests``
from the root of the repository."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import json  # noqa: E402
import shutil  # noqa: E402

import pytest  # noqa: E402


def small_copy(dest: str, batch_cap: int = 2) -> str:
    """A copy of ``BENCHMARK.json`` and ``port_bench/`` under ``dest`` whose
    cells keep their lengths, directions and limits with at most
    ``batch_cap`` transforms a call and one input a call spec."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dest)
    shutil.copytree(os.path.join(ROOT, "port_bench"), os.path.join(dest, "port_bench"),
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    traffic = os.path.join(dest, "port_bench", "traffic")
    for name in os.listdir(traffic):
        path = os.path.join(traffic, name)
        data = json.load(open(path))
        data["pool_bytes"] = 0
        for call in data["calls"]:
            call["batch"] = min(call["batch"], batch_cap)
        json.dump(data, open(path, "w"))
    return dest


@pytest.fixture(scope="session")
def small_root(tmp_path_factory):
    return small_copy(str(tmp_path_factory.mktemp("small")))


@pytest.fixture(scope="session")
def program():
    from port_bench import run

    run.pin_environment(os.environ)
    import portfft_tpu_torch

    return portfft_tpu_torch
