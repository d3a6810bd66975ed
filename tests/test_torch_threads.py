"""Cores shared between parallel test workers.

pytest imports every test module in every worker before any test runs, so
the statement below caps PyTorch's intra-op threads (its OpenMP pool and
the BLAS under ``torch.matmul``) for every test a worker runs: the cores
divided among the ``pytest-xdist`` workers, all of them in a single
process.  With one pool of every core in each of six workers on
eight cores, the workers' OpenMP barriers wait on descheduled threads: on
an 8-core CPU the whole suite under ``-n 6 --dist loadfile`` took 1164 s
where it takes 314 s with one thread a worker, and
``test_torch_smoke_tuned.py`` 1129 s where it takes 22 s alone.  JAX's own
thread pool is not touched.
"""

import os

import torch


def share_of_the_cores() -> int:
    """Intra-op threads for this process: the cores over the xdist
    workers, at least one."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, (os.cpu_count() or 1) // max(1, workers))


torch.set_num_threads(share_of_the_cores())


def test_the_worker_keeps_its_share_of_the_cores():
    assert torch.get_num_threads() == share_of_the_cores()
