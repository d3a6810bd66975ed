"""Where the device time of portfft_tpu_torch's main path goes, per bench row.

    python3 chip_profile.py

For each row of ``bench.py``'s ``CONFIGS``, ``backward_medium`` and
``LADDER_CONFIGS``, of its ``REAL_CONFIGS`` and real_large backward, and of
its ``MULTIDIM_CONFIGS`` plus the BATCH_INTERLEAVED row bi_4096, and of
the plane path's rows (``large_1d_prime`` both ways, n = 1031, 1000 and
2062 at about 1 GiB; the executor's glue shows as torch's own kernels), it
commits the plan on the card, makes 3 warm-up calls,
then profiles 5 calls with ``torch.profiler`` and prints one JSON line: the
plan, the wall ms per call on the host clock around those 5 calls, the
device-busy ms per call (the sum of the kernels' device time), and each
kernel's device ms per launch in launch order.  The first line is the card's
name and power limit as ``nvidia-smi`` gives them.  Needs one CUDA device;
a row whose profile lost device events (some kernel's launches not a
multiple of the calls) is profiled again, up to ``ATTEMPTS`` times, and the
script exits non-zero when none is whole.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

ROWS = [
    ("small_1d", 16, 8 << 20, "forward"),
    ("medium_small_1d", 256, 512 << 10, "forward"),
    ("medium_large_1d", 4096, 32 << 10, "forward"),
    ("large_1d", 65536, 2048, "forward"),
    ("backward_medium", 4096, 32 << 10, "backward"),
    ("ladder_2^17", 1 << 17, 1024, "forward"),
    ("ladder_2^18", 1 << 18, 512, "forward"),
    ("ladder_2^19", 1 << 19, 256, "forward"),
    ("ladder_2^20", 1 << 20, 128, "forward"),
]
REAL_ROWS = [
    ("real_small", 32, 2 << 20, "forward"),
    ("real_medium", 512, 256 << 10, "forward"),
    ("real_large", 8192, 16 << 10, "forward"),
    ("real_131072", 131072, 1024, "forward"),
    ("real_large_backward", 8192, 16 << 10, "backward"),
]
# name, lengths, batch, direction, batch-interleaved (strides [batch],
# distance 1)
MD_ROWS = [
    ("md_512x512", [512, 512], 256, "forward", False),
    ("md_1024x1024", [1024, 1024], 64, "forward", False),
    ("md_128^3", [128, 128, 128], 32, "forward", False),
    ("bi_4096", [4096], 32768, "forward", True),
]
# The plane path (chip_smoke.PLANE_ROWS): K6 around the executor, whose
# glue between K13 and K15 launches runs as torch kernels.
PLANE_ROWS = [
    ("large_1d_prime", 65537, 2048, "forward"),
    ("large_1d_prime_backward", 65537, 2048, "backward"),
    ("bluestein_1031", 1031, 1 << 17, "forward"),
    ("chain_1000", 1000, 1 << 17, "forward"),
    ("global_2062", 2062, 1 << 16, "forward"),
]
CALLS = 5
#: Profiles of a row taken until every kernel shows a whole number of
#: launches per call: the profiler has been seen to drop device events.
ATTEMPTS = 3


def kernel_name(name: str) -> str:
    m = re.search(r"(\w+_kernel)", name)
    return m.group(1) if m else name[:60]


def profiled(compute, x) -> tuple[float, dict[str, list[float]]]:
    """Wall ms per call and each kernel's device ms per launch, in launch
    order, over ``CALLS`` calls under the profiler."""
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            compute(x)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / CALLS
    per: dict[str, list[float]] = {}
    for e in prof.events():
        if e.device_type.name == "CUDA":
            us = getattr(e, "device_time", None)
            if us is None:
                us = e.cuda_time
            per.setdefault(kernel_name(e.name), []).append(us / 1e3)
    return wall, per


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    print(smi.stdout.strip())

    import portfft_tpu_torch as pf

    with profile(activities=[ProfilerActivity.CUDA]):  # the profiler's start-up
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    bi = dict(forward_distance=1, backward_distance=1)
    rows = [(name, [n], b, dn, {}) for name, n, b, dn in ROWS]
    rows += [(name, [n], b, dn, {"domain": pf.Domain.REAL})
             for name, n, b, dn in REAL_ROWS]
    rows += [(name, lengths, b, dn, dict(bi, forward_strides=[b],
                                         backward_strides=[b]) if is_bi else {})
             for name, lengths, b, dn, is_bi in MD_ROWS]
    rows += [(name, [n], b, dn, {}) for name, n, b, dn in PLANE_ROWS]
    for name, lengths, batch, direction, kw in rows:
        plan = pf.Descriptor(lengths=lengths, number_of_transforms=batch,
                             **kw).commit(device="cuda")
        n = lengths[0] if len(lengths) == 1 else lengths
        size = batch * math.prod(lengths)
        if "domain" not in kw:
            numel = 2 * size
        else:  # reals forward, raw half spectra backward
            numel = size if direction == "forward" else size + 2 * batch
        gen = torch.Generator(device="cuda").manual_seed(0)
        x = torch.rand(numel, generator=gen, device="cuda") * 2 - 1
        compute = (plan.compute_forward if direction == "forward"
                   else plan.compute_backward)
        for _ in range(3):
            compute(x)
        torch.cuda.synchronize()
        for attempt in range(1, ATTEMPTS + 1):
            wall, per = profiled(compute, x)
            if per and all(len(v) % CALLS == 0 for v in per.values()):
                break
        else:
            sys.exit(f"{name}: the profiler lost device events in {ATTEMPTS} "
                     f"attempts: {{k: len(v) for k, v in per.items()}}")
        busy = sum(sum(v) for v in per.values()) / CALLS
        print(json.dumps({
            "row": name, "n": n, "batch": batch, "direction": direction,
            "plan": plan.plan_description(),
            "attempts": attempt,
            "wall_ms_per_call": wall, "device_busy_ms_per_call": busy,
            "device_ms_per_launch": {k: v[: len(v) // CALLS] for k, v in per.items()},
        }))
        del x, plan
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
