"""Where the device time of portfft_tpu_torch's main path goes, per bench row.

    python3 chip_profile.py

For each row of ``bench.py``'s ``CONFIGS``, ``backward_medium`` and
``LADDER_CONFIGS``, of its ``REAL_CONFIGS`` and real_large backward, and of
its ``MULTIDIM_CONFIGS`` plus the BATCH_INTERLEAVED row bi_4096, and of
the plane path's rows (``large_1d_prime`` both ways, n = 1031, 1000 and
2062 at about 1 GiB; the executor's glue shows as torch's own kernels),
and of ``chip_smoke.py``'s SPLIT_COMPLEX rows (planes in and out), its
further plane rows (a multi-dim shape with an outer FUSED [5, 128] axis,
the nested GLOBAL length 12232320, the Bluestein length 50431897) and its
layout rows (``chip_smoke.LAYOUT_ROWS``: strided, BATCH_INTERLEAVED in one
or both domains, offsets with an out= tensor, SPLIT strided; K7 shows as
``destride_*``/``restride_*`` kernels), and of the tuned GLOBAL rows
(``TUNED_ROWS``: large_1d and the 2^17 row through K4, the ladder through
K5 and K5-ov; large_1d and the mixed-radix rows 147456 = 384 x 384 and
196608 = 512 x 384 through K3, K16, K17 in both twiddle modes and K18,
large_1d through K19) and of the tuned FUSED rows
(``chip_smoke.TUNED_FUSED_ROWS`` through K2 and every engine their entry
reaches: K2-v2 and K2-v3, or K2-v1 where a has no fold) and of the tuned
multi-dim rows (md_1024x1024 and bi_4096 through K10-mm, ``{"cm": 1}``),
each engine selected by a recorded tuning entry in a cache of the run's
own; every other row runs its static route), and of the REAL plane rows
(``chip_smoke.REAL_PLANE_ROWS`` in each direction they run, the
``_bf`` row with ``PORTFFT_BLUESTEIN_BF`` set at commit; large_1d and
2^20 also through K3-ftw, ``{"eng": 2, "ftw": 1}``), it
commits the plan on the card, makes 3 warm-up calls,
then profiles 5 calls with ``torch.profiler`` and prints one JSON line: the
plan, the wall ms per call on the host clock around those 5 calls, the
device-busy ms per call (the sum of the kernels' device time), and each
kernel's device ms per launch in launch order.  The first line is the card's
name and power limit as ``nvidia-smi`` gives them.  Needs one CUDA device;
a row whose profile lost device events (some kernel's launches not a
multiple of the calls) is profiled again, up to ``ATTEMPTS`` times, and the
script exits non-zero when none is whole.  Arguments, where given, are
prefixes of the row names to profile (``python3 chip_profile.py split_``).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

from chip_smoke import (
    LAYOUT_ROWS,
    REAL_PLANE_ROWS,
    TUNED_FUSED_ROWS,
    fused_engines_reached,
)

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
# chip_smoke.SPLIT_ROWS and chip_smoke.PLANE_MORE_ROWS: name, lengths,
# batch, direction, SPLIT storage.
SPLIT_ROWS = [
    ("split_large_1d", [65536], 2048, "forward", True),
    ("split_large_1d_backward", [65536], 2048, "backward", True),
    ("split_2^20", [1 << 20], 128, "forward", True),
    ("split_4096", [4096], 32768, "forward", True),
    ("split_large_1d_prime", [65537], 2048, "forward", True),
    ("split_md_1024x1024", [1024, 1024], 64, "forward", True),
    ("split_md_128^3", [128, 128, 128], 32, "forward", True),
    ("plane_md_128x640x128", [128, 640, 128], 12, "forward", False),
    ("nested_global_12232320", [12232320], 8, "forward", False),
    ("bluestein_50431897", [50431897], 1, "forward", False),
]
# The tuned GLOBAL rows: name, n, batch, the engine's tuning parameters.
TUNED_ROWS = [
    ("tuned_large_1d_k4", 65536, 2048, {"eng": 5}),
    ("tuned_2^17_k4", 1 << 17, 1024, {"eng": 5}),
    *((f"tuned_2^{e}_{tag}", 1 << e, 1 << (27 - e), params)
      for e in (17, 18, 19, 20)
      for tag, params in (("k5", {"eng": 7}), ("k5ov", {"eng": 7, "ov": 1}))),
    *((f"tuned_{row}_{tag}", n, batch, params)
      for row, n, batch in (("large_1d", 65536, 2048), ("mixed_147456", 147456, 1024),
                            ("mixed_196608", 196608, 512))
      for tag, params in (("k3", {}), ("k16", {"eng": 3}), ("k17", {"eng": 6}),
                          ("k17ftw", {"eng": 6, "ftw": 1}), ("k18", {"eng": 8}))),
    ("tuned_large_1d_k19", 65536, 2048, {"eng": 7, "bf2": 1}),
    ("tuned_large_1d_k3ftw", 65536, 2048, {"eng": 2, "ftw": 1}),
    ("tuned_2^20_k3ftw", 1 << 20, 128, {"eng": 2, "ftw": 1}),
]
# The REAL plane rows (chip_smoke.REAL_PLANE_ROWS), each direction it runs:
# name, n, batch, direction, PORTFFT_BLUESTEIN_BF set at commit.
REAL_PLANE_PROFILE_ROWS = [
    (name if d == "forward" else f"{name}_backward", n, batch, d, bf)
    for name, n, batch, dnames, bf in REAL_PLANE_ROWS for d in dnames]
# The tuned multi-dim rows through K10-mm: name, lengths, batch,
# batch-interleaved, the column kind's tuning parameters.
TUNED_MD_ROWS = [
    ("tuned_md_1024x1024_k10mm", [1024, 1024], 64, False, {"cm": 1}),
    ("tuned_bi_4096_k10mm", [4096], 32768, True, {"cm": 1}),
]


def _tuned_fused_rows() -> list[tuple]:
    """The tuned FUSED rows (``chip_smoke.TUNED_FUSED_ROWS``): each through
    K2 (``{}``) and every engine its ``fused2`` entry can reach, at the
    shipped table's tile where that table names the engine, else at the
    tile the kernel picks."""
    from portfft_tpu_torch import tuning
    from portfft_tpu_torch.config import DeviceConfig
    from portfft_tpu_torch.engines import ENGINES, engine_of
    from portfft_tpu_torch.planner import plan_1d

    shipped = tuning._read(tuning._DEFAULTS_PATH).get("cuda_h100", {}).get(
        "fused2", {})
    rows = []
    for _, n, batch in TUNED_FUSED_ROWS:
        plan0 = plan_1d(n, DeviceConfig(), 4)
        rows.append((f"tuned_fused_{n}_k2", n, batch, {}))
        for kind in fused_engines_reached(plan0, batch):
            params = shipped.get(f"n{n}", {})
            if engine_of(params, plan0).name != kind:
                params = dict(ENGINES[kind].params)
            rows.append((f"tuned_fused_{n}_{kind[-2:]}", n, batch, params))
    return rows


TUNED_ROWS += _tuned_fused_rows()
CALLS = 5
#: Profiles of a row taken until every kernel shows a whole number of
#: launches per call: the profiler has been seen to drop device events.
ATTEMPTS = 3


def kernel_name(name: str) -> str:
    m = re.search(r"(\w+_kernel|(?:de|re)stride_\w+)", name)
    return m.group(1) if m else name[:60]


def profiled(compute, inputs) -> tuple[float, dict[str, list[float]]]:
    """Wall ms per call and each kernel's device ms per launch, in launch
    order, over ``CALLS`` calls under the profiler."""
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            compute(*inputs)
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
    tune_dir = tempfile.mkdtemp(prefix="portfft_tuning_")
    os.environ["PORTFFT_NO_TUNING"] = "1"  # static routes but for TUNED_ROWS
    os.environ["PORTFFT_TUNING_CACHE"] = os.path.join(tune_dir, "tuning.json")
    try:
        profile_rows()
    finally:
        shutil.rmtree(tune_dir, ignore_errors=True)


def commit(pf, desc, params):
    """``desc`` committed on the card; with ``params``, the GLOBAL, FUSED,
    multi-dim or BATCH_INTERLEAVED variant they select recorded in the run's
    tuning cache first, or with ``{"bf": 1}`` ``PORTFFT_BLUESTEIN_BF`` set
    at commit."""
    if params is None:
        return desc.commit(device="cuda")
    if params == {"bf": 1}:
        os.environ["PORTFFT_BLUESTEIN_BF"] = "1"
        try:
            return desc.commit(device="cuda")
        finally:
            del os.environ["PORTFFT_BLUESTEIN_BF"]
    from portfft_tpu_torch import tuning

    os.environ.pop("PORTFFT_NO_TUNING")
    try:
        probe = desc.commit(device="cuda")
        entry = probe._raw_fast[pf.Direction.FORWARD]
        kind = getattr(entry, "inner", entry).tuning_kind
        tuning.record(probe.config.name, kind, tuning._entry_key(probe, kind),
                      params)
        return desc.commit(device="cuda")
    finally:
        os.environ["PORTFFT_NO_TUNING"] = "1"


def profile_rows() -> None:
    import portfft_tpu_torch as pf

    with profile(activities=[ProfilerActivity.CUDA]):  # the profiler's start-up
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    bi = dict(forward_distance=1, backward_distance=1)
    rows = [(name, [n], b, dn, {}) for name, n, b, dn in ROWS]
    split = {"complex_storage": pf.ComplexStorage.SPLIT_COMPLEX}
    rows += [(name, [n], b, dn, {"domain": pf.Domain.REAL})
             for name, n, b, dn in REAL_ROWS]
    rows += [(name, lengths, b, dn, dict(bi, forward_strides=[b],
                                         backward_strides=[b]) if is_bi else {})
             for name, lengths, b, dn, is_bi in MD_ROWS]
    rows += [(name, [n], b, dn, {}) for name, n, b, dn in PLANE_ROWS]
    rows += [(name, lengths, b, dn, split if is_split else {})
             for name, lengths, b, dn, is_split in SPLIT_ROWS]
    # layout rows: the descriptor's fields, and an out= tensor where given
    rows += [(name, [n], b, "forward", dict(fields, **(split if is_split else {})),
              give_out)
             for name, n, b, is_split, fields, give_out in LAYOUT_ROWS]
    rows = [(*r, None) if len(r) == 6 else (*r, False, None) for r in rows]
    rows += [(name, [n], b, dn, {"domain": pf.Domain.REAL}, False,
              {"bf": 1} if bf else None)
             for name, n, b, dn, bf in REAL_PLANE_PROFILE_ROWS]
    rows += [(name, [n], b, "forward", {}, False, params)
             for name, n, b, params in TUNED_ROWS]
    rows += [(name, lengths, b, "forward",
              dict(bi, forward_strides=[b], backward_strides=[b]) if is_bi else {},
              False, params)
             for name, lengths, b, is_bi, params in TUNED_MD_ROWS]
    prefixes = sys.argv[1:]
    for name, lengths, batch, direction, kw, give_out, params in rows:
        if prefixes and not any(name.startswith(p) for p in prefixes):
            continue
        desc = pf.Descriptor(lengths=lengths, number_of_transforms=batch, **kw)
        plan = commit(pf, desc, params)
        n = lengths[0] if len(lengths) == 1 else lengths
        # the input buffer: raw pairs (reals for a REAL forward transform)
        count = desc.get_input_count(pf.Direction(direction))
        numel = count if kw.get("domain") and direction == "forward" else 2 * count
        gen = torch.Generator(device="cuda").manual_seed(0)
        x = torch.rand(numel, generator=gen, device="cuda") * 2 - 1
        # SPLIT: the (re, im) planes
        inputs = ((x[0::2].contiguous(), x[1::2].contiguous())
                  if "complex_storage" in kw else (x,))
        out = None
        if give_out:
            count_out = desc.get_output_count(pf.Direction(direction))
            out = tuple(torch.full((count_out * 2 // len(inputs),), -5.0,
                                   device="cuda") for _ in inputs)
            out = out if len(out) == 2 else out[0]
        forward = (plan.compute_forward if direction == "forward"
                   else plan.compute_backward)

        def compute(*args):
            return forward(*args, out=out)

        for _ in range(3):
            compute(*inputs)
        torch.cuda.synchronize()
        for attempt in range(1, ATTEMPTS + 1):
            wall, per = profiled(compute, inputs)
            if per and all(len(v) % CALLS == 0 for v in per.values()):
                break
        else:
            sys.exit(f"{name}: the profiler lost device events in {ATTEMPTS} "
                     f"attempts: { {k: len(v) for k, v in per.items()} }")
        busy = sum(sum(v) for v in per.values()) / CALLS
        print(json.dumps({
            "row": name, "n": n, "batch": batch, "direction": direction,
            "plan": plan.plan_description(),
            "attempts": attempt,
            "wall_ms_per_call": wall, "device_busy_ms_per_call": busy,
            "device_ms_per_launch": {k: v[: len(v) // CALLS] for k, v in per.items()},
        }))
        del x, inputs, plan, out
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
