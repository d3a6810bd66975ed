"""On the card: the program's spans against the profiler's clock, and what
the spans cost a call.

    python3 chip_clock.py clock [--workload r2c_1d.bulk] [--seed N]
    python3 chip_clock.py cost [--workload r2c_1d.bulk] [--root ROOT]

``clock`` makes one traced run of a benchmark cell (``port_bench/run.py``'s
``run_cell``, ``SECONDS`` long) and checks its traced segment on the
trace's clock (``utils/tracing.py``: spans on ``time.time_ns()``, the
profile's ``trace_start_ns()`` its origin): each ``portfft.call`` inside its
harness ``compute_*`` span, and each of the port's device operations paired,
through the CUDA runtime call that launched it (their correlation id), with
the ``portfft.launch`` span holding that call.  One JSON line: the calls'
margins; for the operations that found the card idle and for those queued
behind others, the µs from the runtime call's start and from the launch
span's end to the operation's start, and the µs the card stood idle before
it; how many operations started before their launch span ended, and
before their runtime call began, which on one clock cannot happen (the
device's stamps then run early); and what
``port_bench/idle_by_span.disagreements`` finds with no correlation ids.

``cost`` commits the cell's call specs from the package under ``ROOT``
(default: this checkout) and times each call on the host, ``fn(x)`` alone
with a sync after it, ``CALLS`` pairs of calls a spec, one with the
tracer off and the next with it on but no profiler (the ``PROFILER`` of
every module that branches on it replaced by a stand-in whose
``_is_profiler_enabled`` is True).  One JSON line: the median µs a call of
each spec both ways, the median of the pairs' differences, the spans a
call, and, where the tracer has ``portfft.launch``, the ns a launch costs
with the tracer off (its branch) and on (its span).
"""

from __future__ import annotations

import argparse
import bisect
import importlib
import json
import os
import statistics
import subprocess
import sys
import time
import types

SEED = 2147483647 + 24
#: How long a traced run measures, and how many pairs of calls ``cost``
#: times a spec.
SECONDS, CALLS = 10.0, 400


def _card() -> str:
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
    except OSError:
        return "not read"
    return smi.stdout.strip()


def _quantiles(values: list) -> dict:
    if len(values) < 2:
        return {"n": len(values)}
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return {"min": min(values), "q1": q1, "median": q2, "q3": q3, "max": max(values),
            "n": len(values)}


def clock(workload: str, seed: int) -> dict:
    import portfft_tpu_torch as pf
    from port_bench import devtrace, idle_by_span, run
    from portfft_tpu_torch.ops import _build
    from portfft_tpu_torch.utils import tracing

    run.pin_environment(os.environ)
    _build.load()
    kept = {}
    collect = devtrace.collect

    def keep(prof, rounds):
        kept["prof"], kept["trace"] = prof, collect(prof, rounds)
        return kept["trace"]

    devtrace.collect = keep
    result = run.run_cell(run.Bench(os.path.abspath(".")), pf, workload, seed, SECONDS,
                          True, "cuda", {}, time.perf_counter())
    trc, events = kept["trace"], kept["prof"].profiler.kineto_results.events()
    origin = idle_by_span.profile_origin_ns(kept["prof"])
    computes = sorted((s for s in trc.spans if s[0].startswith("compute_")),
                      key=lambda s: s[1])
    calls = tracing.calls(len(computes))

    def on_trace(ns: int) -> float:
        return (ns - origin) / 1e9

    call_margin = [min(on_trace(c.root.start_ns) - lo, hi - on_trace(c.root.end_ns))
                   for c, (_, lo, hi) in zip(calls, computes)]

    first = calls[0].root.start_ns
    launches = sorted((s for c in calls for s in c.spans if s.name == tracing.LAUNCH),
                      key=lambda s: s.start_ns)
    starts = [s.start_ns for s in launches]
    runtime = {e.correlation_id(): e for e in events
               if e.device_type().name == "CPU" and e.name().startswith("cuda")
               and e.start_ns() >= first}
    device = sorted((e for e in events if e.device_type().name == "CUDA"
                     and e.start_ns() >= first), key=lambda e: e.start_ns())
    # per operation: µs from its runtime call's start, from its launch's end,
    # and the µs the card stood idle before it
    seen = {"idle": [], "queued": []}
    outside, unpaired, busy_until = 0, 0, device[0].start_ns() if device else 0
    for op in device:
        rt = runtime.get(op.correlation_id()) or runtime.get(op.linked_correlation_id())
        ours = bool(tracing.kernels_of(op.name()))
        queued = busy_until > (rt.start_ns() if rt is not None else op.start_ns())
        idle_us = max(0, op.start_ns() - busy_until) / 1e3
        busy_until = max(busy_until, op.end_ns())
        if not ours:
            continue
        if rt is None:
            unpaired += 1
            continue
        i = bisect.bisect_right(starts, rt.start_ns()) - 1
        if i < 0 or not rt.end_ns() <= launches[i].end_ns:
            outside += 1
            continue
        seen["queued" if queued else "idle"].append(
            ((op.start_ns() - rt.start_ns()) / 1e3,
             (op.start_ns() - launches[i].end_ns) / 1e3, idle_us))
    early = min((v[0] for got in seen.values() for v in got), default=0.0)
    found = idle_by_span.disagreements(
        trc, [(on_trace(s.start_ns), on_trace(s.end_ns)) for s in launches],
        on_trace(first), on_trace(calls[-1].root.end_ns))
    spans = [(on_trace(s.start_ns), on_trace(s.end_ns), s.note) for s in launches]
    busy_ends = [hi for _, hi in trc.busy()]
    flagged = []  # each: its name, the idle before it, the launches about it (µs from it)
    for kind, ops in zip(("early", "late"), found):
        for name, a, b in ops[:5]:
            j = bisect.bisect_left(busy_ends, a) - 1
            k = bisect.bisect_right([lo for lo, _, _ in spans], a)
            flagged.append({
                "kind": kind, "op": name[:60], "idle_before_us": (a - busy_ends[j]) * 1e6
                if j >= 0 else None,
                "launches": [((lo - a) * 1e6, (hi - a) * 1e6, note)
                             for lo, hi, note in spans[max(k - 2, 0):k + 1]]})
    return {"mode": "clock", "workload": workload, "seed": seed, "card": _card(),
            "correct": result["correct"], "calls": len(calls), "computes": len(computes),
            "call_in_compute_margin_us": _quantiles([m * 1e6 for m in call_margin]),
            "calls_outside_compute": sum(m < 0 for m in call_margin),
            "port_ops": sum(map(len, seen.values())), "launch_spans": len(launches),
            "ops_unpaired": unpaired, "runtime_call_outside_launch": outside,
            **{f"{k}_{what}_us": _quantiles([v[j] for v in got])
               for k, got in seen.items()
               for j, what in enumerate(("runtime_start_to_op", "launch_end_to_op",
                                         "gap_before_op"))},
            "ops_starting_before_launch_end": sum(
                v[1] < 0 for got in seen.values() for v in got),
            "ops_starting_before_their_runtime_call": sum(
                v[0] < 0 for got in seen.values() for v in got),
            "device_early_us": -early if early < 0 else 0.0,
            "disagreements_early_late": [len(ops) for ops in found], "flagged": flagged,
            "metrics": {k: v["value"] for k, v in result["metrics"].items()}}


def cost(root: str, workload: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import portfft_tpu_torch as pf
    from port_bench import run
    from portfft_tpu_torch.utils import tracing

    if not os.path.abspath(pf.__file__).startswith(os.path.abspath(root)):
        raise SystemExit(f"the package under test is not under {root}: {pf.__file__}")
    run.pin_environment(os.environ)
    cell = run.CellRun(run.Bench(os.path.abspath(root)), pf, workload, "cuda")
    cell.make_inputs(SEED)
    cell.commit()
    cell.warmup()
    names = ["portfft_tpu_torch." + m for m in
             ("utils.tracing", "committed", "fastpath", "ops.torch_exec", "ops._build")]
    modules = [m for m in map(importlib.import_module, names) if hasattr(m, "PROFILER")]
    off = {m: m.PROFILER for m in modules}
    on = types.SimpleNamespace(_is_profiler_enabled=True)
    pairs = [[] for _ in cell.fns]  # (µs off, µs on), the two calls in turn
    before = len(tracing.spans())
    for k, (fn, pool) in enumerate(zip(cell.fns, cell.pools)):
        for _ in range(CALLS):
            pair = []
            for way in (off, None):
                for m in modules:
                    m.PROFILER = on if way is None else way[m]
                t0 = time.perf_counter()
                y = fn(pool[0])
                t1 = time.perf_counter()
                cell.sync()
                del y
                pair.append((t1 - t0) * 1e6)
            pairs[k].append(pair)
    for m in modules:
        m.PROFILER = off[m]
    specs = {}
    for spec, got in zip(cell.specs, pairs):
        specs[spec.name] = {"off_us": statistics.median(a for a, _ in got),
                            "on_us": statistics.median(b for _, b in got),
                            "cost_us": statistics.median(b - a for a, b in got)}
    out = {"mode": "cost", "root": root, "workload": workload, "card": _card(),
           "modules": [m.__name__ for m in modules], "specs": specs,
           "spans_a_call": (len(tracing.spans()) - before) / (CALLS * len(cell.fns)),
           "cost_us_a_call": statistics.mean(s["cost_us"] for s in specs.values())}
    if hasattr(tracing, "LAUNCH"):
        out.update(_launch_ns())
    return out


def _launch_ns(n: int = 200_000) -> dict:
    """ns a call of a declared library entry point (``_build.declare``; a
    stand-in that does nothing) costs over the entry itself, with the
    tracer off (the branch) and on (the ``portfft.launch`` span)."""
    from portfft_tpu_torch.ops import _build

    def entry(*args):
        return 0

    lib = _build.declare(types.SimpleNamespace(**{k: entry for k in _build._SIGNATURES}))
    args = tuple(range(8))
    out = {}
    for name, fn, enabled in (("entry", entry, False), ("declared_off", lib.pf_direct, False),
                              ("declared_on", lib.pf_direct, True)):
        saved = _build.PROFILER
        _build.PROFILER = types.SimpleNamespace(_is_profiler_enabled=enabled)
        times = []
        for _ in range(3):  # the least of three: the first fills the ring
            t0 = time.perf_counter_ns()
            for _ in range(n):
                fn(*args)
            times.append((time.perf_counter_ns() - t0) / n)
        out[name] = min(times)
        _build.PROFILER = saved
    return {"branch_ns": out["declared_off"] - out["entry"],
            "launch_span_ns": out["declared_on"] - out["entry"]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("mode", choices=("clock", "cost"))
    parser.add_argument("--workload", default="r2c_1d.bulk")
    parser.add_argument("--seed", type=int, default=SEED)
    parser.add_argument("--root", default=".")
    args = parser.parse_args(argv)
    if args.mode == "clock":
        out = clock(args.workload, args.seed)
    else:
        out = cost(args.root, args.workload)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
