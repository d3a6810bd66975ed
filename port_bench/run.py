#!/usr/bin/env python3
"""One run of one cell of the benchmark of portfft_tpu_torch, on the card of
the machine it is started on.

    python3 port_bench/run.py --workload c2c_1d.bulk --seed 7 --seconds 10 --trace 0

Run from the root of a checkout.  ``BENCHMARK.json`` names the cell; the
harness finds everything else by name: the configuration
(``port_bench/configs/<config>.json``, its plain reference beside it as
``<config>.py``), the traffic (``port_bench/traffic/<cell>.json``) and one
reader a metric (``port_bench/metrics/<metric>.py``, a ``read(run)`` that
returns the value or None).

Set-up, from the start of this process to the first timed call: import
torch and the program, start CUDA, load or build the kernel library, make
every input on the card from the seed, commit one plan a call spec of the
cell, and call each plan twice.  The window is a closed loop with one
caller: round-robin over the call specs, ``compute_forward(x)`` with a fresh
output, ``torch.cuda.synchronize()`` after each call, until the round in
which ``--seconds`` have passed ends.  Where the traffic gives
``ahead_calls``, the caller keeps that many calls in flight and waits for the
oldest beyond them instead; once ``--seconds`` have passed it sends nothing
more, waits for every call sent, and the window ends after that wait.  With ``--trace 1`` the profiler
records rounds near the window's end (``TRACE_S``, ``TRACE_ROUNDS``) under
spans the harness puts around its own calls, and the result holds the per-layer metrics; with
``--trace 0`` it holds the end-to-end ones.

``correct``: from each call spec, the outputs of ``CHECK_CALLS`` calls drawn
from the seed over the window (its untraced rounds), some transforms each, are
compared once the window has closed with the configuration's reference
computed from the same inputs.  Each call spec's number is the widest error
over its transforms, as a share of the reference's root mean square, and
has the limit its traffic file gives.

The last line of standard output is the result as one JSON object; the
last lines of standard error give each compared number beside its limit.
The run exits with 2, printing no result, where there is no CUDA device or
the program is not in this checkout.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()  # set-up runs from here

import argparse  # noqa: E402
import collections  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from contextlib import nullcontext  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from port_bench import devtrace, work  # noqa: E402

#: Build and kernel caches of what the run starts, at fixed paths inside the
#: checkout, so that only a checkout's first run compiles.
CACHE = os.path.join(ROOT, ".port_bench_cache")
#: Calls of each call spec whose outputs are checked, a uniform sample of
#: the window drawn from the seed.
CHECK_CALLS = 16
#: Each checked call compares at least this many points and at least
#: ``CHECK_MIN_ROWS`` transforms, its first and last among them.
CHECK_POINTS = 1 << 16
CHECK_MIN_ROWS = 8
#: The traced run profiles the rounds it begins in ``TRACE_S`` seconds from
#: ``TRACE_S`` before the window's end (from its middle at the latest), once
#: the calls in flight are done, and the window runs on until that segment
#: ends; ``TRACE_ROUNDS`` rounds at most, which bounds the trace a short call
#: makes; where the profiler
#: dropped device events, it takes up to ``TRACE_ATTEMPTS`` segments in all,
#: the others after the window.
TRACE_S = 2.0
TRACE_ROUNDS = 500
TRACE_ATTEMPTS = 3
#: Operations and seconds, before the traced rounds, in which the device's
#: first operations after the profiler starts may go unrecorded (seen on an
#: H100: up to four operations, 30 ms).
PRIMER_OPS = 8
PRIMER_S = 0.1
WARMUP_CALLS = 2
_NULL = nullcontext()


class _NullEvent:
    """The event of a device that runs each call before it returns."""

    @staticmethod
    def synchronize() -> None:
        pass


_NULL_EVENT = _NullEvent()


def pin_environment(env) -> None:
    """Clear every ``PORTFFT_*`` setting, and keep the program's caches at
    fixed paths inside the checkout.  The tuning cache is a path below this
    file, which can be neither read nor written, so the shipped
    ``tuning_defaults.json`` alone picks the engines."""
    for key in [k for k in env if k.startswith("PORTFFT_")]:
        del env[key]
    env["PORTFFT_TUNING_CACHE"] = os.path.join(os.path.abspath(__file__), "tuning.json")
    env["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    env["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    env["CUDA_CACHE_PATH"] = os.path.join(CACHE, "cuda")


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _entry(entries: list, name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise SystemExit(f"BENCHMARK.json names no {what} {name!r}")


class Bench:
    """``BENCHMARK.json`` of the checkout at ``root``, and the files it
    names, found by name under ``root/port_bench``."""

    def __init__(self, root: str):
        self.root = root
        self.dir = os.path.join(root, "port_bench")
        self.spec = _load_json(os.path.join(root, "BENCHMARK.json"))

    def cell(self, name: str) -> dict:
        return _entry(self.spec["workloads"], name, "workload")

    def config(self, name: str):
        """The configuration's file and its plain reference's module."""
        entry = _entry(self.spec["configs"], name, "configuration")
        path = os.path.join(self.root, entry["file"])
        module = _load_module(os.path.splitext(path)[0] + ".py", f"port_bench_config_{name}")
        return _load_json(path), module

    def traffic(self, cell: str) -> dict:
        return _load_json(os.path.join(self.dir, "traffic", f"{cell}.json"))

    def metrics(self, cell: str, trace: bool) -> list:
        """``(entry, reader)`` of each metric the run reports: with ``trace``
        the cell's per-layer metrics, else its end-to-end ones."""
        out = []
        for entry in self.spec["per_layer" if trace else "end_to_end"]:
            if cell in entry.get("workloads", [cell]):
                path = os.path.join(self.dir, "metrics", f"{entry['name']}.py")
                name = "port_bench_metric_" + entry["name"].replace(".", "_")
                out.append((entry, _load_module(path, name)))
        return out


@dataclasses.dataclass
class Spec:
    """One call spec of a cell, and its work from the shapes alone."""

    name: str
    lengths: list
    batch: int
    direction: str
    limit: float
    bytes: int
    least_s: float

    def as_dict(self) -> dict:
        return {"lengths": self.lengths, "batch": self.batch,
                "direction": self.direction}


def _specs(traffic: dict, domain: str) -> list:
    specs = []
    for call in traffic["calls"]:
        lengths, batch = [int(n) for n in call["lengths"]], int(call["batch"])
        nbytes, _ = work.work(domain, lengths, batch)
        specs.append(Spec(
            name=call.get("name", "n" + "x".join(map(str, lengths))),
            lengths=lengths, batch=batch, direction=call["direction"],
            limit=float(call["limit"]), bytes=nbytes,
            least_s=work.least_time(domain, lengths, batch)[0]))
    if len({s.name for s in specs}) != len(specs):
        raise SystemExit("two call specs of the traffic share a name")
    return specs


class CellRun:
    """The program under test set up for one cell on one device: its
    inputs, its plans, the window and the check.

    ``wrap(fn, spec, reference)``, where given, replaces each plan's
    compute function by what it returns: the control, or a planted fault."""

    def __init__(self, bench: Bench, pf, workload: str, device: str, wrap=None):
        import torch

        self.torch, self.pf, self.wrap = torch, pf, wrap
        self.cell = bench.cell(workload)
        self.config, self.ref = bench.config(self.cell["config"])
        self.traffic = bench.traffic(workload)
        self.domain = self.config["descriptor"]["domain"]
        self.specs = _specs(self.traffic, self.domain)
        for spec in self.specs:
            if spec.direction not in self.ref.DIRECTIONS:
                raise SystemExit(f"{workload}: the reference of {self.cell['config']} "
                                 f"has no {spec.direction} direction")
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.sync = torch.cuda.synchronize if self.cuda else (lambda: None)
        self.pools: list = []
        self.fns: list = []
        self.commit_s: list = []

    def make_inputs(self, seed: int) -> None:
        """Each call spec's pool of inputs, from the seed: one input, or as
        many as fill the traffic's ``pool_bytes``."""
        gen = self.torch.Generator(device=self.device).manual_seed(seed)
        self.pools = []
        for spec in self.specs:
            each = work.input_bytes(self.domain, spec.lengths, spec.batch)
            count = max(1, int(self.traffic.get("pool_bytes", 0)) // each)
            self.pools.append(self.ref.make_pool(gen, spec.as_dict(), count, self.device))
        self.sync()

    def _descriptor(self, spec: Spec):
        enums = {"domain": self.pf.Domain, "complex_storage": self.pf.ComplexStorage,
                 "placement": self.pf.Placement}
        kw = {key: enums[key][value] if key in enums else value
              for key, value in self.config["descriptor"].items()}
        return self.pf.Descriptor(lengths=spec.lengths,
                                  number_of_transforms=spec.batch, **kw)

    def commit(self) -> None:
        """One plan a call spec, each commit timed on the host clock."""
        from torch.profiler import record_function

        self.fns, self.commit_s = [], []
        for spec in self.specs:
            desc = self._descriptor(spec)
            t = time.perf_counter()
            with record_function("commit"):
                plan = desc.commit(device=self.device.type)
            self.commit_s.append(time.perf_counter() - t)
            fn = plan.compute_forward if spec.direction == "forward" else plan.compute_backward
            self.fns.append(self.wrap(fn, spec.as_dict(), self.ref) if self.wrap else fn)

    def warmup(self) -> None:
        """Each plan called ``WARMUP_CALLS`` times on its own shapes, and
        the check's copy of its output."""
        for spec, fn, pool in zip(self.specs, self.fns, self.pools):
            rows = self.torch.tensor([0, spec.batch - 1], device=self.device)
            for _ in range(WARMUP_CALLS):
                y = fn(pool[0])
                self.ref.out_rows(y, spec.as_dict(), rows)
                del y
                self.sync()

    def _rows(self, rng: random.Random, spec: Spec):
        """The transforms of one checked call, copied to the device without
        waiting for the calls in flight."""
        n = work.points(spec.lengths)
        count = min(spec.batch, max(CHECK_MIN_ROWS, -(-CHECK_POINTS // n)))
        rows = {0, spec.batch - 1}
        rows.update(rng.sample(range(spec.batch), count - len(rows)) if count > 2 else ())
        rows = self.torch.tensor(sorted(rows))
        if self.cuda:
            rows = rows.pin_memory()
        return rows.to(self.device, non_blocking=True)

    def _event(self):
        """A mark of the device's work so far, which a wait can target."""
        if not self.cuda:
            return _NULL_EVENT
        event = self.torch.cuda.Event()
        event.record()
        return event

    def window(self, seconds: float, seed: int, trace_from=None) -> dict:
        """The measured window: the calls' host times ``(spec, start,
        enqueued, end, profiled)``, its length, the sample kept for the
        check, failed calls and, where ``trace_from`` gives the seconds into
        the window at which tracing begins, the profiler of its traced rounds
        and their count."""
        from torch.profiler import ProfilerActivity, profile, record_function

        sync, fns, pools, specs = self.sync, self.fns, self.pools, self.specs
        ahead = int(self.traffic.get("ahead_calls", 0))
        pending: collections.deque = collections.deque()  # calls in flight
        rng = random.Random(seed)
        orders = [rng.sample(range(len(p)), len(p)) for p in pools]
        names = ["compute_" + s.direction for s in specs]
        seen = [0] * len(specs)
        kept: list = [[None] * CHECK_CALLS for _ in specs]
        calls: list = []
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        prof, tracing, traced_rounds, failed, traced_at = None, False, 0, 0, 0.0
        untraced = span = lambda name: _NULL  # noqa: E731

        def settle(most: int) -> None:
            """Wait for the oldest calls in flight until at most ``most``
            remain; ``end`` is the time after the wait."""
            nonlocal end
            if len(pending) > most:
                with span("synchronize"):
                    if most:
                        while len(pending) > most:
                            pending[0][3].synchronize()
                            c = pending.popleft()
                            calls.append(c[:3] + (time.perf_counter(), c[4]))
                    else:
                        sync()
                        t = time.perf_counter()
                        calls.extend(c[:3] + (t, c[4]) for c in pending)
                        pending.clear()
            end = time.perf_counter()

        def stop_tracing():
            sync()
            window_span.__exit__(None, None, None)
            prof.stop()

        gc.collect()  # the collector stays on in the window, as in a user's loop
        start = end = time.perf_counter()
        try:
            while True:
                if trace_from is not None and prof is None and end - start >= trace_from:
                    settle(0)  # the traced rounds start on an idle device
                    prof = profile(activities=activities)
                    prof.start()
                    # the profiler misses the device's first operations after
                    # it starts: let it miss some of the harness's own
                    for _ in range(PRIMER_OPS):
                        self.torch.ones(1, device=self.device).add_(1)
                        sync()
                    time.sleep(PRIMER_S)
                    window_span = record_function("traced_window")
                    window_span.__enter__()
                    tracing, span = True, record_function
                    traced_at = time.perf_counter()
                for k, fn in enumerate(fns):
                    with span("rotate"):
                        j = orders[k][seen[k] % len(orders[k])]
                        x = pools[k][j]
                    t0 = time.perf_counter()
                    with span(names[k]):
                        y = fn(x)
                    t1 = time.perf_counter()
                    if ahead:
                        pending.append((k, t0, t1, self._event(), tracing))
                        settle(ahead)
                    else:
                        with span("synchronize"):
                            sync()
                        end = time.perf_counter()
                        calls.append((k, t0, t1, end, tracing))
                    i = seen[k]
                    seen[k] += 1
                    slot = i if i < CHECK_CALLS else rng.randrange(i + 1)
                    # the traced rounds keep nothing: the copy would show in the trace
                    if slot < CHECK_CALLS and not tracing:
                        rows = self._rows(rng, specs[k])
                        kept[k][slot] = (j, rows, self.ref.out_rows(y, specs[k].as_dict(), rows))
                        if not ahead:
                            sync()
                            end = time.perf_counter()
                    del y
                if tracing:
                    traced_rounds += 1
                    if traced_rounds == TRACE_ROUNDS:
                        stop_tracing()
                        tracing, span = False, untraced
                # a traced segment lasts TRACE_S, though waiting for the calls
                # in flight before it began took it past the window's end
                if end - start >= seconds and not (tracing and end - traced_at < TRACE_S):
                    break
            settle(0)  # every call sent is waited for, and counts
        except Exception:  # the program failed: the run reports it as not correct
            traceback.print_exc()
            failed += 1
        finally:
            if tracing:
                stop_tracing()
        return {"calls": calls, "window_s": end - start, "failed": failed,
                "kept": [[c for c in ks if c is not None] for ks in kept],
                "prof": prof, "rounds": traced_rounds}

    def release(self) -> None:
        """Free the program's plans and their memory."""
        self.fns = []
        gc.collect()
        if self.cuda:
            self.torch.cuda.empty_cache()

    def check(self, kept: list) -> dict:
        """Each call spec's widest error over its kept transforms, as a share
        of the reference's root mean square: ``{name: (value, limit)}``; a
        spec with nothing kept reads None, and fails."""
        out = {}
        for spec, pool, sample in zip(self.specs, self.pools, kept):
            worst = None
            for j, rows, got in sample:
                want = self.ref.reference(self.ref.in_rows(pool[j], spec.as_dict(), rows),
                                          spec.as_dict())
                err = (got.to(want.dtype) - want).abs().max()
                rms = want.abs().square().mean().sqrt()
                worst = max(worst or 0.0, float(err / rms))
            out[spec.name] = (worst, spec.limit)
        return out


@dataclasses.dataclass
class Record:
    """What a run measured, as the metric readers get it: the call specs
    (:class:`Spec`), set-up seconds, each commit's seconds, the window's
    calls ``(spec index, start, enqueued, end, profiled)`` on the host clock
    in seconds, the window's length, the peak of device memory in bytes, and
    the traced segment (:class:`devtrace.Trace`, or None)."""

    specs: list
    setup_s: float
    commit_s: list
    calls: list
    window_s: float
    peak_bytes: int
    trace: object


def _power_limit() -> str:
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "not read"


def run_cell(bench: Bench, pf, workload: str, seed: int, seconds: float,
             trace: bool, device: str, phases: dict, t0: float,
             wrap=None) -> dict:
    """Set up, measure and check one run of the cell; return its result
    line.  ``phases`` holds the set-up phases already timed, and gets the
    rest; ``t0`` is when set-up began."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run = CellRun(bench, pf, workload, device, wrap)
    t = time.perf_counter()
    run.make_inputs(seed)
    phases["inputs"] = time.perf_counter() - t
    t = time.perf_counter()
    run.commit()
    phases["commits"] = time.perf_counter() - t
    t = time.perf_counter()
    run.warmup()
    if trace:  # the profiler's own start-up, outside the window
        with profile(activities=[ProfilerActivity.CPU]
                     + ([ProfilerActivity.CUDA] if run.cuda else [])):
            torch.ones(1, device=run.device).add_(1)
            run.sync()
    phases["warmup"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t0
    print("set-up phases (s): " + json.dumps(phases), flush=True)

    # at least half the window untraced, where the check's sample is kept
    win = run.window(seconds, seed, max(seconds - TRACE_S, seconds / 2) if trace else None)
    peak = torch.cuda.max_memory_allocated(run.device) if run.cuda else 0
    trc, attempts = None, 0
    if trace and not win["failed"]:
        prof, rounds = win["prof"], win["rounds"]
        for attempts in range(1, TRACE_ATTEMPTS + 1):
            trc = devtrace.collect(prof, rounds)
            if not (run.cuda and trc.lost_events()):
                break
            if attempts == TRACE_ATTEMPTS:
                raise SystemExit(f"the profiler lost device events in {attempts} traced segments")
            again = run.window(TRACE_S, seed, 0.0)
            prof, rounds = again["prof"], again["rounds"]
    win.pop("prof")
    run.release()
    checks = run.check(win["kept"])
    failed = win["failed"] + sum(v is None or v > lim for v, lim in checks.values())
    correct = failed == 0

    record = Record(specs=run.specs, setup_s=setup_s, commit_s=run.commit_s,
                    calls=win["calls"], window_s=win["window_s"], peak_bytes=peak, trace=trc)
    metrics = {}
    if not win["failed"]:
        for entry, reader in bench.metrics(workload, trace):
            value = reader.read(record)
            if value is not None:
                metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    dev = {"platform": "gpu" if run.cuda else "cpu",
           "kind": torch.cuda.get_device_name(run.device) if run.cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    if run.cuda:
        dev["power_limit"] = _power_limit()
    result = {"correct": correct, "attempted": len(win["calls"]), "failed": failed,
              "metrics": metrics, "device": dev}
    if trc is not None:
        dev["busy_s"], dev["window_s"] = trc.busy_s(), trc.window_s
        dev["traced_segments"] = attempts
        result["breakdown"] = trc.breakdown()
    result["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim) in checks.items()}
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    pin_environment(os.environ)
    phases: dict = {}
    import torch

    phases["import_torch"] = time.perf_counter() - _T0
    bench = Bench(ROOT)
    chips = bench.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    t = time.perf_counter()
    torch.cuda.init()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    phases["cuda_init"] = time.perf_counter() - t
    t = time.perf_counter()
    import portfft_tpu_torch as pf

    if not os.path.abspath(pf.__file__).startswith(os.path.join(ROOT, "")):
        print(f"the program under test is not in this checkout: {pf.__file__}",
              file=sys.stderr)
        return 2
    phases["import_program"] = time.perf_counter() - t
    t = time.perf_counter()
    from portfft_tpu_torch.ops import _build

    _build.load()
    phases["library"] = time.perf_counter() - t

    result = run_cell(bench, pf, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", phases, _T0)
    for name, check in result["checks"].items():
        ok = "ok" if check["value"] is not None and check["value"] <= check["limit"] else "FAILS"
        print(f"check {name}: {check['value']!r} (limit {check['limit']!r}) {ok}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
