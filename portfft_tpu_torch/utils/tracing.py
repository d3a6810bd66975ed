"""Spans and counters of the call path: a call's host time by layer, the
kernels launched, and the tuning table's outcomes at commit.

Spans record only while a ``torch.profiler`` (or the older
``torch.autograd.profiler.profile``) is recording: a span site reads
``PROFILER._is_profiler_enabled`` and branches, and does nothing else while
no profiler runs.  The spans stay on the host: nothing here puts an
annotation on the profiler's timeline (no ``record_function``, no NVTX), so
a trace's device operations are the program's kernels alone.  Three layers
record them, a wrapper's launch splits the wrapper's, and the per-axis walk
splits the executor's:

- ``portfft.call``: a compute call of a committed plan, the root of its
  spans (``CommittedDescriptor._compute``: validation, buffer conversion,
  the entry's function, the result's conversion); its ``note`` is the
  direction;
- ``portfft.exec``: the plane executor's top-level walk
  (``torch_exec.exec_plan`` or ``core_inner`` from ``fastpath.plane_fn``
  or ``core_fn``);
- ``portfft.<K>`` (``portfft.K1``, ``portfft.K2-v2``, ...): a kernel
  wrapper of ``ops/cuda_*.py`` (:func:`kernel`), from argument checks
  through the launch and its error check;
- ``portfft.launch``, inside ``portfft.<K>``: the call of one library
  entry point that launches kernels (``ops/_build.load`` declares it), a
  :func:`leaf` span; its ``note`` is the entry point's name
  (``pf_direct``).  It splits a
  wrapper's host time into its Python and the launch, any wait to
  enqueue on the card included, and is no kernel: :meth:`Call.kernel_ns`
  counts the wrapper that holds it;
- ``portfft.axis``, inside ``portfft.exec``: one axis of ``core_inner``'s
  walk; its ``note`` is the axis and its route (``1 exec``: the last axis
  through the executor, ``0 K12``: the column kernel, ``0 K13col``: K13's
  column form, ``0 movedim``: the executor after a move).  Inside
  ``portfft.call``: one step of a ``fastpath.MultiDim`` route (the step
  loop of ``fastpath.packed_fn``); its ``note`` is the axes the step
  transforms and its kernels in the order they run (``1 K9``, ``0 K10``,
  ``1 K1+K8a``, ``0,1 K11``; at fp64 ``2 K9 f64``: ``fastpath.step_notes``).
  It is no layer of its own: a span's self time is seen through it
  (:meth:`Call.children`).

Each span is ``(name, start_ns, end_ns, parent, call_id, id, note)`` on
:data:`CLOCK`, ``time.time_ns()``: the Unix time onto which a profiler maps
its own clock, so a span's time in a trace is ``(ns - origin) / 1e9``
seconds, the origin being the profile's ``trace_start_ns()``.  That clock
is assumed not to be stepped while a profiler records: a step would put
every later span off the trace's clock and give the span it falls in a
wrong length.  The readers take each self time as a median over a
segment's calls, which one such span does not move, and
``port_bench/idle_by_span.py`` gives no split where the launches and the
device's operations disagree.  ``parent`` is the id of the span it nests
in (-1 for a root), and every span under one root shares the root's
``call_id``.  The last ``RING`` spans are kept (:func:`spans`).

Counters are always on: launches by kernel (:func:`launches`), counted
where a wrapper's call reached the card; launches by code path
(:func:`paths`: K13's ``radix``, ``plain`` or ``radix_col``, its column
form; K9's ``radix``, or ``radix_f64`` in double; K10's ``radix`` or
``radix_f64`` up to 8192 points, ``f32`` or ``f64`` on its two launches
past it), counted by the wrappers that
choose one; the tuning table's outcomes where commit chooses a route
(:func:`tuning_outcomes`); and the bytes the plane executor's copies write
outside the port's kernels (:func:`glue_bytes`).  Under a recording profiler each such copy is also a
``portfft.glue`` mark in its call, a span of no length whose note is its
bytes (:meth:`Call.glue_bytes`).  One host thread is assumed to drive a
plan at a time, as for the counters they replace.
"""

from __future__ import annotations

import functools
import itertools
import re
import threading
import time
from typing import NamedTuple

from torch.autograd import profiler as PROFILER

#: Prefix of every span name.
PREFIX = "portfft."
#: How many spans are kept, the newest.
RING = 1 << 17
#: The clock of every span's stamps, in ns.
CLOCK = time.time_ns
#: The span of a library entry point's call inside a kernel wrapper.
LAUNCH = PREFIX + "launch"


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int
    call_id: int
    id: int
    note: str = ""


class Kernel(NamedTuple):
    """A registered kernel wrapper: its K-number and the CUDA
    ``__global__`` functions it launches (``csrc/``)."""

    name: str
    symbols: tuple


#: K-number -> :class:`Kernel`, one entry a wrapper.
KERNELS: dict = {}
_launches: dict = {}
#: K-number -> {path: launches}, for the wrappers that count their paths.
_paths: dict = {}
#: The tuning table's outcomes at commit: ``hit`` (a tuned entry routes the
#: plan), ``miss`` (no tuned entry), ``declined`` (a tuned engine whose gate
#: refused the plan; the entry is marked stale and the static route runs).
_tuning = {"hit": 0, "miss": 0, "declined": 0}
#: Bytes written by the plane executor's copies outside the kernels.
_glue = {"bytes": 0}
#: Spans that split their parent's time and are no layer of their own.
WITHIN = (PREFIX + "axis", PREFIX + "glue")

_ring: list = [None] * RING
_ids = itertools.count()
_call_ids = itertools.count(1)
_local = threading.local()


# -- spans ------------------------------------------------------------------


def _open(name: str, note: str = "") -> tuple:
    """Begin a span under the innermost open one; returns its token."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    if stack:
        parent, call_id = stack[-1][0], stack[-1][2]
    else:
        parent, call_id = -1, next(_call_ids)
    token = (next(_ids), name, call_id, parent, note, CLOCK())
    stack.append(token)
    return token


def _close(token: tuple) -> None:
    end = CLOCK()
    _local.stack.pop()
    sid, name, call_id, parent, note, start = token
    _ring[sid % RING] = (name, start, end, parent, call_id, sid, note)


def run(name: str, fn, *args, note: str = "", **kwargs):
    """``fn(*args, **kwargs)`` inside the span ``name``.  Sites call it
    only while ``PROFILER._is_profiler_enabled``."""
    token = _open(name, note)
    try:
        return fn(*args, **kwargs)
    finally:
        _close(token)


def leaf(name: str, fn, args: tuple, note: str = ""):
    """``fn(*args)`` as the span ``name`` under the innermost open one, for
    a site where no span nests (a library entry point's call): its two
    stamps go straight to the ring, with no token on the stack and no
    ``try``, so the span costs its wrapper little (a call that raises
    records none).  Sites call it only while
    ``PROFILER._is_profiler_enabled``."""
    stack = getattr(_local, "stack", None)
    if stack:
        parent, call_id = stack[-1][0], stack[-1][2]
    else:
        parent, call_id = -1, next(_call_ids)
    sid = next(_ids)
    start = CLOCK()
    out = fn(*args)
    _ring[sid % RING] = (name, start, CLOCK(), parent, call_id, sid, note)
    return out


def spans() -> list:
    """The kept spans, oldest first."""
    return sorted((Span._make(s) for s in _ring if s is not None), key=lambda s: s.id)


class Call(NamedTuple):
    """One ``portfft.call`` root and every span of its call."""

    root: Span
    spans: list

    def children(self, span: Span) -> list:
        """The spans nested in ``span``, seen through the ``WITHIN`` spans
        between them (a ``portfft.axis`` span's kernels are children of the
        ``portfft.exec`` span that holds it)."""
        by_id = {s.id: s for s in self.spans}
        out = []
        for s in self.spans:
            if s.name in WITHIN:
                continue
            up = by_id.get(s.parent)
            while up is not None and up.id != span.id and up.name in WITHIN:
                up = by_id.get(up.parent)
            if up is not None and up.id == span.id:
                out.append(s)
        return out

    def self_ns(self, span: Span) -> int:
        """``span``'s duration less the part its children cover."""
        covered, reach = 0, span.start_ns
        for c in sorted(self.children(span), key=lambda s: s.start_ns):
            lo, hi = max(c.start_ns, reach), min(c.end_ns, span.end_ns)
            if hi > lo:
                covered += hi - lo
                reach = hi
        return span.end_ns - span.start_ns - covered

    def kernel_ns(self) -> int:
        """The summed durations of the call's kernel spans (those not
        inside another kernel span)."""
        kernel = {s.id for s in self.spans if s.name[len(PREFIX):] in KERNELS}
        return sum(s.end_ns - s.start_ns for s in self.spans
                   if s.id in kernel and s.parent not in kernel)

    def named(self, name: str) -> list:
        return [s for s in self.spans if s.name == name]

    def glue_bytes(self) -> int:
        """The bytes the call's ``portfft.glue`` marks count."""
        return sum(int(s.note) for s in self.named(PREFIX + "glue"))


def calls(last: int) -> list:
    """The last ``last`` calls kept (fewer where fewer are), oldest first:
    each ``portfft.call`` root with every span that shares its call id."""
    kept = spans()
    roots = [s for s in kept if s.name == PREFIX + "call" and s.parent == -1]
    roots = roots[len(roots) - last:] if last > 0 else []
    by_call: dict = {r.call_id: [] for r in roots}
    for s in kept:
        if s.call_id in by_call:
            by_call[s.call_id].append(s)
    return [Call(r, by_call[r.call_id]) for r in roots]


# -- counters ---------------------------------------------------------------


def kernel(name: str, symbols: tuple):
    """Register a kernel wrapper under its K-number ``name``, launching the
    CUDA functions ``symbols``: the wrapper counts a launch each time a
    call on a CUDA tensor returns (its first argument, or the first plane
    of a (re, im) pair; a CPU call runs the plain version and launches
    nothing), records the span ``portfft.<name>`` while a profiler
    records, and carries its K-number as ``.kernel``."""
    if name in KERNELS:
        raise ValueError(f"kernel {name} is registered twice")
    KERNELS[name] = Kernel(name, tuple(symbols))
    _launches[name] = 0
    span = PREFIX + name

    def wrap(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if PROFILER._is_profiler_enabled:
                y = run(span, fn, *args, **kwargs)
            else:
                y = fn(*args, **kwargs)
            x = args[0]
            if (x[0] if type(x) is tuple else x).is_cuda:
                _launches[name] += 1
            return y

        wrapper.kernel = name
        return wrapper

    return wrap


def launches(name: str | None = None):
    """The launches of the kernel ``name`` (a K-number) so far, or with no
    name ``{K-number: launches}`` of every kernel."""
    return dict(_launches) if name is None else _launches[name]


def reset_launches() -> None:
    for name in _launches:
        _launches[name] = 0
    _paths.clear()


def path(name: str, which: str) -> None:
    """Count one launch of the kernel ``name`` (a K-number) on its code
    path ``which``; the wrapper calls it where its launch reached the
    card."""
    counts = _paths.setdefault(name, {})
    counts[which] = counts.get(which, 0) + 1


def paths(name: str | None = None) -> dict:
    """The launches of the kernel ``name`` so far by path, ``{path:
    launches}`` (empty before its first), or with no name ``{K-number:
    {path: launches}}`` of every kernel that counts its paths."""
    if name is None:
        return {k: dict(v) for k, v in _paths.items()}
    return dict(_paths.get(name, {}))


def kernels_of(op_name: str) -> tuple:
    """The K-numbers whose CUDA functions a device operation's name (as a
    profiler shows it, or with its punctuation made ``_``) names, in
    registry order; a function several wrappers launch gives them all."""
    return tuple(k.name for k in KERNELS.values()
                 if any(re.search(rf"(?<![A-Za-z0-9_]){s}(?![A-Za-z0-9])", op_name)
                        for s in k.symbols))


def glue(nbytes: int) -> None:
    """Count ``nbytes`` written by a copy or multiply of the plane executor
    outside the port's kernels; under a recording profiler also a
    ``portfft.glue`` mark in the call that made it."""
    _glue["bytes"] += nbytes
    if PROFILER._is_profiler_enabled:
        _close(_open(PREFIX + "glue", str(nbytes)))


def glue_bytes() -> int:
    return _glue["bytes"]


def reset_glue() -> None:
    _glue["bytes"] = 0


def tuned(outcome: str) -> None:
    """Count one outcome of the tuning table where commit chooses a
    route."""
    _tuning[outcome] += 1


def tuning_outcomes() -> dict:
    return dict(_tuning)
