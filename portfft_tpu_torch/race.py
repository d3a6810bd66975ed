"""``autotune`` (``CommittedDescriptor.autotune``): race the variants of a
committed route, record the winner in the tuning cache (``tuning``) and
re-register (``fastpath``).  Counterpart of ``portfft_tpu.tuning``'s
``autotune`` and its variants.
"""

from __future__ import annotations

import json
import time
from typing import Optional

import numpy as np
import torch

from . import fastpath, tuning
from .engines import ENGINES, engine_of
from .enums import Direction, Domain
from .utils import logging as plog


def _key_of(committed, inner) -> str:
    """The shape key of an unwrapped route of a tuned kind."""
    if isinstance(inner, fastpath.MultiDim):
        return tuning._entry_key(committed, inner.tuning_kind)
    return tuning._entry_key(committed, inner.tuning_kind, inner.plan.n)


def _variants_for_entry(committed, entry) -> list[dict]:
    """The engines a route can race, ``{}`` (the static route) first:
    those of its ``global2``, ``fused2``, ``multidim`` or ``bi_col`` route,
    which REAL and layout routes wrap."""
    inner = getattr(entry, "inner", entry)
    if isinstance(inner, (fastpath.MultiDim, fastpath.Col)):
        return _variants_md(committed, inner)
    if inner.tuning_kind is None:
        return []
    return _variants_1d(committed, inner.tuning_kind, inner.plan.n, inner.batch)


def _variants_md(committed, inner) -> list[dict]:
    """``{}`` (the static route: K11 where it takes the shape, K10 for the
    column steps) and the variants that change a kernel: ``{"cm": 1}``
    where some column step takes K10-mm; where K11 runs, ``{"m2": 0}`` and
    ``{"m2": 0, "cm": 1}`` (the latter where the per-axis route has a
    column step K10-mm takes).  ``bi_col``: ``{"cm": 1}`` where K10-mm takes
    the length.  The JAX package's TPU tile knobs (``ct``, ``ds``, ``mt1``,
    ``mt2``) are not raced: they have no counterpart here."""

    def takes_mm(params):
        e = fastpath.with_engine(committed, inner, params)
        steps = e.steps if isinstance(e, fastpath.MultiDim) else (e,)
        return any(isinstance(s, fastpath.Col) and s.kernel == "col_mm"
                   for s in steps)

    out = [{}]
    if takes_mm({"cm": 1}):
        out.append({"cm": 1})
    # whether K11 runs on the static route, whatever the tuned entry chose
    if isinstance(inner, fastpath.MultiDim) and isinstance(
            fastpath.with_engine(committed, inner, {}).steps[0], fastpath.Md2):
        out.append({"m2": 0})
        if takes_mm({"m2": 0, "cm": 1}):
            out.append({"m2": 0, "cm": 1})
    return out


def _variants_1d(committed, kind: str, n: int, batch: int) -> list[dict]:
    """``{}`` (the static route) and the parameters of each engine of
    ``kind`` in ``engines.ENGINES`` whose gate takes the length-``n`` plan
    at ``batch``.  ``global2``: every engine once, in the table's order (no
    tile knob worth racing).  ``fused2``: the tiled engines (K2-v2, K2-v3)
    at each batch tile 1 … 32 their gates take; where a has no fold, the
    engine both of their numbers reach there (K2-v1) once."""
    plan = committed.plans[n]
    if kind == "global2":
        return [dict(e.params) for e in ENGINES.values()
                if e.kind == kind and e.gate(plan, 1, 0)]
    if kind != "fused2":
        return []
    out = [{}]
    eng2 = engine_of({"eng": 2}, plan)
    if not eng2.tiled:  # a has no fold: engines 2 and 3 both reach K2-v1
        if eng2.gate(plan, batch, 0):
            out.append(dict(eng2.params))
        return out
    tiled = [e for e in ENGINES.values() if e.kind == kind and e.tiled]
    for bt in (1, 2, 4, 8, 16, 32):
        for e in tiled:
            if e.gate(plan, batch, bt):
                out.append({**e.params, "bt": bt})
    return out


def _time_bursts(fns: dict, x, iters: int, rounds: int = 3) -> dict:
    """Seconds per call of each function, timed in bursts of ``iters``
    calls that take turns over ``rounds`` rounds, so that every variant
    sees the same window of the device's clocks; each variant's best burst
    counts.  CUDA events on the card, ``time.perf_counter`` on the CPU."""
    cuda = x.is_cuda
    best: dict = {}
    for _ in range(rounds):
        for key, fn in fns.items():
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(iters):
                    fn(x)
                end.record()
                end.synchronize()
                t = start.elapsed_time(end) / 1e3 / iters
            else:
                t0 = time.perf_counter()
                for _ in range(iters):
                    fn(x)
                t = (time.perf_counter() - t0) / iters
            best[key] = min(best.get(key, t), t)
    return best


def autotune(committed, iters: int = 5,
             times: Optional[dict] = None) -> Optional[dict]:
    """Race the engines of ``committed``'s forward route on its device,
    persist the winner under the kind (``global2``, ``fused2``,
    ``multidim`` or ``bi_col``) and key of the route it runs (a REAL or
    layout route's inner one, so a REAL transform records under its half
    length and a BATCH_INTERLEAVED layout under ``bi_col``), re-register
    both directions, and return the winning parameters; None where the
    plan has nothing to race.  A variant whose output is more than 1e-3 (relative
    2-norm) from the ``{}`` baseline's is dropped with a trace.  ``times``,
    where given, receives ``{json of the parameters: ms per call}`` of each
    variant raced."""
    entry = committed._raw_fast.get(Direction.FORWARD)
    if entry is None:
        return None
    variants = _variants_for_entry(committed, entry)
    if len(variants) <= 1:
        return None
    d = committed.descriptor
    inner = getattr(entry, "inner", entry)
    kind = inner.tuning_kind
    key = _key_of(committed, inner)
    count = d.get_input_count(Direction.FORWARD)
    real_in = d.domain == Domain.REAL
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(-1, 1, count * (1 if real_in else 2))
                         .astype(np.float32)).to(committed.device)
    fns, ref = {}, None
    for i, params in enumerate(variants):
        fn = fastpath.build_fn(
            committed, fastpath.with_engine(committed, entry, params))
        y = fn(x)
        if ref is None:  # the first variant is the {} baseline
            ref, ref_norm = y, float(torch.linalg.vector_norm(y)) or 1.0
        else:
            rel = float(torch.linalg.vector_norm(y - ref)) / ref_norm
            if not rel <= 1e-3:
                plog.trace(f"autotune {kind}/{key} {params}: output mismatch "
                           f"(rel {rel:.1e}) - dropped")
                continue
        fns[i] = fn
    del ref
    best = None
    for i, t in _time_bursts(fns, x, iters).items():
        plog.trace(f"autotune {kind}/{key} {variants[i]}: {t * 1e3:.3f} ms")
        if times is not None:
            times[json.dumps(variants[i], sort_keys=True)] = t * 1e3
        if best is None or t < best[0]:
            best = (t, variants[i])
    tuning.record(committed.config.name, kind, key, best[1])
    committed._register()
    return best[1]
