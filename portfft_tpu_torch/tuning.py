"""Measured engine choice for GLOBAL, FUSED, multi-dim and
BATCH_INTERLEAVED plans, and ``autotune``.

Counterpart of ``portfft_tpu.tuning``.  A GLOBAL plan n = G1·G2 has up to
ten engines that compute the same function (``fastpath``'s ``global2``
entry): the two-pass K3 (``{}``, the static route) and its factored-twiddle
mode K3-ftw (``{"eng": 2, "ftw": 1}``), the single-pass K4
(``{"eng": 5}``), the butterfly-factored single-sweep K5 (``{"eng": 7}``),
its phase-overlay schedule K5-ov (``{"eng": 7, "ov": 1}``), K5 with its low
twiddle factor resident K19 (``{"eng": 7, "bf2": 1}``), the mixed-radix
single sweep K18 (``{"eng": 8}``, subs A·128 with A = 2^a·3^b), K3's two
passes in one launch K17 (``{"eng": 6}``, and ``{"eng": 6, "ftw": 1}`` with
its factored twiddle) and the tensor-core two-pass K16 (``{"eng": 3}``).  A FUSED plan [a, 128] (the
``fused2`` entry) has K2 (``{}``, the static route), K2-v2 (``{"eng": 2,
"bt": bt}``) and K2-v3 (``{"eng": 3, "bt": bt}``) with a batch tile bt, or,
where a has no fold, K2-v1 (``{"eng": 2}``).  A multi-dim transform (the
``multidim`` kind) races its column kernel, K10 (``{}``) or the
tensor-core K10-mm (``{"cm": 1}``), and where K11 runs by default the
per-axis route without it (``{"m2": 0}``, ``{"m2": 0, "cm": 1}``); a
BATCH_INTERLEAVED 1D transform (the ``bi_col`` kind) K10 against K10-mm.
Which is fastest is measured once per (device, plan) and the winner
persisted:

* ``tuning_defaults.json`` (shipped, read-only): winners measured on an
  H100 (key ``cuda_h100``) by :meth:`CommittedDescriptor.autotune`
  (``chip_smoke.py``'s tuned phase prints each race).
* the user cache, ``~/.cache/portfft_tpu_torch_tuning.json`` or the file
  ``PORTFFT_TUNING_CACHE`` names, written by ``autotune`` on the user's
  own card; it overrides the shipped table.

Lookups are by device name (``config.DeviceConfig.name``: ``cuda_h100``,
``cpu``), kind (``"global2"``, ``"fused2"``, ``"multidim"``, ``"bi_col"``,
or ``"global_split"`` for the planner's split) and a shape key
(:func:`_entry_key`; it holds no batch,
so a tuned batch tile the batch cannot take is dropped at commit, not
marked stale).  ``PORTFFT_NO_TUNING`` turns
every lookup off.  A miss keeps the static route, so the table only ever
adds.  The engine is fixed at commit: ``fastpath`` marks a tuned engine
whose gate declines the plan stale (:func:`mark_stale_if_tuned`) and takes
the static route, and raises for an engine this package has no kernel for.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

import numpy as np
import torch

_DEFAULTS_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "tuning_defaults.json"
)
_USER_PATH = os.path.expanduser(
    os.environ.get("PORTFFT_TUNING_CACHE",
                   "~/.cache/portfft_tpu_torch_tuning.json")
)

_lock = threading.Lock()
_tables: Optional[dict] = None  # {device: {kind: {key: params}}}
_user: Optional[dict] = None


def _read(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _load() -> None:
    global _tables, _user
    if _tables is None:
        _tables, _user = _read(_DEFAULTS_PATH), _read(_USER_PATH)


def _save() -> None:
    try:
        os.makedirs(os.path.dirname(_USER_PATH) or ".", exist_ok=True)
        with open(_USER_PATH, "w") as f:
            json.dump(_user, f, indent=1, sort_keys=True)
    except OSError:
        pass  # read-only home: keep the in-memory entry


def lookup(device: str, kind: str, key: str) -> Optional[dict]:
    """Tuned parameters for (device, kind, key), user cache first.  An entry
    with a ``"stale"`` mark returns None, and a stale mark in the user cache
    masks the shipped entry of the same key."""
    from .utils.logging import _env_flag

    if _env_flag("PORTFFT_NO_TUNING"):
        return None
    with _lock:
        _load()
        for table in (_user, _tables):
            params = table.get(device, {}).get(kind, {}).get(key)
            if params is not None:
                return None if "stale" in params else params
    return None


def record(device: str, kind: str, key: str, params: dict) -> None:
    """Persist a measured winner to the user cache (clearing a stale
    mark)."""
    with _lock:
        _load()
        _user.setdefault(device, {}).setdefault(kind, {})[key] = params
        _save()


def mark_stale(device: str, kind: str, key: str, reason: str) -> None:
    """Mark a tuned entry stale.  The mark lives in the user cache, so it
    masks a shipped entry of the same key; it keeps the entry's parameters
    and the reason (cut to 200 characters).  ``record`` of a new winner
    replaces the whole entry, mark and all."""
    with _lock:
        _load()
        prev = None
        for table in (_user, _tables):
            prev = table.get(device, {}).get(kind, {}).get(key)
            if prev is not None:
                break
        entry = dict(prev or {})
        entry["stale"] = reason[:200]
        _user.setdefault(device, {}).setdefault(kind, {})[key] = entry
        _save()


def mark_stale_if_tuned(committed, kind: str, reason: str,
                        n: Optional[int] = None) -> bool:
    """If (device, kind, the plan's key) resolves to a tuned entry, mark it
    stale and return True."""
    key = _entry_key(committed, kind, n)
    if lookup(committed.config.name, kind, key) is None:
        return False
    mark_stale(committed.config.name, kind, key, reason)
    return True


def stale_entries(device: Optional[str] = None) -> list[tuple]:
    """(device, kind, key, entry) of every user-cache entry marked stale."""
    out = []
    with _lock:
        _load()
        for dev, kinds in _user.items():
            if device and dev != device:
                continue
            for kind, entries in kinds.items():
                for key, params in entries.items():
                    if isinstance(params, dict) and "stale" in params:
                        out.append((dev, kind, key, params))
    return out


def forget(device: str, kind: str, key: str) -> None:
    """Remove a user-cache entry (no-op where there is none)."""
    with _lock:
        _load()
        _user.get(device, {}).get(kind, {}).pop(key, None)
        _save()


def _reset_for_tests() -> None:
    global _tables, _user
    with _lock:
        _tables = None
        _user = None


# -- variants and measurement ---------------------------------------------------


def _entry_key(committed, kind: str, n: Optional[int] = None) -> str:
    """The shape key of ``kind`` for the transform length ``n`` (default:
    the descriptor's first length): ``n{n}_g{G1}x{G2}`` for ``global2``,
    ``n{L0}x{L1}…`` (the descriptor's lengths) for ``multidim``, ``n{n}``
    otherwise, as the JAX package keys them."""
    if kind == "multidim":
        return "n" + "x".join(map(str, committed.descriptor.lengths))
    n = n or committed.descriptor.lengths[0]
    if kind == "global2":
        g1, g2 = committed.plans[n].sub
        return f"n{n}_g{g1.n}x{g2.n}"
    return f"n{n}"


def _key_of(committed, inner) -> str:
    """The shape key of an unwrapped entry of a tuned kind."""
    kind = inner[0]
    if kind == "multidim":
        return _entry_key(committed, kind)
    return _entry_key(committed, kind, (inner[2] if kind == "bi_col" else inner[1]).n)


def _variants_for_entry(committed, entry) -> list[dict]:
    """The engines an entry can race, ``{}`` (the static route) first:
    those of its ``global2``, ``fused2``, ``multidim`` or ``bi_col`` entry,
    which REAL and layout entries wrap."""
    from .fastpath import inner_entry

    inner = inner_entry(entry)
    if inner[0] in ("multidim", "bi_col"):
        return _variants_md(committed, inner)
    if inner[0] not in ("global2", "fused2"):
        return []
    return _variants_1d(committed, inner[0], inner[1].n, inner[2])


def _variants_md(committed, inner) -> list[dict]:
    """``{}`` (the static route: K11 where it takes the shape, K10 for the
    column steps) and the variants that change a kernel: ``{"cm": 1}``
    where some column step takes K10-mm; where K11 runs, ``{"m2": 0}`` and
    ``{"m2": 0, "cm": 1}`` (the latter where the per-axis route has a
    column step K10-mm takes).  ``bi_col``: ``{"cm": 1}`` where K10-mm takes
    the length.  The JAX package's TPU tile knobs (``ct``, ``ds``, ``mt1``,
    ``mt2``) are not raced: they have no counterpart here."""
    from .fastpath import with_engine

    def takes_mm(params):
        e = with_engine(committed, inner, params)
        steps = e[2] if e[0] == "multidim" else (e,)
        return any("col_mm" in (s[0], s[-1]) for s in steps)

    out = [{}]
    if takes_mm({"cm": 1}):
        out.append({"cm": 1})
    # whether K11 runs on the static route, whatever the tuned entry chose
    if inner[0] == "multidim" and with_engine(committed, inner, {})[1]:
        out.append({"m2": 0})
        if takes_mm({"m2": 0, "cm": 1}):
            out.append({"m2": 0, "cm": 1})
    return out


def _variants_1d(committed, kind: str, n: int, batch: int) -> list[dict]:
    """``{}`` (the static route) and each engine whose gate takes the
    length-``n`` plan at ``batch``.  ``global2``: the engines of
    ``fastpath.ENGINE_PARAMS`` in its order, ``{"eng": 2, "ftw": 1}``
    (K3-ftw), ``{"eng": 5}`` (K4), ``{"eng":
    7}`` (K5), ``{"eng": 7, "ov": 1}`` (K5-ov), ``{"eng": 3}`` (K16),
    ``{"eng": 6}`` and ``{"eng": 6, "ftw": 1}`` (K17), ``{"eng": 8}``
    (K18), ``{"eng": 7, "bf2": 1}`` (K19); no tile knob worth racing.  ``fused2``: ``{"eng": 2, "bt": bt}`` (K2-v2) and
    ``{"eng": 3, "bt": bt}`` (K2-v3) for each bt in 1 … 32 that divides the
    batch and that the gate takes; where a has no fold, ``{"eng": 2}``
    (K2-v1) once, since engines 2 and 3 both reach it there."""
    from .fastpath import ENGINE_PARAMS, _engine_of, engine_supported

    plan = committed.plans[n]
    if kind == "global2":
        return [params for engine, params in ENGINE_PARAMS.items()
                if engine_supported(engine, plan)]
    if kind != "fused2":
        return []
    out = [{}]
    if _engine_of({"eng": 2}, plan) == "fused2_v1":
        if engine_supported("fused2_v1", plan):
            out.append({"eng": 2})
        return out
    for bt in (1, 2, 4, 8, 16, 32):
        for eng in (2, 3):
            if engine_supported(_engine_of({"eng": eng}, plan), plan, batch, bt):
                out.append({"eng": eng, "bt": bt})
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
    """Race the engines of ``committed``'s forward entry on its device,
    persist the winner under the kind (``global2``, ``fused2``,
    ``multidim`` or ``bi_col``) and key of the entry it runs (a REAL or
    layout entry's inner one, so a REAL transform records under its half
    length and a BATCH_INTERLEAVED layout under ``bi_col``), re-register
    both directions, and return the winning parameters; None where the
    plan has nothing to race.  A variant whose output is more than 1e-3 (relative
    2-norm) from the ``{}`` baseline's is dropped with a trace.  ``times``,
    where given, receives ``{json of the parameters: ms per call}`` of each
    variant raced."""
    from . import fastpath
    from .enums import Direction, Domain
    from .utils import logging as plog

    entry = committed._raw_fast.get(Direction.FORWARD)
    if entry is None:
        return None
    variants = _variants_for_entry(committed, entry)
    if len(variants) <= 1:
        return None
    d = committed.descriptor
    inner = fastpath.inner_entry(entry)
    kind = inner[0]
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
    record(committed.config.name, kind, key, best[1])
    committed._register()
    return best[1]
