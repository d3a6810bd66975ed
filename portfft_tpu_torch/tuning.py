"""The tuning cache: measured engine choices and their keys.

Counterpart of ``portfft_tpu.tuning``'s table.  A GLOBAL plan (the
``global2`` kind) and a FUSED [a, 128] plan (``fused2``) have several
engines that compute the same function (``engines.ENGINES``, with the
parameters that select each); a multi-dim transform (``multidim``) and a
BATCH_INTERLEAVED 1D transform (``bi_col``) have ``{"cm": 1}`` and
``{"m2": 0}`` (``fastpath.MultiDim``).  ``race.autotune`` measures the
fastest once per (device, plan) and persists the winner:

* ``tuning_defaults.json`` (shipped, read-only): winners measured on an
  H100 (key ``cuda_h100``; ``chip_smoke.py``'s tuned phases print each
  race).
* the user cache, ``~/.cache/portfft_tpu_torch_tuning.json`` or the file
  ``PORTFFT_TUNING_CACHE`` names, written by ``autotune`` on the user's
  own card; it overrides the shipped table.

Lookups are by device name (``config.DeviceConfig.name``: ``cuda_h100``,
``cpu``), kind (the four above, or ``"global_split"`` for the planner's
split) and a shape key (:func:`_entry_key`; it holds no batch, so a tuned
batch tile the batch cannot take is dropped at commit, not marked stale).
``PORTFFT_NO_TUNING`` turns every lookup off.  A miss keeps the static
route, so the table only ever adds.  The registry (``fastpath``) fixes the
engine at commit, marks a tuned engine whose gate declines the plan stale
(:func:`mark_stale_if_tuned`) and takes the static route; this module
reads no route.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Optional

from .utils.logging import _env_flag

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


# -- keys -----------------------------------------------------------------------


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
