"""The engines of a raw route, in one table: every kernel that runs a
DIRECT, FUSED [a, 128] or GLOBAL plan as one call on the raw interleaved
buffer (``ENGINES``), with the JAX package's tuning parameters that select
it, its gate and its tables.

An engine's ``kind`` is ``"direct"`` or a tuning kind, ``"fused2"`` or
``"global2"``; the engine named after its kind is that kind's static route
(K1, K2, K3).  :func:`engine_of` maps tuning parameters to an engine with
the reference's numbering.  Each kernel's wrapper carries its K-number, and
its module names the Pallas call it ports.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from .enums import Level
from .exceptions import UnsupportedConfiguration
from .ops import cuda_fft, cuda_global, cuda_global_bf, cuda_global_ilv
from .ops.torch_fft import fold_factor, is_two_stage

#: Longest sub-transform a GLOBAL pass holds in one tile: one column in two
#: ping-pong tiles of float2 plus its root table (``pass_smem_bytes`` in
#: csrc/fft_common.cuh) fits the 227 KB of shared memory a block may use up
#: to this length.  The C side checks no length; a launch past it fails.
#: K15's convolution subs share the tile geometry and the limit.
GLOBAL_SUB_MAX = 8192


class RawFastUnavailable(UnsupportedConfiguration):
    """No kernel of this package covers the descriptor (declined at
    commit)."""


def global_raw(plan) -> bool:
    """A GLOBAL plan whose subs K3 takes (the ``global2`` kind): DIRECT or
    FUSED [a, 128], each at most ``GLOBAL_SUB_MAX`` points."""
    return plan.level == Level.GLOBAL and all(
        (g.level == Level.DIRECT or is_two_stage(g)) and g.n <= GLOBAL_SUB_MAX
        for g in plan.sub)


def raw_kind(plan) -> str | None:
    """The kind of a plan's raw route: ``"direct"``, ``"fused2"`` (FUSED
    [a, 128]), ``"global2"`` (:func:`global_raw`), or None where the plan
    needs the plane path."""
    if plan.level == Level.DIRECT:
        return "direct"
    if is_two_stage(plan):
        return "fused2"
    return "global2" if global_raw(plan) else None


@dataclasses.dataclass(frozen=True, eq=False)
class Engine:
    """One kernel of a raw route.  ``gate(plan, batch, bt)`` says whether it
    takes the plan at the batch and the batch tile ``bt`` (0: at any tile);
    ``tables(plan, sign, keys, arrays, batch, bt)`` gives the kernel's
    arguments between ``batch`` and ``scale`` from the committed plan's
    bank; a ``tiled`` engine takes the batch tile ``"bt"`` of its tuning
    parameters."""

    name: str
    kind: str
    params: dict
    kernel: Callable = dataclasses.field(repr=False)
    gate: Callable = dataclasses.field(repr=False)
    tables: Callable = dataclasses.field(repr=False)
    tiled: bool = False


def _on_plan(gate):
    return lambda plan, batch=1, bt=0: gate(plan)


def _one(make, **kw):
    return lambda plan, sign, keys, arrays, batch, bt: (
        make(plan, sign, keys, arrays, **kw),)


def _batched(make, **kw):
    return lambda plan, sign, keys, arrays, batch, bt: (
        make(plan, sign, keys, arrays, batch, **kw),)


def _tiled(name):
    # the tile is fixed here, so the plain version tiles as the kernel
    return lambda plan, sign, keys, arrays, batch, bt: (
        cuda_fft.sub_tables(plan, sign, keys, arrays),
        bt or cuda_fft.pick_tile(name, plan.factors[0], batch))


def _two_subs(plan, sign, keys, arrays, batch, bt):
    g1, g2 = plan.sub
    t = keys[("T", g1.n, g2.n, sign)]
    return (cuda_fft.sub_tables(g1, sign, keys, arrays),
            cuda_fft.sub_tables(g2, sign, keys, arrays),
            arrays[t + "r"], arrays[t + "i"])


_sub = _one(cuda_fft.sub_tables)
_bf = _batched(cuda_global_bf.bf_tables)

#: Every engine by name; within a kind in the order ``autotune`` races them.
ENGINES = {e.name: e for e in (
    Engine("direct", "direct", {}, cuda_fft.direct,
           _on_plan(lambda p: p.level == Level.DIRECT), _sub),
    Engine("fused2", "fused2", {}, cuda_fft.fused2, _on_plan(is_two_stage), _sub),
    Engine("fused2_v1", "fused2", {"eng": 2}, cuda_fft.fused2_v1,
           _on_plan(cuda_fft.fused2_v1_supported), _sub),
    Engine("fused2_v2", "fused2", {"eng": 2}, cuda_fft.fused2_v2,
           cuda_fft.fused2_v2_supported, _tiled("fused2_v2"), tiled=True),
    Engine("fused2_v3", "fused2", {"eng": 3}, cuda_fft.fused2_v3,
           cuda_fft.fused2_v3_supported, _tiled("fused2_v3"), tiled=True),
    Engine("global2", "global2", {}, cuda_global.global2, _on_plan(global_raw),
           _two_subs),
    Engine("global2_ftw", "global2", {"eng": 2, "ftw": 1}, cuda_global.global2_ftw,
           _on_plan(lambda p: global_raw(p) and cuda_global.global2_ftw_supported(p)),
           _one(cuda_global.global2_ftw_tables)),
    Engine("global_sq", "global2", {"eng": 5}, cuda_global.global_sq,
           _on_plan(cuda_global.global_sq_supported), _two_subs),
    Engine("global_bf", "global2", {"eng": 7}, cuda_global_bf.global_bf,
           _on_plan(cuda_global_bf.global_bf_supported), _bf),
    Engine("global_bf_ov", "global2", {"eng": 7, "ov": 1}, cuda_global_bf.global_bf_ov,
           _on_plan(cuda_global_bf.global_bf_supported), _bf),
    Engine("global3", "global2", {"eng": 3}, cuda_global.global3,
           _on_plan(cuda_global.global3_supported), _one(cuda_global.global3_tables)),
    Engine("global_fused", "global2", {"eng": 6}, cuda_global.global_fused,
           _on_plan(cuda_global.global_fused_supported),
           _batched(cuda_global.global_fused_tables)),
    Engine("global_fused_ftw", "global2", {"eng": 6, "ftw": 1}, cuda_global.global_fused,
           _on_plan(lambda p: cuda_global.global_fused_supported(p, ftw=True)),
           _batched(cuda_global.global_fused_tables, ftw=True)),
    Engine("global_ilv", "global2", {"eng": 8}, cuda_global_ilv.global_ilv,
           _on_plan(cuda_global_ilv.global_ilv_supported), _bf),
    Engine("global_bf2", "global2", {"eng": 7, "bf2": 1}, cuda_global_bf.global_bf2,
           _on_plan(cuda_global_bf.global_bf2_supported),
           _batched(cuda_global_bf.bf_tables, resident=True)),
)}


def engine_of(params: dict, plan=None) -> Engine:
    """The engine tuning parameters select.  For a GLOBAL plan (or ``plan``
    None) the JAX package's engine 2 is K3 (``"ftw": 1`` K3-ftw), 3 K16, 5
    K4, 6 K17 (``"ftw": 1`` its factored twiddle), 7 K5, K5-ov (``"ov":
    1``) or K19 (``"bf2": 1``), 8 K18.  The reference's TPU knobs have no
    counterpart here and are read and ignored: the tiles ``t1``/``t2``
    (engines 2, 3, 6, 7, 8; the factored tables are read at
    ``torch_fft.FTW_T1`` columns whatever ``t1``), ``bt`` (5), ``st3``/
    ``ta`` (bf2), and ``mm`` and ``ds`` on engine 2.  For a FUSED [a, 128]
    plan, engine 4 (or none) is K2 (its ``flat``, ``ds`` and ``bt`` knobs
    have no counterpart), 2 K2-v2 and 3 K2-v3, each K2-v1 where a has no
    fold, as the reference's chain (v3 or v2, then v1) reaches it there.
    Any other engine raises :class:`RawFastUnavailable`."""
    eng = params.get("eng")
    fused = plan is not None and is_two_stage(plan)
    if fused:
        if eng in (2, 3) and fold_factor(plan.factors[0]) == 0:
            return ENGINES["fused2_v1"]
        name = {None: "fused2", 4: "fused2", 2: "fused2_v2", 3: "fused2_v3"}.get(eng)
    else:
        name = {
            2: "global2_ftw" if params.get("ftw") else "global2",
            3: "global3",
            5: "global_sq",
            6: "global_fused_ftw" if params.get("ftw") else "global_fused",
            7: ("global_bf2" if params.get("bf2") else
                "global_bf_ov" if params.get("ov") else "global_bf"),
            8: "global_ilv",
        }.get(2 if eng is None else eng)
    if name is None:
        raise RawFastUnavailable(f"the {'FUSED' if fused else 'GLOBAL'} engine "
                                 f"{params} has no kernel in this package")
    return ENGINES[name]
