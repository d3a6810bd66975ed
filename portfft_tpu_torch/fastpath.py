"""Raw-I/O registry: which kernel runs a committed plan.

The 1D C2C fp32 INTERLEAVED PACKED transform with zero offsets — the
contract ``bench.py`` measures — runs as one kernel call on the raw
interleaved buffer, chosen by plan level:

| plan level | kernel (``ops``) | JAX counterpart |
|---|---|---|
| DIRECT | ``cuda_fft.direct`` (K1) | ``pallas_fft.direct_raw_call`` |
| FUSED [a, 128] | the entry's engine: ``cuda_fft.fused2`` (K2, the static route), ``fused2_v1`` (K2-v1), ``fused2_v2`` (K2-v2) or ``fused2_v3`` (K2-v3) | ``pallas_fft.fused2_raw_mm_call``, ``fused2_raw_call``, ``fused2_raw_v2_call``, ``fused2_raw_v3_call`` |
| GLOBAL, DIRECT or FUSED [a, 128] subs | the entry's engine: ``cuda_global.global2`` (K3, the static route), ``cuda_global.global2_ftw`` (K3-ftw, its factored twiddle), ``cuda_global.global_sq`` (K4), ``cuda_global_bf.global_bf`` (K5), ``global_bf_ov`` (K5-ov), ``global_bf2`` (K19), ``cuda_global.global3`` (K16), ``cuda_global.global_fused`` (K17, dense or factored twiddle) or ``cuda_global_ilv.global_ilv`` (K18) | ``pallas_global.global2_raw_call`` (``use_ftw`` for K3-ftw), ``global_sq_raw_call``, ``pallas_global_bf.global_bf_raw_call``, ``global_bf_ov_raw_call``, ``global_bf2_raw_call``, ``pallas_global3.build_call``, ``pallas_global.global_fused_raw_call``, ``pallas_global_ilv.global_ilv_raw_call`` |
| anything else (BLUESTEIN; GLOBAL with another sub; a FUSED chain not [a, 128]) | the plane path, ``("plane", ...)`` below | ``committed._traced_interleaved`` |

The engine of a GLOBAL entry, ``("global2", plan, batch, sign, scale,
engine)``, and of a FUSED entry, ``("fused2", plan, batch, sign, scale,
engine, bt)``, is fixed at commit from the tuning table (``tuning.lookup``
of the plan's ``global2`` or ``fused2`` key, written by
``CommittedDescriptor.autotune``), else the static route, K3 or K2
(``_tuned_engine``).  FUSED follows the JAX package's chain: engine 4 or
none is K2, engine 2 K2-v2 and engine 3 K2-v3, each K2-v1 on a plan whose
a has no fold; ``bt`` is the tuned batch tile of K2-v2 and K2-v3 (0: the
kernel picks; a tuned tile this batch cannot take is dropped).  The 1D
entry, the half-length entry under a REAL transform and the inner entry of
a layout take it; a multi-dimensional row step runs K3 or K2.  A tuned
engine whose gate declines the plan is marked stale and the static route
runs; an engine with no kernel here raises.

The static FUSED route is K2 for every [a, 128] plan and batch.  The JAX
package's static route differs there (ROADMAP Queue 3): it runs v1 on the
plans whose a has no fold, and at batches its tiles decline it falls back
to its plane path.

The plane path (``plane_fn``) runs ``cuda_io.deinterleave`` (K6), then the
executor ``ops/torch_exec.exec_plan`` on the (re, im) planes with a leaf
hook that runs each node's kernel, then ``cuda_io.interleave`` (K6) with
the direction's scale.  The route of every node is fixed at commit
(``plane_routes``) by the JAX package's ``leaf_dispatch`` gates:

| node | kernel | JAX counterpart |
|---|---|---|
| DIRECT, FUSED [a >= 8, 128], any other FUSED chain | ``cuda_chain.chain`` (K13: its direct, two-stage and chain modes) | ``pallas_fft.fused_chain``, ``_generic_chain_call`` |
| GLOBAL with DIRECT or FUSED [a, 128] subs, a dividing 128 (``cuda_global.global2_supported``) | ``cuda_global.global2_planes`` (K14) | ``pallas_global.global2_call`` |
| BLUESTEIN with a GLOBAL convolution (``cuda_bluestein.supported``) whose subs fit K15's tile | ``cuda_bluestein.bluestein`` (K15), or with ``PORTFFT_BLUESTEIN_BF`` set at commit and both subs A·128, A = 2^a·3^b ≤ 16, ``cuda_bluestein.bluestein_bf`` (K15-bf, its butterfly mode) | ``pallas_bluestein.bluestein_call`` (its butterfly mode under the same flag) |
| other BLUESTEIN, other GLOBAL | the executor's glue around the kernels of its nodes; a Bluestein convolution on K14 takes b̂ and the final chirp as ``post`` tables | ``xla_fft._exec_bluestein``, ``exec_plan`` |

SPLIT_COMPLEX C2C (PACKED, zero offsets, any rank) and the multi-dim
interleaved shapes the raw route below declines run the JAX package's
per-axis walk (``_core_inner``, here ``torch_exec.core_inner``, the
``("core", ...)`` entry of ``_register_core``): the last axis through the
executor, each outer axis on K12 (``cuda_axis.axis_m2``) where the JAX
package's gates take it, else ``movedim`` + executor + ``movedim``.  The
copies that move an axis and put it back count as glue bytes
(``tracing.glue_bytes``), and each axis is a ``portfft.axis`` span under a
profiler.
SPLIT planes go in and out with no K6; the interleaved entry runs K6
around the walk.  Where the scale goes:

| route of the last axis that runs | scale |
|---|---|
| K12 | in K12 |
| K14 (its node, or a Bluestein convolution with ``post``) | K14's pass 2 |
| K15 | K15's pass 3 |
| K13, generic GLOBAL or Bluestein | one torch multiply after it |
| any, interleaved (``plane`` and ``core`` entries) | K6's interleave |

The 1D REAL fp32 transform (R2C forward, C2R backward, INTERLEAVED PACKED,
out-of-place) runs, for even n ≤ ``SMALL_REAL_MAX_N``, as one call of
``cuda_real.small_real`` (K9, entries ``realsf``/``realsb``); for longer
even n as the C2C transform of the h = n/2 plan at scale 1 on the real
buffer viewed as h complex pairs, followed (forward) by
``cuda_real.untangle`` (K8a) or preceded (backward) by
``cuda_real.retangle`` (K8b), which apply the direction's scale.  Where h
has a raw entry (K1, K2, K3 or a tuned engine) that entry runs
(``realf``/``realb``); where h needs the plane path, the plane entry of h
runs (``realplane``: K6, the executor with K13–K15, K6), and the forward
untangle is K8a-w (``cuda_real.untangle_wide``) where its gate takes the
shape (the JAX package's ``_core_real_forward``/``_core_real_backward``).
C2R reads Im X[0] and Im X[n/2] as the JAX package does: dropped below
n = 1024, where it has no retangle table, used from there on (K8b's
``drop`` flag, set at commit).  The JAX package declines some raw shapes
to its plane path (h not a multiple of 128, h ≥ 2^15, 512 < n < 1024,
batches that do not group); the kernels here take them all.

Multi-dimensional C2C fp32 (rank >= 2, INTERLEAVED PACKED, zero offsets)
runs as an ``("multidim", md2, steps)`` entry: the kernels in the order they
run, the first out of place (or into the caller's buffer in place) and the
rest in place on its result.  Route as the JAX package's
``_register_multidim``:

| route | kernels, in order |
|---|---|
| md2 (``cuda_multidim.md2_supported`` of the two trailing plans) | ``cuda_multidim.md2`` (K11) on the trailing 2D transforms, then ``cuda_multidim.col`` (K10) for axes −3 … 0 |
| per axis | the last axis's 1D kernel (K1, K2 or K3) at batch B·prod(lengths[:-1]), then K10 for axes −2 … 0 |

Length-1 axes are skipped; the direction's scale goes into the last kernel
that runs.  Every outer axis must be one K10 takes (DIRECT ≤ 512 or FUSED
[a, 128] with a | 128, so up to 16384) and the last axis one of K1–K3;
other shapes run on the per-axis walk above.  The 1D BATCH_INTERLEAVED
layout (stride = batch, distance 1, both domains) is one K10 call with
bpre = 1: the ``bi_col`` entry, where K10 takes the length.

Both entries take the JAX package's ``multidim`` (key ``n{L0}x{L1}…``) and
``bi_col`` (key ``n{n}``) tuning kinds at commit: ``{"m2": 0}`` turns K11
off (the per-axis route), and ``{"cm": 1}`` runs each column step on
K10-mm (``cuda_multidim.col_mm``, the tensor cores) where its gate takes
the axis, K10 elsewhere.  The reference's TPU tile knobs ``ct``, ``ds``,
``mt1`` and ``mt2`` are read and ignored: Hopper tiles are the kernels'
own.

Buffer layouts (the JAX package's ``strided1d`` entry, without its TPU
tile gates).  Every entry above runs on its own blocks at offset 0: PACKED
rows, or ``bi_col``'s BATCH_INTERLEAVED block.  A descriptor whose buffers
are laid out otherwise gets ``("layout", inner, src, dst)`` around the
inner entry, ``src`` for the input domain and ``dst`` for the output
domain (``_with_layout``):

| a domain's buffer | side | how the inner entry reaches it |
|---|---|---|
| the inner entry's block at an offset (any rank; PACKED, or BI for ``bi_col``) | the offset, an int | a contiguous view at the offset; the inner kernels read it, and write it where they can |
| any other 1D layout: strides, distances, BATCH_INTERLEAVED in one domain or over a length K10 declines | its ``utils.layout.Rows`` | ``cuda_stride.destride`` (K7) into packed rows; ``cuda_stride.restride`` (K7) back |

The direction's scale stays in the inner entry, so K7 is a pure copy.  A
new output buffer is zero wherever no result lands (K7's ``fill_gaps``, or
the zeroed leading offset of a view); a caller's buffer keeps those
elements.  IN_PLACE reads all input before writing any output: the inner
entry runs in place only on the view it reads or on K7's scratch, else
into a new buffer that is then restrided or copied into the caller's
(``layout_fn``).  The REAL route takes only PACKED buffers at offset 0.

Registration happens at commit.  Anything outside this slice raises
:class:`RawFastUnavailable` (an :class:`UnsupportedConfiguration`) naming
the ROADMAP Queue 1 item that will port it; no configuration is quietly
sent down another path.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from . import tuning
from .enums import ComplexStorage, Direction, Domain, Layout, Level, Placement
from .enums import inv as _inv
from .exceptions import UnsupportedConfiguration
from .ops import (
    cuda_axis,
    cuda_bluestein,
    cuda_chain,
    cuda_fft,
    cuda_global,
    cuda_global_bf,
    cuda_global_ilv,
    cuda_io,
    cuda_multidim,
    cuda_real,
    cuda_stride,
    torch_exec,
)
from .ops.torch_fft import fold_factor, is_two_stage
from .utils import logging as plog
from .utils import tracing
from .utils.layout import Rows, get_layout, rows_1d
from .utils.tracing import PROFILER


class RawFastUnavailable(UnsupportedConfiguration):
    """No kernel of this package covers the descriptor (declined at
    commit)."""


_SIGNS = {Direction.FORWARD: -1, Direction.BACKWARD: +1}

#: Longest sub-transform a GLOBAL pass holds in one tile: one column in two
#: ping-pong tiles of float2 plus its root table (``pass_smem_bytes`` in
#: csrc/fft_common.cuh) fits the 227 KB of shared memory a block may use up
#: to this length.  The C side checks no length; a launch past it fails.
#: K15's convolution subs share the tile geometry and the limit.
GLOBAL_SUB_MAX = 8192

#: Longest REAL transform K9 takes whole; longer even lengths run the
#: half-length path.  The JAX package's limit (``pallas_real``) too.
SMALL_REAL_MAX_N = 512


def _leaf_ok(plan) -> bool:
    return plan.level == Level.DIRECT or is_two_stage(plan)


def _raw_entry(plan0, batch: int, sign: int, scale: float,
               engine: str | None = None, bt: int = 0):
    """The raw entry of one 1D PACKED transform, ``(kind, plan, batch,
    sign, scale)``, for a FUSED [a, 128] plan with its ``engine`` and batch
    tile ``bt`` after them, for a GLOBAL plan with its ``engine``; None
    where the plan needs the plane path.  ``engine`` None is the static
    route (K2, K3)."""
    if plan0.level == Level.DIRECT:
        return ("direct", plan0, batch, sign, scale)
    if is_two_stage(plan0):
        return ("fused2", plan0, batch, sign, scale, engine or "fused2", bt)
    if _global_raw(plan0):
        return ("global2", plan0, batch, sign, scale, engine or "global2")
    return None


def _global_raw(plan0) -> bool:
    """A GLOBAL plan whose subs K3 takes (the ``global2`` entry)."""
    if plan0.level != Level.GLOBAL:
        return False
    g1, g2 = plan0.sub
    return _leaf_ok(g1) and _leaf_ok(g2) and max(g1.n, g2.n) <= GLOBAL_SUB_MAX


# -- engines of the global2 and fused2 entries ----------------------------------

#: The kernels of a ``global2`` entry and the tuning parameters (the JAX
#: package's engine numbers) that select them.
ENGINE_PARAMS = {
    "global2": {},                         # K3, two passes (engine 2)
    "global2_ftw": {"eng": 2, "ftw": 1},   # K3-ftw, its factored twiddle
    "global_sq": {"eng": 5},               # K4, one pass in a cluster
    "global_bf": {"eng": 7},               # K5, butterfly-factored sweep
    "global_bf_ov": {"eng": 7, "ov": 1},   # K5-ov, its phase overlay
    "global3": {"eng": 3},                 # K16, two passes on tensor cores
    "global_fused": {"eng": 6},            # K17, K3's passes in one launch
    "global_fused_ftw": {"eng": 6, "ftw": 1},  # K17, factored twiddle
    "global_ilv": {"eng": 8},              # K18, mixed-radix sweep
    "global_bf2": {"eng": 7, "bf2": 1},    # K19, K5 with GB resident
}

#: The kernels of a ``fused2`` entry and the JAX package's engine numbers
#: that select them (with a batch tile ``bt`` for engines 2 and 3).  On a
#: plan whose a has no fold, engines 2 and 3 select K2-v1, as the
#: reference's chain (v3 or v2, then v1) reaches it there.
FUSED_ENGINE_PARAMS = {
    "fused2": {},             # K2 (engine 4, the mm kernel)
    "fused2_v1": {"eng": 2},  # K2-v1, on a plan with no fold
    "fused2_v2": {"eng": 2},  # K2-v2
    "fused2_v3": {"eng": 3},  # K2-v3
}

def _engine_of(params: dict, plan0=None) -> str:
    """The kernel that tuning parameters select: for a GLOBAL plan (or
    ``plan0`` None) the JAX package's engine 2 is K3 (``"ftw": 1`` K3-ftw,
    its factored twiddle), 3 K16, 5 K4, 6 K17 (``"ftw": 1`` its factored
    twiddle), 7 K5, K5-ov (``"ov": 1``) or K19 (``"bf2": 1``), 8 K18.  The
    reference's TPU knobs have no counterpart here and are read and
    ignored: the tiles ``t1``/``t2`` (engines 2, 3, 6, 7, 8; the factored
    tables are read at ``torch_fft.FTW_T1`` columns whatever ``t1``),
    ``bt`` (5), ``st3``/``ta`` (bf2), and ``mm`` and ``ds`` on engine 2.
    For a FUSED [a, 128] plan, engine 4 (or none) is K2 (its ``flat``,
    ``ds`` and ``bt`` knobs have no counterpart), 2 K2-v2 and 3 K2-v3, each
    K2-v1 where a has no fold; any other engine raises."""
    eng = params.get("eng")
    if plan0 is not None and is_two_stage(plan0):
        if eng in (None, 4):
            return "fused2"
        if eng in (2, 3):
            if fold_factor(plan0.factors[0]) == 0:
                return "fused2_v1"
            return "fused2_v2" if eng == 2 else "fused2_v3"
        raise RawFastUnavailable(
            f"the FUSED engine {params} has no kernel in this package")
    eng = 2 if eng is None else eng
    if eng == 2:
        return "global2_ftw" if params.get("ftw") else "global2"
    if eng == 3:
        return "global3"
    if eng == 5:
        return "global_sq"
    if eng == 6:
        return "global_fused_ftw" if params.get("ftw") else "global_fused"
    if eng == 7:
        if params.get("bf2"):
            return "global_bf2"
        return "global_bf_ov" if params.get("ov") else "global_bf"
    if eng == 8:
        return "global_ilv"
    raise RawFastUnavailable(
        f"the GLOBAL engine {params} has no kernel in this package")


def engine_supported(engine: str, plan0, batch: int = 1, bt: int = 0) -> bool:
    """Whether ``engine``'s gate takes the plan (K3 and K2 take every plan
    their entries hold); K2-v2 and K2-v3 at the batch tile ``bt`` (0: at
    any tile)."""
    if engine == "global_sq":
        return cuda_global.global_sq_supported(plan0)
    if engine == "global2_ftw":
        return _global_raw(plan0) and cuda_global.global2_ftw_supported(plan0)
    if engine in ("global_bf", "global_bf_ov"):
        return cuda_global_bf.global_bf_supported(plan0)
    if engine == "global_bf2":
        return cuda_global_bf.global_bf2_supported(plan0)
    if engine == "global3":
        return cuda_global.global3_supported(plan0)
    if engine in ("global_fused", "global_fused_ftw"):
        return cuda_global.global_fused_supported(
            plan0, ftw=engine == "global_fused_ftw")
    if engine == "global_ilv":
        return cuda_global_ilv.global_ilv_supported(plan0)
    if engine == "fused2_v1":
        return cuda_fft.fused2_v1_supported(plan0)
    if engine == "fused2_v2":
        return cuda_fft.fused2_v2_supported(plan0, batch, bt)
    if engine == "fused2_v3":
        return cuda_fft.fused2_v3_supported(plan0, batch, bt)
    if engine == "fused2":
        return is_two_stage(plan0)
    return _global_raw(plan0)


def _tile_of(engine: str, params: dict) -> int:
    """The batch tile tuning parameters give ``engine`` (0: none, the
    kernel picks)."""
    return params.get("bt", 0) if engine in ("fused2_v2", "fused2_v3") else 0


def _tuned_engine(committed, plan0, batch: int) -> tuple[str | None, int]:
    """``(engine, bt)`` of the ``global2`` or ``fused2`` entry of
    ``plan0`` (:func:`_tuned_kind`), fixed at commit: the tuned table's
    (``tuning.lookup``), else the static route, whose engine has the
    kind's name (K3, K2); ``(None, 0)`` for a plan of no tuned kind.  The key holds no
    batch, so a tuned batch tile that does not divide this batch, or does
    not fit, is dropped with a trace and the kernel picks its own (the JAX
    package's "stale tuning (different batch): let the kernel pick").  A
    tuned engine whose gate declines the plan at every tile is marked stale
    in the tuning cache, with a warning, and the static route runs; one
    that has no kernel here raises."""
    kind = _tuned_kind(plan0)
    if kind is None:
        return None, 0
    key = tuning._entry_key(committed, kind, plan0.n)
    params = tuning.lookup(committed.config.name, kind, key)
    if params is None:
        tracing.tuned("miss")
        return kind, 0
    engine = _engine_of(params, plan0)
    bt = _tile_of(engine, params)
    if bt and not engine_supported(engine, plan0, batch, bt):
        plog.trace(f"tuned {kind}/{key} {params}: batch tile {bt} does not suit "
                   f"batch {batch}; the kernel picks its tile")
        bt = 0
    if engine_supported(engine, plan0, batch, bt):
        tracing.tuned("hit")
        return engine, bt
    tracing.tuned("declined")
    reason = f"the gate of {engine} declines {plan0.describe()}"
    tuning.mark_stale_if_tuned(committed, kind, reason, plan0.n)
    plog.warn(f"stale tuned entry {kind}/{key} {params}: {reason}; "
              f"{'K3' if kind == 'global2' else 'K2'} runs")
    return kind, 0


def _counted_lookup(committed, kind: str) -> dict:
    """The tuned parameters of the committed shape's ``kind`` entry
    (``multidim``, ``bi_col``), or ``{}``; the outcome is counted."""
    params = tuning.lookup(committed.config.name, kind,
                           tuning._entry_key(committed, kind))
    tracing.tuned("miss" if params is None else "hit")
    return params or {}


def _tuned_kind(plan0) -> str | None:
    """The tuned kind of a plan's raw entry, or None (DIRECT, plane)."""
    if is_two_stage(plan0):
        return "fused2"
    return "global2" if _global_raw(plan0) else None


#: Entries that wrap an inner entry at ``entry[1]``.
_WRAPPERS = ("layout", "realf", "realb", "realplane")
#: The REAL entries: small path, half-length path, half length on the plane
#: path.
_REAL = ("realsf", "realsb", "realf", "realb", "realplane")


def inner_entry(entry):
    """The entry a REAL or layout entry runs (unwrapped), or ``entry``."""
    while entry[0] in _WRAPPERS:
        entry = entry[1]
    return entry


def with_engine(committed, entry, params: dict):
    """``entry`` with the engine of its ``global2`` or ``fused2`` entry
    (:func:`inner_entry`) set by ``params``, or its ``multidim`` or
    ``bi_col`` entry rebuilt with the tuning parameters ``params``; raises
    where that engine has no kernel here or its gate declines the plan at
    the given tile."""
    kind = entry[0]
    if kind in _WRAPPERS:
        return (kind, with_engine(committed, entry[1], params), *entry[2:])
    if kind == "bi_col":
        return (*entry[:6], _col_kernel(entry[2], params))
    if kind == "multidim":
        sign = _step_sign(entry[2][0])
        return _register_multidim(committed, params)[
            next(dn for dn, s in _SIGNS.items() if s == sign)]
    if kind not in ("global2", "fused2"):
        raise RawFastUnavailable(f"a {kind} entry has no tuned engine")
    plan0, batch = entry[1], entry[2]
    engine = _engine_of(params, plan0)
    bt = _tile_of(engine, params)
    if not engine_supported(engine, plan0, batch, bt):
        raise RawFastUnavailable(
            f"the gate of {engine} declines {plan0.describe()} at batch "
            f"{batch}" + (f", tile {bt}" if bt else ""))
    return (*entry[:5], engine, bt) if kind == "fused2" else (*entry[:5], engine)


# -- the plane path -----------------------------------------------------------


def plane_routes(plan0, config) -> dict:
    """The plane path's route of ``plan0``, chosen at commit with the JAX
    package's gates (``pallas_fft.leaf_dispatch``): ``{n: kind}`` for every
    node of the plan tree that runs (a length has one plan, so one kind).
    Kinds: ``"direct"``, ``"two_stage"``, ``"chain"`` (K13's modes, as
    ``fused_chain`` picks), ``"global2"`` (K14, a GLOBAL plan
    ``global2_supported`` takes; its subs run inside it), ``"bluestein"``
    (K15, where ``bluestein_call`` takes the plan), ``"bluestein_bf"``
    (K15-bf, its butterfly mode, where ``cuda_bluestein.bf_mode`` takes
    it) and ``"generic"`` (a
    GLOBAL four-step or Bluestein transform whose glue runs in the
    executor around its nodes' kernels; a Bluestein convolution on K14
    takes b̂ and the final chirp as its ``post`` tables).  Raises
    :class:`RawFastUnavailable` where K13 does not take a leaf."""
    routes: dict = {}
    # a loop, not a recursive closure: a closure that calls itself is a
    # reference cycle, which would keep what it holds alive until the
    # cyclic garbage collector runs
    todo = [plan0]
    while todo:
        p = todo.pop()
        if p.level in (Level.DIRECT, Level.FUSED):
            mode = cuda_chain.leaf_mode(p)
            if mode == "chain" and not cuda_chain.chain_fits(p):
                raise RawFastUnavailable(
                    f"FUSED plan {p.describe()} is a factor chain the chain "
                    f"kernel K13 does not take (more than "
                    f"{cuda_chain.MAX_FACTORS} factors, or a tile past "
                    f"{cuda_chain.CHAIN_TILE_MAX} points after its first "
                    "factor)")
            routes[p.n] = mode
        elif p.level == Level.GLOBAL:
            if cuda_global.global2_supported(p, config.direct_threshold):
                routes[p.n] = "global2"
            else:
                routes[p.n] = "generic"
                todo += [p.sub[1], p.sub[0]]
        elif (cuda_bluestein.supported(p, config)
              and max(s.n for s in p.conv.sub) <= GLOBAL_SUB_MAX):
            routes[p.n] = ("bluestein_bf" if cuda_bluestein.bf_mode(p)
                           else "bluestein")
        else:  # K15's gate declines the plan, or its tile a sub past the max
            routes[p.n] = "generic"
            todo.append(p.conv)
    return routes


def plane_steps(committed, plans, routes: dict) -> dict:
    """``{(n, sign): (kind, kernel, args)}``: the kernel of every node of
    the trees of ``plans`` that runs one (K13 ``cuda_chain.chain``, K14
    ``cuda_global.global2_planes``, K15 ``cuda_bluestein.bluestein`` or
    K15-bf ``cuda_bluestein.bluestein_bf``),
    in both directions (a Bluestein transform runs its convolution both
    ways), with the committed plan's device tables."""
    keys, arrays = committed._bank_keys, committed._bank_arrays
    steps = {}
    todo = list(plans)  # a loop, for the reason given in plane_routes
    while todo:
        p = todo.pop()
        kind = routes.get(p.n, "generic")
        for sign in (-1, +1):
            if kind in ("bluestein", "bluestein_bf"):
                steps[(p.n, sign)] = (kind, getattr(cuda_bluestein, kind), (
                    cuda_bluestein.bluestein_tables(
                        p, sign, keys, arrays, bf=kind == "bluestein_bf"),))
            elif kind == "global2":
                steps[(p.n, sign)] = (kind, cuda_global.global2_planes, (
                    cuda_global.global2_tables(p, sign, keys, arrays),))
            elif kind != "generic":
                steps[(p.n, sign)] = (kind, cuda_chain.chain, (
                    cuda_chain.chain_tables(p, sign, keys, arrays),))
        if kind == "generic":
            todo += p.sub or (p.conv,)
    return steps


def leaf_hook(steps: dict, plain: bool = False):
    """The executor's ``leaf_fn`` (``torch_exec.exec_plan``): the kernel of
    a node's step (its plain version if ``plain``), None for a generic
    node.  K14 and K15 fold the scale in (K14 also ``post``); after K13 it
    is one torch multiply.  Only K14 takes ``post`` (as the JAX package's
    ``leaf_dispatch``): other nodes given one return None.  The copy that
    makes a moved axis's rows contiguous, and the multiply, count as glue
    bytes (``torch_exec.copied``).  A DIRECT or
    FUSED node without a step is a routing fault and raises: no torch
    chain stands in for K13."""

    def leaf_fn(xr, xi, plan, sign, bank, post=None, scale=1.0):
        step = steps.get((plan.n, sign))
        if step is None:
            if plan.level in (Level.DIRECT, Level.FUSED):
                raise AssertionError(f"no kernel step for {plan.describe()}")
            return None
        kind, kernel, args = step
        if post is not None and kind != "global2":
            return None
        fn = kernel.plain if plain else kernel
        x2r = torch_exec.copied(xr, xr.reshape(-1, plan.n).contiguous())
        x2i = torch_exec.copied(xi, xi.reshape(-1, plan.n).contiguous())
        if kind == "global2":
            yr, yi = fn(x2r, x2i, *args, scale=scale, post=post)
        elif kind in ("bluestein", "bluestein_bf"):
            yr, yi = fn(x2r, x2i, *args, scale=scale)
        else:
            yr, yi = fn(x2r, x2i, *args)
            if scale != 1.0:
                yr = torch_exec.copied(yr, yr * scale)
                yi = torch_exec.copied(yi, yi * scale)
        return yr.reshape(xr.shape), yi.reshape(xi.shape)

    return leaf_fn


def _side(d, direction, block: Layout):
    """How an entry reaches one domain's buffer: the offset of the block
    its inner kernels read or write as it is (the domain is in the
    ``block`` layout, or its :class:`Rows` are contiguous), or the
    domain's :class:`Rows`, which K7 de/restrides."""
    if len(d.lengths) > 1 or get_layout(d, direction) == block:
        return d.get_offset(direction)
    rows = rows_1d(d, direction)
    return rows.offset if rows.contiguous else rows


def _with_layout(d, entries: dict, block: Layout = Layout.PACKED) -> dict:
    """``entries`` (inner entries on ``block`` buffers at offset 0) as the
    descriptor's layouts need them: an inner entry as it is where both of
    its buffers are such blocks at offset 0, else ``("layout", inner, src,
    dst)`` with ``_side`` of the input and the output domain."""
    out = {}
    for direction, inner in entries.items():
        src, dst = _side(d, direction, block), _side(d, _inv(direction), block)
        out[direction] = inner if src == 0 and dst == 0 else (
            "layout", inner, src, dst)
    return out


def _register_core(committed, split: bool) -> dict:
    """Entries of a transform on the plane path's per-axis walk
    (``torch_exec.core_inner``): ``("core", split, batch, sign, scale,
    k12, routes)``.  ``k12`` is ``((axis, mode), ...)`` for the outer axes
    the column kernel K12 takes (``cuda_axis.axis_m2_mode`` of the axis
    and the product of the axes after it); every other axis runs through
    the executor, on ``routes`` (``plane_routes`` of its plan).  SPLIT
    entries take and give (re, im) planes; interleaved ones run K6 around
    the walk and fold the scale into the interleave."""
    d = committed.descriptor
    lengths, plans = list(d.lengths), committed.plans
    k12, routes = [], {}
    for axis, n in enumerate(lengths):
        if n == 1:
            continue
        mode = None if axis == len(lengths) - 1 else cuda_axis.axis_m2_mode(
            plans[n], math.prod(lengths[axis + 1:]))
        if mode is None:
            routes.update(plane_routes(plans[n], committed.config))
        else:
            k12.append((axis, mode))
    return {
        direction: ("core", split, d.number_of_transforms, sign,
                    float(d.get_scale(direction)), tuple(k12), routes)
        for direction, sign in _SIGNS.items()
    }


def _col_axis_ok(plan, config) -> bool:
    return cuda_multidim.col_axis_supported(plan, config.direct_threshold)


def _col_kernel(plan, params: dict) -> str:
    """The column kernel of an axis under tuning parameters: K10-mm
    (``"col_mm"``) for ``{"cm": 1}`` where its gate takes the plan, else
    K10 (``"col"``)."""
    if params.get("cm") and cuda_multidim.col_mm_supported(plan):
        return "col_mm"
    return "col"


def _step_sign(step) -> int:
    """The sign of a multi-dim step: a K10, K10-mm or K11 step, or a 1D
    entry."""
    return step[4] if step[0] in ("col", "col_mm", "md2") else step[3]


def _register_multidim(committed, params: dict | None = None) -> dict:
    """Entries of a multi-dimensional C2C transform: ``("multidim", md2,
    steps)``, the steps in the order they run (see the module docstring).
    A column step is ``("col", bpre, plan, rest, sign, scale)`` (K10) or
    ``("col_mm", ...)`` (K10-mm), the K11 step ``("md2", batch, plan1,
    plan2, sign, scale)``, a row step a 1D entry.  ``params`` are the
    ``multidim`` tuning parameters (default: the tuning table's for the
    shape): ``{"m2": 0}`` turns K11 off, ``{"cm": 1}`` takes K10-mm.
    Where K10 does not take an outer axis or the last axis needs the plane
    path, the transform runs on the plane path's per-axis walk
    (``_register_core``), as the JAX package's ``_traced_interleaved``."""
    d = committed.descriptor
    lengths, plans = list(d.lengths), committed.plans
    batch = d.number_of_transforms
    if not all(_col_axis_ok(plans[ln], committed.config)
               for ln in lengths[:-1] if ln > 1) or _raw_entry(
                   plans[lengths[-1]], 1, -1, 1.0) is None:
        return _register_core(committed, split=False)
    if params is None:
        params = _counted_lookup(committed, "multidim")
    total = batch * math.prod(lengths)
    plan_last = plans[lengths[-1]]
    plan_a = plans[lengths[-2]] if lengths[-2] > 1 else None
    md2 = plan_a is not None and params.get("m2", 1) != 0 and (
        cuda_multidim.md2_supported(plan_a, plan_last, committed.config))
    first = len(lengths) - (3 if md2 else 2)
    cols = [
        (plans[lengths[ax]], batch * math.prod(lengths[:ax]),
         math.prod(lengths[ax + 1:]))
        for ax in range(first, -1, -1)
        if lengths[ax] > 1
    ]
    out: dict = {}
    for direction, sign in _SIGNS.items():
        scale = float(d.get_scale(direction))
        # the scale goes into the last kernel that runs
        head_scale = 1.0 if cols else scale
        if md2:
            n2d = lengths[-2] * lengths[-1]
            head = ("md2", total // n2d, plan_a, plan_last, sign, head_scale)
        else:
            head = _raw_entry(plan_last, total // lengths[-1], sign, head_scale)
        steps = [head] + [
            (_col_kernel(plan, params), bpre, plan, rest, sign,
             scale if i == len(cols) - 1 else 1.0)
            for i, (plan, bpre, rest) in enumerate(cols)
        ]
        out[direction] = ("multidim", md2, tuple(steps))
    return out


#: Shortest REAL length whose C2R keeps Im X[0] and Im X[n/2]: the JAX
#: package banks its retangle table (``R``) from n = 1024 on and uses both
#: parts there; below it runs a C2C of the Hermitian extension and keeps the
#: real part, which drops them (``committed._core_real_backward``).
REAL_KEEP_MIN_N = 1024


def _register_real(committed) -> dict:
    """Entries of a 1D REAL transform: ``(kind, n, batch, sign, scale)``
    for the small path; for the half-length path ``("realf", c2c_entry, h,
    batch, sign, scale)`` and ``("realb", c2c_entry, h, batch, sign, scale,
    drop)``, whose C2C entry runs at scale 1; where the half length needs
    the plane path, ``("realplane", plane_entry, h, batch, sign, scale,
    kernel, drop)``: ``kernel`` the un/retangle that runs (``"untangle"``
    K8a, ``"untangle_wide"`` K8a-w where ``cuda_real.wide_supported`` takes the
    shape, ``"retangle"`` K8b).  ``drop`` (backward) is K8b's flag: Im X[0]
    and Im X[n/2] read as 0 below ``REAL_KEEP_MIN_N``, as the JAX package."""
    d = committed.descriptor
    if len(d.lengths) >= 2:
        raise RawFastUnavailable(
            "multi-dimensional REAL transforms are not ported yet "
            "(ROADMAP Queue 1 item 9)"
        )
    if d.placement == Placement.IN_PLACE:
        raise RawFastUnavailable(
            "in-place REAL transforms (the FFTW padded layout) are not "
            "ported yet (ROADMAP Queue 1 item 9)"
        )
    if d.complex_storage != ComplexStorage.INTERLEAVED_COMPLEX:
        raise RawFastUnavailable(
            "SPLIT_COMPLEX REAL transforms are not ported yet "
            "(ROADMAP Queue 1 item 9)"
        )
    for direction in _SIGNS:
        if d.get_offset(direction) or get_layout(d, direction) != Layout.PACKED:
            raise RawFastUnavailable(
                "REAL transforms with buffer offsets or strided layouts are "
                "not ported yet (ROADMAP Queue 1 item 9): the JAX package "
                "runs them through its REAL plane path, which on C2R drops "
                f"Im X[0] and Im X[n/2] below n = {REAL_KEEP_MIN_N} and "
                "uses them from there on, as the packed route here does")
    n, batch = d.lengths[0], d.number_of_transforms
    h = n // 2
    plan_h = committed.plans[h] if n > SMALL_REAL_MAX_N else None
    # the half-length transform takes the tuned engine of its own length
    engine, bt = (_tuned_engine(committed, plan_h, batch)
                  if plan_h is not None else (None, 0))
    routes = (plane_routes(plan_h, committed.config)
              if plan_h is not None and _raw_entry(plan_h, 1, -1, 1.0) is None
              else None)
    drop = n < REAL_KEEP_MIN_N
    out: dict = {}
    for direction, sign in _SIGNS.items():
        scale = float(d.get_scale(direction))
        forward = direction == Direction.FORWARD
        if plan_h is None:
            out[direction] = ("realsf" if forward else "realsb", n, batch,
                              sign, scale)
        elif routes is not None:
            inner = ("plane", plan_h, batch, sign, 1.0, routes)
            kernel = ("retangle" if not forward else "untangle_wide"
                      if cuda_real.wide_supported(n, batch) else "untangle")
            out[direction] = ("realplane", inner, h, batch, sign, scale,
                              kernel, drop)
        elif forward:
            out[direction] = ("realf", _raw_entry(plan_h, batch, sign, 1.0,
                                                  engine, bt),
                              h, batch, sign, scale)
        else:
            out[direction] = ("realb", _raw_entry(plan_h, batch, sign, 1.0,
                                                  engine, bt),
                              h, batch, sign, scale, drop)
    return out


def register(committed) -> dict:
    """The per-direction entry table of a committed plan.  Raises
    :class:`RawFastUnavailable` for every descriptor outside the slice."""
    d = committed.descriptor
    if committed.precision.name != "float32":
        raise RawFastUnavailable(
            "fp64 transforms are not ported yet (ROADMAP Queue 1 item 12)"
        )
    if d.domain == Domain.REAL:
        return _register_real(committed)
    if d.complex_storage == ComplexStorage.SPLIT_COMPLEX:
        # the JAX package's raw registry never takes SPLIT: its planes go
        # straight into the per-axis walk, with no K6
        return _with_layout(d, _register_core(committed, split=True))
    if len(d.lengths) >= 2:
        return _with_layout(d, _register_multidim(committed))
    plan0 = committed.plans[d.lengths[0]]
    batch = d.number_of_transforms
    bi = Layout.BATCH_INTERLEAVED
    if (get_layout(d, Direction.FORWARD) == bi == get_layout(d, Direction.BACKWARD)
            and _col_axis_ok(plan0, committed.config)):
        # the (n, batch) buffer is one column transform with bpre = 1, on
        # the column kernel of the bi_col tuning kind
        params = _counted_lookup(committed, "bi_col")
        kernel = _col_kernel(plan0, params)
        return _with_layout(d, {
            direction: ("bi_col", 1, plan0, batch, sign,
                        float(d.get_scale(direction)), kernel)
            for direction, sign in _SIGNS.items()
        }, bi)
    engine, bt = _tuned_engine(committed, plan0, batch)
    out = {}
    for direction, sign in _SIGNS.items():
        scale = float(d.get_scale(direction))
        out[direction] = _raw_entry(plan0, batch, sign, scale, engine, bt)
    if out[Direction.FORWARD] is None:
        routes = plane_routes(plan0, committed.config)
        out = {
            direction: ("plane", plan0, batch, sign,
                        float(d.get_scale(direction)), routes)
            for direction, sign in _SIGNS.items()
        }
    return _with_layout(d, out)


def kernel_args(committed, entry):
    """``(kernel, args)`` of an entry: the wrapper (``cuda_fft.direct``,
    the ``fused2`` entry's engine ``cuda_fft.fused2``/``fused2_v1``/
    ``fused2_v2``/``fused2_v3``, the ``global2`` entry's, ``cuda_real.small_real``,
    ``cuda_multidim.col`` or ``col_mm`` for ``bi_col`` and a column step,
    ``cuda_multidim.md2`` for a K11 step, or for the half-length REAL
    entries ``cuda_real.untangle``/``retangle``) and the arguments that
    follow the buffer, with the committed plan's device tables.  A
    half-length REAL entry's C2C kernel is ``kernel_args(committed,
    entry[1])``; a multi-dim entry's are those of its steps,
    ``entry[2]``."""
    kind = entry[0]
    keys, arrays = committed._bank_keys, committed._bank_arrays
    if kind in ("col", "col_mm", "bi_col"):
        _, bpre, plan, rest, sign, scale = entry[:6]
        kernel = getattr(cuda_multidim, entry[6] if kind == "bi_col" else kind)
        return kernel, (
            bpre, rest, cuda_fft.sub_tables(plan, sign, keys, arrays), scale
        )
    if kind == "md2":
        _, batch, plan1, plan2, sign, scale = entry
        return cuda_multidim.md2, (
            batch, cuda_fft.sub_tables(plan1, sign, keys, arrays),
            cuda_fft.sub_tables(plan2, sign, keys, arrays), scale,
        )
    if kind in ("realsf", "realsb"):
        _, n, batch, sign, scale = entry
        w, m = keys[("W", n, sign)], keys[("RM", n, sign)]
        return cuda_real.small_real, (batch, cuda_real.SmallRealTables(
            n, sign, scale, arrays[w + "r"], arrays[w + "i"], arrays[m + "m"]
        ))
    if kind in ("realf", "realb", "realplane"):
        _, _, h, batch, sign, scale = entry[:6]
        r = keys[("R", 2 * h, sign)]
        args = (batch, h, arrays[r + "r"], arrays[r + "i"], scale)
        if sign > 0:  # K8b, with its flag
            return cuda_real.retangle, (*args, entry[-1])
        name = entry[6] if kind == "realplane" else "untangle"
        return getattr(cuda_real, name), args
    if kind == "global2":
        _, plan0, batch, sign, scale, engine = entry
        if engine in ("global_bf", "global_bf_ov", "global_bf2", "global_ilv"):
            kernel = (cuda_global_ilv.global_ilv if engine == "global_ilv"
                      else getattr(cuda_global_bf, engine))
            return kernel, (batch, cuda_global_bf.bf_tables(
                plan0, sign, keys, arrays, batch,
                resident=engine == "global_bf2"), scale)
        if engine in ("global_fused", "global_fused_ftw"):
            return cuda_global.global_fused, (batch, cuda_global.global_fused_tables(
                plan0, sign, keys, arrays, batch,
                ftw=engine == "global_fused_ftw"), scale)
        if engine == "global3":
            return cuda_global.global3, (batch, cuda_global.global3_tables(
                plan0, sign, keys, arrays), scale)
        if engine == "global2_ftw":
            return cuda_global.global2_ftw, (batch, cuda_global.global2_ftw_tables(
                plan0, sign, keys, arrays), scale)
        g1, g2 = plan0.sub
        t = keys[("T", g1.n, g2.n, sign)]
        return getattr(cuda_global, engine), (
            batch,
            cuda_fft.sub_tables(g1, sign, keys, arrays),
            cuda_fft.sub_tables(g2, sign, keys, arrays),
            arrays[t + "r"], arrays[t + "i"], scale,
        )
    if kind == "fused2":
        _, plan0, batch, sign, scale, engine, bt = entry
        sub = cuda_fft.sub_tables(plan0, sign, keys, arrays)
        if engine in ("fused2_v2", "fused2_v3"):
            # the tile is fixed here, so the plain version tiles as the kernel
            bt = bt or cuda_fft.pick_tile(engine, plan0.factors[0], batch)
            return getattr(cuda_fft, engine), (batch, sub, bt, scale)
        return getattr(cuda_fft, engine), (batch, sub, scale)
    _, plan0, batch, sign, scale = entry
    return cuda_fft.direct, (batch, cuda_fft.sub_tables(plan0, sign, keys, arrays),
                             scale)


def plane_fn(committed, entry, plain: bool = False):
    """``fn(raw, out=None) -> tensor`` of a plane entry: K6 deinterleave,
    the executor (``torch_exec.exec_plan``) with the route's K13, K14 and
    K15 steps as its leaf hook, and K6 interleave with the direction's scale
    into ``out`` (for IN_PLACE the caller's buffer, which the deinterleave
    has already read).  ``plain`` chains the plain versions instead (the
    CPU path, and ``chip_smoke.py``'s yardstick on the card)."""
    _, plan0, batch, sign, scale, routes = entry
    n = plan0.n
    leaf = leaf_hook(plane_steps(committed, [plan0], routes), plain)
    keys, arrays = committed._bank_keys, committed._bank_arrays

    def walk(xr, xi):
        args = (xr.view(batch, n), xi.view(batch, n), plan0, sign, keys, arrays,
                leaf)
        if PROFILER._is_profiler_enabled:
            return tracing.run("portfft.exec", torch_exec.exec_plan, *args)
        return torch_exec.exec_plan(*args)

    return _interleaved(walk, scale, plain)


def _interleaved(walk, scale: float, plain: bool):
    """``fn(raw, out=None)``: K6 deinterleave, ``walk`` on the planes, and
    K6 interleave with the direction's scale into ``out`` (for IN_PLACE
    the caller's buffer, which the deinterleave has already read)."""
    de = cuda_io.deinterleave.plain if plain else cuda_io.deinterleave

    def fn(raw, out=None):
        yr, yi = walk(*de(raw))
        yr, yi = yr.reshape(-1), yi.reshape(-1)
        if not plain:
            return cuda_io.interleave(yr, yi, scale, out=out)
        y = cuda_io.interleave.plain(yr, yi, scale)
        return y if out is None else out.copy_(y)

    return fn


def _column(k, bpre, trailing, sub, xr, xi, s):
    """K12 (or its plain version ``k``) on one outer axis of (b, L1, L2)
    planes, times ``s``."""
    return k(xr.contiguous(), xi.contiguous(), bpre, trailing, sub, s)


def core_fn(committed, entry, plain: bool = False):
    """The function of a ``"core"`` entry (``_register_core``): the
    per-axis walk ``torch_exec.core_inner`` on (batch, *lengths) planes,
    with K12 (``cuda_axis.axis_m2``) on the outer axes it takes and the
    route's K13, K14 and K15 steps as the executor's leaf hook.  SPLIT:
    ``fn(xr, xi) -> (yr, yi)`` on flat planes, the scale in the last
    kernel that takes one (K12, K14 pass 2, K15 pass 3) or else one torch
    multiply; interleaved: ``fn(raw, out=None)`` with K6 around the walk
    and the scale in the interleave.  ``plain`` chains the plain versions
    instead."""
    _, split, batch, sign, scale, k12, routes = entry
    d = committed.descriptor
    lengths, plans = list(d.lengths), committed.plans
    keys, arrays = committed._bank_keys, committed._bank_arrays
    walked = [plans[n] for n in set(lengths) if n in routes]
    leaf = leaf_hook(plane_steps(committed, walked, routes), plain)
    k = cuda_axis.axis_m2.plain if plain else cuda_axis.axis_m2
    columns = {}
    for axis, _ in k12:
        sub = cuda_fft.sub_tables(plans[lengths[axis]], sign, keys, arrays)
        columns[axis] = functools.partial(
            _column, k, batch * math.prod(lengths[:axis]),
            math.prod(lengths[axis + 1:]), sub)
    shape = (batch, *lengths)

    def walk(xr, xi, s=1.0):
        args = (xr.view(shape), xi.view(shape), lengths, plans, sign, keys,
                arrays, leaf, columns, s)
        if PROFILER._is_profiler_enabled:
            return tracing.run("portfft.exec", torch_exec.core_inner, *args)
        return torch_exec.core_inner(*args)

    if not split:
        return _interleaved(walk, scale, plain)

    def fn(xr, xi):
        yr, yi = walk(xr, xi, scale)
        return yr.reshape(-1), yi.reshape(-1)

    return fn


def packed_fn(committed, entry, plain: bool = False):
    """``fn(x, out=None)`` of a C2C entry on its own buffers at offset 0
    (PACKED, or the BATCH_INTERLEAVED block of ``bi_col``): interleaved,
    ``x`` is the raw input of exactly the input count and ``out`` (may be
    ``x``) receives the result, else a new tensor; SPLIT (``"core"``),
    ``x`` is the (re, im) pair and the result new planes.  A multi-dim
    entry runs its first step into ``out`` and the rest in place on its
    result.  ``plain`` chains the plain versions instead (the CPU path,
    and ``chip_smoke.py``'s yardstick on the card)."""
    kind = entry[0]
    if kind == "plane":
        return plane_fn(committed, entry, plain)
    if kind == "core":
        walk = core_fn(committed, entry, plain)
        return walk if not entry[1] else lambda x, out=None: walk(*x)
    steps = [kernel_args(committed, s)
             for s in (entry[2] if kind == "multidim" else (entry,))]

    def fn(raw, out=None):
        x = raw
        for i, (kernel, args) in enumerate(steps):
            target = out if i == 0 else x
            if plain:
                x = cuda_fft.into(target, kernel.plain(x, *args))
            else:
                x = kernel(x, *args, out=target)
        return x

    return fn


def layout_fn(committed, entry, plain: bool = False):
    """``fn(x, out=None)`` of a ``("layout", inner, src, dst)`` entry (see
    ``build_fn``): the input side as a view of ``x`` at its offset (``src``
    an int) or K7 ``destride`` of its :class:`Rows`, the inner entry on
    packed buffers, and the output side likewise: the inner entry writes
    straight into the view of ``out`` at ``dst`` where it can, else K7
    ``restride`` (zeroing every other element of a buffer it allocates)
    or a copy into that view.  IN_PLACE reads all input before writing any
    output: the inner entry runs in place only on the very view it reads
    or on K7's scratch, and otherwise into a new buffer that is then
    copied or restrided into the caller's."""
    _, inner, src, dst = entry
    d = committed.descriptor
    split = d.complex_storage == ComplexStorage.SPLIT_COMPLEX
    in_place = d.placement == Placement.IN_PLACE
    total = d.number_of_transforms * math.prod(d.lengths)
    width = 1 if split else 2
    run = packed_fn(committed, inner, plain)
    de, re = cuda_stride.destride, cuda_stride.restride
    if plain:
        de, re = de.plain, re.plain
    strided_in, strided_out = isinstance(src, Rows), isinstance(dst, Rows)
    count = dst.index_bound() + 1 if strided_out else dst + total
    # the inner entry writes the caller's view itself (interleaved only:
    # the SPLIT walk returns new planes)
    direct = not split and not strided_out and not (in_place and src != dst)

    def view(buf, offset):
        if split:
            return tuple(p[offset:offset + total] for p in buf)
        return buf[width * offset:width * (offset + total)]

    def fn(x, out=None):
        xin = de(x, *dataclasses.astuple(src)) if strided_in else view(x, src)
        new = out is None
        if new:
            if split and dst == 0:
                return run(xin)
            dev = (x[0] if split else x).device
            bufs = [torch.empty(width * count, dtype=torch.float32, device=dev)
                    for _ in range(2 if split else 1)]
            if not strided_out:  # restride with fill_gaps zeroes its own
                for b in bufs:
                    b[:width * dst].zero_()
            out = tuple(bufs) if split else bufs[0]
        if direct:
            run(xin, out=view(out, dst))
            return out
        # K7's scratch is the inner entry's to overwrite
        y = run(xin, out=xin if strided_in and not split else None)
        if strided_out:
            return re(y, *dataclasses.astuple(dst), out, fill_gaps=new)
        for o, p in zip(_planes(view(out, dst)), _planes(y)):
            o.copy_(p)
        return out

    return fn


def _planes(buf) -> tuple:
    return buf if isinstance(buf, tuple) else (buf,)


def half_c2c_fn(committed, sub, plain: bool = False):
    """``fn(raw, out=None)`` of the C2C entry under a half-length REAL
    entry (``entry[1]``): a raw kernel entry, or a plane entry
    (``plane_fn``); ``plain`` runs the plain versions."""
    if sub[0] == "plane":
        return plane_fn(committed, sub, plain)
    kernel, args = kernel_args(committed, sub)
    if plain:
        return lambda x, out=None: cuda_fft.into(out, kernel.plain(x, *args))
    return lambda x, out=None: kernel(x, *args, out=out)


def build_fn(committed, entry, plain: bool = False):
    """The function of an entry.  C2C: ``fn(x, out=None)``, where ``x`` is
    the caller's whole input buffer on the plan's device (a flat float32
    tensor of raw (re, im) pairs, or for SPLIT_COMPLEX a (re, im) pair of
    flat float32 planes), at least the input count long; ``out``, of the
    same kind, is the output buffer (``x`` itself for IN_PLACE), at least
    the output count long, whose elements outside the output layout are
    left as they are, or None for a new buffer of exactly the output count
    that is zero wherever no result lands.  Returns the output buffer.
    REAL: ``fn(raw)`` on exactly the input count, returning a new buffer.
    ``plain`` chains the plain versions (the CPU path, and
    ``chip_smoke.py``'s yardstick on the card)."""
    kind = entry[0]
    if kind not in _REAL:
        return layout_fn(committed, entry if kind == "layout"
                         else ("layout", entry, 0, 0), plain)
    kernel, args = kernel_args(committed, entry)
    if plain:
        kernel = kernel.plain
    if kind in ("realsf", "realsb"):
        return lambda raw: kernel(raw, *args)
    c2c = half_c2c_fn(committed, entry[1], plain)
    if entry[4] < 0:

        def fn(raw):
            # the real rows are the h-point input z = x_even + i·x_odd
            return kernel(c2c(raw), *args)

    else:

        def fn(raw):
            z = kernel(raw, *args)
            # the h-point transform of Z, in place, is the real rows
            return c2c(z, out=z)

    return fn
