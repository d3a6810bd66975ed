"""Raw-I/O registry: which kernels run a committed plan.

``register`` fixes, at commit, one route per direction: a record below
whose fields say what runs, the scale where it goes, and the route it
wraps.  Every route runs on its own blocks at offset 0; a :class:`Layout`
reaches any other buffer layout.  Anything outside this slice raises
:class:`RawFastUnavailable` (an :class:`UnsupportedConfiguration`) naming
the ROADMAP Queue 1 item that will port it; nothing is quietly sent down
another path.

| transform | route | kernels, in order |
|---|---|---|
| 1D C2C, a DIRECT, FUSED [a, 128] or GLOBAL plan with DIRECT or FUSED [a, 128] subs | :class:`Raw` | its engine (``engines.ENGINES``): the tuning table's for the plan's ``fused2`` or ``global2`` key, else K1, K2, K3 |
| 1D C2C, any other plan (BLUESTEIN; GLOBAL with another sub; a FUSED chain not [a, 128]) | :class:`Plane` | K6, the executor ``ops/torch_exec.exec_plan`` with each node's kernel (below), K6 with the scale |
| 1D BATCH_INTERLEAVED in both domains, a length K10 takes | :class:`Col` (bpre = 1) | K10, or K10-mm under ``{"cm": 1}`` of the ``bi_col`` kind |
| multi-dim C2C, K11 takes the two trailing plans | :class:`MultiDim` | K11 (:class:`Md2`), then K10 (:class:`Col`) for axes −3 … 0 |
| multi-dim C2C, the per-axis route | :class:`MultiDim` | the last axis's :class:`Raw` (K1–K3), then K10 for axes −2 … 0 |
| SPLIT_COMPLEX, and multi-dim shapes the raw route declines | :class:`Core` | the JAX package's per-axis walk ``_core_inner`` (``torch_exec.core_inner``): K12 on the outer axes its gates take, K13's column form on the others whose leaf it runs in one launch, ``movedim`` + executor + ``movedim`` on the rest; K6 around it interleaved |
| 1D REAL, even n ≤ ``SMALL_REAL_MAX_N`` | :class:`SmallReal` | K9 |
| 1D REAL, longer even n | :class:`HalfReal` | the h = n/2 C2C route (:class:`Raw`, or :class:`Plane`), then K8a or K8a-w; backward K8b first |
| multi-dim REAL, every outer axis one K10 takes | :class:`MultiDim` | the last axis's 1D REAL route (:class:`SmallReal` or :class:`HalfReal`) over batch·∏outer rows, then K10 (:class:`Col`) for axes −2 … 0 in place on the half spectrum, the scale in the last; backward the :class:`Col` steps first, then the 1D REAL route with the scale |
| fp64: 1D REAL of even n ≤ ``SMALL_REAL_MAX_N``, and multi-dim REAL of such a last axis whose outer axes K10 takes in float64 (``cuda_multidim.col_f64_supported``) | :class:`SmallReal`, or :class:`MultiDim` of it and :class:`Col` steps | the fp32 route's kernels in double: K9 and K10 on float64 buffers and tables (K10, never K10-mm) |

fp64 runs only where every step has a double kernel: the REAL routes of K9
and K10 above.  Every other fp64 descriptor raises, naming what it lacks: a
C2C transform (no C2C kernel has a double instantiation), a REAL last axis
past ``SMALL_REAL_MAX_N`` (:class:`HalfReal`: K8a/K8b around a C2C of
n/2), an outer axis K10 takes only in float32, and K10-mm (its three-term
TF32 split is a float32 method).

A multi-dim route takes the ``multidim`` tuning kind: ``{"m2": 0}`` turns
K11 off, ``{"cm": 1}`` puts K10-mm on each column step its gate takes; the
reference's TPU tile knobs ``ct``, ``ds``, ``mt1`` and ``mt2`` are read and
ignored.  Every outer axis must be one K10 takes (DIRECT ≤ 512 or FUSED [a,
128] with a | 128) and the last axis one of K1–K3; a multi-dim REAL
transform whose outer axis K10 declines raises (no per-axis walk for REAL
yet).  The JAX package declines some REAL shapes to its plane path (h not a
multiple of 128, h ≥ 2^15, 512 < n < 1024, batches that do not group), and
walks the outer axes of a multi-dim REAL transform on planes
(``committed._core_real_forward``); the kernels here take them all, the
outer axes on K10 in place on the interleaved half spectrum.  The static
FUSED route is K2 for every [a, 128] plan and batch; the JAX package's
differs (ROADMAP Queue 3): v1 where a has no fold, and its plane path at
batches its tiles decline.

The plane path's node routes are fixed at commit (``plane_routes``) by the
JAX package's ``leaf_dispatch`` gates:

| node | kernel | JAX counterpart |
|---|---|---|
| DIRECT, FUSED [a >= 8, 128], any other FUSED chain | ``cuda_chain.chain`` (K13: its direct, two-stage and chain modes) | ``pallas_fft.fused_chain``, ``_generic_chain_call`` |
| GLOBAL with DIRECT or FUSED [a, 128] subs, a dividing 128 (``cuda_global.global2_supported``) | ``cuda_global.global2_planes`` (K14) | ``pallas_global.global2_call`` |
| BLUESTEIN with a GLOBAL convolution (``cuda_bluestein.supported``) whose subs fit K15's tile | ``cuda_bluestein.bluestein`` (K15), or with ``PORTFFT_BLUESTEIN_BF`` set at commit and both subs A·128, A = 2^a·3^b ≤ 16, ``cuda_bluestein.bluestein_bf`` (K15-bf, its butterfly mode) | ``pallas_bluestein.bluestein_call`` (its butterfly mode under the same flag) |
| other BLUESTEIN, other GLOBAL | the executor's glue around the kernels of its nodes; a Bluestein convolution on K14 takes b̂ and the final chirp as ``post`` tables | ``xla_fft._exec_bluestein``, ``exec_plan`` |

The per-axis walk's copies that move an axis and put it back count as glue
bytes (``tracing.glue_bytes``), and each axis is a ``portfft.axis`` span
under a profiler, as is each step of a :class:`MultiDim` (``step_notes``).
Where the scale goes on the plane path and the walk:

| route of the last axis that runs | scale |
|---|---|
| K12, K13's column form | in the kernel |
| K14 (its node, or a Bluestein convolution with ``post``) | K14's pass 2 |
| K15 | K15's pass 3 |
| K13, generic GLOBAL or Bluestein | one torch multiply after it |
| any, interleaved (:class:`Plane` and :class:`Core`) | K6's interleave |

Buffer layouts (the JAX package's ``strided1d`` entry, without its TPU
tile gates; ``_with_layout``):

| a domain's buffer | side | how the inner route reaches it |
|---|---|---|
| the inner route's block at an offset (any rank; PACKED, or BI for a :class:`Col`) | the offset, an int | a contiguous view at the offset; the inner kernels read it, and write it where they can |
| any other 1D layout: strides, distances, BATCH_INTERLEAVED in one domain or over a length K10 declines | its ``utils.layout.Rows`` | ``cuda_stride.destride`` (K7) into packed rows; ``cuda_stride.restride`` (K7) back |

The direction's scale stays in the inner route, so K7 is a pure copy.  The
REAL routes take only PACKED buffers at offset 0.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import ClassVar

import torch

from . import tuning
from .engines import ENGINES, GLOBAL_SUB_MAX, Engine, RawFastUnavailable
from .engines import engine_of, raw_kind
from .enums import ComplexStorage, Direction, Domain, Level, Placement
from .enums import Layout as BufferLayout
from .enums import inv as _inv
from .ops import (
    cuda_axis,
    cuda_bluestein,
    cuda_chain,
    cuda_fft,
    cuda_global,
    cuda_io,
    cuda_multidim,
    cuda_real,
    cuda_stride,
    torch_exec,
)
from .planner import Plan1D
from .utils import logging as plog
from .utils import tracing
from .utils.layout import Rows, get_layout, rows_1d
from .utils.tracing import PROFILER

_SIGNS = {Direction.FORWARD: -1, Direction.BACKWARD: +1}

#: Longest REAL transform K9 takes whole; longer even lengths run the
#: half-length path.  The JAX package's limit (``pallas_real``) too.
SMALL_REAL_MAX_N = 512

#: Shortest REAL length whose C2R keeps Im X[0] and Im X[n/2]: the JAX
#: package banks its retangle table (``R``) from n = 1024 on and uses both
#: parts there; below it runs a C2C of the Hermitian extension and keeps the
#: real part, which drops them (``committed._core_real_backward``).
REAL_KEEP_MIN_N = 1024


# -- routes -------------------------------------------------------------------


class Route:
    """A committed route.  ``tuning_kind`` names the tuning kind
    ``autotune`` races on it (None: nothing to race); a wrapper route
    (:class:`Layout`, :class:`HalfReal`) has none and holds its ``inner``
    route."""

    tuning_kind: ClassVar[str | None] = None


@dataclasses.dataclass(frozen=True)
class Raw(Route):
    """One 1D PACKED transform of ``batch`` rows on the raw interleaved
    buffer by ``engine`` (:mod:`engines`), at the batch tile ``bt`` (0: the
    kernel picks)."""

    plan: Plan1D
    batch: int
    sign: int
    scale: float
    engine: Engine
    bt: int = 0

    @property
    def tuning_kind(self) -> str | None:
        return None if self.engine.kind == "direct" else self.engine.kind

    def kernel_args(self, committed) -> tuple:
        """``(kernel, args after the buffer)``."""
        tables = self.engine.tables(self.plan, self.sign, committed._bank_keys,
                                    committed._bank_arrays, self.batch, self.bt)
        return self.engine.kernel, (self.batch, *tables, self.scale)


@dataclasses.dataclass(frozen=True)
class Col(Route):
    """A column transform of ``plan`` over (``bpre``, L, ``rest``) rows on
    ``kernel``: ``"col"`` (K10) or ``"col_mm"`` (K10-mm).  A multi-dim
    step, or with ``bpre`` = 1 and ``rest`` the batch the whole 1D
    BATCH_INTERLEAVED transform (the ``bi_col`` tuning kind)."""

    tuning_kind: ClassVar[str] = "bi_col"

    kernel: str
    bpre: int
    plan: Plan1D
    rest: int
    sign: int
    scale: float

    def kernel_args(self, committed) -> tuple:
        return getattr(cuda_multidim, self.kernel), (
            self.bpre, self.rest, cuda_fft.sub_tables(
                self.plan, self.sign, committed._bank_keys,
                committed._bank_arrays), self.scale)


@dataclasses.dataclass(frozen=True)
class Md2(Route):
    """K11 (``cuda_multidim.md2``) on ``batch`` trailing 2D transforms of
    ``plan1`` × ``plan2``: a multi-dim step."""

    batch: int
    plan1: Plan1D
    plan2: Plan1D
    sign: int
    scale: float

    def kernel_args(self, committed) -> tuple:
        keys, arrays = committed._bank_keys, committed._bank_arrays
        return cuda_multidim.md2, (
            self.batch, cuda_fft.sub_tables(self.plan1, self.sign, keys, arrays),
            cuda_fft.sub_tables(self.plan2, self.sign, keys, arrays), self.scale)


@dataclasses.dataclass(frozen=True)
class MultiDim(Route):
    """A multi-dimensional transform: ``steps`` in the order they run, the
    first out of place and the rest in place on its result.  C2C: an
    :class:`Md2` or a :class:`Raw`, then :class:`Col` steps.  REAL: forward
    the last axis's :class:`SmallReal` or :class:`HalfReal`, then
    :class:`Col` steps on the half spectrum; backward the reverse (the REAL
    step makes its own output)."""

    tuning_kind: ClassVar[str] = "multidim"

    steps: tuple


@dataclasses.dataclass(frozen=True)
class Plane(Route):
    """One 1D transform of ``batch`` rows on the plane path (``plane_fn``),
    its nodes on ``routes`` (``plane_routes``)."""

    plan: Plan1D
    batch: int
    sign: int
    scale: float
    routes: dict


@dataclasses.dataclass(frozen=True)
class Core(Route):
    """A transform on the plane path's per-axis walk (``core_fn``): SPLIT
    (``split``, planes in and out) or interleaved with K6 around it.
    ``columns`` is ``((axis, kernel), ...)`` for the outer axes a column
    kernel takes where they lie: ``"K12"`` (``cuda_axis.axis_m2``) or
    ``"K13col"`` (K13's column form, ``cuda_chain.chain_cols``); every other
    axis runs through the executor on ``routes``."""

    split: bool
    batch: int
    sign: int
    scale: float
    columns: tuple
    routes: dict


@dataclasses.dataclass(frozen=True)
class Layout(Route):
    """The ``inner`` route on buffers laid out otherwise than its own
    blocks at offset 0: ``src`` (input) and ``dst`` (output) are each an
    offset or the domain's :class:`Rows` (``_side``)."""

    inner: Route
    src: object
    dst: object


@dataclasses.dataclass(frozen=True)
class SmallReal(Route):
    """A REAL transform of even ``n`` ≤ ``SMALL_REAL_MAX_N`` on K9
    (``cuda_real.small_real``), forward for ``sign`` −1."""

    n: int
    batch: int
    sign: int
    scale: float

    def kernel_args(self, committed) -> tuple:
        keys, arrays = committed._bank_keys, committed._bank_arrays
        w, m = keys[("W", self.n, self.sign)], keys[("RM", self.n, self.sign)]
        return cuda_real.small_real, (self.batch, cuda_real.SmallRealTables(
            self.n, self.sign, self.scale, arrays[w + "r"], arrays[w + "i"],
            arrays[m + "m"]))


@dataclasses.dataclass(frozen=True)
class HalfReal(Route):
    """A REAL transform of n = 2h: the ``inner`` C2C route of h at scale 1
    (a :class:`Raw` or a :class:`Plane`) and ``tangle``, the kernel that
    applies the scale: ``"untangle"`` (K8a) or ``"untangle_wide"`` (K8a-w)
    after it forward, ``"retangle"`` (K8b) before it backward.  ``drop`` is
    K8b's flag: Im X[0] and Im X[n/2] read as 0 below ``REAL_KEEP_MIN_N``,
    as the JAX package."""

    inner: Route
    h: int
    batch: int
    sign: int
    scale: float
    tangle: str
    drop: bool

    def kernel_args(self, committed) -> tuple:
        """The un/retangle kernel and its arguments after the buffer."""
        r = committed._bank_keys[("R", 2 * self.h, self.sign)]
        arrays = committed._bank_arrays
        return getattr(cuda_real, self.tangle), (
            self.batch, self.h, arrays[r + "r"], arrays[r + "i"], self.scale,
            *((self.drop,) if self.tangle == "retangle" else ()))


# -- engines of the fused2 and global2 kinds ------------------------------------


def _raw_entry(plan0, batch: int, sign: int, scale: float,
               engine: Engine | None = None, bt: int = 0) -> Raw | None:
    """The :class:`Raw` route of one 1D PACKED transform on ``engine``
    (None: its kind's static route, K1, K2 or K3), or None where the plan
    needs the plane path."""
    kind = raw_kind(plan0)
    if kind is None:
        return None
    return Raw(plan0, batch, sign, scale, engine or ENGINES[kind], bt)


def _tuned_engine(committed, plan0, batch: int) -> tuple[Engine | None, int]:
    """``(engine, bt)`` of the raw route of ``plan0``, fixed at commit: the
    tuned table's (``tuning.lookup`` of the plan's ``fused2`` or
    ``global2`` key), else ``(None, 0)``, the static route.  The key holds
    no batch, so a tuned batch tile that does not divide this batch, or
    does not fit, is dropped with a trace and the kernel picks its own (the
    JAX package's "stale tuning (different batch): let the kernel pick").
    A tuned engine whose gate declines the plan at every tile is marked
    stale in the tuning cache, with a warning, and the static route runs;
    one that has no kernel here raises."""
    kind = raw_kind(plan0)
    if kind not in ("fused2", "global2"):
        return None, 0
    key = tuning._entry_key(committed, kind, plan0.n)
    params = tuning.lookup(committed.config.name, kind, key)
    if params is None:
        tracing.tuned("miss")
        return None, 0
    engine = engine_of(params, plan0)
    bt = params.get("bt", 0) if engine.tiled else 0
    if bt and not engine.gate(plan0, batch, bt):
        plog.trace(f"tuned {kind}/{key} {params}: batch tile {bt} does not suit "
                   f"batch {batch}; the kernel picks its tile")
        bt = 0
    if engine.gate(plan0, batch, bt):
        tracing.tuned("hit")
        return engine, bt
    tracing.tuned("declined")
    reason = f"the gate of {engine.name} declines {plan0.describe()}"
    tuning.mark_stale_if_tuned(committed, kind, reason, plan0.n)
    plog.warn(f"stale tuned entry {kind}/{key} {params}: {reason}; "
              f"{ENGINES[kind].kernel.kernel} runs")
    return None, 0


def _counted_lookup(committed, kind: str) -> dict:
    """The tuned parameters of the committed shape's ``kind`` entry
    (``multidim``, ``bi_col``), or ``{}``; the outcome is counted."""
    params = tuning.lookup(committed.config.name, kind,
                           tuning._entry_key(committed, kind))
    tracing.tuned("miss" if params is None else "hit")
    return params or {}


def with_engine(committed, entry: Route, params: dict) -> Route:
    """``entry`` with the engine of its :class:`Raw` route (inside a
    wrapper's) set by ``params``, or its :class:`MultiDim` or top-level
    :class:`Col` route rebuilt with the tuning parameters ``params``;
    raises where that engine has no kernel here or its gate declines the
    plan at the given tile."""
    if isinstance(entry, (Layout, HalfReal)):
        return dataclasses.replace(
            entry, inner=with_engine(committed, entry.inner, params))
    if isinstance(entry, Col):
        return dataclasses.replace(entry, kernel=_col_kernel(entry.plan, params))
    if isinstance(entry, MultiDim):
        register_md = (_register_real if committed.descriptor.domain == Domain.REAL
                       else _register_multidim)
        return register_md(committed, params)[
            next(dn for dn, s in _SIGNS.items() if s == entry.steps[0].sign)]
    if entry.tuning_kind is None:
        raise RawFastUnavailable(
            f"a {type(entry).__name__} entry has no tuned engine")
    plan0, batch = entry.plan, entry.batch
    engine = engine_of(params, plan0)
    bt = params.get("bt", 0) if engine.tiled else 0
    if not engine.gate(plan0, batch, bt):
        raise RawFastUnavailable(
            f"the gate of {engine.name} declines {plan0.describe()} at batch "
            f"{batch}" + (f", tile {bt}" if bt else ""))
    return dataclasses.replace(entry, engine=engine, bt=bt)


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


def _both(d, route) -> dict:
    """``{direction: route(sign, scale)}`` for both directions of ``d``."""
    return {dn: route(sign, float(d.get_scale(dn))) for dn, sign in _SIGNS.items()}


def _side(d, direction, block: BufferLayout):
    """How a route reaches one domain's buffer: the offset of the block
    its inner kernels read or write as it is (the domain is in the
    ``block`` layout, or its :class:`Rows` are contiguous), or the
    domain's :class:`Rows`, which K7 de/restrides."""
    if len(d.lengths) > 1 or get_layout(d, direction) == block:
        return d.get_offset(direction)
    rows = rows_1d(d, direction)
    return rows.offset if rows.contiguous else rows


def _with_layout(d, entries: dict, block: BufferLayout = BufferLayout.PACKED) -> dict:
    """``entries`` (inner routes on ``block`` buffers at offset 0) as the
    descriptor's layouts need them: an inner route as it is where both of
    its buffers are such blocks at offset 0, else a :class:`Layout` with
    ``_side`` of the input and the output domain."""
    out = {}
    for direction, inner in entries.items():
        src, dst = _side(d, direction, block), _side(d, _inv(direction), block)
        out[direction] = inner if src == 0 and dst == 0 else Layout(inner, src, dst)
    return out


def _column_kernel(plan, trailing: int) -> str | None:
    """The column kernel of an outer axis of ``plan`` over ``trailing``
    columns: K12 where ``cuda_axis.axis_m2_mode`` takes it, else K13's
    column form where ``cuda_chain.cols_supported`` does, else None (the
    executor after a ``movedim``)."""
    if cuda_axis.axis_m2_mode(plan, trailing) is not None:
        return "K12"
    return "K13col" if cuda_chain.cols_supported(plan, trailing) else None


def _register_core(committed, split: bool) -> dict:
    """:class:`Core` routes of a transform on the plane path's per-axis
    walk (``torch_exec.core_inner``): each outer axis, of the product of
    the axes after it, on its column kernel (``_column_kernel``); the last
    axis and the outer axes no column kernel takes on their plans'
    ``plane_routes``."""
    d = committed.descriptor
    lengths, plans = list(d.lengths), committed.plans
    columns, routes = [], {}
    for axis, n in enumerate(lengths):
        if n == 1:
            continue
        kernel = (_column_kernel(plans[n], math.prod(lengths[axis + 1:]))
                  if axis < len(lengths) - 1 else None)
        if kernel is None:
            routes.update(plane_routes(plans[n], committed.config))
        else:
            columns.append((axis, kernel))
    return _both(d, lambda sign, scale: Core(
        split, d.number_of_transforms, sign, scale, tuple(columns), routes))


def _col_axis_ok(plan, config) -> bool:
    return cuda_multidim.col_axis_supported(plan, config.direct_threshold)


def _col_kernel(plan, params: dict) -> str:
    """The column kernel of an axis under tuning parameters: K10-mm
    (``"col_mm"``) for ``{"cm": 1}`` where its gate takes the plan, else
    K10 (``"col"``).  An fp64 route reads no table and passes no parameters
    (``_register_real``): K10."""
    if params.get("cm") and cuda_multidim.col_mm_supported(plan):
        return "col_mm"
    return "col"


def _f64(committed) -> bool:
    """Whether the plan runs in double (``precision`` fp64)."""
    return committed.precision.itemsize == 8


def _outer_cols(committed, shape, first: int) -> list:
    """``(plan, bpre, rest)`` of the column steps over axes ``first`` … 0
    of (batch, *``shape``) complex elements, in the order they run; axes of
    length 1 have none."""
    batch, plans = committed.descriptor.number_of_transforms, committed.plans
    return [(plans[shape[ax]], batch * math.prod(shape[:ax]), math.prod(shape[ax + 1:]))
            for ax in range(first, -1, -1) if shape[ax] > 1]


def _cols(cols: list, params: dict, sign: int, scale: float) -> tuple:
    """The :class:`Col` steps of ``cols`` (``_outer_cols``), each on the
    column kernel ``_col_kernel`` picks under the ``multidim`` tuning
    parameters ``params`` (``{}`` at fp64), ``scale`` in the last."""
    return tuple(Col(_col_kernel(plan, params), bpre, plan, rest, sign,
                     scale if i == len(cols) - 1 else 1.0)
                 for i, (plan, bpre, rest) in enumerate(cols))


def _declined_outer(committed, f64: bool = False) -> list:
    """The plans of the outer axes (longer than 1) K10 does not take, in
    float64 where ``f64``."""
    lengths, plans = committed.descriptor.lengths, committed.plans
    ok = (functools.partial(cuda_multidim.col_f64_supported,
                            max_direct=committed.config.direct_threshold)
          if f64 else lambda p: _col_axis_ok(p, committed.config))
    return [plans[ln] for ln in lengths[:-1] if ln > 1 and not ok(plans[ln])]


def _register_multidim(committed, params: dict | None = None) -> dict:
    """:class:`MultiDim` routes of a multi-dimensional C2C transform (see
    the module docstring).  ``params`` are the ``multidim`` tuning
    parameters (default: the tuning table's for the shape): ``{"m2": 0}``
    turns K11 off, ``{"cm": 1}`` takes K10-mm.  Where K10 does not take an
    outer axis or the last axis needs the plane path, the transform runs on
    the plane path's per-axis walk (``_register_core``), as the JAX
    package's ``_traced_interleaved``."""
    d = committed.descriptor
    lengths, plans = list(d.lengths), committed.plans
    if _declined_outer(committed) or raw_kind(plans[lengths[-1]]) is None:
        return _register_core(committed, split=False)
    if params is None:
        params = _counted_lookup(committed, "multidim")
    total = d.number_of_transforms * math.prod(lengths)
    plan_last = plans[lengths[-1]]
    plan_a = plans[lengths[-2]] if lengths[-2] > 1 else None
    md2 = plan_a is not None and params.get("m2", 1) != 0 and (
        cuda_multidim.md2_supported(plan_a, plan_last, committed.config))
    cols = _outer_cols(committed, lengths, len(lengths) - (3 if md2 else 2))

    def route(sign, scale):
        # the scale goes into the last kernel that runs
        head_scale = 1.0 if cols else scale
        if md2:
            n2d = lengths[-2] * lengths[-1]
            head = Md2(total // n2d, plan_a, plan_last, sign, head_scale)
        else:
            head = _raw_entry(plan_last, total // lengths[-1], sign, head_scale)
        return MultiDim((head, *_cols(cols, params, sign, scale)))

    return _both(d, route)


def _real_head(committed, n: int, batch: int):
    """``route(sign, scale)`` of ``batch`` 1D REAL transforms of even
    ``n``: :class:`SmallReal` up to ``SMALL_REAL_MAX_N``, else
    :class:`HalfReal` around the h = n/2 route (a :class:`Raw` on h's
    tuned engine, or a :class:`Plane`)."""
    h = n // 2
    plan_h = committed.plans[h] if n > SMALL_REAL_MAX_N else None
    # the half-length transform takes the tuned engine of its own length
    engine, bt = (_tuned_engine(committed, plan_h, batch)
                  if plan_h is not None else (None, 0))
    routes = (plane_routes(plan_h, committed.config)
              if plan_h is not None and raw_kind(plan_h) is None else None)

    def route(sign, scale):
        if plan_h is None:
            return SmallReal(n, batch, sign, scale)
        if routes is None:
            inner = _raw_entry(plan_h, batch, sign, 1.0, engine, bt)
        else:
            inner = Plane(plan_h, batch, sign, 1.0, routes)
        # K8a-w under a plane inner route only, as the JAX package
        tangle = ("retangle" if sign > 0 else "untangle_wide"
                  if routes is not None and cuda_real.wide_supported(n, batch)
                  else "untangle")
        return HalfReal(inner, h, batch, sign, scale, tangle, n < REAL_KEEP_MIN_N)

    return route


def _register_real(committed, params: dict | None = None) -> dict:
    """Routes of a REAL transform.  1D: the last axis's route
    (``_real_head``).  Multi-dim: a :class:`MultiDim` whose REAL step is
    that route over batch·∏outer rows and whose :class:`Col` steps (the
    column rule of ``_register_multidim``, under the ``multidim`` tuning
    parameters ``params``, default the table's) run the outer axes, from
    the last to axis 0, in place on the interleaved half spectrum: forward
    the REAL step first, the scale in the last column; backward the
    columns first, the scale in the REAL step.  Raises where K10 declines
    an outer axis."""
    d = committed.descriptor
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
        if d.get_offset(direction) or get_layout(d, direction) != BufferLayout.PACKED:
            raise RawFastUnavailable(
                "REAL transforms with buffer offsets or strided layouts are "
                "not ported yet (ROADMAP Queue 1 item 9): the JAX package "
                "runs them through its REAL plane path, which on C2R drops "
                f"Im X[0] and Im X[n/2] below n = {REAL_KEEP_MIN_N} and "
                "uses them from there on, as the packed route here does")
    lengths = list(d.lengths)
    n = lengths[-1]
    head = _real_head(committed, n, d.number_of_transforms * math.prod(lengths[:-1]))
    if len(lengths) == 1:
        return _both(d, head)
    declined = _declined_outer(committed)
    if declined:
        raise RawFastUnavailable(
            f"multi-dimensional REAL transforms whose outer axes K10 does not "
            f"take ({', '.join(p.describe() for p in declined)}) are not ported "
            "yet (ROADMAP Queue 1 item 9): no per-axis walk runs the outer axes "
            "of the half spectrum")
    if _f64(committed):
        # K10 alone runs fp64 columns: the table is not read, and asking for
        # K10-mm raises
        if params and params.get("cm"):
            raise RawFastUnavailable(
                "K10-mm at fp64 is not ported (ROADMAP Queue 1 item 12): its "
                "three-term TF32 split is a float32 method; fp64 columns run "
                "on K10")
        params = {}
    elif params is None:
        params = _counted_lookup(committed, "multidim")
    cols = _outer_cols(committed, [*lengths[:-1], n // 2 + 1], len(lengths) - 2)

    def route(sign, scale):
        if sign < 0:
            return MultiDim((head(sign, 1.0 if cols else scale),
                             *_cols(cols, params, sign, scale)))
        return MultiDim((*_cols(cols, params, sign, 1.0), head(sign, scale)))

    return _both(d, route)


def real_step(entry: Route) -> Route:
    """The 1D REAL step of a REAL route: the route itself, or the
    :class:`SmallReal` or :class:`HalfReal` step of its :class:`MultiDim`."""
    if isinstance(entry, MultiDim):
        return next(s for s in entry.steps if isinstance(s, (SmallReal, HalfReal)))
    return entry


def _check_f64(committed) -> None:
    """Raises for an fp64 descriptor whose route has a step with no double
    kernel (the module docstring); the REAL routes' own rules (placement,
    storage, layouts, outer axes K10 declines at every precision) are
    ``_register_real``'s."""
    d = committed.descriptor
    if d.domain != Domain.REAL:
        raise RawFastUnavailable(
            "fp64 C2C transforms are not ported yet (ROADMAP Queue 1 item "
            "12): no C2C kernel has a double instantiation; fp64 runs the "
            f"REAL routes of K9 and K10 (last axis ≤ {SMALL_REAL_MAX_N})")
    n = d.lengths[-1]
    if n > SMALL_REAL_MAX_N:
        raise RawFastUnavailable(
            f"fp64 REAL transforms whose last axis is longer than "
            f"{SMALL_REAL_MAX_N} ({n}) are not ported yet (ROADMAP Queue 1 "
            "item 12): their HalfReal route (K8a/K8b around a C2C of n/2) "
            "has no double kernels")
    only32 = [p for p in _declined_outer(committed, f64=True)
              if _col_axis_ok(p, committed.config)]
    if only32:
        raise RawFastUnavailable(
            f"fp64 REAL outer axes that K10 takes only in float32 "
            f"({', '.join(p.describe() for p in only32)}) are not ported yet "
            f"(ROADMAP Queue 1 item 12): K10's double tile holds at most "
            f"{cuda_multidim.COL_F64_MAX} points")


def register(committed) -> dict:
    """The per-direction route table of a committed plan.  Raises
    :class:`RawFastUnavailable` for every descriptor outside the slice."""
    d = committed.descriptor
    if _f64(committed):
        _check_f64(committed)
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
    bi = BufferLayout.BATCH_INTERLEAVED
    if (get_layout(d, Direction.FORWARD) == bi == get_layout(d, Direction.BACKWARD)
            and _col_axis_ok(plan0, committed.config)):
        # the (n, batch) buffer is one column transform with bpre = 1, on
        # the column kernel of the bi_col tuning kind
        kernel = _col_kernel(plan0, _counted_lookup(committed, "bi_col"))
        return _with_layout(d, _both(d, lambda sign, scale: Col(
            kernel, 1, plan0, batch, sign, scale)), bi)
    if raw_kind(plan0) is None:
        routes = plane_routes(plan0, committed.config)
        return _with_layout(d, _both(d, lambda sign, scale: Plane(
            plan0, batch, sign, scale, routes)))
    engine, bt = _tuned_engine(committed, plan0, batch)
    return _with_layout(d, _both(d, lambda sign, scale: _raw_entry(
        plan0, batch, sign, scale, engine, bt)))


def plane_fn(committed, entry: Plane, plain: bool = False):
    """``fn(raw, out=None) -> tensor`` of a :class:`Plane` route: K6
    deinterleave, the executor (``torch_exec.exec_plan``) with the route's
    K13, K14 and K15 steps as its leaf hook, and K6 interleave with the
    direction's scale into ``out`` (for IN_PLACE the caller's buffer, which
    the deinterleave has already read).  ``plain`` chains the plain
    versions instead (the CPU path, and ``chip_smoke.py``'s yardstick on
    the card)."""
    plan0, batch, sign = entry.plan, entry.batch, entry.sign
    n = plan0.n
    leaf = leaf_hook(plane_steps(committed, [plan0], entry.routes), plain)
    keys, arrays = committed._bank_keys, committed._bank_arrays

    def walk(xr, xi):
        args = (xr.view(batch, n), xi.view(batch, n), plan0, sign, keys, arrays,
                leaf)
        if PROFILER._is_profiler_enabled:
            return tracing.run("portfft.exec", torch_exec.exec_plan, *args)
        return torch_exec.exec_plan(*args)

    return _interleaved(walk, entry.scale, plain)


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


def _column(k, bpre, trailing, tabs, xr, xi, s):
    """A column kernel (K12, K13's column form, or the plain version
    ``k``) on one outer axis of (b, L1, L2) planes, times ``s``."""
    return k(xr.contiguous(), xi.contiguous(), bpre, trailing, tabs, s)


def core_fn(committed, entry: Core, plain: bool = False):
    """The function of a :class:`Core` route (``_register_core``): the
    per-axis walk ``torch_exec.core_inner`` on (batch, *lengths) planes,
    with K12 (``cuda_axis.axis_m2``) and K13's column form
    (``cuda_chain.chain_cols``) on the outer axes they take and the
    route's K13, K14 and K15 steps as the executor's leaf hook.  SPLIT:
    ``fn(xr, xi) -> (yr, yi)`` on flat planes, the scale in the last
    kernel that takes one (K12, K13's column form, K14 pass 2, K15 pass 3)
    or else one torch multiply; interleaved: ``fn(raw, out=None)`` with K6
    around the walk and the scale in the interleave.  ``plain`` chains the
    plain versions instead."""
    batch, sign, scale, routes = entry.batch, entry.sign, entry.scale, entry.routes
    d = committed.descriptor
    lengths, plans = list(d.lengths), committed.plans
    keys, arrays = committed._bank_keys, committed._bank_arrays
    walked = [plans[n] for n in set(lengths) if n in routes]
    leaf = leaf_hook(plane_steps(committed, walked, routes), plain)
    kernels = {"K12": (cuda_axis.axis_m2, cuda_fft.sub_tables),
               "K13col": (cuda_chain.chain_cols, cuda_chain.chain_tables)}
    columns = {}
    for axis, route in entry.columns:
        k, tables = kernels[route]
        columns[axis] = (route, functools.partial(
            _column, k.plain if plain else k, batch * math.prod(lengths[:axis]),
            math.prod(lengths[axis + 1:]),
            tables(plans[lengths[axis]], sign, keys, arrays)))
    shape = (batch, *lengths)

    def walk(xr, xi, s=1.0):
        args = (xr.view(shape), xi.view(shape), lengths, plans, sign, keys,
                arrays, leaf, columns, s)
        if PROFILER._is_profiler_enabled:
            return tracing.run("portfft.exec", torch_exec.core_inner, *args)
        return torch_exec.core_inner(*args)

    if not entry.split:
        return _interleaved(walk, scale, plain)

    def fn(xr, xi):
        yr, yi = walk(xr, xi, scale)
        return yr.reshape(-1), yi.reshape(-1)

    return fn


def route_kernels(route: Route) -> tuple:
    """The K-numbers of the kernels ``route`` launches, in the order they
    run (a plane node the executor glues runs none of its own)."""
    if isinstance(route, Raw):
        return (route.engine.kernel.kernel,)
    if isinstance(route, Col):
        return (getattr(cuda_multidim, route.kernel).kernel,)
    if isinstance(route, Md2):
        return (cuda_multidim.md2.kernel,)
    if isinstance(route, SmallReal):
        return (cuda_real.small_real.kernel,)
    if isinstance(route, HalfReal):
        tangle = (getattr(cuda_real, route.tangle).kernel,)
        inner = route_kernels(route.inner)
        return inner + tangle if route.sign < 0 else tangle + inner
    if isinstance(route, Plane):
        nodes = {"global2": cuda_global.global2_planes,
                 "bluestein": cuda_bluestein.bluestein,
                 "bluestein_bf": cuda_bluestein.bluestein_bf}
        inner = {nodes.get(kind, cuda_chain.chain).kernel
                 for kind in route.routes.values() if kind != "generic"}
        return (cuda_io.deinterleave.kernel, *sorted(inner), cuda_io.interleave.kernel)
    raise TypeError(f"no kernels listed for a {type(route).__name__} route")


def step_notes(committed, entry: MultiDim) -> list:
    """The note of each step's ``portfft.axis`` span: the axes it
    transforms (comma-separated) and its kernels in the order they run
    (``+``-joined), e.g. ``1 K9``, ``0 K10``, ``1 K1+K8a``, ``0,1 K11``;
    at fp64 followed by `` f64`` (``2 K9 f64``), the precision that ran."""
    lengths = committed.descriptor.lengths
    tag = " f64" if _f64(committed) else ""
    last = len(lengths) - 1
    # the column steps take the outer axes longer than 1, last first (an
    # Md2 the first of them with the last axis)
    outer = iter(ax for ax in range(last - 1, -1, -1) if lengths[ax] > 1)
    notes = []
    for step in entry.steps:
        axes = (next(outer) if isinstance(step, Col)
                else f"{next(outer)},{last}" if isinstance(step, Md2) else last)
        notes.append(f"{axes} {'+'.join(route_kernels(step))}{tag}")
    return notes


def _step_fn(committed, step: Route, plain: bool):
    """``fn(x, out)`` of one step: its kernel on ``x`` into ``out`` (None:
    a new buffer), or for a 1D REAL step the REAL route, which makes its
    own output.  ``plain`` runs the plain versions."""
    if isinstance(step, (SmallReal, HalfReal)):
        real = build_fn(committed, step, plain)
        return lambda x, out: real(x)
    kernel, args = step.kernel_args(committed)
    if plain:
        return lambda x, out: cuda_fft.into(out, kernel.plain(x, *args))
    return lambda x, out: kernel(x, *args, out=out)


def packed_fn(committed, entry: Route, plain: bool = False):
    """``fn(x, out=None)`` of a route on its own buffers at offset 0
    (PACKED, or the BATCH_INTERLEAVED block of a top-level :class:`Col`):
    interleaved, ``x`` is the raw input of exactly the input count and
    ``out`` (may be ``x``) receives the result, else a new tensor; SPLIT
    (a :class:`Core`), ``x`` is the (re, im) pair and the result new
    planes.  A :class:`MultiDim` runs its first step into ``out`` and the
    rest in place on its result (a REAL step makes its own output), each
    step a ``portfft.axis`` span (``step_notes``) while a profiler records.
    ``plain`` chains the plain versions instead (the CPU path, and
    ``chip_smoke.py``'s yardstick on the card)."""
    if isinstance(entry, Plane):
        return plane_fn(committed, entry, plain)
    if isinstance(entry, Core):
        walk = core_fn(committed, entry, plain)
        return walk if not entry.split else lambda x, out=None: walk(*x)
    multi = isinstance(entry, MultiDim)
    steps = [_step_fn(committed, s, plain) for s in (entry.steps if multi else (entry,))]
    notes = step_notes(committed, entry) if multi else None

    def fn(raw, out=None):
        x = raw
        for i, step in enumerate(steps):
            target = out if i == 0 else x
            if notes and PROFILER._is_profiler_enabled:
                x = tracing.run("portfft.axis", step, x, target, note=notes[i])
            else:
                x = step(x, target)
        return x

    return fn


def layout_fn(committed, entry: Layout, plain: bool = False):
    """``fn(x, out=None)`` of a :class:`Layout` route (see ``build_fn``):
    the input side as a view of ``x`` at its offset (``src``
    an int) or K7 ``destride`` of its :class:`Rows`, the inner entry on
    packed buffers, and the output side likewise: the inner entry writes
    straight into the view of ``out`` at ``dst`` where it can, else K7
    ``restride`` (zeroing every other element of a buffer it allocates)
    or a copy into that view.  IN_PLACE reads all input before writing any
    output: the inner entry runs in place only on the very view it reads
    or on K7's scratch, and otherwise into a new buffer that is then
    copied or restrided into the caller's."""
    src, dst = entry.src, entry.dst
    d = committed.descriptor
    split = d.complex_storage == ComplexStorage.SPLIT_COMPLEX
    in_place = d.placement == Placement.IN_PLACE
    total = d.number_of_transforms * math.prod(d.lengths)
    width = 1 if split else 2
    run = packed_fn(committed, entry.inner, plain)
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


def half_c2c_fn(committed, inner: Route, plain: bool = False):
    """``fn(raw, out=None)`` of the C2C route under a :class:`HalfReal`: a
    :class:`Raw` route's kernel called straight, or a :class:`Plane`
    route (``plane_fn``); ``plain`` runs the plain versions."""
    if isinstance(inner, Plane):
        return plane_fn(committed, inner, plain)
    step = _step_fn(committed, inner, plain)
    return lambda x, out=None: step(x, out)


def build_fn(committed, entry: Route, plain: bool = False):
    """The function of a route.  C2C: ``fn(x, out=None)``, where ``x`` is
    the caller's whole input buffer on the plan's device (a flat float32
    tensor of raw (re, im) pairs, or for SPLIT_COMPLEX a (re, im) pair of
    flat float32 planes), at least the input count long; ``out``, of the
    same kind, is the output buffer (``x`` itself for IN_PLACE), at least
    the output count long, whose elements outside the output layout are
    left as they are, or None for a new buffer of exactly the output count
    that is zero wherever no result lands.  Returns the output buffer.
    REAL (1D, or a multi-dim :class:`MultiDim`): ``fn(raw)`` on exactly the
    input count, returning a new buffer.
    ``plain`` chains the plain versions (the CPU path, and
    ``chip_smoke.py``'s yardstick on the card)."""
    if isinstance(entry, MultiDim) and committed.descriptor.domain == Domain.REAL:
        return packed_fn(committed, entry, plain)
    if not isinstance(entry, (SmallReal, HalfReal)):
        return layout_fn(committed, entry if isinstance(entry, Layout)
                         else Layout(entry, 0, 0), plain)
    kernel, args = entry.kernel_args(committed)
    if plain:
        kernel = kernel.plain
    if isinstance(entry, SmallReal):
        return lambda raw: kernel(raw, *args)
    c2c = half_c2c_fn(committed, entry.inner, plain)
    if entry.sign < 0:

        def fn(raw):
            # the real rows are the h-point input z = x_even + i·x_odd
            return kernel(c2c(raw), *args)

    else:

        def fn(raw):
            z = kernel(raw, *args)
            # the h-point transform of Z, in place, is the real rows
            return c2c(z, out=z)

    return fn
