"""The plan executor on (re, im) float32 planes: the torch port of the JAX
package's ``ops/xla_fft.py`` ``exec_chain_xla``, ``exec_plan`` and
``_exec_bluestein``, and of ``committed._core_inner`` (the per-axis walk of
a multi-dimensional transform).

Every function takes planes whose last axis is the transform (``core_inner``:
planes (batch, *lengths)) and returns new planes of the same shape.
``leaf_fn(xr, xi, plan, sign, bank, post=None, scale=1.0)`` is the hook of
the JAX package's ``leaf_dispatch``: it returns the planes a kernel
computed for the node ``plan``, times ``scale`` (and for a GLOBAL node
times ``post``, a (g1, g2) table multiplied in its second pass), or None
where the node runs here.  With no hook every node runs here: a DIRECT or
FUSED leaf as its Stockham chain of ``torch.matmul`` calls against the
bank's DFT matrices, in full float32.  With the hook of a committed plan
(``fastpath``) only the glue between kernels runs here, the glue that the
JAX package computes in XLA outside its Pallas kernels: the GLOBAL
four-step's reshapes, swaps and twiddle multiply, the generic Bluestein
transform's chirp multiply, zero pad, b̂ multiply and slice, and a
multi-dimensional transform's ``movedim`` around an axis no column kernel
takes (K12 or K13's column form).  Where the hook runs no kernel for the
node, the scale is one torch multiply at the end, as the JAX package's XLA
multiply.  The copies of a moved axis, and the hook's (``copied``), count as
glue bytes (``tracing.glue``).  Nothing here calls ``torch.fft``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch.nn.functional as F

from ..enums import Level
from ..planner import Plan1D
from ..utils import tracing
from ..utils.tracing import PROFILER
from .torch_fft import complex_matmul, complex_mul, full_fp32_matmuls

LeafFn = Optional[Callable]


def exec_chain(xr, xi, factors: list[int], sign: int, keys: dict,
               bank: dict):
    """The Stockham chain of ``factors`` over the last axis: with n = f·m
    and x[n1, n2] = x[n1·m + n2], the f-point DFT over n1, the twiddle
    T(f, m)[n2, k1], the chain of the rest over n2, and X[k1 + f·k2] =
    C[k1, k2]."""
    if len(factors) == 1:
        w = keys[("W", factors[0], sign)]
        with full_fp32_matmuls(xr):
            return complex_matmul(xr, xi, bank[w + "r"], bank[w + "i"])
    f, rest = factors[0], factors[1:]
    n = math.prod(factors)
    m = n // f
    lead = xr.shape[:-1]
    xr = xr.reshape(*lead, f, m).transpose(-2, -1)  # [n2, n1]
    xi = xi.reshape(*lead, f, m).transpose(-2, -1)
    w = keys[("W", f, sign)]
    with full_fp32_matmuls(xr):
        ar, ai = complex_matmul(xr, xi, bank[w + "r"], bank[w + "i"])
    t = keys.get(("T", f, m, sign))  # stored (m, f) = [n2, k1]
    if t is None:  # a two-stage [a, 128] leaf banks it only as U, (f, m)
        u = keys[("U", f, m, sign)]
        tr, ti = bank[u + "r"].T, bank[u + "i"].T
    else:
        tr, ti = bank[t + "r"], bank[t + "i"]
    ar, ai = complex_mul(ar, ai, tr, ti)
    cr, ci = exec_chain(ar.transpose(-2, -1), ai.transpose(-2, -1), rest,
                        sign, keys, bank)
    return (cr.transpose(-2, -1).reshape(*lead, n),
            ci.transpose(-2, -1).reshape(*lead, n))


def _scaled(yr, yi, scale: float):
    return (yr, yi) if scale == 1.0 else (yr * scale, yi * scale)


def exec_plan(xr, xi, plan: Plan1D, sign: int, keys: dict, bank: dict,
              leaf_fn: LeafFn = None, scale: float = 1.0):
    """Execute the plan tree over the last axis of (xr, xi), times
    ``scale``."""
    if leaf_fn is not None:
        res = leaf_fn(xr, xi, plan, sign, bank, scale=scale)
        if res is not None:
            return res
    if plan.level in (Level.DIRECT, Level.FUSED):
        return _scaled(*exec_chain(xr, xi, plan.factors, sign, keys, bank),
                       scale)
    if plan.level == Level.GLOBAL:
        g1, g2 = plan.sub
        f, m = g1.n, g2.n
        lead = xr.shape[:-1]
        xr = xr.reshape(*lead, f, m).transpose(-2, -1)
        xi = xi.reshape(*lead, f, m).transpose(-2, -1)
        ar, ai = exec_plan(xr, xi, g1, sign, keys, bank, leaf_fn)
        t = keys[("T", f, m, sign)]
        ar, ai = complex_mul(ar, ai, bank[t + "r"], bank[t + "i"])
        cr, ci = exec_plan(ar.transpose(-2, -1), ai.transpose(-2, -1), g2,
                           sign, keys, bank, leaf_fn)
        return _scaled(cr.transpose(-2, -1).reshape(*lead, plan.n),
                       ci.transpose(-2, -1).reshape(*lead, plan.n), scale)
    if plan.level == Level.BLUESTEIN:
        return exec_bluestein(xr, xi, plan, sign, keys, bank, leaf_fn, scale)
    raise AssertionError(f"unknown level {plan.level}")


def exec_bluestein(xr, xi, plan: Plan1D, sign: int, keys: dict, bank: dict,
                   leaf_fn: LeafFn = None, scale: float = 1.0):
    """Chirp-z transform X[k] = c[k] · IDFT(DFT(x·c, M) · b̂)[k], c[j] =
    exp(sign·πi·j²/n), M = conv_n, times ``scale``.  The convolution's
    directions are fixed (forward −1, backward +1) for either user
    direction; the user's sign lives in the chirp and b̂, which also
    carries 1/M.  Where the convolution is GLOBAL and the hook runs it on
    the plane GLOBAL kernel, b̂ and the final chirp (zero past n) go into
    that kernel's second pass as ``post`` tables, the scale with the
    chirp: two fewer sweeps over the convolution."""
    n, conv_n = plan.n, plan.conv.n
    b = keys[("B", n, sign)]
    cr, ci = bank[b + "cr"], bank[b + "ci"]
    ar, ai = complex_mul(xr, xi, cr, ci)
    ar = F.pad(ar, (0, conv_n - n))
    ai = F.pad(ai, (0, conv_n - n))
    post = keys.get(("BPOST", n, sign))
    if post is not None and leaf_fn is not None:
        res = leaf_fn(ar, ai, plan.conv, -1, bank,
                      post=(bank[post + "fr"], bank[post + "fi"]))
        if res is not None:
            yr, yi = leaf_fn(*res, plan.conv, +1, bank,
                             post=(bank[post + "gr"], bank[post + "gi"]),
                             scale=scale)
            return yr[..., :n], yi[..., :n]
    fr, fi = exec_plan(ar, ai, plan.conv, -1, keys, bank, leaf_fn)
    fr, fi = complex_mul(fr, fi, bank[b + "br"], bank[b + "bi"])
    yr, yi = exec_plan(fr, fi, plan.conv, +1, keys, bank, leaf_fn)
    return _scaled(*complex_mul(yr[..., :n], yi[..., :n], cr, ci), scale)


def copied(src, out):
    """``out``, made from ``src``: where it is a copy (new memory), its bytes
    count as the executor's glue (``tracing.glue``)."""
    if out.data_ptr() != src.data_ptr():
        tracing.glue(out.numel() * out.element_size())
    return out


def core_inner(xr, xi, lengths, plans: dict, sign: int, keys: dict,
               bank: dict, leaf_fn: LeafFn = None, columns: dict | None = None,
               scale: float = 1.0):
    """The transform over every axis of (batch, *lengths) planes, the last
    (contiguous) axis first, times ``scale`` (the port of
    ``committed._core_inner``).  Length-1 axes are skipped.  An outer axis
    in ``columns``, ``{axis: (route, fn)}``, goes to ``fn(xr3, xi3, scale)``
    on the (b, L1, L2) view where it lies (route ``"K12"``: the column
    kernel K12; ``"K13col"``: K13's column form), any other through the
    executor after a ``movedim`` to the last place, and back by a copy
    (counted as glue).  The scale is offered to the last axis that runs.
    Under a recording profiler each axis is a ``portfft.axis`` span whose
    note is the axis and its route."""
    ndims = len(lengths)
    columns = columns or {}
    todo = [ax for ax in range(ndims - 1, -1, -1) if lengths[ax] > 1]
    shape = xr.shape

    def step(xr, xi, axis, route, s):
        n, plan = lengths[axis], plans[lengths[axis]]
        if route == "exec":
            return exec_plan(xr, xi, plan, sign, keys, bank, leaf_fn, s)
        if route == "movedim":
            yr, yi = exec_plan(xr.movedim(1 + axis, -1),
                               xi.movedim(1 + axis, -1), plan, sign, keys,
                               bank, leaf_fn, s)
            return (copied(yr, yr.movedim(-1, 1 + axis).contiguous()),
                    copied(yi, yi.movedim(-1, 1 + axis).contiguous()))
        trailing = math.prod(shape[2 + axis:])
        yr, yi = columns[axis][1](xr.reshape(-1, n, trailing),
                                  xi.reshape(-1, n, trailing), s)
        return yr.reshape(shape), yi.reshape(shape)

    for i, axis in enumerate(todo):
        s = scale if i == len(todo) - 1 else 1.0
        route = ("exec" if axis == ndims - 1
                 else columns[axis][0] if axis in columns else "movedim")
        if PROFILER._is_profiler_enabled:
            xr, xi = tracing.run("portfft.axis", step, xr, xi, axis, route, s,
                                 note=f"{axis} {route}")
        else:
            xr, xi = step(xr, xi, axis, route, s)
    if not todo and scale != 1.0:
        xr, xi = xr * scale, xi * scale
    return xr, xi
