"""The plan executor on (re, im) float32 planes: the torch port of the JAX
package's ``ops/xla_fft.py`` ``exec_chain_xla``, ``exec_plan`` and
``_exec_bluestein``.

Every function takes planes whose last axis is the transform and returns
new planes of the same shape.  ``leaf_fn(xr, xi, plan, sign, bank)`` is the
hook of the JAX package's ``leaf_dispatch``: it returns the planes a kernel
computed for the node ``plan``, or None where the node runs here.  With no
hook every node runs here: a DIRECT or
FUSED leaf as its Stockham chain of ``torch.matmul`` calls against the
bank's DFT matrices, in full float32.  With the hook of a committed plan
(``fastpath``) only the glue between kernels runs here, the glue that the
JAX package computes in XLA outside its Pallas kernels: the GLOBAL
four-step's reshapes, swaps and twiddle multiply, and the generic Bluestein
transform's chirp multiply, zero pad, b̂ multiply and slice.  Nothing here
calls ``torch.fft``.

The JAX package's Bluestein executor has one more branch: a GLOBAL
convolution folded into its plane GLOBAL kernel (``post=``, K14) when the
three-pass kernel declines.  The port's route raises at commit for every
plan that would reach it (``fastpath``), so the branch is not carried.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch.nn.functional as F

from ..enums import Level
from ..planner import Plan1D
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


def exec_plan(xr, xi, plan: Plan1D, sign: int, keys: dict, bank: dict,
              leaf_fn: LeafFn = None):
    """Execute the plan tree over the last axis of (xr, xi)."""
    if leaf_fn is not None:
        res = leaf_fn(xr, xi, plan, sign, bank)
        if res is not None:
            return res
    if plan.level in (Level.DIRECT, Level.FUSED):
        return exec_chain(xr, xi, plan.factors, sign, keys, bank)
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
        return (cr.transpose(-2, -1).reshape(*lead, plan.n),
                ci.transpose(-2, -1).reshape(*lead, plan.n))
    if plan.level == Level.BLUESTEIN:
        return exec_bluestein(xr, xi, plan, sign, keys, bank, leaf_fn)
    raise AssertionError(f"unknown level {plan.level}")


def exec_bluestein(xr, xi, plan: Plan1D, sign: int, keys: dict, bank: dict,
                   leaf_fn: LeafFn = None):
    """Chirp-z transform X[k] = c[k] · IDFT(DFT(x·c, M) · b̂)[k], c[j] =
    exp(sign·πi·j²/n), M = conv_n.  The convolution's directions are fixed
    (forward −1, backward +1) for either user direction; the user's sign
    lives in the chirp and b̂, which also carries 1/M."""
    n, conv_n = plan.n, plan.conv.n
    b = keys[("B", n, sign)]
    cr, ci = bank[b + "cr"], bank[b + "ci"]
    ar, ai = complex_mul(xr, xi, cr, ci)
    ar = F.pad(ar, (0, conv_n - n))
    ai = F.pad(ai, (0, conv_n - n))
    fr, fi = exec_plan(ar, ai, plan.conv, -1, keys, bank, leaf_fn)
    fr, fi = complex_mul(fr, fi, bank[b + "br"], bank[b + "bi"])
    yr, yi = exec_plan(fr, fi, plan.conv, +1, keys, bank, leaf_fn)
    return complex_mul(yr[..., :n], yi[..., :n], cr, ci)

