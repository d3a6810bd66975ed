"""Constant tables of a committed plan, and the complex matmul that the
plain PyTorch versions of the kernels share.

:class:`TwiddleBank` keeps host numpy tables under the JAX package's key
strings (``portfft_tpu.ops.xla_fft.TwiddleBank``): ``W{f|b}{n}`` for DFT
matrices, ``T{f|b}{f}x{m}`` for inter-factor twiddles stored transposed
(m, f), ``U{f|b}{f}x{m}`` for the same twiddles in (f, m) orientation,
``R{f|b}{n}`` for the REAL untangle/retangle post-twiddle, each with an
``r``/``i`` plane suffix.  The values are the JAX package's too
(``twiddle.py``), so a table carried over from it (``convert.py``) and one
built here are interchangeable.  ``RM{f|b}{n}_{scale}m`` (the small-n REAL
matrix, :meth:`TwiddleBank.real_small`) has no counterpart there: the JAX
package keeps the same matrix only as a bf16 stack.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .. import twiddle as tw
from ..enums import Level
from ..planner import Plan1D


class TwiddleBank:
    """Named constant tables for a committed plan."""

    def __init__(self, dtype=np.float32):
        self.dtype = np.dtype(dtype)
        #: name -> array; a bare key maps to None and marks a table pair.
        self.host: dict[str, np.ndarray | None] = {}

    def dft(self, f: int, sign: int) -> str:
        """f×f DFT matrix W[j, k] = ω_f^{jk}.  Row 1 is the root table the
        kernels index as ``W[1, (j·k) mod f]``."""
        key = f"W{'f' if sign < 0 else 'b'}{f}"
        if key not in self.host:
            re, im = tw.dft_matrix(f, sign, self.dtype)
            self.host[key + "r"] = re
            self.host[key + "i"] = im
            self.host[key] = None
        return key

    def twiddle(self, f: int, m: int, sign: int) -> str:
        """Inter-factor twiddles of the split f·m, stored (m, f) = [n2, k1]."""
        key = f"T{'f' if sign < 0 else 'b'}{f}x{m}"
        if key not in self.host:
            re, im = tw.twiddles(f, m, sign, self.dtype)
            self.host[key + "r"] = np.ascontiguousarray(re.T)
            self.host[key + "i"] = np.ascontiguousarray(im.T)
            self.host[key] = None
        return key

    def twiddle_fm(self, f: int, m: int, sign: int) -> str:
        """Inter-factor twiddles of the split f·m in (f, m) = [k1, n2]
        orientation (the two-stage [a, 128] kernel's inner twiddle)."""
        key = f"U{'f' if sign < 0 else 'b'}{f}x{m}"
        if key not in self.host:
            re, im = tw.twiddles(f, m, sign, self.dtype)
            self.host[key + "r"] = re
            self.host[key + "i"] = im
            self.host[key] = None
        return key

    def rfft_untangle(self, n: int, sign: int) -> str:
        """Post-twiddle W^k = exp(sign·2πi·k/n), k < n/2, of the packed
        half-length REAL transform (forward untangle, backward retangle)."""
        key = f"R{'f' if sign < 0 else 'b'}{n}"
        if key not in self.host:
            k = np.arange(n // 2, dtype=np.float64)
            theta = (2.0 * np.pi / n) * k
            self.host[key + "r"] = np.cos(theta).astype(self.dtype)
            self.host[key + "i"] = (np.float64(sign) * np.sin(theta)).astype(
                self.dtype
            )
            self.host[key] = None
        return key

    def real_small(self, n: int, sign: int, scale: float) -> str:
        """The whole small-n REAL transform of one row as a real matrix over
        the row's raw floats, scale folded in.  Forward (sign < 0): (n, n+2),
        row j = float view of ``rfft(e_j)``.  Backward: (n+2, n), row j =
        ``irfft(float basis j)·n`` (the unnormalized inverse; irfft drops the
        imaginary parts of bins 0 and n/2).  Built in float64 as the JAX
        package's ``TwiddleBank.real_small`` builds it, then cast."""
        key = f"RM{'f' if sign < 0 else 'b'}{n}_{scale!r}"
        if key not in self.host:
            if sign < 0:
                eye = np.eye(n, dtype=np.float64)
                m = np.fft.rfft(eye, axis=1) * scale
                m = np.ascontiguousarray(m).view(np.float64)
            else:
                basis = np.eye(n + 2, dtype=np.float64).view(np.complex128)
                m = np.fft.irfft(basis, n, axis=1) * n * scale
            self.host[key + "m"] = m.astype(self.dtype)
            self.host[key] = None
        return key

    def device_arrays(self, device) -> dict[str, torch.Tensor]:
        """Every table as a tensor on ``device``."""
        return {
            k: torch.from_numpy(v).to(device)
            for k, v in self.host.items()
            if v is not None
        }


def is_two_stage(plan: Plan1D) -> bool:
    """True for the FUSED shape [a, 128] the two-stage kernel runs."""
    f = plan.factors
    return plan.level == Level.FUSED and len(f) == 2 and f[1] == 128


def collect_bank_keys(
    plan: Plan1D, sign: int, bank: TwiddleBank, keys: dict
) -> dict:
    """Materialize the tables the kernels of ``plan`` need and record their
    names in ``keys`` under the JAX package's tuple keys: ``("W", f, sign)``,
    ``("U", a, 128, sign)``, ``("T", g1, g2, sign)``."""
    if plan.level == Level.DIRECT:
        keys[("W", plan.n, sign)] = bank.dft(plan.n, sign)
    elif is_two_stage(plan):
        a = plan.factors[0]
        keys[("W", a, sign)] = bank.dft(a, sign)
        keys[("W", 128, sign)] = bank.dft(128, sign)
        keys[("U", a, 128, sign)] = bank.twiddle_fm(a, 128, sign)
    elif plan.level == Level.GLOBAL:
        g1, g2 = plan.sub
        keys[("T", g1.n, g2.n, sign)] = bank.twiddle(g1.n, g2.n, sign)
        collect_bank_keys(g1, sign, bank, keys)
        collect_bank_keys(g2, sign, bank, keys)
    return keys


def complex_matmul(xr, xi, wr, wi):
    """(xr + i·xi) @ (wr + i·wi) as four real ``torch.matmul`` calls."""
    return (
        torch.matmul(xr, wr) - torch.matmul(xi, wi),
        torch.matmul(xr, wi) + torch.matmul(xi, wr),
    )


def complex_mul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


@contextlib.contextmanager
def full_fp32_matmuls(t: torch.Tensor):
    """Plain versions multiply in full float32: on a CUDA tensor, TF32 for
    matmuls is off inside the block (it keeps about three decimal digits
    and would miss the 2·eps·N·log2N tolerance), and the caller's setting
    is restored on the way out."""
    if not t.is_cuda:
        yield
        return
    allowed = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allowed
