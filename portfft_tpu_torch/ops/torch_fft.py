"""Constant tables of a committed plan, and the complex matmul that the
plain PyTorch versions of the kernels share.

:class:`TwiddleBank` keeps host numpy tables under the JAX package's key
strings (``portfft_tpu.ops.xla_fft.TwiddleBank``): ``W{f|b}{n}`` for DFT
matrices, ``T{f|b}{f}x{m}`` for inter-factor twiddles stored transposed
(m, f), ``U{f|b}{f}x{m}`` for the same twiddles in (f, m) orientation,
``R{f|b}{n}`` for the REAL untangle/retangle post-twiddle, each with an
``r``/``i`` plane suffix; for Bluestein ``B{f|b}{n}_{M}`` (chirp ``c`` and
b̂), ``O{f|b}{n}_{g1}x{g2}`` (b̂ ``f`` and final chirp ``g`` in [k1, k2]),
``C{f|b}{n}_{g2}x{nv}`` and ``D{f|b}{n}_{g2}x{g1}`` (the three-pass
kernel's first and last chirps).  The values are the JAX package's too
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
from ..planner import Plan1D, stage_shapes


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

    @staticmethod
    def _bluestein_bhat(n: int, conv_n: int, sign: int):
        """Chirp c (complex128, length n) and b̂ = DFT of the zero-padded
        mirrored conjugate chirp, with the backward convolution's
        1/conv_n folded in."""
        cr, ci = tw.bluestein_chirp(n, sign, np.float64)
        c = cr + 1j * ci
        b = np.zeros(conv_n, dtype=np.complex128)
        b[:n] = np.conj(c)
        b[conv_n - n + 1 :] = np.conj(c)[1:][::-1]
        return c, np.fft.fft(b) * (1.0 / conv_n)

    def chirp(self, n: int, conv_n: int, sign: int) -> str:
        """Bluestein chirp ``c`` (suffixes ``cr``/``ci``, length n) and b̂
        (``br``/``bi``, length conv_n, 1/conv_n folded in)."""
        key = f"B{'f' if sign < 0 else 'b'}{n}_{conv_n}"
        if key not in self.host:
            c, bf = self._bluestein_bhat(n, conv_n, sign)
            self.host[key + "cr"] = c.real.astype(self.dtype)
            self.host[key + "ci"] = c.imag.astype(self.dtype)
            self.host[key + "br"] = bf.real.astype(self.dtype)
            self.host[key + "bi"] = bf.imag.astype(self.dtype)
            self.host[key] = None
        return key

    def bluestein_post(self, n: int, conv_n: int, g1: int, g2: int,
                       sign: int) -> str:
        """b̂ (suffix ``f``) and the final chirp zero-extended past n
        (``g``), each arranged [k1, k2] (g1, g2) for a GLOBAL convolution
        g1 × g2.  The three-pass kernel reads ``f`` in its middle pass."""
        key = f"O{'f' if sign < 0 else 'b'}{n}_{g1}x{g2}"
        if key not in self.host:
            c, bf = self._bluestein_bhat(n, conv_n, sign)
            cz = np.zeros(conv_n, dtype=np.complex128)
            cz[:n] = c
            for suf, arr in (("f", bf), ("g", cz)):
                m = arr.reshape(g2, g1).T  # [k1, k2]
                self.host[key + suf + "r"] = np.ascontiguousarray(
                    m.real
                ).astype(self.dtype)
                self.host[key + suf + "i"] = np.ascontiguousarray(
                    m.imag
                ).astype(self.dtype)
            self.host[key] = None
        return key

    def bluestein_pre(self, n: int, g2: int, nv: int, sign: int) -> str:
        """Pass-1 chirp of the three-pass kernel: (nv, g2) [j1, j2] =
        c[j1·g2 + j2], zero past n."""
        key = f"C{'f' if sign < 0 else 'b'}{n}_{g2}x{nv}"
        if key not in self.host:
            cr, ci = tw.bluestein_chirp(n, sign, np.float64)
            cz = np.zeros(nv * g2, dtype=np.complex128)
            cz[:n] = cr + 1j * ci
            m = cz.reshape(nv, g2)
            self.host[key + "r"] = m.real.astype(self.dtype)
            self.host[key + "i"] = m.imag.astype(self.dtype)
            self.host[key] = None
        return key

    def bluestein_final(self, n: int, g1b: int, g2b: int, sign: int) -> str:
        """Pass-3 chirp of the three-pass kernel on the swapped backward
        factorization (g1b, g2b): [k1', k2'] = c[k1' + g1b·k2'], zero past
        n."""
        key = f"D{'f' if sign < 0 else 'b'}{n}_{g1b}x{g2b}"
        if key not in self.host:
            cr, ci = tw.bluestein_chirp(n, sign, np.float64)
            cz = np.zeros(g1b * g2b, dtype=np.complex128)
            cz[:n] = cr + 1j * ci
            m = cz.reshape(g2b, g1b).T  # [k1', k2']
            self.host[key + "r"] = np.ascontiguousarray(m.real).astype(
                self.dtype
            )
            self.host[key + "i"] = np.ascontiguousarray(m.imag).astype(
                self.dtype
            )
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


def valid_rows(n: int, g2: int) -> int:
    """Rows of the (g1, g2) view of a Bluestein convolution that hold input
    (or output) of the n-point transform, ceil(n / g2), rounded up to 8 as
    the JAX package rounds it (``pallas_bluestein.valid_rows``)."""
    return -(-(-(-n // g2)) // 8) * 8


def collect_bank_keys(
    plan: Plan1D, sign: int, bank: TwiddleBank, keys: dict
) -> dict:
    """Materialize the tables the kernels of ``plan`` need and record their
    names in ``keys`` under the JAX package's tuple keys: ``("W", f, sign)``,
    ``("U", a, 128, sign)``, ``("T", f, m, sign)``; for a BLUESTEIN plan
    ``("B", n, sign)`` and, when its convolution is GLOBAL g1 × g2,
    ``("BPOST", n, sign)``, ``("BPRE", n, sign)``, ``("BFIN", n, sign)``
    and ``("T", g2, g1, +1)`` (the three-pass kernel's), then the
    convolution's own tables in both directions."""
    if plan.level == Level.DIRECT:
        keys[("W", plan.n, sign)] = bank.dft(plan.n, sign)
    elif is_two_stage(plan):  # K2, K13's two-stage mode: U, not T
        a = plan.factors[0]
        keys[("W", a, sign)] = bank.dft(a, sign)
        keys[("W", 128, sign)] = bank.dft(128, sign)
        keys[("U", a, 128, sign)] = bank.twiddle_fm(a, 128, sign)
    elif plan.level == Level.FUSED:  # the chain's tables, as the JAX package's
        for f, m in stage_shapes(plan.factors):
            keys[("W", f, sign)] = bank.dft(f, sign)
            if m > 1:
                keys[("T", f, m, sign)] = bank.twiddle(f, m, sign)
    elif plan.level == Level.GLOBAL:
        g1, g2 = plan.sub
        keys[("T", g1.n, g2.n, sign)] = bank.twiddle(g1.n, g2.n, sign)
        collect_bank_keys(g1, sign, bank, keys)
        collect_bank_keys(g2, sign, bank, keys)
    elif plan.level == Level.BLUESTEIN:
        n, conv = plan.n, plan.conv
        keys[("B", n, sign)] = bank.chirp(n, conv.n, sign)
        if conv.level == Level.GLOBAL:
            g1, g2 = conv.sub[0].n, conv.sub[1].n
            keys[("BPOST", n, sign)] = bank.bluestein_post(n, conv.n, g1, g2, sign)
            nv = valid_rows(n, g2)
            if nv <= g1 and bank.dtype == np.float32:
                keys[("BPRE", n, sign)] = bank.bluestein_pre(n, g2, nv, sign)
                keys[("BFIN", n, sign)] = bank.bluestein_final(n, g2, g1, sign)
                keys[("T", g2, g1, +1)] = bank.twiddle(g2, g1, +1)
        collect_bank_keys(conv, -1, bank, keys)
        collect_bank_keys(conv, +1, bank, keys)
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
