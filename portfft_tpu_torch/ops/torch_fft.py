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
kernel's first and last chirps); for K16 ``G{f|b}{ga}x{gb}N{n}t{t1}``
(its factored twiddle, suffixes ``1r``/``1i``/``2r``/``2i``); for K5,
K18 and K19 ``GA{f|b}{A1}x{g2}N{n}`` and ``GB{f|b}128x{g2}N{n/A1}`` (the
factored inter-factor twiddle) and for K19 ``G2{f|b}L{n/A1}t{t1}`` (GB
itself factored, suffixes ``1tr``/``1ti``/``2r``/``2i``); for K17's
factored mode ``Q{f|b}{g1}N{n}t{t1}`` (a DIRECT G1) and
``Y{f|b}{a}x{g2}N{n}t{t1}`` (a FUSED [a, 128] G1), suffixes ``1r`` …
``4i``.  The values are the JAX package's too
(``twiddle.py``), so a table carried over from it (``convert.py``) and one
built here are interchangeable.  ``RM{f|b}{n}_{scale}m`` (the small-n REAL
matrix, :meth:`TwiddleBank.real_small`) has no counterpart there: the JAX
package keeps the same matrix only as a bf16 stack.  Neither has the port
a counterpart of its bf16 presplit matrices (``mat_kara``, ``dft_kstack``)
or its split-output tables (``vmat_split``): the tensor-core kernels
K10-mm and K16 split the bank's float32 roots into TF32 hi/lo parts in
registers, and their plain versions do the same with :func:`tf32_split`.
Nor has it the TPU layouts of engine 8's tables (the pair-duplicated
``UI``/``GAI``/``GBI``, the stacked bf16 ``ILL``/``ILR``, ``UT``) or the
duplicate orientations of the bf2 and Z tables: K18 reads K5's ``U``,
``GA`` and ``GB``, and each kernel reads one orientation.
"""

from __future__ import annotations

import contextlib
import math

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

    def blane_permuted(self, base_key: str, row_f, col_f,
                       suffixes=("r", "i")) -> str:
        """A banked table with its rows (``row_f``) and/or columns
        (``col_f``) in the butterfly lane DFT's slab-digit-major order
        (:func:`lane_perm`): position p holds frequency p // 128 + A·(p %
        128), f = A·128.  K15's butterfly mode reads the tables that sit
        between its forward stages, which leave their outputs in that
        order, and its backward stages, which take them so
        (``xla_fft.TwiddleBank.blane_permuted``)."""
        key = base_key + f"_bl{row_f or 0}x{col_f or 0}"
        if key not in self.host:
            for suf in suffixes:
                m = np.asarray(self.host[base_key + suf])
                if row_f:
                    m = m[lane_perm(row_f), :]
                if col_f:
                    m = m[:, lane_perm(col_f)]
                self.host[key + suf] = np.ascontiguousarray(m)
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

    def bf_twiddle_hi(self, a: int, g2: int, n: int, sign: int) -> str:
        """K5's high-digit factor of the inter-factor twiddle, (A1, g2)
        [kA1, n2] = w_n^(kA1·n2)."""
        key = f"GA{'f' if sign < 0 else 'b'}{a}x{g2}N{n}"
        if key not in self.host:
            re, im = tw.twiddles_n(a, g2, n, sign, self.dtype)
            self.host[key + "r"] = re
            self.host[key + "i"] = im
            self.host[key] = None
        return key

    def bf_twiddle_lo(self, g2: int, n_lo: int, sign: int) -> str:
        """K5's low-digit factor, (128, g2) [kB1, n2] = w_{n/A1}^(kB1·n2):
        with the high factor, w_n^(k1·n2) for k1 = kA1 + A1·kB1."""
        key = f"GB{'f' if sign < 0 else 'b'}128x{g2}N{n_lo}"
        if key not in self.host:
            re, im = tw.twiddles_n(128, g2, n_lo, sign, self.dtype)
            self.host[key + "r"] = re
            self.host[key + "i"] = im
            self.host[key] = None
        return key

    def global3_btw(self, ga: int, gb: int, n: int, t1: int, sign: int) -> str:
        """K16's resident factors of its pass-1 twiddle w_n^(k1·n2b), k1 =
        k1_lo + ga·k1_hi, n2b < t1 (the JAX package's
        ``TwiddleBank.global3_btw``, the same key and arrays): ``1`` =
        B1[k1_lo, 2·n2b + q] = w_n^(k1_lo·n2b), (ga, 2·t1), and ``2`` =
        B2[k1_hi, 2·n2b + q] = w_(n/ga)^(k1_hi·n2b), (gb, 2·t1), each value
        twice (the reference's lanes hold re/im pairs; K16 reads every
        second column)."""
        key = f"G{'f' if sign < 0 else 'b'}{ga}x{gb}N{n}t{t1}"
        if key not in self.host:
            b1r, b1i = tw.twiddles_n(ga, t1, n, sign, np.float64)
            b2r, b2i = tw.twiddles_n(gb, t1, n // ga, sign, np.float64)
            for suf, arr in (("1r", b1r), ("1i", b1i), ("2r", b2r), ("2i", b2i)):
                self.host[key + suf] = np.ascontiguousarray(
                    np.repeat(arr, 2, 1)).astype(self.dtype)
            self.host[key] = None
        return key

    def btw_planes(self, g1: int, g2: int, n: int, t1: int, sign: int) -> str:
        """K17's factored pass-1 twiddle for a DIRECT G1 (128 | G1; the
        JAX package's ``TwiddleBank.btw_planes``, the same key and arrays):
        with k1 = k1_lo + 128·k1_hi and n2 = t1·ti + n2b, w_n^(k1·n2) is
        the product of ``1`` = B1[n2b, k1_lo] = w_n^(n2b·k1_lo) (t1, 128),
        ``2`` = B2[n2b, k1_hi] = w_(n/128)^(n2b·k1_hi) (t1, G1/128), ``3``
        = A1[ti, k1_lo] = w_n^(ti·t1·k1_lo) (G2/t1, 128) and ``4`` =
        A2[ti, k1_hi] = w_(n/128)^(ti·t1·k1_hi) (G2/t1, G1/128)."""
        gb = g1 // 128
        key = f"Q{'f' if sign < 0 else 'b'}{g1}N{n}t{t1}"
        if key not in self.host:
            rows = np.arange(t1, dtype=np.float64)
            tiles = np.arange(g2 // t1, dtype=np.float64) * t1
            for suf, (r, cols, root) in (("1", (rows, 128, n)),
                                         ("2", (rows, gb, n // 128)),
                                         ("3", (tiles, 128, n)),
                                         ("4", (tiles, gb, n // 128))):
                self._roots(key + suf, r, np.arange(cols, dtype=np.float64),
                            root, sign)
            self.host[key] = None
        return key

    def global_fused_twiddles_factored(self, a: int, g2: int, n: int, t1: int,
                                       sign: int) -> str:
        """K17's factored pass-1 twiddle for a FUSED [a, 128] G1 (a | 128;
        the JAX package's ``TwiddleBank.global_fused_twiddles_factored``,
        the same key and arrays): with k1 = k1a + a·k2a and n2 = t1·ti +
        n2b, w_n^(k1·n2) = w_n^(k1a·n2)·w_(n/a)^(k2a·n2), each factor split
        over n2.  Columns q hold exponent q mod a (``1``, ``3``) and σ(q) =
        (q mod a)·(128/a) + q div a (``2``, ``4``, the reference's fold
        order): ``1`` = w_n^(n2b·(q mod a)) (t1, 128), ``2`` =
        w_(n/a)^(n2b·σ(q)) (t1, 128), ``3`` and ``4`` the same at ti·t1
        (G2/t1, 128).  K17 reads column k1a of ``1``/``3`` and column
        σ⁻¹(k2a) of ``2``/``4``."""
        key = f"Y{'f' if sign < 0 else 'b'}{a}x{g2}N{n}t{t1}"
        if key not in self.host:
            q = np.arange(128)
            e1 = np.mod(q, a).astype(np.float64)
            sigma = ((q % a) * (128 // a) + q // a).astype(np.float64)
            rows = np.arange(t1, dtype=np.float64)
            tiles = np.arange(g2 // t1, dtype=np.float64) * t1
            for suf, (r, cols, root) in (("1", (rows, e1, n)),
                                         ("2", (rows, sigma, n // a)),
                                         ("3", (tiles, e1, n)),
                                         ("4", (tiles, sigma, n // a))):
                self._roots(key + suf, r, cols, root, sign)
            self.host[key] = None
        return key

    def bf_lo_factored(self, n_lo: int, t1: int, n_tiles: int, sign: int) -> str:
        """K19's resident factors of K5's low twiddle GB[kB1, n2] =
        w_(n_lo)^(kB1·n2), n_lo = n/A1, with n2 = c + t1·s (the JAX
        package's ``TwiddleBank.bf_lo_factored``, the same key; of its
        orientations the two K19 reads): ``1t`` = B1ᵀ[kB1, c] =
        w_(n_lo)^(c·kB1) (128, t1) and ``2`` = B2[s, kB1] =
        w_(n_lo)^(s·t1·kB1) (n_tiles, 128)."""
        key = f"G2{'f' if sign < 0 else 'b'}L{n_lo}t{t1}"
        if key not in self.host:
            kb = np.arange(128, dtype=np.float64)
            self._roots(key + "1t", kb, np.arange(t1, dtype=np.float64), n_lo,
                        sign)
            self._roots(key + "2", np.arange(n_tiles, dtype=np.float64) * t1,
                        kb, n_lo, sign)
            self.host[key] = None
        return key

    def _roots(self, name: str, rows, cols, root: int, sign: int) -> None:
        """``name`` r/i = w_root^(rows[i]·cols[j]), the exponent reduced mod
        the root order in float64 before scaling, as ``twiddle.py``."""
        theta = (2.0 * np.pi / root) * np.mod(rows[:, None] * cols[None, :], root)
        self.host[name + "r"] = np.cos(theta).astype(self.dtype)
        self.host[name + "i"] = (np.float64(sign) * np.sin(theta)).astype(
            self.dtype)

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


def fold_factor(a: int) -> int:
    """The JAX package's k2-fold count g of a FUSED [a, 128] plan
    (``pallas_fft.fold_factor``): 1 where 2a is a multiple of 128, 128/(2a)
    where 2a divides 128, else 0.  Its engine-2 and engine-3 kernels take
    only g > 0; the Hopper kernels K2-v2 and K2-v3 keep that condition (they
    fold nothing: they write natural order directly)."""
    if (2 * a) % 128 == 0:
        return 1
    if 128 % (2 * a) == 0:
        return 128 // (2 * a)
    return 0


def _planes(raw: torch.Tensor, batch: int, a: int):
    """The (re, im) planes of the raw buffer as (batch, a, 128) = [n1, n2]."""
    x = raw.view(batch, a, 128, 2)
    return x[..., 0], x[..., 1]


def _natural(cr: torch.Tensor, ci: torch.Tensor, scale: float) -> torch.Tensor:
    """C (..., k1, k2) planes -> the raw buffer in natural order
    out[k1 + a·k2], scaled."""
    y = torch.stack((cr, ci), dim=-1).transpose(-2, -3)  # [k2, k1, p]
    return (y * scale).reshape(-1)


def fused2_v1_plain(raw: torch.Tensor, batch: int, sub, scale: float) -> torch.Tensor:
    """Plain version of K2-v1 (``fused2_raw_call``'s decomposition): the
    planes transposed to [n2, n1], stage A as a right matmul by W_a, the
    inner twiddle in [n2, k1] orientation, the transpose back, stage B by
    W_128, and the digit-reversed store out[k1 + a·k2] as one transpose.
    ``sub``: ``cuda_fft.SubTables`` of the plan (W_a, W_128, U)."""
    xr, xi = _planes(raw, batch, sub.a)
    with full_fp32_matmuls(raw):
        ar, ai = complex_matmul(xr.transpose(-1, -2), xi.transpose(-1, -2),
                                sub.wr, sub.wi)  # [n2, k1]
        ar, ai = complex_mul(ar, ai, sub.ur.T, sub.ui.T)
        cr, ci = complex_matmul(ar.transpose(-1, -2), ai.transpose(-1, -2),
                                sub.br, sub.bi)  # [k1, k2]
        return _natural(cr, ci, scale)


def fused2_v2_plain(raw: torch.Tensor, batch: int, sub, bt: int,
                    scale: float) -> torch.Tensor:
    """Plain version of K2-v2 (``fused2_raw_v2_call``'s decomposition):
    de-interleaved planes, per tile of ``bt`` transforms stage A as one left
    matmul W_a @ X over the (a, bt·128) view, the inner twiddle broadcast
    over the tile, stage B by W_128 over the (a, bt, 128) view, then
    re-interleaved in natural order with the scale."""
    a = sub.a
    xr, xi = _planes(raw, batch, a)

    def tiled(p):  # (batch, a, 128) -> (tiles, a, bt·128) = [n1, (b, n2)]
        return p.reshape(batch // bt, bt, a, 128).transpose(1, 2).reshape(
            batch // bt, a, bt * 128)

    with full_fp32_matmuls(raw):
        ar, ai = complex_matmul(sub.wr, sub.wi, tiled(xr), tiled(xi))
        shape = (batch // bt, a, bt, 128)
        ar, ai = complex_mul(ar.view(shape), ai.view(shape),
                             sub.ur[:, None], sub.ui[:, None])
        cr, ci = complex_matmul(ar, ai, sub.br, sub.bi)  # [k1, b, k2]
        return _natural(cr.transpose(1, 2), ci.transpose(1, 2), scale)


def _pairswap(x: torch.Tensor) -> torch.Tensor:
    """Interleaved (re, im) pairs -> (-im, re): i·z on the pairs."""
    p = x.unflatten(-1, (-1, 2))
    return torch.stack((-p[..., 1], p[..., 0]), dim=-1).flatten(-2)


def fused2_v3_plain(raw: torch.Tensor, batch: int, sub, bt: int,
                    scale: float) -> torch.Tensor:
    """Plain version of K2-v3 (``fused2_raw_v3_call``'s decomposition):
    the pairs stay interleaved.  Stage A is the left complex matmul on
    interleaved rows, W_r @ x + W_i @ pairswap(x); the inner twiddle is
    y·U_r + pairswap(y)·U_i with U pair-expanded; stage B is one real
    matmul by the (256, 256) interleaved table of scale·W_128 (the scale
    folded into the stage-B table, as the reference's ``vmat_split``).
    ``bt`` tiles nothing here: the transforms are independent."""
    del bt
    a = sub.a
    x = raw.view(batch, a, 256)  # [n1, 2·n2 + p]
    with full_fp32_matmuls(raw):
        y = torch.matmul(sub.wr, x) + torch.matmul(sub.wi, _pairswap(x))
        y = (y * sub.ur.repeat_interleave(2, -1)
             + _pairswap(y) * sub.ui.repeat_interleave(2, -1))
        br, bi = sub.br * scale, sub.bi * scale
        v = torch.empty(256, 256, dtype=raw.dtype, device=raw.device)
        v[0::2, 0::2], v[1::2, 0::2] = br, -bi
        v[0::2, 1::2], v[1::2, 1::2] = bi, br
        c = torch.matmul(y, v).view(batch, a, 128, 2)  # [k1, k2, p]
        return c.transpose(1, 2).reshape(-1)


def bf_factor(g: int) -> int:
    """The butterfly factor A of g = A·128 for K5: a power of two in
    [1, 16], else 0 (``pallas_global_bf.bf_factor``)."""
    if g % 128:
        return 0
    a = g // 128
    return a if 1 <= a <= 16 and not a & (a - 1) else 0


def lane_perm(f: int) -> list[int]:
    """The frequency at each position of the butterfly lane DFT's output,
    f = A·128: position p holds p // 128 + A·(p % 128) (slab kA = k mod A
    at positions [128·kA, 128·kA + 128), kB = k // A within it;
    ``pallas_bluestein.lane_perm``)."""
    a = f // 128
    return [(p // 128) + a * (p % 128) for p in range(f)]


def ilv_factor(g: int) -> int:
    """The slab factor A of g = A·128 for K18: any A = 2^a·3^b in [1, 16]
    (mixed radix, so 3·2^k and 9·2^k subs such as 384 and 1152 qualify),
    else 0 (``pallas_global_ilv.ilv_factor``)."""
    if g % 128 or not 1 <= g // 128 <= 16:
        return 0
    a = r = g // 128
    for p in (2, 3):
        while r % p == 0:
            r //= p
    return a if r == 1 else 0


def _snap(v: float) -> float:
    """A host-computed root of unity's part snapped to exact 0 or ±1, so
    the butterfly multiplies by exact constants
    (``pallas_global_bf._snap``)."""
    for t in (0.0, 1.0, -1.0):
        if abs(v - t) < 1e-12:
            return t
    return v


def unit_root(e: int, s: int, sign: int) -> tuple[float, float]:
    """exp(sign·2πi·e/s) with its parts snapped (:func:`_snap`)."""
    ang = sign * 2.0 * math.pi * (e % s) / s
    return _snap(math.cos(ang)), _snap(math.sin(ang))


def _cmul_const(xr, xi, wr: float, wi: float):
    """(xr + i·xi)·(wr + i·wi) with the exact shortcuts for ±1 and ±i."""
    if wi == 0.0:
        return (xr, xi) if wr == 1.0 else (-xr, -xi) if wr == -1.0 else (
            xr * wr, xi * wr)
    if wr == 0.0:
        return (-xi, xr) if wi == 1.0 else (xi, -xr) if wi == -1.0 else (
            -xi * wi, xr * wi)
    return xr * wr - xi * wi, xr * wi + xi * wr


def mixed_radix_dft(slabs: list, sign: int) -> list:
    """The A-point DFT across the A = ``len(slabs)`` (re, im) slabs, A =
    2^a·3^b: decimation in time, radix 2 while A is even, then radix 3
    (``pallas_global_ilv._bf_slabs_ilv``), natural order in and out: input
    slab j is the high digit iA of i = 128·iA + iB, output slab k the low
    frequency digit kA of k = kA + A·kB.  With r the radix and m = A/r,
    out[q + t·m] = Σ_i (sub_i[q]·w_A^(i·q))·w_r^(i·t), sub_i the m-point
    DFT of slabs i, i + r, …; every constant snapped (:func:`unit_root`).
    Powers of two are K5's radix-2 butterfly.  ``csrc/fft_global_bf.cuh``'s
    ``slab_dft`` runs the same steps."""
    a = len(slabs)
    if a == 1:
        return slabs
    r = 2 if a % 2 == 0 else 3
    m = a // r
    subs = [mixed_radix_dft(slabs[i::r], sign) for i in range(r)]
    out = [None] * a
    for q in range(m):
        parts = [subs[0][q]] + [_cmul_const(*subs[i][q], *unit_root(i * q, a, sign))
                                for i in range(1, r)]
        for t in range(r):
            acc = parts[0]
            for i in range(1, r):
                pr, pi = _cmul_const(*parts[i], *unit_root(i * t, r, sign))
                acc = (acc[0] + pr, acc[1] + pi)
            out[q + t * m] = acc
    return out


#: The widths the port picks for the factored twiddle tables of K17
#: (``Q``/``ZQ``, one of the JAX package's ``FTW_T1_CANDIDATES``, and a
#: multiple of every K17 tile width) and of K19 (``G2L``, the least of its
#: ``BF2_T1_CANDIDATES``, which leaves K5's tiles the most shared memory).
FTW_T1 = 64
BF2_T1 = 128


def ftw_factors(plan: Plan1D) -> tuple[int, int] | None:
    """(L, H) of K17's factored twiddle, k1 = k1_lo + L·k1_hi: (128,
    G1/128) for a DIRECT G1 with 128 | G1 (the ``Q`` tables), (a, 128)
    for a FUSED [a, 128] G1 with a | 128 (``ZQ``); None where no such
    table exists or ``FTW_T1`` does not divide G2."""
    if plan.level != Level.GLOBAL:
        return None
    g1, g2 = plan.sub
    if g2.n % FTW_T1:
        return None
    if g1.level == Level.DIRECT:
        return (128, g1.n // 128) if g1.n % 128 == 0 else None
    if is_two_stage(g1) and 128 % g1.factors[0] == 0:
        return g1.factors[0], 128
    return None


#: The width of K16's twiddle tables (``TwiddleBank.global3_btw``): one of
#: the JAX package's ``pallas_global3.T1_CANDIDATES``, dividing every G2 K16
#: takes, so that the reference banks the same key.
GLOBAL3_T1 = 64


def digit_split(g: int) -> tuple[int, int]:
    """g = ga·gb, ga the largest power-of-two divisor of g with ga² ≤ g
    (``pallas_global3.digit_split``)."""
    ga, d = 1, 2
    while g % d == 0 and d * d <= g:
        ga, d = d, 2 * d
    return ga, g // ga


def global3_digits(plan: Plan1D) -> tuple[int, int] | None:
    """The digits (ga, gb) of K16's twiddle for a GLOBAL plan the JAX
    package's ``global3_supported`` takes (G1 DIRECT ≤ 512 or FUSED [a, 128],
    G2 DIRECT ≤ 512, both multiples of 128): ``digit_split(G1)``, or (a, 128)
    for a FUSED G1; None for any other plan."""
    if plan.level != Level.GLOBAL:
        return None
    g1, g2 = plan.sub
    if g1.level == Level.DIRECT:
        ok1 = g1.n <= 512
    else:
        ok1 = is_two_stage(g1) and g1.factors[0] >= 2
    if not (ok1 and g2.level == Level.DIRECT and g2.n <= 512
            and g2.n % 128 == 0 and g1.n % 128 == 0):
        return None
    return digit_split(g1.n) if g1.level == Level.DIRECT else (g1.factors[0], 128)


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
    and ``("T", g2, g1, +1)`` (the three-pass kernel's), and where both
    convolution subs are A·128 with A = 2^a·3^b ≤ 16 (``ilv_factor``) the
    butterfly mode's ``("BLT", n, sign)``, ``("BLP", n, sign)`` and
    ``("BLB", n, sign)`` (:meth:`TwiddleBank.blane_permuted`) with ``("U",
    A, 128, ±1)`` and ``("W", 128, ±1)``, then the convolution's own tables
    in both directions.  A GLOBAL plan whose
    subs are both A·128 (``bf_factor``) also gets K5's ``("U", A1, 128,
    sign)``, ``("U", A2, 128, sign)``, ``("GA", g1, g2, sign)``, ``("GB",
    g1, g2, sign)`` and ``("W", 128, sign)``, as the JAX package banks its
    butterfly engine's tables; the same for subs whose factors are
    2^a·3^b (``ilv_factor``, K18's).  Where both are powers of two it also
    gets K19's ``("G2L", g2, BF2_T1, sign)``.  A GLOBAL plan K16 takes
    (``global3_digits``) gets ``("G3", g1, g2, sign)``, K16's factored
    twiddle at width ``GLOBAL3_T1``; one whose G1 K17's factored mode
    takes (``ftw_factors``) its ``("Q", g1, n, sign, FTW_T1)`` (DIRECT
    G1) or ``("ZQ", g1, g2, sign, FTW_T1)`` (FUSED G1)."""
    if plan.level == Level.DIRECT:
        keys[("W", plan.n, sign)] = bank.dft(plan.n, sign)
    elif is_two_stage(plan):  # K2, K13's two-stage mode: U, not T
        a = plan.factors[0]
        keys[("W", a, sign)] = bank.dft(a, sign)
        keys[("W", 128, sign)] = bank.dft(128, sign)
        keys[("U", a, 128, sign)] = bank.twiddle_fm(a, 128, sign)
        if a < 8:  # the plane path runs [a < 8, 128] in K13's chain mode
            keys[("T", a, 128, sign)] = bank.twiddle(a, 128, sign)
    elif plan.level == Level.FUSED:  # the chain's tables, as the JAX package's
        for f, m in stage_shapes(plan.factors):
            keys[("W", f, sign)] = bank.dft(f, sign)
            if m > 1:
                keys[("T", f, m, sign)] = bank.twiddle(f, m, sign)
    elif plan.level == Level.GLOBAL:
        g1, g2 = plan.sub
        keys[("T", g1.n, g2.n, sign)] = bank.twiddle(g1.n, g2.n, sign)
        digits = global3_digits(plan)
        if digits:  # K16's factored twiddle
            keys[("G3", g1.n, g2.n, sign)] = bank.global3_btw(
                *digits, plan.n, GLOBAL3_T1, sign)
        if ftw_factors(plan):  # K17's factored twiddle
            if g1.level == Level.DIRECT:
                keys[("Q", g1.n, plan.n, sign, FTW_T1)] = bank.btw_planes(
                    g1.n, g2.n, plan.n, FTW_T1, sign)
            else:
                keys[("ZQ", g1.n, g2.n, sign, FTW_T1)] = (
                    bank.global_fused_twiddles_factored(
                        g1.factors[0], g2.n, plan.n, FTW_T1, sign))
        a1, a2 = ilv_factor(g1.n), ilv_factor(g2.n)
        if a1 and a2:  # K5, K18: digit twiddles, factored twiddle, 128-point roots
            keys[("U", a1, 128, sign)] = bank.twiddle_fm(a1, 128, sign)
            keys[("U", a2, 128, sign)] = bank.twiddle_fm(a2, 128, sign)
            keys[("GA", g1.n, g2.n, sign)] = bank.bf_twiddle_hi(
                a1, g2.n, plan.n, sign)
            keys[("GB", g1.n, g2.n, sign)] = bank.bf_twiddle_lo(
                g2.n, plan.n // a1, sign)
            keys[("W", 128, sign)] = bank.dft(128, sign)
            if bf_factor(g1.n) and bf_factor(g2.n):  # K19: GB factored
                keys[("G2L", g2.n, BF2_T1, sign)] = bank.bf_lo_factored(
                    plan.n // a1, BF2_T1, g2.n // BF2_T1, sign)
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
                a1, a2 = ilv_factor(g1), ilv_factor(g2)
                if a1 and a2:  # K15's butterfly mode: the permuted tables
                    twf = bank.twiddle(g1, g2, -1)
                    keys[("T", g1, g2, -1)] = twf
                    keys[("BLT", n, sign)] = bank.blane_permuted(twf, None, g1)
                    keys[("BLP", n, sign)] = bank.blane_permuted(
                        keys[("BPOST", n, sign)], g1, g2, suffixes=("fr", "fi"))
                    keys[("BLB", n, sign)] = bank.blane_permuted(
                        keys[("T", g2, g1, +1)], g1, None)
                    for s2 in (-1, +1):
                        keys[("U", a1, 128, s2)] = bank.twiddle_fm(a1, 128, s2)
                        keys[("U", a2, 128, s2)] = bank.twiddle_fm(a2, 128, s2)
                        keys[("W", 128, s2)] = bank.dft(128, s2)
        collect_bank_keys(conv, -1, bank, keys)
        collect_bank_keys(conv, +1, bank, keys)
    return keys


def complex_matmul(xr, xi, wr, wi):
    """(xr + i·xi) @ (wr + i·wi) as four real ``torch.matmul`` calls."""
    return (
        torch.matmul(xr, wr) - torch.matmul(xi, wi),
        torch.matmul(xr, wi) + torch.matmul(xi, wr),
    )


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: float32 ``x`` rounded to 10 mantissa bits, ties
    away from zero (adding half of the 13 dropped bits to the magnitude
    field, then clearing them)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo): hi = tf32(x), lo = tf32(x - hi); hi + lo is x to about
    2^-22 of x."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def _mm_x3(a: tuple, b: tuple) -> torch.Tensor:
    """a @ b from their TF32 splits, lo·lo dropped: the tensor-core DFT
    tile's three mma per real product (``csrc/fft_mma.cuh``)."""
    (ah, al), (bh, bl) = a, b
    return torch.matmul(al, bh) + torch.matmul(ah, bl) + torch.matmul(ah, bh)


def dft_x3(wr, wi, xr, xi):
    """The complex product W @ X of the tensor-core DFT tile, each real
    product at its three-term TF32 grade: the plain versions of K10-mm and
    K16.  W (len, len) broadcasts over the leading axes of X (..., len, N)."""
    wr, wi, xr, xi = (tf32_split(t) for t in (wr, wi, xr, xi))
    return _mm_x3(wr, xr) - _mm_x3(wi, xi), _mm_x3(wr, xi) + _mm_x3(wi, xr)


def complex_mul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def radix_stages(n: int) -> list[int]:
    """The radices of ``csrc/fft_radix.cuh``'s n-point FFT in stage order
    (its ``stages``): each prime factor above 3, then the 3s, then the
    power of two as 8s with one 4, two 4s or one 2 (128 = 8·4·4, 384 =
    3·8·4·4, 508 = 127·4, 512 = 8·8·8)."""
    twos = threes = 0
    while n % 2 == 0:
        n, twos = n // 2, twos + 1
    while n % 3 == 0:
        n, threes = n // 3, threes + 1
    primes, p = [], 5
    while n > 1:
        if p * p > n:
            p = n
        while n % p == 0:
            primes.append(p)
            n //= p
        p += 2
    fours = {0: [], 1: [4, 4] if twos > 1 else [2], 2: [4]}[twos % 3]
    eights = (twos - (3 if twos % 3 == 1 and twos > 1 else 0)) // 3
    return primes + [3] * threes + [8] * eights + fours


def _butterfly(v: list, sg: float) -> list:
    """The R-point DFT (R = ``len(v)`` in 2, 3, 4, 8) of complex tensors in
    natural order, w_R = exp(sg·2πi/R), by ``fft_radix.cuh``'s ``Bfly``
    steps and constants."""
    if len(v) == 2:
        return [v[0] + v[1], v[0] - v[1]]
    if len(v) == 3:
        t1, t2 = v[1] + v[2], v[1] - v[2]
        m, r = v[0] - 0.5 * t1, t2 * complex(0.0, sg * 0.86602540378443865)
        return [v[0] + t1, m + r, m - r]
    if len(v) == 4:
        a, b = v[0] + v[2], v[0] - v[2]
        c, d = v[1] + v[3], (v[1] - v[3]) * complex(0.0, sg)
        return [a + c, b + d, a - c, b - d]
    e, o = _butterfly(v[0::2], sg), _butterfly(v[1::2], sg)
    c = 0.70710678118654752
    o = [o[0], o[1] * complex(c, sg * c), o[2] * complex(0.0, sg),
         o[3] * complex(-c, sg * c)]
    return [e[q] + o[q] for q in range(4)] + [e[q] - o[q] for q in range(4)]


def radix_plain(x: torch.Tensor, root: torch.Tensor) -> torch.Tensor:
    """The n-point DFT of the last axis of the complex tensor ``x`` by the
    Stockham stages of ``csrc/fft_radix.cuh``, in its stage order, twiddle
    indices and output order: a stage of radix R after stages whose radices
    multiply to ns views the data as v[r, jj, k] = x[(jj·ns + k) + r·n/R],
    multiplies v[r] by root[r·k·n/(ns·R)] (ns > 1), takes the R-point
    butterfly and writes [jj, q, k]; a prime R > 3 is one sum whose root
    index r·(k + q·ns)·n/(ns·R) mod n folds in the stage twiddle.  ``root``
    is the complex root table (row 1 of the DFT matrix), whose imaginary
    part at 1 gives the direction."""
    *lead, n = x.shape
    sg = -1.0 if n > 2 and bool(root[1].imag < 0) else 1.0
    ns = 1
    for r in radix_stages(n):
        tw = n // (ns * r)
        v = x.reshape(*lead, r, n // (r * ns), ns)  # [r, jj, k]
        rr = torch.arange(r, device=x.device)
        k = torch.arange(ns, device=x.device)
        if r in (2, 3, 4, 8):
            if ns > 1:
                v = v * root[rr[:, None] * k * tw][:, None, :]
            y = torch.stack(_butterfly(list(v.unbind(-3)), sg), dim=-3)
        else:  # w[k, r, q] = root[r·(k + q·ns)·tw mod n]
            w = root[rr[None, :, None] * (k[:, None, None] + rr * ns) * tw % n]
            y = (v.movedim(-1, -3).transpose(-1, -2) @ w).transpose(-1, -2).movedim(-3, -1)
        x = y.movedim(-3, -2).reshape(*lead, n)  # [jj, q, k]
        ns *= r
    return x


def _root_table(wr: torch.Tensor, wi: torch.Tensor, n: int) -> torch.Tensor:
    """Row 1 of the n x n DFT planes as one complex tensor (the root table
    a kernel loads, ``load_roots``)."""
    row = n if n > 1 else 0
    return torch.complex(wr.reshape(-1)[row:row + n], wi.reshape(-1)[row:row + n])


def radix_sub_plain(sub, x: torch.Tensor) -> torch.Tensor:
    """``fft_radix.cuh``'s ``sub_fft`` on the last axis of the complex
    tensor ``x``, for the tables ``sub`` (``cuda_fft.SubTables``): DIRECT,
    :func:`radix_plain` of the m-point roots; FUSED [a, 128], stage A over
    n1 of element 128·n1 + n2, times the inner twiddle U[k1, n2], then stage
    B over n2, output k1 + a·k2."""
    if sub.a == 0:
        return radix_plain(x, _root_table(sub.wr, sub.wi, sub.m))
    a, lead = sub.a, x.shape[:-1]
    xa = x.reshape(*lead, a, 128).transpose(-1, -2)  # [n2, n1]
    ya = radix_plain(xa, _root_table(sub.wr, sub.wi, a))
    ya = ya * torch.complex(sub.ur, sub.ui).reshape(a, 128).transpose(0, 1)
    yb = radix_plain(ya.transpose(-1, -2), _root_table(sub.br, sub.bi, 128))
    return yb.transpose(-1, -2).reshape(*lead, sub.m)  # [k2, k1]


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
