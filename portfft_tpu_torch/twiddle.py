"""Twiddle-factor and DFT-matrix precomputation on the host.

Every constant the kernels use is computed here in float64 with the angle
reduced to its exact residue (``j·k mod n``) before scaling by 2π/n, then
cast to the compute precision — the same arithmetic as
``portfft_tpu.twiddle``, so the tables are bit-equal to the JAX package's.
No kernel evaluates ``sin`` or ``cos`` on the device.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=64)  # bounded: an entry is n×n float64 planes
def _dft_matrix_f64(n: int, sign: int) -> tuple:
    """n×n DFT matrix W[j, k] = exp(sign · 2πi · j·k / n) in float64.

    ``sign=-1`` is the forward transform, ``+1`` backward.  Row 1 is the
    n-entry root table ``W[1, k] = ω^k``, and ``W[j, k] = W[1, (j·k) mod n]``
    holds bit for bit, because both are computed from the same residue.
    """
    j = np.arange(n, dtype=np.float64)[:, None]
    k = np.arange(n, dtype=np.float64)[None, :]
    jk = np.mod(j * k, n)
    theta = (2.0 * np.pi / n) * jk
    return np.cos(theta), np.array(sign, np.float64) * np.sin(theta)


def dft_matrix(n: int, sign: int, dtype) -> tuple[np.ndarray, np.ndarray]:
    """Real/imag planes of the n-point DFT matrix in ``dtype``."""
    re, im = _dft_matrix_f64(n, sign)
    return re.astype(dtype), im.astype(dtype)


@functools.lru_cache(maxsize=64)
def _twiddles_f64(f: int, m: int, sign: int) -> tuple:
    """Inter-factor twiddles T[j, t] = exp(sign·2πi·j·t/(f·m)), shape (f, m):
    the factors between the f-point and the m-point transforms of the
    Cooley–Tukey split N = f·m."""
    n = f * m
    j = np.arange(f, dtype=np.float64)[:, None]
    t = np.arange(m, dtype=np.float64)[None, :]
    jt = np.mod(j * t, n)
    theta = (2.0 * np.pi / n) * jt
    return np.cos(theta), np.array(sign, np.float64) * np.sin(theta)


def twiddles(f: int, m: int, sign: int, dtype) -> tuple[np.ndarray, np.ndarray]:
    """Real/imag planes of the (f, m) inter-factor twiddle array."""
    re, im = _twiddles_f64(f, m, sign)
    return re.astype(dtype), im.astype(dtype)


@functools.lru_cache(maxsize=64)
def _twiddles_n_f64(f: int, m: int, n: int, sign: int) -> tuple:
    """T[j, t] = exp(sign·2πi·j·t/n), shape (f, m), for a root order ``n``
    that need not be f·m (the butterfly-factored GLOBAL engine's factored
    inter-factor twiddle)."""
    j = np.arange(f, dtype=np.float64)[:, None]
    t = np.arange(m, dtype=np.float64)[None, :]
    jt = np.mod(j * t, n)
    theta = (2.0 * np.pi / n) * jt
    return np.cos(theta), np.array(sign, np.float64) * np.sin(theta)


def twiddles_n(f: int, m: int, n: int, sign: int,
               dtype) -> tuple[np.ndarray, np.ndarray]:
    """Real/imag planes of the (f, m) twiddle block of root order ``n``."""
    re, im = _twiddles_n_f64(f, m, n, sign)
    return re.astype(dtype), im.astype(dtype)


def bluestein_chirp(n: int, sign: int, dtype) -> tuple[np.ndarray, np.ndarray]:
    """Chirp c[k] = exp(sign·πi·k²/n), k < n, of the Bluestein transform;
    the argument is reduced to k² mod 2n before scaling."""
    k = np.arange(n, dtype=np.float64)
    theta = (np.pi / n) * np.mod(k * k, 2.0 * n)
    return (
        np.cos(theta).astype(dtype),
        (np.array(sign, np.float64) * np.sin(theta)).astype(dtype),
    )
