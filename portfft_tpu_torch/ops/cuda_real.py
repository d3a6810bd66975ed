"""K8a ``untangle``, K8a-w ``untangle_wide``, K8b ``retangle`` and K9
``small_real``: wrappers of the CUDA kernels (``csrc/fft_real.cu``) and
their plain PyTorch versions.

Counterparts of ``portfft_tpu/ops/pallas_real.py``: ``untangle_raw_call``
(K8a), ``untangle_wide_raw_call`` with its gate ``wide_bt_ct`` (K8a-w, the
same function in column chunks), ``retangle_raw_call`` (K8b) and
``small_real_raw_call`` (K9).  The plain versions of K8 follow the JAX
package's plane path (``committed._core_real_forward``/
``_core_real_backward``); K9's multiplies the rows by the bank's small-n
REAL matrix (``TwiddleBank.real_small``).

Buffers are flat float32 tensors: the raw Z spectrum of ``2·batch·h``
scalars, the interleaved half spectrum of ``batch·(2h+2)`` and the real rows
of ``batch·n``.  K9 also takes float64 buffers with float64 tables (fp64:
its double kernels, ``pf_small_real_f64``).  Same rule as ``cuda_fft``: CPU
tensors go to the plain version, CUDA tensors to the kernel, and nothing
falls back.
"""

from __future__ import annotations

import dataclasses

import torch

from ..exceptions import InvalidConfiguration
from ..utils import tracing
from . import _build
from .cuda_fft import check_buffer, interleave, require_cuda, stream_of
from .torch_fft import complex_mul, full_fp32_matmuls


@dataclasses.dataclass(frozen=True)
class SmallRealTables:
    """The device tables of one direction of K9 at length ``n``: ``wr``/
    ``wi`` the n×n DFT planes (the kernel reads row 1, the root table) and
    ``mat`` the real matrix the plain version multiplies by, (n, n+2)
    forward or (n+2, n) backward, with ``scale`` folded in."""

    n: int
    sign: int
    scale: float
    wr: torch.Tensor
    wi: torch.Tensor
    mat: torch.Tensor


def _check_tables(buf: torch.Tensor, numel: int, what: str, *tables) -> None:
    """The tables are of ``numel`` scalars, on the buffer's device and of
    its dtype."""
    for t in tables:
        if t.device != buf.device or t.dtype != buf.dtype or t.numel() != numel:
            raise InvalidConfiguration(
                f"{what}: expected {buf.dtype} tables of {numel} scalars on "
                f"{buf.device}, got {t.dtype} of {t.numel()} on {t.device}"
            )


def untangle_plain(z, batch: int, h: int, wr, wi, scale: float):
    """Plain version of K8a: X[k] = E[k] + W^k·O[k] for k < h from Z and
    its reversal Z[(h−k) mod h], X[h] = Re Z[0] − Im Z[0], times scale."""
    zc = z.view(batch, h, 2)
    zr, zi = zc[..., 0], zc[..., 1]
    rr = torch.roll(torch.flip(zr, [-1]), 1, -1)
    ri = torch.roll(torch.flip(zi, [-1]), 1, -1)
    er = 0.5 * (zr + rr)
    ei = 0.5 * (zi - ri)
    our = 0.5 * (zi + ri)
    oui = -0.5 * (zr - rr)
    tr, ti = complex_mul(our, oui, wr, wi)
    xr = torch.cat([er + tr, zr[:, :1] - zi[:, :1]], -1)
    xi = torch.cat([ei + ti, torch.zeros_like(zi[:, :1])], -1)
    return interleave(xr, xi, scale)


def wide_supported(n: int, batch: int) -> bool:
    """K8a-w's gate: the JAX package's shape rule (``pallas_real.wide_bt_ct``:
    128 | h, h ≥ 256, batch a multiple of bt = 8, a ct ∈ {32, 16} tiles of
    128 dividing h/128) without its TPU VMEM term (ROADMAP Queue 3).  The
    kernel's own chunk is 256 bin pairs of 8 rows whatever the TPU's ct;
    the ct rule stays for parity with the reference's routes."""
    h = n // 2
    if n % 2 or h % 128 or h < 256 or batch % 8:
        return False
    return any((h // 128) % c == 0 for c in (32, 16))


def untangle_wide_plain(z, batch: int, h: int, wr, wi, scale: float):
    """Plain version of K8a-w, in its decomposition: the bin pairs (k,
    m = (h − k) mod h), k ≤ h/2, each giving X[k] from (Z[k], Z[m]) and
    X[m] from (Z[m], Z[k]) (X[m] written only where m is not k itself),
    and X[h] = Re Z[0] − Im Z[0], all times scale."""
    zc = z.view(batch, h, 2)
    x = torch.empty(batch, h + 1, 2, dtype=z.dtype, device=z.device)
    k = torch.arange(h // 2 + 1, device=z.device)
    m = (h - k) % h
    a, b = zc[:, k], zc[:, m]

    def bins(u, v, idx):
        er = 0.5 * (u[..., 0] + v[..., 0])
        ei = 0.5 * (u[..., 1] - v[..., 1])
        our = 0.5 * (u[..., 1] + v[..., 1])
        oui = -0.5 * (u[..., 0] - v[..., 0])
        tr, ti = complex_mul(our, oui, wr[idx], wi[idx])
        return torch.stack([(er + tr) * scale, (ei + ti) * scale], -1)

    x[:, k] = bins(a, b, k)
    keep = m != k
    x[:, m[keep]] = bins(b, a, m)[:, keep]
    x[:, h, 0] = (zc[:, 0, 0] - zc[:, 0, 1]) * scale
    x[:, h, 1] = 0.0
    return x.reshape(-1)


def retangle_plain(x, batch: int, h: int, wr, wi, scale: float,
                   drop: bool = False):
    """Plain version of K8b: Z = E2 + i·W^k·N2 with E2 = X[k] + conj X[h−k]
    and N2 = X[k] − conj X[h−k] (k = 0 reads X[h]), times scale; ``drop``
    reads Im X[0] and Im X[h] as 0."""
    xc = x.view(batch, h + 1, 2)
    if drop:
        xc = xc.clone()
        xc[:, 0, 1] = 0.0
        xc[:, h, 1] = 0.0
    xr, xi = xc[..., 0], xc[..., 1]
    rev_r = torch.flip(xr[:, 1:], [-1])
    rev_i = torch.flip(xi[:, 1:], [-1])
    e2r = xr[:, :h] + rev_r
    e2i = xi[:, :h] - rev_i
    n2r = xr[:, :h] - rev_r
    n2i = xi[:, :h] + rev_i
    o2r, o2i = complex_mul(n2r, n2i, wr, wi)
    return interleave(e2r - o2i, e2i + o2r, scale)


def small_real_plain(raw, batch: int, tabs: SmallRealTables):
    """Plain version of K9: each row times the small-n REAL matrix."""
    rows = raw.view(batch, tabs.mat.shape[0])
    with full_fp32_matmuls(raw):
        return torch.matmul(rows, tabs.mat).reshape(-1)


def _half_length(kernel_name: str, src, batch, h, wr, wi, scale, out_numel,
                 *flags):
    lib = _build.load()
    out = torch.empty(out_numel, dtype=torch.float32, device=src.device)
    with torch.cuda.device(src.device):
        err = getattr(lib, "pf_" + kernel_name)(
            src.data_ptr(), out.data_ptr(), wr.data_ptr(), wi.data_ptr(),
            batch, h, scale, *flags, stream_of(src),
        )
    _build.check(lib, err, kernel_name + " kernel")
    return out


@tracing.kernel("K8a", ("untangle_kernel",))
def untangle(z, batch: int, h: int, wr, wi, scale: float):
    """K8a: the raw Z spectrum of ``batch`` h-point forward transforms ->
    the interleaved half spectra of length n = 2h.  ``wr``/``wi``: the
    bank's ("R", n, -1) planes."""
    check_buffer(z, 2 * batch * h, "untangle")
    if z.device.type == "cpu":
        return untangle_plain(z, batch, h, wr, wi, scale)
    require_cuda(z, "untangle")
    _check_tables(z, h, "untangle", wr, wi)
    x = _half_length("untangle", z, batch, h, wr, wi, scale, batch * (2 * h + 2))
    return x


untangle.plain = untangle_plain


@tracing.kernel("K8a-w", ("untangle_wide_kernel",))
def untangle_wide(z, batch: int, h: int, wr, wi, scale: float):
    """K8a-w: K8a's function (``untangle``) in column chunks, for the
    shapes :func:`wide_supported` takes (the kernel itself takes any h ≥ 2 and
    batch)."""
    check_buffer(z, 2 * batch * h, "untangle_wide")
    if z.device.type == "cpu":
        return untangle_wide_plain(z, batch, h, wr, wi, scale)
    require_cuda(z, "untangle_wide")
    _check_tables(z, h, "untangle_wide", wr, wi)
    x = _half_length("untangle_wide", z, batch, h, wr, wi, scale,
                     batch * (2 * h + 2))
    return x


untangle_wide.plain = untangle_wide_plain


@tracing.kernel("K8b", ("retangle_kernel",))
def retangle(x, batch: int, h: int, wr, wi, scale: float, drop: bool = False):
    """K8b: ``batch`` interleaved half spectra of length n = 2h -> the raw
    Z spectrum that the h-point backward transform turns into the reals.
    ``wr``/``wi``: the bank's ("R", n, +1) planes.  ``drop`` reads Im X[0]
    and Im X[h] as 0 (irfft semantics), as the JAX package's route does
    below n = 1024; from n = 1024 on its retangle uses them."""
    check_buffer(x, batch * (2 * h + 2), "retangle")
    if x.device.type == "cpu":
        return retangle_plain(x, batch, h, wr, wi, scale, drop)
    require_cuda(x, "retangle")
    _check_tables(x, h, "retangle", wr, wi)
    z = _half_length("retangle", x, batch, h, wr, wi, scale, 2 * batch * h,
                     int(drop))
    return z


retangle.plain = retangle_plain


@tracing.kernel("K9", ("small_real_fwd_kernel", "small_real_bwd_kernel",
                        "small_real_fwd_f64_kernel", "small_real_bwd_f64_kernel"))
def small_real(raw, batch: int, tabs: SmallRealTables):
    """K9: ``batch`` whole REAL transforms of even length ``tabs.n`` ≤ 512:
    forward (``tabs.sign`` < 0) ``batch·n`` reals -> ``batch·(n+2)``
    interleaved half spectra; backward the reverse (irfft semantics), in the
    buffer's precision (float32, or float64 with float64 tables).  The
    kernel reads ``tabs.wr``/``wi`` and ``tabs.scale``, and runs each row as
    the h = n/2 point FFT on the radix stages with the untangle (or the
    retangle) in shared memory; each launch counts on
    ``tracing.paths("K9")`` as ``"radix"``, or ``"radix_f64"`` in
    float64."""
    n = tabs.n
    forward = tabs.sign < 0
    check_buffer(raw, batch * (n if forward else n + 2), "small_real",
                 (torch.float32, torch.float64))
    if raw.device.type == "cpu":
        return small_real_plain(raw, batch, tabs)
    require_cuda(raw, "small_real")
    _check_tables(raw, n * n, "small_real", tabs.wr, tabs.wi)
    lib = _build.load()
    f64 = raw.dtype == torch.float64
    y = torch.empty(batch * (n + 2 if forward else n), dtype=raw.dtype,
                    device=raw.device)
    with torch.cuda.device(raw.device):
        err = (lib.pf_small_real_f64 if f64 else lib.pf_small_real)(
            raw.data_ptr(), y.data_ptr(), tabs.wr.data_ptr(), tabs.wi.data_ptr(),
            batch, n, tabs.sign, tabs.scale, stream_of(raw),
        )
    _build.check(lib, err, "small_real kernel")
    tracing.path("K9", "radix_f64" if f64 else "radix")
    return y


small_real.plain = small_real_plain
