"""K15 ``bluestein`` and its butterfly mode K15-bf ``bluestein_bf``:
wrappers of the CUDA kernels (``csrc/fft_bluestein.cu``), their plain
PyTorch versions, and the JAX package's gates.

Counterpart of ``portfft_tpu/ops/pallas_bluestein.py`` ``bluestein_call``:
the n-point transform of a BLUESTEIN plan whose convolution M = g1·g2 is
GLOBAL, in three passes over a (b, g1, g2) convolution buffer, on (re, im)
float32 planes (b, n).  The convolution runs forward (−1) then backward
(+1) whatever the user's direction; the user's sign lives in the chirp
tables.  The butterfly mode (``bluestein_call`` with
``PORTFFT_BLUESTEIN_BF``, its ``blane_dif``/``blane_dit``) factors each
sub-transform g = A·128 into an A-point slab DFT, a digit twiddle and a
128-point DFT; the forward stages leave their outputs digit-major
(``torch_fft.lane_perm``), the backward stages take them so, and the tables
between them are the bank's permuted ``BLT``/``BLP``/``BLB``.  Same rule as
``cuda_fft``: CPU tensors go to the plain version, CUDA tensors to the
kernel, and nothing falls back.
"""

from __future__ import annotations

import dataclasses

import torch

from ..enums import Level
from ..exceptions import InvalidConfiguration
from ..planner import Plan1D
from ..utils import tracing
from ..utils.logging import _env_flag
from . import _build
from .cuda_fft import SubTables, require_cuda, stream_of, sub_tables
from .cuda_global import global2_supported
from .cuda_io import check_plane
from .torch_fft import (
    complex_matmul,
    complex_mul,
    full_fp32_matmuls,
    ilv_factor,
    mixed_radix_dft,
    radix_sub_plain,
    valid_rows,
)


def supported(plan: Plan1D, config) -> bool:
    """``pallas_bluestein.supported``: a GLOBAL convolution the plane
    GLOBAL kernel takes, and valid rows within g1.  ``bluestein_call`` also
    declines where no lane tile fits the reference's planning VMEM (every
    convolution with a FUSED [16, 128] sub, primes from about 131000 up);
    that is a budget of the TPU's VMEM, and this kernel's tiles take those
    subs, so the port runs K15 there too, as its raw kernels take lengths
    the reference's VMEM gates decline."""
    if plan.level != Level.BLUESTEIN or plan.conv is None:
        return False
    conv = plan.conv
    if not global2_supported(conv, config.direct_threshold):
        return False
    return valid_rows(plan.n, conv.sub[1].n) <= conv.sub[0].n


def bf_mode(plan: Plan1D) -> bool:
    """Whether a plan K15 takes runs in the butterfly mode, decided at
    commit as the JAX package's ``bluestein_call`` decides it: opt-in
    through ``PORTFFT_BLUESTEIN_BF``, with both convolution subs A·128,
    A = 2^a·3^b ≤ 16 (``ilv_factor``)."""
    g1, g2 = plan.conv.sub
    return (_env_flag("PORTFFT_BLUESTEIN_BF") and bool(ilv_factor(g1.n))
            and bool(ilv_factor(g2.n)))


@dataclasses.dataclass(frozen=True)
class BluesteinTables:
    """The device tables of one direction of a K15 plan: the four
    convolution subs (g1 and g2, forward and backward), the pass-1 chirp
    ``pre`` (nv, g2), the forward twiddle ``twf`` T(g1, g2, −1) (g2, g1),
    b̂ ``hat`` (g1, g2), the backward twiddle ``twb`` T(g2, g1, +1) (g1,
    g2) and the pass-3 chirp ``fin`` (g2, g1), each an (re, im) pair.  In
    the butterfly mode (``bf``) each sub is (g, A, —, —, the 128-point DFT
    planes of its direction, U(A, 128) of its direction) and ``twf``,
    ``hat`` and ``twb`` are the permuted ``BLT``, ``BLP`` and ``BLB``."""

    n: int
    f1: SubTables
    b1: SubTables
    f2: SubTables
    b2: SubTables
    pre: tuple
    twf: tuple
    hat: tuple
    twb: tuple
    fin: tuple
    bf: bool = False

    @property
    def g1(self) -> int:
        return self.f1.m

    @property
    def g2(self) -> int:
        return self.f2.m


def bluestein_tables(plan: Plan1D, sign: int, keys: dict, arrays: dict,
                     bf: bool = False) -> BluesteinTables:
    """Resolve one direction's tables from the bank
    (``torch_fft.collect_bank_keys``); ``bf``: the butterfly mode's."""
    n = plan.n
    p1, p2 = plan.conv.sub

    def pair(key, suffix=""):
        return arrays[key + suffix + "r"], arrays[key + suffix + "i"]

    if bf:
        def sub(g, s):
            a = ilv_factor(g)
            w, u = keys[("W", 128, s)], keys[("U", a, 128, s)]
            return SubTables(g, a, None, None, *pair(w), *pair(u))

        return BluesteinTables(
            n, sub(p1.n, -1), sub(p1.n, +1), sub(p2.n, -1), sub(p2.n, +1),
            pre=pair(keys[("BPRE", n, sign)]), twf=pair(keys[("BLT", n, sign)]),
            hat=pair(keys[("BLP", n, sign)], "f"), twb=pair(keys[("BLB", n, sign)]),
            fin=pair(keys[("BFIN", n, sign)]), bf=True)
    return BluesteinTables(
        n,
        sub_tables(p1, -1, keys, arrays), sub_tables(p1, +1, keys, arrays),
        sub_tables(p2, -1, keys, arrays), sub_tables(p2, +1, keys, arrays),
        pre=pair(keys[("BPRE", n, sign)]),
        twf=pair(keys[("T", p1.n, p2.n, -1)]),
        hat=pair(keys[("BPOST", n, sign)], "f"),
        twb=pair(keys[("T", p2.n, p1.n, +1)]),
        fin=pair(keys[("BFIN", n, sign)]),
    )


def bluestein_plain(xr: torch.Tensor, xi: torch.Tensor, t: BluesteinTables,
                    scale: float = 1.0):
    """Plain version of K15: its three passes with every sub-transform on
    the radix stages of ``csrc/fft_radix.cuh`` (``torch_fft.radix_sub_plain``:
    the kernel's stages, twiddle indices and orders) and the pointwise
    steps between them, in complex64."""
    b, n, g1, g2 = xr.shape[0], t.n, t.g1, t.g2

    def table(pair):
        return torch.complex(*pair)

    with full_fp32_matmuls(xr):
        # pass 1: chirp, zero-extend to g1 rows, DFT down n1, forward twiddle
        x = torch.complex(xr, xi) * table(t.pre).reshape(-1)[:n]
        x = torch.nn.functional.pad(x, (0, g1 * g2 - n)).view(b, g1, g2)
        a = radix_sub_plain(t.f1, x.transpose(1, 2)) * table(t.twf)  # [n2, k1]
        # pass 2: forward DFT over n2, b̂, backward DFT, backward twiddle
        a = radix_sub_plain(t.f2, a.transpose(1, 2)) * table(t.hat)  # [k1, k2]
        a = radix_sub_plain(t.b2, a) * table(t.twb)  # [k1, k1']
        # pass 3: backward DFT down k1, final chirp, the first n outputs
        a = radix_sub_plain(t.b1, a.transpose(1, 2)) * table(t.fin)  # [k1', k2']
    y = a.transpose(1, 2).reshape(b, g1 * g2)[:, :n] * scale
    return y.real.contiguous(), y.imag.contiguous()


def _launch(name: str, xr, xi, t: BluesteinTables, scale: float, plain):
    """Check the planes, then the plain version on the CPU, else the C
    entry point ``pf_{name}`` (three launches through two float2 buffers of
    b·g1·g2 elements each)."""
    if t.bf != (name == "bluestein_bf"):
        raise InvalidConfiguration(f"{name}: the tables are of the other mode")
    n = t.n
    b = xr.numel() // n
    check_plane(xr, b * n, name)
    check_plane(xi, b * n, name)
    xr, xi = xr.view(b, n), xi.view(b, n)
    if xr.device.type == "cpu":
        return plain(xr, xi, t, scale)
    require_cuda(xr, name)
    lib = _build.load()
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    conv = 2 * b * t.g1 * t.g2
    s1 = torch.empty(conv, dtype=torch.float32, device=xr.device)
    s2 = torch.empty_like(s1)
    tabs = [p.data_ptr() for pair in (t.pre, t.twf, t.hat, t.twb, t.fin)
            for p in pair]
    subs = []
    for s in (t.f1, t.b1, t.f2, t.b2):
        subs += [s.m, s.a, *s.pointers()]
    with torch.cuda.device(xr.device):
        err = getattr(lib, "pf_" + name)(
            xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            s1.data_ptr(), s2.data_ptr(), n, *subs, *tabs, b, scale,
            stream_of(xr))
    _build.check(lib, err, name + " kernel")
    return yr, yi


@tracing.kernel("K15", ("blue_pass1", "blue_pass2", "blue_pass3"))
def bluestein(xr: torch.Tensor, xi: torch.Tensor, t: BluesteinTables,
              scale: float = 1.0):
    """K15: the ``t.n``-point transform of each row of the (b, n) planes,
    times ``scale``; returns new (b, n) planes.  Three launches through
    two float2 buffers of b·g1·g2 elements each."""
    return _launch("bluestein", xr, xi, t, scale, bluestein_plain)


bluestein.plain = bluestein_plain


def _blane(xr, xi, sub: SubTables, sign: int, dif: bool):
    """The butterfly lane DFT of the last axis, g = A·128
    (``pallas_bluestein.blane_dif``/``blane_dit``).  ``dif``: natural in,
    digit-major out — the A-point slab DFT over the high digit
    (``torch_fft.mixed_radix_dft``), the digit twiddle U, the 128-point DFT
    over the low digit, slab kA holding frequencies kA + A·kB.  Else
    digit-major in, natural out: the 128-point DFT of each slab, U, the
    A-point slab DFT across slabs."""
    a, lead = sub.a, xr.shape[:-1]
    if dif:
        slabs = [(xr[..., j * 128:(j + 1) * 128], xi[..., j * 128:(j + 1) * 128])
                 for j in range(a)]
        tw = [complex_mul(yr, yi, sub.ur[k], sub.ui[k])
              for k, (yr, yi) in enumerate(mixed_radix_dft(slabs, sign))]
        zr, zi = complex_matmul(torch.stack([p[0] for p in tw], -2),
                                torch.stack([p[1] for p in tw], -2), sub.br, sub.bi)
        return zr.reshape(*lead, sub.m), zi.reshape(*lead, sub.m)
    zr, zi = complex_matmul(xr.reshape(*lead, a, 128), xi.reshape(*lead, a, 128),
                            sub.br, sub.bi)
    slabs = [complex_mul(zr[..., k, :], zi[..., k, :], sub.ur[k], sub.ui[k])
             for k in range(a)]
    y = mixed_radix_dft(slabs, sign)
    return torch.cat([p[0] for p in y], -1), torch.cat([p[1] for p in y], -1)


def bluestein_bf_plain(xr: torch.Tensor, xi: torch.Tensor, t: BluesteinTables,
                       scale: float = 1.0):
    """Plain version of K15-bf: K15's three passes with each DFT the
    butterfly lane DFT (:func:`_blane`; forward stages digit-major out,
    backward stages digit-major in) and the permuted tables between."""
    b, n, g1, g2 = xr.shape[0], t.n, t.g1, t.g2
    with full_fp32_matmuls(xr):
        ar, ai = complex_mul(xr, xi, t.pre[0].reshape(-1)[:n],
                             t.pre[1].reshape(-1)[:n])
        pad = g1 * g2 - n
        ar = torch.nn.functional.pad(ar, (0, pad)).view(b, g1, g2)
        ai = torch.nn.functional.pad(ai, (0, pad)).view(b, g1, g2)
        ar, ai = _blane(ar.transpose(1, 2), ai.transpose(1, 2), t.f1, -1, True)
        ar, ai = complex_mul(ar, ai, *t.twf)  # (b, g2, g1) [n2, p1]
        ar, ai = _blane(ar.transpose(1, 2), ai.transpose(1, 2), t.f2, -1, True)
        ar, ai = complex_mul(ar, ai, *t.hat)  # (b, g1, g2) [p1, q]
        ar, ai = _blane(ar, ai, t.b2, +1, False)
        ar, ai = complex_mul(ar, ai, *t.twb)  # (b, g1, g2) [p1, k1']
        ar, ai = _blane(ar.transpose(1, 2), ai.transpose(1, 2), t.b1, +1, False)
        ar, ai = complex_mul(ar, ai, *t.fin)  # (b, g2, g1) [k1', k2']
    yr = ar.transpose(1, 2).reshape(b, g1 * g2)[:, :n] * scale
    yi = ai.transpose(1, 2).reshape(b, g1 * g2)[:, :n] * scale
    return yr.contiguous(), yi.contiguous()


@tracing.kernel("K15-bf", ("bf_pass1", "bf_pass2", "bf_pass3"))
def bluestein_bf(xr: torch.Tensor, xi: torch.Tensor, t: BluesteinTables,
                 scale: float = 1.0):
    """K15-bf: K15's function in the butterfly mode (``t.bf`` tables),
    three launches as K15."""
    return _launch("bluestein_bf", xr, xi, t, scale, bluestein_bf_plain)


bluestein_bf.plain = bluestein_bf_plain
