"""K15 ``bluestein``: wrapper of the CUDA kernel (``csrc/fft_bluestein.cu``),
its plain PyTorch version, and the JAX package's gate.

Counterpart of ``portfft_tpu/ops/pallas_bluestein.py`` ``bluestein_call``:
the n-point transform of a BLUESTEIN plan whose convolution M = g1·g2 is
GLOBAL, in three passes over a (b, g1, g2) convolution buffer, on (re, im)
float32 planes (b, n).  The convolution runs forward (−1) then backward
(+1) whatever the user's direction; the user's sign lives in the chirp
tables.  Same rule as ``cuda_fft``: CPU tensors go to the plain version,
CUDA tensors to the kernel, and nothing falls back.
"""

from __future__ import annotations

import dataclasses

import torch

from ..enums import Level
from ..planner import Plan1D
from . import _build
from .cuda_fft import SubTables, require_cuda, rows_plain, stream_of, sub_tables
from .cuda_io import check_plane
from .cuda_multidim import _lane_dft_shape
from .torch_fft import complex_mul, full_fp32_matmuls, valid_rows


def global2_supported(plan: Plan1D, max_direct: int) -> bool:
    """``pallas_global.global2_supported``: a GLOBAL plan whose subs are
    DIRECT (≤ ``max_direct``, a multiple of 8) or FUSED [a, 128] with
    a | 128 — the plans the JAX package's plane GLOBAL kernel (K14)
    takes."""
    if plan.level != Level.GLOBAL:
        return False
    return all(
        (s.n <= max_direct and s.n % 8 == 0) if s.level == Level.DIRECT
        else _lane_dft_shape(s)
        for s in plan.sub
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


@dataclasses.dataclass(frozen=True)
class BluesteinTables:
    """The device tables of one direction of a K15 plan: the four
    convolution subs (g1 and g2, forward and backward), the pass-1 chirp
    ``pre`` (nv, g2), the forward twiddle ``twf`` T(g1, g2, −1) (g2, g1),
    b̂ ``hat`` (g1, g2), the backward twiddle ``twb`` T(g2, g1, +1) (g1,
    g2) and the pass-3 chirp ``fin`` (g2, g1), each an (re, im) pair."""

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

    @property
    def g1(self) -> int:
        return self.f1.m

    @property
    def g2(self) -> int:
        return self.f2.m


def bluestein_tables(plan: Plan1D, sign: int, keys: dict,
                     arrays: dict) -> BluesteinTables:
    """Resolve one direction's tables from the bank
    (``torch_fft.collect_bank_keys``)."""
    n = plan.n
    p1, p2 = plan.conv.sub

    def pair(key, suffix=""):
        return arrays[key + suffix + "r"], arrays[key + suffix + "i"]

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
    """Plain version of K15: its three passes as ``torch.matmul`` calls in
    full float32 (``cuda_fft.rows_plain`` for every DFT)."""
    b, n, g1, g2 = xr.shape[0], t.n, t.g1, t.g2
    with full_fp32_matmuls(xr):
        # pass 1: chirp, zero-extend to g1 rows, DFT down n1, forward twiddle
        ar, ai = complex_mul(xr, xi, t.pre[0].reshape(-1)[:n],
                             t.pre[1].reshape(-1)[:n])
        pad = g1 * g2 - n
        ar = torch.nn.functional.pad(ar, (0, pad)).view(b, g1, g2)
        ai = torch.nn.functional.pad(ai, (0, pad)).view(b, g1, g2)
        ar, ai = rows_plain(t.f1, ar.transpose(1, 2), ai.transpose(1, 2))
        ar, ai = complex_mul(ar, ai, *t.twf)  # (b, g2, g1) [n2, k1]
        # pass 2: forward DFT over n2, b̂, backward DFT, backward twiddle
        ar, ai = rows_plain(t.f2, ar.transpose(1, 2), ai.transpose(1, 2))
        ar, ai = complex_mul(ar, ai, *t.hat)
        ar, ai = rows_plain(t.b2, ar, ai)
        ar, ai = complex_mul(ar, ai, *t.twb)  # (b, g1, g2) [k1, k1']
        # pass 3: backward DFT down k1, final chirp, the first n outputs
        ar, ai = rows_plain(t.b1, ar.transpose(1, 2), ai.transpose(1, 2))
        ar, ai = complex_mul(ar, ai, *t.fin)  # (b, g2, g1) [k1', k2']
    yr = ar.transpose(1, 2).reshape(b, g1 * g2)[:, :n] * scale
    yi = ai.transpose(1, 2).reshape(b, g1 * g2)[:, :n] * scale
    return yr.contiguous(), yi.contiguous()


def bluestein(xr: torch.Tensor, xi: torch.Tensor, t: BluesteinTables,
              scale: float = 1.0):
    """K15: the ``t.n``-point transform of each row of the (b, n) planes,
    times ``scale``; returns new (b, n) planes.  Three launches through
    two float2 buffers of b·g1·g2 elements each."""
    n = t.n
    b = xr.numel() // n
    check_plane(xr, b * n, "bluestein")
    check_plane(xi, b * n, "bluestein")
    xr, xi = xr.view(b, n), xi.view(b, n)
    if xr.device.type == "cpu":
        return bluestein_plain(xr, xi, t, scale)
    require_cuda(xr, "bluestein")
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
        err = lib.pf_bluestein(
            xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            s1.data_ptr(), s2.data_ptr(), n, *subs, *tabs, b, scale,
            stream_of(xr))
    _build.check(lib, err, "bluestein kernel")
    bluestein.launches += 1
    return yr, yi


bluestein.launches = 0
bluestein.plain = bluestein_plain
