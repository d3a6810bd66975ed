"""K3 ``global2``: wrapper of the CUDA kernel (``csrc/fft_global2.cu``) and
its plain PyTorch version.

Counterpart of ``portfft_tpu/ops/pallas_global.py::global2_raw_call``: the
GLOBAL four-step n = G1·G2 on the PACKED interleaved buffer, in two passes
through a scratch buffer.  Same rule as ``cuda_fft``: CPU tensors go to the
plain version, CUDA tensors to the kernel, and nothing falls back.
"""

from __future__ import annotations

import torch

from . import _build
from .cuda_fft import (
    SubTables,
    check_buffer,
    interleave,
    into,
    require_cuda,
    rows_plain,
    stream_of,
)
from .torch_fft import complex_mul, full_fp32_matmuls


def global2_plain(
    raw: torch.Tensor, batch: int, sub1: SubTables, sub2: SubTables,
    tr: torch.Tensor, ti: torch.Tensor, scale: float,
):
    """Plain version of K3, the same two passes:
    pass 1 ``S[b, n2, k1] = (G1-point transform of x[b, :, n2])[k1] ·
    T[n2, k1]``; pass 2 ``out[b, k1 + G1·k2] = scale ·
    (G2-point transform of S[b, :, k1])[k2]``."""
    g1, g2 = sub1.m, sub2.m
    x = raw.view(batch, g1, g2, 2).transpose(1, 2)  # [b, n2, n1]
    with full_fp32_matmuls(raw):
        sr, si = rows_plain(sub1, x[..., 0], x[..., 1])
        sr, si = complex_mul(sr, si, tr, ti)  # T stored (g2, g1) = [n2, k1]
        cr, ci = rows_plain(sub2, sr.transpose(1, 2), si.transpose(1, 2))
    return interleave(cr.transpose(1, 2), ci.transpose(1, 2), scale)


def global2(
    raw, batch: int, sub1: SubTables, sub2: SubTables, tr, ti, scale: float,
    out=None,
):
    """K3: ``batch`` GLOBAL transforms of length ``sub1.m · sub2.m``.
    ``tr``/``ti`` are the bank's (G2, G1) inter-pass twiddle planes.  The
    wrapper allocates the scratch buffer (the size of the input)."""
    check_buffer(raw, 2 * batch * sub1.m * sub2.m, "global2")
    if raw.device.type == "cpu":
        return into(out, global2_plain(raw, batch, sub1, sub2, tr, ti, scale))
    require_cuda(raw, "global2")
    lib = _build.load()
    y = torch.empty_like(raw) if out is None else out
    scratch = torch.empty_like(raw)
    with torch.cuda.device(raw.device):
        err = lib.pf_global2(
            raw.data_ptr(), y.data_ptr(), scratch.data_ptr(),
            sub1.m, sub1.a, *sub1.pointers(), sub2.m, sub2.a, *sub2.pointers(),
            tr.data_ptr(), ti.data_ptr(), batch, scale, stream_of(raw),
        )
    _build.check(lib, err, "global2 kernel")
    global2.launches += 1
    return y


global2.launches = 0
global2.plain = global2_plain
