"""K6 ``deinterleave`` / ``interleave``: wrappers of the CUDA kernels
(``csrc/fft_io.cu``) and their plain PyTorch versions.

Counterparts of ``portfft_tpu/ops/pallas_io.py`` ``deinterleave`` and
``interleave``: the PACKED interleaved buffer (a flat float32 tensor of
``2·m`` scalars, (re, im) pairs) to two float32 planes of ``m``, and back.
The plane path runs them around its executor.  Any ``m`` is taken; the JAX
package pads to its (128, 128) transpose tile, which the card does not
need.  Same rule as ``cuda_fft``: CPU tensors go to the plain version, CUDA
tensors to the kernel, and nothing falls back.
"""

from __future__ import annotations

import torch

from ..exceptions import InvalidConfiguration
from . import _build
from .cuda_fft import check_buffer, require_cuda, stream_of


def check_plane(t: torch.Tensor, numel: int, what: str) -> None:
    """A plane the kernels take: contiguous float32 of ``numel`` elements
    (any shape)."""
    if t.dtype != torch.float32 or not t.is_contiguous() or t.numel() != numel:
        raise InvalidConfiguration(
            f"{what}: expected a contiguous float32 plane of {numel} "
            f"elements, got {t.dtype} of shape {tuple(t.shape)}"
        )


def deinterleave_plain(raw: torch.Tensor):
    """Plain version of the deinterleave: the even and odd scalars."""
    x = raw.view(-1, 2)
    return x[:, 0].contiguous(), x[:, 1].contiguous()


def deinterleave(raw: torch.Tensor):
    """K6: ``raw`` (flat float32, ``2·m`` scalars) -> ``(re, im)``, two new
    flat planes of ``m``."""
    check_buffer(raw, 2 * (raw.numel() // 2), "deinterleave")
    if raw.device.type == "cpu":
        return deinterleave_plain(raw)
    require_cuda(raw, "deinterleave")
    lib = _build.load()
    m = raw.numel() // 2
    re = torch.empty(m, dtype=torch.float32, device=raw.device)
    im = torch.empty_like(re)
    with torch.cuda.device(raw.device):
        err = lib.pf_deinterleave(raw.data_ptr(), re.data_ptr(), im.data_ptr(),
                                  m, stream_of(raw))
    _build.check(lib, err, "deinterleave kernel")
    deinterleave.launches += 1
    return re, im


deinterleave.launches = 0
deinterleave.plain = deinterleave_plain


def interleave_plain(re: torch.Tensor, im: torch.Tensor, scale: float):
    """Plain version of the interleave: (re, im) pairs, times ``scale``."""
    return (torch.stack((re.reshape(-1), im.reshape(-1)), dim=-1) * scale).reshape(-1)


def interleave(re: torch.Tensor, im: torch.Tensor, scale: float, out=None):
    """K6: planes ``re``, ``im`` of ``m`` elements -> the flat interleaved
    buffer of ``2·m`` scalars.  The direction's scale is folded in here: the
    plane path's last step multiplies every output element by ``scale``
    (the JAX package applies it in XLA after its executor).  ``out`` (a
    flat float32 tensor of ``2·m``) receives the result; otherwise a new
    tensor."""
    m = re.numel()
    check_plane(re, m, "interleave")
    check_plane(im, m, "interleave")
    if out is not None:
        check_buffer(out, 2 * m, "interleave")
    if re.device.type == "cpu":
        y = interleave_plain(re, im, scale)
        if out is None:
            return y
        out.copy_(y)
        return out
    require_cuda(re, "interleave")
    lib = _build.load()
    y = torch.empty(2 * m, dtype=torch.float32, device=re.device) if out is None else out
    with torch.cuda.device(re.device):
        err = lib.pf_interleave(re.data_ptr(), im.data_ptr(), y.data_ptr(), m,
                                scale, stream_of(re))
    _build.check(lib, err, "interleave kernel")
    interleave.launches += 1
    return y


interleave.launches = 0
interleave.plain = interleave_plain
