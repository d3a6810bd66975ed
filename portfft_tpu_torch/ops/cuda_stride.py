"""K7 ``destride`` / ``restride``: wrappers of the CUDA kernel
(``csrc/fft_stride.cu``) and their plain PyTorch versions.

Counterparts of ``portfft_tpu/ops/pallas_io.py`` ``destride`` and
``restride``.  A 1D layout is one affine map (``utils/layout.Rows``):
element (b, j) of a domain's buffer sits at ``o + b·dist + j·s``, for
b < ``batch`` and j < ``n``.  ``destride`` gathers those elements into
packed (batch, n) rows; ``restride`` scatters packed rows back.  A buffer
is a flat float32 tensor of raw (re, im) pairs (an element is two floats)
or, for SPLIT_COMPLEX, a ``(re, im)`` pair of flat float32 planes (an
element is one float; both planes go in one launch).  Every s >= 1 and
dist >= 1 is taken: the JAX package's kernels keep its TPU tile gates
(batch % 128, a chunk dividing n, dist >= span) and send other layouts to
XLA, which the card does not need.  Both are exact copies, so the kernel
equals its plain version bit for bit.  Same rule as ``cuda_fft``: CPU
tensors go to the plain version, CUDA tensors to the kernel, and nothing
falls back.
"""

from __future__ import annotations

import torch

from ..exceptions import InvalidConfiguration
from ..utils import tracing
from . import _build
from .cuda_fft import require_cuda, stream_of


def _planes(buf) -> tuple[tuple, int]:
    """``(planes, width)``: the flat tensors of a buffer and the floats
    per element (2 for raw interleaved pairs, 1 for SPLIT planes)."""
    if isinstance(buf, tuple):
        return buf, 1
    return (buf,), 2


def _check(buf, elements: int, what: str, exact: bool = False) -> None:
    """Flat contiguous float32 planes of at least (``exact``: exactly)
    ``elements`` elements each, element-aligned on the card."""
    planes, width = _planes(buf)
    for t in planes:
        if t.dtype != torch.float32 or t.dim() != 1 or not t.is_contiguous():
            raise InvalidConfiguration(
                f"{what}: expected a flat contiguous float32 tensor, got "
                f"{t.dtype} of shape {tuple(t.shape)}")
        have, rem = divmod(t.numel(), width)
        if rem or have < elements or (exact and have != elements):
            raise InvalidConfiguration(
                f"{what}: expected {'exactly' if exact else 'at least'} "
                f"{elements} elements of {width} float(s), got {t.numel()} "
                "floats")
        if t.is_cuda and t.data_ptr() % (4 * width):
            raise InvalidConfiguration(f"{what}: buffer is not element-aligned")


def _count(o: int, s: int, dist: int, n: int, batch: int) -> int:
    """The element count the layout needs (its largest index + 1); raises
    where the map is not one the kernel takes."""
    if min(s, dist, n, batch) < 1 or o < 0:
        raise InvalidConfiguration(
            f"layout o={o} s={s} dist={dist} n={n} batch={batch}: needs "
            "o >= 0 and s, dist, n, batch >= 1")
    return o + (batch - 1) * dist + (n - 1) * s + 1


def _rows_view(e: torch.Tensor, o: int, s: int, dist: int, n: int, batch: int):
    """The (batch, n) view of the layout's elements in ``e``: a plane, or
    the (m, 2) view of a raw buffer (then (batch, n, 2))."""
    st = e.stride(0)
    return e.as_strided((batch, n, *e.shape[1:]), (dist * st, s * st, *e.stride()[1:]),
                        e.storage_offset() + o * st)


def _elements(t: torch.Tensor, width: int) -> torch.Tensor:
    return t.view(-1, 2) if width == 2 else t


def destride_plain(x, o: int, s: int, dist: int, n: int, batch: int):
    """Plain version of the destride: one ``as_strided`` gather into a new
    buffer per plane."""
    planes, width = _planes(x)
    ys = []
    for t in planes:
        view = _rows_view(_elements(t, width), o, s, dist, n, batch)
        ys.append(torch.empty(view.shape, dtype=t.dtype, device=t.device)
                  .copy_(view).reshape(-1))
    return tuple(ys) if isinstance(x, tuple) else ys[0]


@tracing.kernel("K7-de", ("destride_rows", "destride_tile"))
def destride(x, o: int, s: int, dist: int, n: int, batch: int):
    """K7: the layout's elements of ``x`` -> new packed (batch, n) rows, of
    the kind of ``x`` (a raw tensor or a (re, im) pair)."""
    _check(x, _count(o, s, dist, n, batch), "destride")
    planes, width = _planes(x)
    if planes[0].device.type == "cpu":
        return destride_plain(x, o, s, dist, n, batch)
    require_cuda(planes[0], "destride")
    lib = _build.load()
    ys = tuple(torch.empty(width * batch * n, dtype=torch.float32,
                           device=planes[0].device) for _ in planes)
    second = (planes[1].data_ptr(), ys[1].data_ptr()) if len(planes) == 2 else (None, None)
    with torch.cuda.device(planes[0].device):
        err = lib.pf_destride(planes[0].data_ptr(), second[0], ys[0].data_ptr(),
                              second[1], width, o, s, dist, n, batch,
                              stream_of(planes[0]))
    _build.check(lib, err, "destride kernel")
    return ys if isinstance(x, tuple) else ys[0]


destride.plain = destride_plain


def restride_plain(y, o: int, s: int, dist: int, n: int, batch: int, out,
                   fill_gaps: bool):
    """Plain version of the restride: zero ``out`` where ``fill_gaps``,
    then one ``as_strided`` copy per plane."""
    ys, width = _planes(y)
    for src, dst in zip(ys, _planes(out)[0]):
        if fill_gaps:
            dst.zero_()
        view = _rows_view(_elements(dst, width), o, s, dist, n, batch)
        view.copy_(src.view(view.shape))
    return out


@tracing.kernel("K7-re", ("restride_rows", "restride_fill_rows", "restride_tile"))
def restride(y, o: int, s: int, dist: int, n: int, batch: int, out,
             fill_gaps: bool):
    """K7: packed (batch, n) rows ``y`` -> the layout's elements of ``out``
    (the kind of ``y``), which is returned.  With ``fill_gaps`` every
    other element of ``out`` becomes 0 (a buffer the library allocates);
    without, nothing else is touched (an out= buffer, an in-place
    transform).  ``y`` must not overlap ``out``."""
    _check(y, batch * n, "restride", exact=True)
    _check(out, _count(o, s, dist, n, batch), "restride")
    planes, width = _planes(y)
    outs = _planes(out)[0]
    if len(outs) != len(planes) or (fill_gaps and len({t.numel() for t in outs}) != 1):
        raise InvalidConfiguration(
            "restride: out must hold as many planes as y (of one length "
            "with fill_gaps)")
    if planes[0].device.type == "cpu":
        return restride_plain(y, o, s, dist, n, batch, out, fill_gaps)
    require_cuda(planes[0], "restride")
    lib = _build.load()
    second = (planes[1].data_ptr(), outs[1].data_ptr()) if len(planes) == 2 else (None, None)
    with torch.cuda.device(planes[0].device):
        err = lib.pf_restride(planes[0].data_ptr(), second[0], outs[0].data_ptr(),
                              second[1], width, o, s, dist, n, batch,
                              min(t.numel() for t in outs) // width, int(fill_gaps),
                              stream_of(planes[0]))
    _build.check(lib, err, "restride kernel")
    return out


restride.plain = restride_plain
