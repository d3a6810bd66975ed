"""Buffer layouts of portfft_tpu_torch — strides, distances, offsets,
BATCH_INTERLEAVED in one domain, ``out=`` buffers, in place — against
portfft_tpu (``commit(use_pallas=True)``, Pallas kernels in interpret mode)
and ``np.fft``, and the strided copy kernel K7's plain version against the
JAX package's ``pallas_io.destride``/``restride``.

Tolerance: both packages within the oracle's per-element 2·eps·N·log2N of
``np.fft`` (absolute or relative, ``oracle.verify``), and the port within
the same bound of the reference.  Everything the output layout does not
address (gaps, the leading offset, the tail of a longer buffer) must equal
the reference's bit for bit, and the returned buffers have the
reference's length.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
import portfft_tpu as ref
import portfft_tpu_torch as pt
from portfft_tpu.ops import pallas_io
from portfft_tpu_torch.ops import cuda_stride
from portfft_tpu_torch.utils.layout import Rows, rows_1d

SENTINEL = oracle.SENTINEL * (1 + 1j)


def _strided(s_in=1, d_in=None, s_out=1, d_out=None, o_in=0, o_out=0):
    kw = dict(forward_strides=[s_in], backward_strides=[s_out],
              forward_offset=o_in, backward_offset=o_out)
    if d_in is not None:
        kw["forward_distance"] = d_in
    if d_out is not None:
        kw["backward_distance"] = d_out
    return kw


def _bi(batch, forward=True, backward=True):
    kw = {}
    if forward:
        kw.update(forward_strides=[batch], forward_distance=1)
    if backward:
        kw.update(backward_strides=[batch], backward_distance=1)
    return kw


# (id, lengths, batch, descriptor fields, options, the port's sides: the
# input's and the output's, "view" for a block at an offset, "K7" for
# Rows).  Options: split (SPLIT_COMPLEX), in_place, out (the kind of the
# out= buffer), longer (extra elements past the input count).
CASES = [
    ("strided_in", [64], 3, _strided(2, 130), {}, ("K7", "view")),
    ("strided_out", [64], 3, _strided(s_out=3, d_out=200), {}, ("view", "K7")),
    ("strided_both", [512], 2, _strided(2, 1029, 3, 1534, 3, 1), {}, ("K7", "K7")),
    ("strided_both_split", [512], 2, _strided(2, 1029, 3, 1534, 3, 1),
     {"split": True}, ("K7", "K7")),
    ("minimal_span_odd_stride", [100], 3, _strided(3, 298, o_in=5), {}, ("K7", "view")),
    ("bi_out_only", [16], 4, _bi(4, forward=False), {}, ("view", "K7")),
    ("bi_both_split", [64], 3, _bi(3), {"split": True}, ("K7", "K7")),
    # the layout test_strided_large.py gives the JAX package's index gather
    ("index_gather", [512], 8, dict(backward_strides=[8], backward_distance=1,
                                    backward_offset=3), {}, ("view", "K7")),
    ("offset_rank1", [64], 2, dict(forward_offset=3, backward_offset=5), {},
     ("view", "view")),
    ("offset_rank1_split", [64], 2, dict(forward_offset=3, backward_offset=5),
     {"split": True}, ("view", "view")),
    ("offset_rank2", [8, 16], 2, dict(forward_offset=4, backward_offset=1), {},
     ("view", "view")),
    ("offset_rank2_split", [8, 16], 2, dict(forward_offset=4, backward_offset=1),
     {"split": True}, ("view", "view")),
    ("offset_rank3", [4, 8, 16], 1, dict(forward_offset=2, backward_offset=6), {},
     ("view", "view")),
    ("offset_rank3_split", [4, 8, 16], 1, dict(forward_offset=2, backward_offset=6),
     {"split": True}, ("view", "view")),
    ("out_numpy_complex", [64], 3, _strided(s_out=2, d_out=150), {"out": "np"},
     ("view", "K7")),
    ("out_torch_complex", [64], 3, _strided(s_out=2, d_out=150), {"out": "complex"},
     ("view", "K7")),
    ("out_torch_raw", [64], 3, _strided(s_out=2, d_out=150), {"out": "raw"},
     ("view", "K7")),
    ("out_split_pair", [64], 3, _strided(s_out=2, d_out=150),
     {"split": True, "out": "pair"}, ("view", "K7")),
    ("out_packed_offset", [8, 16], 2, dict(backward_offset=3), {"out": "np"},
     ("view", "view")),
    ("in_place_strided", [64], 3, _strided(2, 130, 2, 130, 1, 1),
     {"in_place": True}, ("K7", "K7")),
    ("in_place_strided_split", [64], 3, _strided(2, 130, 2, 130, 1, 1),
     {"in_place": True, "split": True}, ("K7", "K7")),
    ("in_place_offsets_differ", [64], 3, dict(forward_offset=3, backward_offset=40),
     {"in_place": True}, ("view", "view")),
    ("in_place_strided_offsets_differ", [64], 3, _strided(2, 130, 2, 130, 0, 1),
     {"in_place": True}, ("K7", "K7")),
    ("longer_input", [64], 3, _strided(2, 130), {"longer": 9}, ("K7", "view")),
    ("longer_input_split", [1000], 1, dict(forward_offset=2), {"longer": 5, "split": True},
     ("view", "view")),
    # the cases that raised naming ROADMAP item 8 before K7
    ("was_item8_split_strided", [16], 2, _strided(2, 32, 2, 32), {"split": True},
     ("K7", "K7")),
    ("was_item8_strided", [16], 2, _strided(2, 32, 2, 32), {}, ("K7", "K7")),
    ("was_item8_bi_forward_only", [16], 4, _bi(4, backward=False), {},
     ("K7", "view")),
    ("was_item8_offset", [16], 1, dict(forward_offset=2), {}, ("view", "view")),
    ("was_item8_multidim_split_offset", [8, 16], 1, dict(forward_offset=3),
     {"split": True}, ("view", "view")),
    ("was_item8_multidim_offset", [8, 16], 1, dict(forward_offset=3), {},
     ("view", "view")),
    ("was_item8_bi_both_offset", [16], 4, dict(_bi(4), backward_offset=2), {},
     ("view", "view")),
    # BATCH_INTERLEAVED over lengths K10 declines: GLOBAL, the chain
    # [125, 8] and FUSED [5, 128]
    ("was_item4_bi_65536", [65536], 2, _bi(2), {}, ("K7", "K7")),
    ("was_item4_bi_1000", [1000], 2, _bi(2), {}, ("K7", "K7")),
    ("was_item4_bi_640", [640], 2, _bi(2), {}, ("K7", "K7")),
]


def _descs(lengths, batch, fields, opts):
    n = int(np.prod(lengths))
    kw = dict(lengths=lengths, number_of_transforms=batch, forward_scale=0.5,
              backward_scale=1.0 / n, **fields)
    r, p = dict(kw), dict(kw)
    if opts.get("split"):
        r["complex_storage"] = ref.ComplexStorage.SPLIT_COMPLEX
        p["complex_storage"] = pt.ComplexStorage.SPLIT_COMPLEX
    if opts.get("in_place"):
        r["placement"] = ref.Placement.IN_PLACE
        p["placement"] = pt.Placement.IN_PLACE
    return ref.Descriptor(**r), pt.Descriptor(**p)


def _port_out(kind, buf):
    """The port's ``out=`` of ``kind`` holding the complex ``buf``."""
    if kind == "np":
        return buf.copy()
    if kind == "complex":
        return torch.from_numpy(buf.copy())
    if kind == "raw":
        return torch.from_numpy(buf.view(np.float32).copy())
    return (torch.from_numpy(buf.real.copy()), torch.from_numpy(buf.imag.copy()))


def _as_complex(y):
    """A result of either package (numpy, torch, jax, raw or a (re, im)
    pair) as a flat complex64 numpy array."""
    if isinstance(y, tuple):
        re, im = (np.asarray(t) for t in y)
        return (re + 1j * im).astype(np.complex64)
    if isinstance(y, torch.Tensor):
        y = torch.view_as_real(y) if y.is_complex() else y
        return y.numpy().reshape(-1).view(np.complex64)
    y = np.asarray(y)
    return y if np.iscomplexobj(y) else y.reshape(-1).view(np.complex64)


def _calls(opts, rfn, pfn, flat, out_buf):
    """The reference's and the port's result on the same buffers."""
    if opts.get("split"):
        args = lambda: (flat.real.copy(), flat.imag.copy())  # noqa: E731
        if out_buf is None:
            return rfn(*args()), pfn(*args())
        rout = (out_buf.real.copy(), out_buf.imag.copy())
        got = pfn(*args(), out=_port_out(opts["out"], out_buf))
        return rfn(*args(), out=rout), got
    if out_buf is None:
        return rfn(flat.copy()), pfn(flat.copy())
    port_out = _port_out(opts["out"], out_buf)
    got = pfn(flat.copy(), out=port_out)
    # a tensor or writable numpy out= is written in place and returned
    assert got is port_out
    return rfn(flat.copy(), out=out_buf.copy()), got


def _sides(entry):
    if entry[0] != "layout":
        return ("view", "view"), entry
    _, inner, src, dst = entry
    return tuple("K7" if isinstance(s, Rows) else "view" for s in (src, dst)), inner


@pytest.mark.parametrize("lengths,batch,fields,opts,sides",
                         [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_layout_matches_reference(lengths, batch, fields, opts, sides):
    rdesc, pdesc = _descs(lengths, batch, fields, opts)
    rplan = rdesc.commit(use_pallas=True)
    plan = pdesc.commit(device="cpu")
    canon = oracle.gen_input(rdesc, seed=sum(lengths) + batch)
    tol = oracle.tolerance(rdesc)
    for rdir, pdir in zip(ref.Direction, pt.Direction):
        assert _sides(plan._raw_fast[pdir])[0] == (
            sides if rdir == ref.Direction.FORWARD else sides[::-1])
        rfn, pfn = ((rplan.compute_forward, plan.compute_forward)
                    if rdir == ref.Direction.FORWARD
                    else (rplan.compute_backward, plan.compute_backward))
        flat = oracle.materialize(rdesc, canon, rdir)
        count_out = rdesc.get_output_count(rdir)
        if opts.get("in_place"):  # one buffer for both layouts
            flat = np.concatenate([flat, np.full(max(0, count_out - flat.size),
                                                 SENTINEL, np.complex64)])
        flat = np.concatenate([flat, np.full(opts.get("longer", 0), SENTINEL,
                                             np.complex64)])
        out_buf = None
        if "out" in opts:
            out_buf = np.full(count_out + 4, SENTINEL, np.complex64)
        want, got = _calls(opts, rfn, pfn, flat, out_buf)
        want, got = _as_complex(want), _as_complex(got)
        assert got.shape == want.shape
        if not opts.get("in_place"):
            assert got.shape == ((count_out,) if out_buf is None else out_buf.shape)
        expect = oracle.reference_output(rdesc, canon, rdir)
        keep = out_buf is not None  # gaps keep the sentinel
        oracle.verify(rdesc, want, expect, rdir, check_padding=keep)
        oracle.verify(rdesc, got, expect, rdir, check_padding=keep)
        idx = oracle._indices(rdesc, ref.inv(rdir)).reshape(-1)
        diff = np.abs(got[idx] - want[idx]).astype(np.float64)
        assert np.all((diff <= tol) | (diff <= tol * np.abs(want[idx]))), diff.max()
        rest = np.ones(got.size, bool)
        rest[idx] = False
        assert np.array_equal(got[rest].view(np.uint32), want[rest].view(np.uint32))
        if out_buf is None and not opts.get("in_place"):
            assert not np.any(got[rest])


@pytest.mark.parametrize("n", [128, 256])
@pytest.mark.parametrize("s", [1, 2, 3])
@pytest.mark.parametrize("pad", [0, 7], ids=["minimal", "padded"])
def test_k7_plain_matches_pallas_io(n, s, pad):
    """K7's plain versions equal the JAX package's destride/restride bit
    for bit on the shapes those kernels take (batch 128, dist minimal or
    padded); restride with fill_gaps on a buffer of batch·dist elements is
    the reference's zero-filled (batch, 2·dist) output."""
    batch, dist = 128, (n - 1) * s + 1 + pad
    rng = np.random.default_rng(n + s + pad)
    x = rng.uniform(-1, 1, (batch, 2 * dist)).astype(np.float32)
    want = np.asarray(pallas_io.destride(jnp.asarray(x), n, s, interpret=True))
    got = cuda_stride.destride(torch.from_numpy(x.reshape(-1)), 0, s, dist, n, batch)
    assert np.array_equal(got.numpy().view(np.uint32), want.reshape(-1).view(np.uint32))
    y = rng.uniform(-1, 1, (batch, 2 * n)).astype(np.float32)
    want = np.asarray(pallas_io.restride(jnp.asarray(y), n, s, dist, interpret=True))
    out = torch.full((2 * batch * dist,), float("nan"))
    got = cuda_stride.restride(torch.from_numpy(y.reshape(-1)), 0, s, dist, n,
                               batch, out, True)
    assert got is out
    assert np.array_equal(out.numpy().view(np.uint32), want.reshape(-1).view(np.uint32))


# (o, s, dist, n, batch): row-major, overlapping reads (dist < span),
# batch-innermost (dist < s) with and without gaps, one row.
K7_MAPS = [(0, 2, 40, 16, 3), (5, 3, 50, 16, 4), (1, 2, 3, 8, 5),
           (0, 4, 1, 16, 4), (2, 8, 2, 16, 4), (3, 2, 1, 10, 1)]


@pytest.mark.parametrize("o,s,dist,n,batch", K7_MAPS)
@pytest.mark.parametrize("split", [False, True], ids=["interleaved", "planes"])
def test_k7_plain_is_the_affine_map(o, s, dist, n, batch, split):
    """destride reads element (b, j) at o + b·dist + j·s; restride writes
    it there and, with fill_gaps, zeroes everything else of ``out``,
    without it leaves everything else alone."""
    count = o + (batch - 1) * dist + (n - 1) * s + 1
    rng = np.random.default_rng(count)
    x = (rng.uniform(-1, 1, count + 3) + 1j * rng.uniform(-1, 1, count + 3)
         ).astype(np.complex64)
    addr = o + dist * np.arange(batch)[:, None] + s * np.arange(n)[None]

    def kind(c):
        return ((torch.from_numpy(c.real.copy()), torch.from_numpy(c.imag.copy()))
                if split else torch.from_numpy(c.view(np.float32).copy()))

    got = cuda_stride.destride(kind(x), o, s, dist, n, batch)
    assert np.array_equal(_as_complex(got), x[addr].reshape(-1))
    y = x[addr].reshape(-1)[::-1].copy()
    for fill in (False, True):
        if batch > 1 and dist < (n - 1) * s + 1 and dist >= s:
            break  # overlapping rows: read-only layouts
        out = kind(np.full(count + 3, SENTINEL, np.complex64))
        assert cuda_stride.restride(kind(y), o, s, dist, n, batch, out, fill) is out
        res = _as_complex(out)
        assert np.array_equal(res[addr].reshape(-1), y)
        rest = np.ones(res.size, bool)
        rest[addr.reshape(-1)] = False
        assert np.all(res[rest] == (0 if fill else SENTINEL))


def test_k7_wrappers_check_their_buffers():
    x = torch.zeros(2 * 40)
    with pytest.raises(pt.InvalidConfiguration, match="at least 42"):
        cuda_stride.destride(x, 1, 2, 20, 11, 2)
    with pytest.raises(pt.InvalidConfiguration, match="s, dist, n, batch >= 1"):
        cuda_stride.destride(x, 0, 0, 20, 4, 2)
    with pytest.raises(pt.InvalidConfiguration, match="exactly 22"):
        cuda_stride.restride(torch.zeros(40), 0, 2, 20, 11, 2, x, True)
    with pytest.raises(pt.InvalidConfiguration, match="plane"):
        cuda_stride.restride((torch.zeros(22), torch.zeros(22)), 0, 2, 20, 11, 2,
                             (torch.zeros(50), torch.zeros(60)), True)


def test_rows_of_one_transform_ignore_the_declared_distance():
    """With one transform the declared distance sizes nothing: the Rows
    distance is the span, and a unit stride is a packed block at the
    offset (no K7)."""
    d = pt.Descriptor(lengths=[1024], forward_strides=[2], forward_distance=10**9)
    assert rows_1d(d, pt.Direction.FORWARD) == Rows(0, 2, 2047, 1024, 1)
    plan = pt.Descriptor(lengths=[64], forward_distance=10**9,
                         forward_offset=3).commit(device="cpu")
    assert plan._raw_fast[pt.Direction.FORWARD] == (
        "layout", plan._raw_fast[pt.Direction.FORWARD][1], 3, 0)
    x = np.random.default_rng(0).uniform(-1, 1, 2 * 67).astype(np.float32)
    x = x.view(np.complex64)
    assert np.allclose(plan.compute_forward(x),
                       np.fft.fft(x[3:].astype(np.complex128)), atol=1e-4)


def test_buffer_errors():
    plan = pt.Descriptor(lengths=[16], number_of_transforms=2,
                         backward_strides=[2], backward_distance=40).commit(device="cpu")
    x = np.zeros(32, np.complex64)
    with pytest.raises(pt.InvalidConfiguration, match="output buffer has 70"):
        plan.compute_forward(x, out=np.zeros(70, np.complex64))
    with pytest.raises(pt.InvalidConfiguration, match="single complex"):
        plan.compute_forward(x, out_imag=np.zeros(71, np.float32))
    split = pt.Descriptor(lengths=[16], complex_storage=pt.ComplexStorage.SPLIT_COMPLEX,
                          forward_offset=4).commit(device="cpu")
    re = np.zeros(20, np.float32)
    with pytest.raises(pt.InvalidConfiguration, match="both the real and the imaginary"):
        split.compute_forward(re, re, out=np.zeros(16, np.float32))
    with pytest.raises(pt.InvalidConfiguration, match="split output buffers need 16"):
        split.compute_forward(re, re, out=(np.zeros(15, np.float32),) * 2)
    ip = pt.Descriptor(lengths=[16], placement=pt.Placement.IN_PLACE,
                       backward_offset=3).commit(device="cpu")
    with pytest.raises(pt.InvalidConfiguration, match="output buffer has 16"):
        ip.compute_forward(np.zeros(16, np.complex64))
