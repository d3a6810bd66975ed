"""The multi-dimensional C2C path and the BATCH_INTERLEAVED 1D entry of
portfft_tpu_torch against portfft_tpu (``commit(use_pallas=True)``, Pallas
kernels in interpret mode) and ``np.fft``.

Each case runs the same seeded input through both packages and asserts the
same plans and the same route: the kernels the reference traced, in order,
are the port's steps.  Tolerance: both within the oracle's per-element
2·eps·N·log2N of ``np.fft`` (N the flattened length); port against
reference max|Δ| ≤ 5e-5·max|y_ref| (the reference's bf16×3 matrix
products).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
import portfft_tpu as ref
import portfft_tpu_torch as pt
from portfft_tpu.config import DeviceConfig as RefConfig
from portfft_tpu.ops import pallas_fft, pallas_global, pallas_multidim, xla_fft
from portfft_tpu.planner import plan_1d as ref_plan_1d
from portfft_tpu_torch import convert, fastpath
from portfft_tpu_torch.config import DeviceConfig
from portfft_tpu_torch.ops import cuda_fft, cuda_multidim, torch_fft
from portfft_tpu_torch.planner import plan_1d

REF_CFG = RefConfig(name="cpu")
CFG = DeviceConfig()

# (lengths, batch, kernels in order): one row per route of the tentpole.
ROUTES = [
    ([16, 64], 2, ("direct", "col")),           # DIRECT rows + col DIRECT
    ([1024, 16], 1, ("direct", "col")),         # col FUSED [8, 128]
    ([16384, 2], 1, ("direct", "col")),         # col [128, 128], two launches
    ([256, 128], 2, ("md2",)),                  # md2 DIRECT x DIRECT
    ([1024, 128], 1, ("md2",)),                 # md2, FUSED phase A
    ([128, 1024], 1, ("md2",)),                 # md2, FUSED phase B
    ([4, 8, 32], 2, ("direct", "col", "col")),  # rows + two col passes
    ([2, 128, 128], 1, ("md2", "col")),         # md2 + col L = 2
    ([1, 64, 32], 2, ("direct", "col")),        # leading 1, scale != 1
    ([1, 128, 128], 1, ("md2",)),               # leading 1, scale in md2
]
# The reference's kernel functions and the port's step kinds they map to.
REF_KERNELS = {
    (pallas_fft, "direct_raw_call"): "direct",
    (pallas_fft, "fused2_raw_mm_call"): "fused2",
    (pallas_fft, "fused2_raw_v2_call"): "fused2",
    (pallas_fft, "fused2_raw_call"): "fused2_v1",
    (pallas_global, "global2_raw_call"): "global2",
    (pallas_multidim, "col_raw_call"): "col",
    (pallas_multidim, "col_raw_mm_call"): "col",
    (pallas_multidim, "md2_fused_raw_call"): "md2",
}


@pytest.fixture
def ref_calls(monkeypatch):
    """The port kinds of the reference's kernel calls that returned a
    result, in the order its fast path traced them."""
    calls = []
    for (mod, name), kind in REF_KERNELS.items():
        fn = getattr(mod, name)

        def wrapped(*a, _fn=fn, _kind=kind, **k):
            res = _fn(*a, **k)
            if res is not None:
                calls.append(_kind)
            return res

        monkeypatch.setattr(mod, name, wrapped)
    return calls


def _kw(mod, kw):
    kw = dict(kw)
    for field, enum in (("placement", "Placement"),
                        ("complex_storage", "ComplexStorage"),
                        ("domain", "Domain")):
        if field in kw:
            kw[field] = getattr(mod, enum)[kw[field]]
    return kw


def _descs(lengths, batch, **kw):
    n = int(np.prod(lengths))
    kw = dict(lengths=lengths, number_of_transforms=batch, forward_scale=0.5,
              backward_scale=1.0 / n, **kw)
    return ref.Descriptor(**_kw(ref, kw)), pt.Descriptor(**_kw(pt, kw))


def _assert_close(got, want_ref, desc, canon, direction):
    """``got`` and ``want_ref`` (flat complex) against np.fft, and each
    other."""
    expect = oracle.reference_output(desc, canon, direction)
    oracle.verify(desc, np.asarray(want_ref), expect, direction,
                  check_padding=False)
    oracle.verify(desc, np.asarray(got), expect, direction, check_padding=False)
    delta = np.abs(np.asarray(got) - np.asarray(want_ref)).max()
    assert delta <= 5e-5 * np.abs(want_ref).max(), delta


def _step_kinds(route) -> tuple:
    """The kernel of each step of a multi-dim route, in order: a row
    step's engine, a column step's kernel, ``md2``."""
    return tuple(s.engine.name if isinstance(s, fastpath.Raw) else
                 s.kernel if isinstance(s, fastpath.Col) else "md2"
                 for s in route.steps)


def _ref_md2(rplan, lengths) -> bool:
    """Whether the reference's fast path takes md2 for ``lengths``."""
    if lengths[-2] == 1:
        return False
    return pallas_multidim.md2_supported(
        rplan.plans[lengths[-2]], rplan.plans[lengths[-1]], rplan.config
    )


@pytest.mark.parametrize("lengths,batch,kinds", ROUTES)
def test_multidim_route_and_values_match_reference(ref_calls, lengths, batch,
                                                   kinds):
    rdesc, pdesc = _descs(lengths, batch)
    rplan = rdesc.commit(use_pallas=True)
    plan = pdesc.commit(device="cpu")
    assert plan.plan_description() == rplan.plan_description()
    canon = oracle.gen_input(rdesc, seed=sum(lengths) + batch)
    x = canon.reshape(-1)
    for rdir, pdir in zip(ref.Direction, pt.Direction):
        ref_calls.clear()
        rfn = rplan.compute_forward if rdir == ref.Direction.FORWARD else (
            rplan.compute_backward)
        pfn = plan.compute_forward if pdir == pt.Direction.FORWARD else (
            plan.compute_backward)
        want = rfn(x)
        got = pfn(x)
        # the reference ran its fast path (no fallback) through these kernels
        rroute = rplan._raw_fast[rdir]
        assert rroute[0] == "multidim"
        assert tuple(ref_calls) == kinds
        entry = plan._raw_fast[pdir]
        assert isinstance(entry, fastpath.MultiDim)
        assert isinstance(entry.steps[0], fastpath.Md2) == _ref_md2(rplan, lengths)
        assert _step_kinds(entry) == kinds
        # the scale rides on the last kernel only
        scale = float(pdesc.get_scale(pdir))
        assert [s.scale for s in entry.steps] == [1.0] * (len(kinds) - 1) + [scale]
        assert isinstance(got, np.ndarray) and got.dtype == np.complex64
        assert got.shape == want.shape == x.shape
        _assert_close(got, want, rdesc, canon, rdir)


@pytest.mark.parametrize("lengths,batch", [([256, 128], 2), ([4, 8, 32], 2)])
def test_multidim_in_place_tensor_raw(lengths, batch):
    """IN_PLACE on a raw float32 tensor: the result lands in the caller's
    tensor and equals the reference's in-place result; the backward round
    trip (scales 0.5 and 1/N) gives x/2."""
    rdesc, pdesc = _descs(lengths, batch, placement="IN_PLACE")
    rplan = rdesc.commit(use_pallas=True)
    plan = pdesc.commit(device="cpu")
    canon = oracle.gen_input(rdesc, seed=7)
    raw = canon.reshape(-1).view(np.float32).copy()
    want = np.asarray(rplan.compute_forward(raw.copy())).view(np.complex64)
    t = torch.from_numpy(raw.copy())
    assert plan.compute_forward(t) is t
    _assert_close(t.numpy().view(np.complex64), want, rdesc, canon,
                  ref.Direction.FORWARD)
    assert plan.compute_backward(t) is t
    back = t.numpy().view(np.complex64)
    assert np.abs(back - 0.5 * canon.reshape(-1)).max() <= 1e-5


@pytest.mark.parametrize("n,batch", [(64, 8), (1024, 4)])
def test_batch_interleaved_matches_reference(ref_calls, n, batch):
    """BATCH_INTERLEAVED (stride = batch, distance 1, both domains) runs
    the column kernel once with bpre = 1, as the reference's ``bi_col``."""
    kw = dict(forward_strides=[batch], backward_strides=[batch],
              forward_distance=1, backward_distance=1)
    rdesc, pdesc = _descs([n], batch, **kw)
    rplan = rdesc.commit(use_pallas=True)
    plan = pdesc.commit(device="cpu")
    canon = oracle.gen_input(rdesc, seed=n)
    for rdir, pdir in zip(ref.Direction, pt.Direction):
        flat = oracle.materialize(rdesc, canon, rdir)
        ref_calls.clear()
        rfn = rplan.compute_forward if rdir == ref.Direction.FORWARD else (
            rplan.compute_backward)
        pfn = plan.compute_forward if pdir == pt.Direction.FORWARD else (
            plan.compute_backward)
        want = rfn(flat)
        got = pfn(flat)
        rroute = rplan._raw_fast[rdir]
        assert rroute[0] == "bi_col" and ref_calls == ["col"]
        entry = plan._raw_fast[pdir]
        assert isinstance(entry, fastpath.Col)
        assert (entry.bpre, entry.plan, entry.rest) == (1, plan.plans[n], batch)
        _assert_close(got, want, rdesc, canon, rdir)


def _check_axis(got, want, x, shape, axes, sign, scale):
    """Kernel results against np.fft over ``axes`` of the complex ``shape``
    view (tolerance at N = the transform's size), and port against
    reference."""
    xc = x.view(np.complex64).reshape(shape).astype(np.complex128)
    n = int(np.prod([shape[a] for a in axes]))
    ref_y = (np.fft.fftn(xc, axes=axes) if sign < 0
             else np.fft.ifftn(xc, axes=axes) * n) * scale
    tol = 2.0 * np.finfo(np.float32).eps * n * max(np.log2(n), 1.0)
    for raw in (got, want):
        y = np.asarray(raw).view(np.complex64).reshape(shape)
        diff = np.abs(y - ref_y)
        assert np.all((diff <= tol) | (diff <= tol * np.abs(ref_y))), diff.max()
    delta = np.abs(np.asarray(got) - np.asarray(want)).max()
    assert delta <= 5e-5 * np.abs(np.asarray(want)).max(), delta


def _sub(n, sign, rbank):
    """The port's sub-tables of the length-n plan, carried over from the
    reference's bank."""
    plan = plan_1d(n, CFG, 4)
    keys = torch_fft.collect_bank_keys(plan, sign, torch_fft.TwiddleBank(), {})
    arrays = convert.bank_from_reference(rbank.host, "cpu")
    return cuda_fft.sub_tables(plan, sign, keys, arrays)


@pytest.mark.parametrize(
    "bpre,L,rest,sign,scale",
    [(2, 16, 64, -1, 1.0), (1, 1024, 16, +1, 0.5), (3, 100, 8, -1, 2.0)],
)
def test_col_matches_col_raw_call(bpre, L, rest, sign, scale):
    x = np.random.default_rng(L).uniform(-1, 1, 2 * bpre * L * rest).astype(
        np.float32)
    rplan = ref_plan_1d(L, REF_CFG, 4)
    rbank = xla_fft.TwiddleBank(np.float32)
    xla_fft.collect_bank_keys(rplan, sign, rbank)
    names = pallas_multidim.col_table_names(rplan, sign, rbank)
    want = pallas_multidim.col_raw_call(
        jnp.asarray(x), bpre, rplan, 2 * rest, sign, names,
        rbank.device_arrays(), REF_CFG, scale=scale,
    )
    assert want is not None
    sub = _sub(L, sign, rbank)
    got = cuda_multidim.col(torch.from_numpy(x), bpre, rest, sub, scale)
    assert torch.equal(got, cuda_multidim.col.plain(torch.from_numpy(x), bpre,
                                                    rest, sub, scale))
    _check_axis(got.numpy(), want, x, (bpre, L, rest), (1,), sign, scale)


@pytest.mark.parametrize(
    "batch,n1,n2,sign,scale",
    [(2, 256, 128, -1, 1.0), (1, 1024, 128, +1, 0.25), (1, 128, 1024, -1, 0.5)],
)
def test_md2_matches_md2_fused_raw_call(batch, n1, n2, sign, scale):
    x = np.random.default_rng(n1 + n2).uniform(
        -1, 1, 2 * batch * n1 * n2).astype(np.float32)
    rbank = xla_fft.TwiddleBank(np.float32)
    rp1, rp2 = ref_plan_1d(n1, REF_CFG, 4), ref_plan_1d(n2, REF_CFG, 4)
    rkeys = xla_fft.collect_bank_keys(rp1, sign, rbank)
    xla_fft.collect_bank_keys(rp2, sign, rbank, rkeys)
    want = pallas_multidim.md2_fused_raw_call(
        jnp.asarray(x), batch, rp1, rp2, sign, rkeys, rbank.device_arrays(),
        REF_CFG, scale=scale,
    )
    assert want is not None
    sub1, sub2 = _sub(n1, sign, rbank), _sub(n2, sign, rbank)
    got = cuda_multidim.md2(torch.from_numpy(x), batch, sub1, sub2, scale)
    _check_axis(got.numpy(), want, x, (batch, n1, n2), (1, 2), sign, scale)


def test_gates_match_reference():
    """col_axis_supported, md2_supported and the md2 tiles equal the
    reference's on every pair of a spread of lengths."""
    sizes = [2, 16, 100, 128, 256, 384, 512, 640, 1024, 2048, 4096, 16384,
             65536]
    for n1 in sizes:
        p1, r1 = plan_1d(n1, CFG, 4), ref_plan_1d(n1, REF_CFG, 4)
        assert cuda_multidim.col_axis_supported(p1) == (
            pallas_multidim.col_axis_supported(r1))
        for n2 in sizes:
            p2, r2 = plan_1d(n2, CFG, 4), ref_plan_1d(n2, REF_CFG, 4)
            assert cuda_multidim.md2_supported(p1, p2, CFG) == (
                pallas_multidim.md2_supported(r1, r2, REF_CFG)), (n1, n2)
            lane = 1 << 30  # DIRECT of any length, or FUSED [a, 128], a | 128
            if all(cuda_multidim.col_axis_supported(p, lane) for p in (p1, p2)):
                assert cuda_multidim.md2_pick_tiles(p1, p2, CFG) == (
                    pallas_multidim.md2_pick_tiles(r1, r2, REF_CFG)), (n1, n2)


def test_bench_rows_route_as_the_reference():
    """The three ``MULTIDIM_CONFIGS`` rows: md2 at 512² and 128³, the
    per-axis route at 1024² (no md2 tile pair fits)."""
    for lengths, kinds in (([512, 512], ("md2",)),
                           ([1024, 1024], ("fused2", "col")),
                           ([128, 128, 128], ("md2", "col"))):
        plan = pt.Descriptor(lengths=lengths).commit(device="cpu")
        assert _step_kinds(plan._raw_fast[pt.Direction.FORWARD]) == kinds
    rplan = ref.Descriptor(lengths=[1024, 1024]).commit(use_pallas=True)
    assert not _ref_md2(rplan, [1024, 1024])


@pytest.mark.parametrize(
    "kw,match",
    [
        # the offset, one-sided BATCH_INTERLEAVED and BATCH_INTERLEAVED
        # 65536, 1000 and 640 cases that raised here are parity cases of
        # tests/test_torch_layout.py (K7 and views at offsets)
        (dict(lengths=[8, 16], domain="REAL", forward_offset=3), "item 9"),
        (dict(lengths=[8, 16], domain="REAL"), "multi-dim.*item 9"),
    ],
)
def test_outside_the_slice_raises_at_commit(kw, match):
    with pytest.raises(pt.UnsupportedConfiguration, match=match):
        pt.Descriptor(**_kw(pt, kw)).commit(device="cpu")


@pytest.mark.parametrize(
    "lengths,routes",
    [
        ([640, 16], {640: "chain", 16: "direct"}),  # FUSED [5, 128] outer axis
        ([65536, 2], {65536: "global2", 2: "direct"}),  # GLOBAL outer axis
    ],
)
def test_plane_outer_axes_take_the_plane_route(lengths, routes):
    """An outer axis K10 does not take sends the transform down the plane
    path's per-axis walk, as the reference's raw registry sends it to
    ``_traced_interleaved``: here no column kernel K12 either (a < 8, and
    a GLOBAL axis), so each axis runs through the executor; the result
    matches the reference."""
    rdesc, pdesc = _descs(lengths, 1)
    rplan = rdesc.commit(use_pallas=True)
    plan = pdesc.commit(device="cpu")
    assert ref.Direction.FORWARD not in rplan._raw_fast
    entry = plan._raw_fast[pt.Direction.FORWARD]
    assert isinstance(entry, fastpath.Core)
    assert entry.split is False and entry.k12 == ()
    assert entry.routes == routes
    canon = oracle.gen_input(rdesc, seed=sum(lengths))
    x = canon.reshape(-1)
    _assert_close(plan.compute_forward(x), rplan.compute_forward(x), rdesc,
                  canon, ref.Direction.FORWARD)


def test_committed_plan_runs_on_carried_tables():
    """A multi-dim plan whose device tables are the reference's, carried
    over, computes what the same plan on its own tables computes."""
    rdesc, pdesc = _descs([256, 128], 2)
    rplan = rdesc.commit(use_pallas=True)
    plan = pdesc.commit(device="cpu")
    x = torch.from_numpy(
        oracle.gen_input(rdesc, seed=3).reshape(-1).view(np.float32).copy())
    for direction in pt.Direction:
        want = plan._fns[direction](x)
        arrays = plan._bank_arrays
        plan._bank_arrays = convert.bank_from_reference(rplan._bank.host, "cpu")
        fn = fastpath.build_fn(plan, plan._raw_fast[direction])
        plan._bank_arrays = arrays
        assert torch.equal(fn(x), want)


def test_every_axis_length_has_its_tables():
    """The committed bank holds the tables of each distinct axis length in
    both directions: the row kernel's, every column pass's and K11's."""
    plan = pt.Descriptor(lengths=[1024, 16, 100]).commit(device="cpu")
    for sign in (-1, +1):
        for n in (16, 100, 8, 128):
            assert ("W", n, sign) in plan._bank_keys
        assert ("U", 8, 128, sign) in plan._bank_keys
    for direction in pt.Direction:
        for s in plan._raw_fast[direction].steps:
            s.kernel_args(plan)  # every table resolves
