"""The checks of ``chip_smoke.py``, run on the CPU at every shape of its
kernel phase: they pass a correct result, and they reject a faulty kernel
and the faults the smoke run plants itself.

On the CPU a wrapper runs its plain version, so the correct "kernel" here
is the plain path.  A faulty kernel is a wrapper that runs the plain
version on a conjugated table (``chip_smoke.planted``) or returns zeros.
The batch is cut to 1 or 2 rows.
"""

import json
import math

import pytest
import torch

import chip_smoke
import portfft_tpu_torch as pf

SIZES = sorted({n for n, _ in chip_smoke.KERNEL_CASES})
DIRECTIONS = [(pf.Direction.FORWARD, -1), (pf.Direction.BACKWARD, +1)]


def _case(n, direction):
    batch = 2 if n <= 65536 else 1
    plan = pf.Descriptor(
        lengths=[n], number_of_transforms=batch, forward_scale=0.5,
        backward_scale=2.0 / n,
    ).commit(device="cpu")
    gen = torch.Generator().manual_seed(n)
    x = torch.rand(2 * batch * n, generator=gen) * 2 - 1
    return (*chip_smoke.kernel_and_args(plan, direction), x)


@pytest.mark.parametrize("n", SIZES)
def test_checks_pass_a_correct_result(n):
    for direction, sign in DIRECTIONS:
        kind, kernel, args, x = _case(n, direction)
        r = chip_smoke.check_kernel(kind, kernel, args, x, n, sign)
        assert r["rel"] == 0.0 and r["excess"] <= 1.0
        # both planted faults were rejected by both checks, by a wide margin
        for rel, excess in r["caught"].values():
            assert rel > 100 * chip_smoke.KERNEL_TOL and excess > 100.0


@pytest.mark.parametrize("fault", ["conjugated table", "zeros"])
@pytest.mark.parametrize("n", SIZES)
def test_checks_reject_a_faulty_kernel(n, fault):
    direction, sign = DIRECTIONS[0]
    kind, kernel, args, x = _case(n, direction)

    def faulty(raw, *a):
        if fault == "zeros":
            return torch.zeros_like(raw)
        return kernel.plain(raw, *chip_smoke.planted(kind, a))

    faulty.plain = kernel.plain
    with pytest.raises(chip_smoke.SmokeFailure, match=r"max\|kernel - plain\|"):
        chip_smoke.check_kernel(kind, faulty, args, x, n, sign)
    y = faulty(x, *args)
    assert chip_smoke.oracle_excess(y, x, n, args[0], sign, args[-1]) > 100.0


REAL_SIZES = sorted({n for n, _ in chip_smoke.REAL_KERNEL_CASES})


def _real_case(n, direction):
    """One direction of chip_smoke's REAL kernel phase at ``n`` on the CPU,
    batch cut to 1 or 2: ``(kind, kernel, args, input, finish, source,
    sign, scale)``."""
    batch = 2 if n <= 8192 else 1
    scale = 0.5 if direction == pf.Direction.FORWARD else 2.0 / n
    plan = pf.Descriptor(
        lengths=[n], number_of_transforms=batch, domain=pf.Domain.REAL,
        forward_scale=0.5, backward_scale=2.0 / n,
    ).commit(device="cpu")
    x = chip_smoke.random_raw(batch * n, seed=n, device="cpu")
    spec = chip_smoke.half_spectra(batch, n, seed=n + 1, device="cpu")
    sign = -1 if direction == pf.Direction.FORWARD else +1
    src = x if sign < 0 else spec
    return (*chip_smoke.real_case(plan, direction, x, spec), src, sign, scale)


@pytest.mark.parametrize("n", REAL_SIZES)
def test_real_checks_pass_a_correct_result(n):
    for direction, _ in DIRECTIONS:
        kind, kernel, args, inp, finish, src, sign, scale = _real_case(n, direction)
        assert kind == ("small_real" if n <= 512 else
                        "untangle" if sign < 0 else "retangle")
        r = chip_smoke.check_real(kind, kernel, args, inp, finish, src, n,
                                  sign, scale)
        assert r["rel"] == 0.0 and r["excess"] <= 1.0
        for rel, excess in r["caught"].values():
            assert rel > 100 * chip_smoke.KERNEL_TOL and excess > 100.0


@pytest.mark.parametrize("fault", ["conjugated table", "zeros"])
@pytest.mark.parametrize("n", REAL_SIZES)
def test_real_checks_reject_a_faulty_kernel(n, fault):
    for direction, _ in DIRECTIONS:
        kind, kernel, args, inp, finish, src, sign, scale = _real_case(n, direction)

        def faulty(raw, *a):
            if fault == "zeros":
                return torch.zeros_like(kernel.plain(raw, *a))
            return kernel.plain(raw, *chip_smoke.planted(kind, a))

        faulty.plain = kernel.plain
        with pytest.raises(chip_smoke.SmokeFailure,
                           match=r"max\|kernel - plain\|"):
            chip_smoke.check_real(kind, faulty, args, inp, finish, src, n,
                                  sign, scale)
        y = faulty(inp, *args)
        final = y if finish is None else finish(y)
        assert chip_smoke.real_oracle_excess(final, src, n, args[0], sign,
                                             scale) > 100.0


def test_bounds_of_the_bench_rows():
    """Every C2C bench row moves 2^31 bytes (0.641 ms at 3.35 TB/s); the
    REAL rows 4·b·n + 8·b·(n/2+1) bytes: 0.165 ms at 2^26 reals, 0.321 ms
    at 2^27.  All are bound by bytes at the nominal flop counts."""
    for _, n, batch, _ in chip_smoke.ROWS:
        bound, by = chip_smoke.bound_of("direct", n, batch)
        assert by == "bytes" and bound == pytest.approx(2**31 / 3.35e9)
    want = {32: 0.165, 512: 0.321, 8192: 0.321, 131072: 0.321}
    for _, n, batch, _ in chip_smoke.REAL_ROWS:
        bound, by = chip_smoke.bound_of("small_real", n, batch)
        assert by == "bytes" and bound == pytest.approx(want[n], abs=1e-3)
    bound, by = chip_smoke.bound_of("untangle", 8192, 16 * 1024)
    assert by == "bytes" and bound == pytest.approx(
        (8 * 4096 + 8 * 4097) * 16 * 1024 / 3.35e9)


@pytest.mark.parametrize(
    "n,batch,real", [(16, 3, False), (4096, 2, False), (32, 3, True),
                     (1000, 2, True), (8192, 2, True)],
)
def test_library_call_computes_the_path_function(n, batch, real):
    """The yardstick ``torch.fft`` call that chip_smoke times beside each
    row computes what the row's plain path computes, both directions."""
    plan = pf.Descriptor(
        lengths=[n], number_of_transforms=batch,
        domain=pf.Domain.REAL if real else pf.Domain.COMPLEX,
    ).commit(device="cpu")
    for direction, sign in DIRECTIONS:
        numel = (batch * n if sign < 0 else batch * (n + 2)) if real else 2 * batch * n
        x = (chip_smoke.half_spectra(batch, n, 7, device="cpu")
             if real and sign > 0 else chip_smoke.random_raw(numel, 7, device="cpu"))
        want = chip_smoke.plain_path(plan, plan._raw_fast[direction])(x)
        got = chip_smoke.library_call(x, n, batch, real, sign < 0)()
        got = torch.view_as_real(got).reshape(-1) if got.is_complex() else got.reshape(-1)
        assert torch.allclose(got, want, atol=1e-3 * want.abs().max().item())


# Multi-dim kernel phase, cut on the CPU: K10 to bpre <= 2 and rest <= 8,
# K11 to one transform; L, n1 and n2 as on the card.
MD_CASES = ([("col", (min(b, 2), L, min(r, 8))) for b, L, r in chip_smoke.MD_COL_CASES]
            + [("md2", (1, n1, n2)) for _, n1, n2 in chip_smoke.MD2_CASES])


def _md_case(kind, shape, sign):
    n = math.prod(shape[d] for d in chip_smoke.MD_DIMS[kind])
    scale = 0.5 if sign < 0 else 2.0 / n
    kernel, args = chip_smoke.md_kernel_case(pf, kind, shape, sign, scale, "cpu")
    x = chip_smoke.random_raw(2 * math.prod(shape), seed=sum(shape), device="cpu")
    return kernel, args, x


@pytest.mark.parametrize("kind,shape", MD_CASES)
def test_md_checks_pass_a_correct_result(kind, shape):
    for _, sign in DIRECTIONS:
        kernel, args, x = _md_case(kind, shape, sign)
        r = chip_smoke.check_md(kind, kernel, args, x, shape, sign)
        assert r["rel"] == 0.0 and r["excess"] <= 1.0
        for rel, excess in r["caught"].values():
            assert rel > 100 * chip_smoke.KERNEL_TOL and excess > 100.0


@pytest.mark.parametrize("fault", ["conjugated table", "zeros"])
@pytest.mark.parametrize("kind,shape", MD_CASES)
def test_md_checks_reject_a_faulty_kernel(kind, shape, fault):
    for _, sign in DIRECTIONS:
        kernel, args, x = _md_case(kind, shape, sign)

        def faulty(raw, *a):
            if fault == "zeros":
                return torch.zeros_like(raw)
            return kernel.plain(raw, *chip_smoke.planted(kind, a))

        faulty.plain = kernel.plain
        with pytest.raises(chip_smoke.SmokeFailure, match=r"max\|kernel - plain\|"):
            chip_smoke.check_md(kind, faulty, args, x, shape, sign)
        excess = chip_smoke.nd_oracle_excess(faulty(x, *args), x, shape,
                                             chip_smoke.MD_DIMS[kind], sign,
                                             args[-1])
        assert excess > 100.0


def test_bounds_of_the_multidim_rows():
    """Each multi-dim row moves 2^30 bytes (0.321 ms at 3.35 TB/s) and
    bi_4096 2^31 (0.641 ms), bound by bytes at the nominal flops; K10 and
    K11 alone move 2^30."""
    for name, lengths, batch, _, _ in chip_smoke.MD_ROWS:
        bound, by = chip_smoke.bound_of("md2", math.prod(lengths), batch)
        nbytes = 2**31 if name == "bi_4096" else 2**30
        assert by == "bytes" and bound == pytest.approx(nbytes / 3.35e9)
    for kind, shape in chip_smoke.MD_ALONE.items():
        n = math.prod(shape[d] for d in chip_smoke.MD_DIMS[kind])
        bound, by = chip_smoke.bound_of(kind, n, math.prod(shape) // n)
        assert by == "bytes" and bound == pytest.approx(2**30 / 3.35e9)


@pytest.mark.parametrize("lengths,batch,bi", [((16, 64), 2, False),
                                              ((4, 8, 32), 1, False),
                                              ((1024,), 4, True)])
def test_fftn_call_computes_the_multidim_path_function(lengths, batch, bi):
    """The ``torch.fft`` yardstick of a multi-dim or BATCH_INTERLEAVED row
    computes what the row's plain path computes, both directions."""
    kw = dict(forward_strides=[batch], backward_strides=[batch],
              forward_distance=1, backward_distance=1) if bi else {}
    plan = pf.Descriptor(lengths=list(lengths), number_of_transforms=batch,
                         **kw).commit(device="cpu")
    n = math.prod(lengths)
    shape = (1, n, batch) if bi else (batch, *lengths)
    dims = (1,) if bi else tuple(range(1, len(shape)))
    x = chip_smoke.random_raw(2 * batch * n, 7, device="cpu")
    for direction, sign in DIRECTIONS:
        want = chip_smoke.plain_path(plan, plan._raw_fast[direction])(x)
        got = torch.view_as_real(chip_smoke.fftn_call(x, shape, dims, sign < 0)())
        assert torch.allclose(got.reshape(-1), want, atol=1e-3 * want.abs().max().item())


# Plane kernel phase, cut on the CPU: K13 and K15 to 2 rows, K6 to its
# element counts up to 2^20; n as on the card.
PLANE_CASES = ([("chain", n) for n, _ in chip_smoke.CHAIN_CASES]
               + [("bluestein", n) for n, _ in chip_smoke.BLUESTEIN_CASES])


@pytest.mark.parametrize("kind,n", PLANE_CASES)
def test_plane_checks_pass_a_correct_result(kind, n):
    x = chip_smoke.random_raw(2 * 2 * n, seed=n, device="cpu")
    for _, sign in DIRECTIONS:
        kernel, args = chip_smoke.plane_case(pf, kind, n, sign, "cpu")
        r = chip_smoke.check_plane(kind, kernel, args, x, n, 2, sign)
        assert r["rel"] == 0.0 and r["excess"] <= 1.0
        for rel, excess in r["caught"].values():
            assert rel > 100 * chip_smoke.KERNEL_TOL and excess > 100.0


@pytest.mark.parametrize("fault", ["conjugated table", "zeros"])
@pytest.mark.parametrize("kind,n", PLANE_CASES)
def test_plane_checks_reject_a_faulty_kernel(kind, n, fault):
    x = chip_smoke.random_raw(2 * 2 * n, seed=n, device="cpu")
    for _, sign in DIRECTIONS:
        kernel, args = chip_smoke.plane_case(pf, kind, n, sign, "cpu")

        def faulty(xr, xi, *a):
            if fault == "zeros":
                return torch.zeros_like(xr), torch.zeros_like(xi)
            return kernel.plain(xr, xi, *chip_smoke.planted(kind, a))

        faulty.plain = kernel.plain
        faulty.launches = 0
        with pytest.raises(chip_smoke.SmokeFailure, match=r"max\|kernel - plain\|"):
            chip_smoke.check_plane(kind, faulty, args, x, n, 2, sign)
        y = chip_smoke.on_raw(faulty, n)(x, *args)
        assert chip_smoke.oracle_excess(y, x, n, 2, sign, 1.0) > 100.0


@pytest.mark.parametrize("m", [m for m in chip_smoke.IO_CASES if m <= 1 << 20])
def test_io_check_passes_and_rejects_faults(m, monkeypatch):
    """K6's check passes the plain versions (exact), rejects both planted
    faults by a wide margin, and rejects a deinterleave that swaps the
    planes and an interleave that drops the scale."""
    from portfft_tpu_torch.ops import cuda_io

    x = chip_smoke.random_raw(2 * m, seed=m, device="cpu")
    r = chip_smoke.check_io(m, x, 0.5)
    assert r["rel"] == 0.0 and len(r["caught"]) == 4
    for rel, exc in r["caught"].values():
        assert rel > 100 * chip_smoke.KERNEL_TOL and exc > 100 * chip_smoke.KERNEL_TOL
    swapped = lambda raw: cuda_io.deinterleave_plain(raw)[::-1]  # noqa: E731
    swapped.plain, swapped.launches = cuda_io.deinterleave.plain, 0
    monkeypatch.setattr(cuda_io, "deinterleave", swapped)
    with pytest.raises(chip_smoke.SmokeFailure, match="deinterleave"):
        chip_smoke.check_io(m, x, 0.5)
    monkeypatch.undo()
    unscaled = lambda re, im, scale: cuda_io.interleave_plain(re, im, 1.0)  # noqa: E731
    unscaled.plain, unscaled.launches = cuda_io.interleave.plain, 0
    monkeypatch.setattr(cuda_io, "interleave", unscaled)
    with pytest.raises(chip_smoke.SmokeFailure, match="interleave"):
        chip_smoke.check_io(m, x, 0.5)


@pytest.mark.parametrize("m", [1000, 1 << 14])
def test_io_library_calls_compute_k6(m):
    """K6's library yardstick computes K6 at scale 1: the transposed copy
    holds the re plane then the im plane, and ``torch.complex`` of the
    planes is ``x`` again."""
    from portfft_tpu_torch.ops import cuda_io

    x = chip_smoke.random_raw(2 * m, seed=m, device="cpu")
    re, im = cuda_io.deinterleave.plain(x)
    planes, joined = (f() for f in chip_smoke.io_library_calls(x, re, im))
    assert planes.shape == (2, m)
    assert torch.equal(planes[0], re) and torch.equal(planes[1], im)
    assert torch.equal(torch.view_as_real(joined).reshape(-1),
                       cuda_io.interleave.plain(re, im, 1.0))


def test_bounds_of_the_plane_rows():
    """large_1d_prime moves 16·2048·65537 bytes (0.641 ms at 3.35 TB/s);
    K6 alone moves twice that; every plane row is bound by bytes."""
    for _, n, batch, _ in chip_smoke.PLANE_ROWS:
        bound, by = chip_smoke.bound_of("bluestein", n, batch)
        assert by == "bytes" and bound == pytest.approx(16 * n * batch / 3.35e9)
    m, b = chip_smoke.PLANE_ALONE["interleave"]
    bound, by = chip_smoke.bound_of("interleave", m, b)
    assert by == "bytes" and bound == pytest.approx(32 * 65537 * 2048 / 3.35e9)


@pytest.mark.parametrize("n,batch", [(1000, 2), (2062, 2), (20011, 1)])
def test_library_call_computes_the_plane_path_function(n, batch):
    """The ``torch.fft`` yardstick of a plane row computes what the row's
    plain path (``fastpath.plane_fn(plain=True)``) computes, both ways."""
    plan = pf.Descriptor(lengths=[n], number_of_transforms=batch).commit(device="cpu")
    x = chip_smoke.random_raw(2 * batch * n, 7, device="cpu")
    for direction, sign in DIRECTIONS:
        entry = plan._raw_fast[direction]
        assert entry[0] == "plane"
        want = chip_smoke.plain_path(plan, entry)(x)
        got = torch.view_as_real(chip_smoke.library_call(x, n, batch, False, sign < 0)())
        assert torch.allclose(got.reshape(-1), want, atol=1e-3 * want.abs().max().item())


# K14/K12 kernel phase, cut on the CPU: K14 to one transform and its
# [128, 128] case to 16384 x 8 without post (the 2^27-point convolution's
# host tables would take minutes; post is checked at 65537's); K12 to
# bpre <= 2 and rest <= 8.
SPLIT_CASES = (
    [("global2_planes", (g1, 8, 1, None) if g1 == 16384 else (g1, g2, 1, post))
     for g1, g2, _, post in chip_smoke.GLOBAL_PLANES_CASES]
    + [("axis_m2", (min(b, 2), L, min(r, 8))) for b, L, r in chip_smoke.AXIS_CASES])


@pytest.mark.parametrize("kind,case", SPLIT_CASES)
def test_split_checks_pass_a_correct_result(kind, case):
    shape = chip_smoke.split_shape(kind, case)
    x = chip_smoke.random_raw(2 * math.prod(shape), seed=shape[1], device="cpu")
    for _, sign in DIRECTIONS:
        kernel, args = chip_smoke.split_case(pf, kind, case, sign, "cpu")
        r = chip_smoke.check_split(kind, kernel, args, x, shape, sign)
        assert r["rel"] == 0.0 and r["excess"] <= 1.0
        for rel, excess in r["caught"].values():
            assert rel > 100 * chip_smoke.KERNEL_TOL and excess > 100.0


@pytest.mark.parametrize("fault", ["conjugated table", "zeros"])
@pytest.mark.parametrize("kind,case", SPLIT_CASES)
def test_split_checks_reject_a_faulty_kernel(kind, case, fault):
    shape = chip_smoke.split_shape(kind, case)
    x = chip_smoke.random_raw(2 * math.prod(shape), seed=shape[1], device="cpu")
    for _, sign in DIRECTIONS:
        kernel, args = chip_smoke.split_case(pf, kind, case, sign, "cpu")

        def faulty(xr, xi, *a):
            if fault == "zeros":
                return torch.zeros_like(xr), torch.zeros_like(xi)
            return kernel.plain(xr, xi, *chip_smoke.planted(kind, a))

        faulty.plain = kernel.plain
        faulty.launches = 0
        with pytest.raises(chip_smoke.SmokeFailure, match=r"max\|kernel - plain\|"):
            chip_smoke.check_split(kind, faulty, args, x, shape, sign)


def test_path_kinds_of_the_new_rows():
    """The kernels each SPLIT row and plane row must launch, from its
    route (the two largest plane rows by their routes alone: their banks
    hold GiB-sized tables)."""
    from portfft_tpu_torch import fastpath
    from portfft_tpu_torch.planner import plan_1d

    want = {
        "split_large_1d": ["global2_planes"], "split_2^20": ["global2_planes"],
        "split_4096": ["chain"], "split_large_1d_prime": ["bluestein"],
        "split_md_1024x1024": ["chain", "axis_m2"],
        "split_md_128^3": ["chain", "axis_m2"],
    }
    for name, lengths, _, dname in chip_smoke.SPLIT_ROWS:
        plan = pf.Descriptor(lengths=list(lengths),
                             complex_storage=pf.ComplexStorage.SPLIT_COMPLEX
                             ).commit(device="cpu")
        entry = plan._raw_fast[pf.Direction(dname)]
        assert chip_smoke.path_kinds(entry) == want[name.replace("_backward", "")]
    md = pf.Descriptor(lengths=[128, 640, 128]).commit(device="cpu")
    entry = md._raw_fast[pf.Direction.FORWARD]
    assert chip_smoke.path_kinds(entry) == ["deinterleave", "interleave",
                                            "chain", "axis_m2"]
    cfg = pf.DeviceConfig()
    for n, kinds in ((12232320, ["chain", "global2_planes"]),
                     (50431897, ["global2_planes"])):
        routes = fastpath.plane_routes(plan_1d(n, cfg, 4), cfg)
        entry = ("plane", None, 1, -1, 1.0, routes)
        assert chip_smoke.path_kinds(entry) == ["deinterleave", "interleave", *kinds]


def _k14_nodes(plan, batch: int, routes: dict, post_n, out: set) -> None:
    """The (g1, g2, batch, post_n) of every node of ``plan`` that its route
    sends to K14, at the batch the executor gives it: a GLOBAL node's subs
    run at the batch times the other sub's length, a Bluestein
    convolution at the batch, with the post tables of its length."""
    from portfft_tpu_torch.enums import Level

    if routes.get(plan.n) == "global2":
        out.add((plan.sub[0].n, plan.sub[1].n, batch, post_n))
    elif plan.level == Level.GLOBAL:
        g1, g2 = plan.sub
        _k14_nodes(g1, batch * g2.n, routes, None, out)
        _k14_nodes(g2, batch * g1.n, routes, None, out)
    elif plan.level == Level.BLUESTEIN:
        _k14_nodes(plan.conv, batch, routes, plan.n, out)


def test_kernel_cases_hold_the_main_path_shapes():
    """The K14/K12 kernel phase checks each kernel at every shape the SPLIT
    rows and the plane rows give it: K14 at each node its route takes (the
    nested node of 12232320 at batch 8 x 277, the post case of 50431897's
    convolution), K12 at each outer axis its gate takes (bpre the batch
    times the axes before it, rest the product of those after it)."""
    from portfft_tpu_torch import fastpath
    from portfft_tpu_torch.ops import cuda_axis
    from portfft_tpu_torch.planner import plan_1d

    cfg = pf.DeviceConfig()
    k14, k12 = set(), set()
    for _, lengths, batch, _ in chip_smoke.SPLIT_ROWS + chip_smoke.PLANE_MORE_ROWS:
        plan = plan_1d(lengths[-1], cfg, 4)
        _k14_nodes(plan, batch * math.prod(lengths[:-1]),
                   fastpath.plane_routes(plan, cfg), None, k14)
        for i, length in enumerate(lengths[:-1]):
            rest = math.prod(lengths[i + 1:])
            if cuda_axis.axis_m2_mode(plan_1d(length, cfg, 4), rest):
                k12.add((batch * math.prod(lengths[:i]), length, rest))
    assert (240, 184, 8 * 277, None) in k14
    assert (16384, 8192, 1, 50431897) in k14
    assert (12, 128, 640 * 128) in k12
    assert k14 <= set(chip_smoke.GLOBAL_PLANES_CASES)
    assert k12 <= set(chip_smoke.AXIS_CASES)


def _cut(m):
    """A K7 case cut for the CPU: n <= 256 and batch <= 4, the gap past a
    row's span (row-major) or the batch-innermost stride kept."""
    o, s, dist, n, batch = m
    n2, b2 = min(n, 256), min(batch, 4)
    if dist < s:
        return (o, b2 if s == batch else s, dist, n2, b2)
    return (o, s, dist - s * (n - n2), n2, b2)


@pytest.mark.parametrize("name,m,split", chip_smoke.STRIDE_CASES,
                         ids=[c[0] for c in chip_smoke.STRIDE_CASES])
def test_stride_checks_pass_and_reject_faults(name, m, split, monkeypatch):
    """K7's check passes the plain versions (exact) with both planted
    faults rejected, and fails a destride that reads one element late and
    a restride that drops its fill_gaps zeros."""
    from portfft_tpu_torch.ops import cuda_stride

    m = _cut(m)
    r = chip_smoke.check_stride(name, m, split, device="cpu")
    assert r["err"] == 0.0 and len(r["caught"]) == 6
    assert all(v > 0.0 for v in r["caught"].values())
    late = lambda x, o, *rest: cuda_stride.destride_plain(x, o + 1, *rest)  # noqa: E731
    late.plain, late.launches = cuda_stride.destride.plain, 0
    monkeypatch.setattr(cuda_stride, "destride", late)
    with pytest.raises(chip_smoke.SmokeFailure, match="destride"):
        chip_smoke.check_stride(name, m, split, device="cpu")
    monkeypatch.undo()
    unfilled = lambda y, *a: cuda_stride.restride_plain(y, *a[:-1], False)  # noqa: E731
    unfilled.plain, unfilled.launches = cuda_stride.restride.plain, 0
    monkeypatch.setattr(cuda_stride, "restride", unfilled)
    with pytest.raises(chip_smoke.SmokeFailure, match="restride fill_gaps=True"):
        chip_smoke.check_stride(name, m, split, device="cpu")


def test_layout_rows_route_through_k7():
    """Each layout row commits to the route its name promises, and the K7
    phase checks K7 at every layout those rows give it."""
    from portfft_tpu_torch.utils.layout import Rows, rows_1d

    want = {
        "strided_large": ["destride", "global2"],
        "strided_out_large": ["global2", "restride"],
        "bi_in_4096": ["destride", "fused2"],
        "bi_65536": ["destride", "global2", "restride"],
        "offset_out_large_1d": ["global2"],
        "split_strided_4096": ["destride", "chain", "restride"],
    }
    cases = {(m, split) for _, m, split in chip_smoke.STRIDE_CASES}
    for name, n, batch, split, fields, _ in chip_smoke.LAYOUT_ROWS:
        desc = pf.Descriptor(lengths=[n], number_of_transforms=batch,
                             complex_storage=(pf.ComplexStorage.SPLIT_COMPLEX if split
                                              else pf.ComplexStorage.INTERLEAVED_COMPLEX),
                             **fields)
        entry = desc.commit(device="cpu")._raw_fast[pf.Direction.FORWARD]
        assert chip_smoke.layout_kinds(entry) == want[name]
        for side in entry[2:]:
            if isinstance(side, Rows):
                assert (tuple(vars(side).values()), split) in cases, (name, side)
        for direction in pf.Direction:
            rows = rows_1d(desc, direction)
            assert rows.contiguous or (tuple(vars(rows).values()), split) in cases


def test_tuned_layout_rows_take_the_shipped_engine():
    """Each tuned layout row is a layout row whose GLOBAL plan the shipped
    ``cuda_h100`` table names an engine for, and with that engine its route
    is K7 around K16 (the table's 65536 winner)."""
    from portfft_tpu_torch import fastpath, tuning

    with open(tuning._DEFAULTS_PATH) as f:
        table = json.load(f)["cuda_h100"]["global2"]
    want = {
        "strided_large": ["destride", "global3"],
        "strided_out_large": ["global3", "restride"],
        "bi_65536": ["destride", "global3", "restride"],
        "offset_out_large_1d": ["global3"],
    }
    assert set(chip_smoke.TUNED_LAYOUT) == set(want)
    for name, n, batch, split, fields, _ in chip_smoke.LAYOUT_ROWS:
        if name not in want:
            continue
        plan = pf.Descriptor(lengths=[n], number_of_transforms=batch,
                             **fields).commit(device="cpu")
        params = table[tuning._entry_key(plan, "global2")]
        entry = fastpath.with_engine(plan, plan._raw_fast[pf.Direction.FORWARD],
                                     params)
        assert chip_smoke.layout_kinds(entry) == want[name]


def test_bounds_of_k7_and_the_layout_rows():
    """K7 at strided_large reads 512 rows of a stride-2 span (16 bytes a
    used element, in sectors) and writes 256 MiB: 805 MB, 0.240 ms at
    3.35 TB/s; a BATCH_INTERLEAVED side costs 8 bytes an element, a
    stride-3 side 24, one past 4 elements a whole sector."""
    from portfft_tpu_torch.utils.layout import Rows

    m = dict((name, m) for name, m, _ in chip_smoke.STRIDE_CASES)["strided_large"]
    bound, by = chip_smoke.stride_bound(m, False)
    assert by == "bytes" and bound == pytest.approx(
        (16 + 8) * 65536 * 512 / 3.35e9) == pytest.approx(0.2404, abs=1e-4)
    assert chip_smoke.side_bytes(Rows(0, 512, 1, 64, 512), 8) == 8 * 64 * 512
    assert chip_smoke.side_bytes(Rows(5, 3, 400, 64, 4), 8) == 24 * 64 * 4
    assert chip_smoke.side_bytes(Rows(0, 5, 400, 64, 4), 8) == 32 * 64 * 4
    assert chip_smoke.side_bytes(Rows(0, 2, 400, 64, 4), 4, 2) == 2 * 8 * 64 * 4


def test_tuned_cases_hold_the_tuned_rows():
    """The tuned-GLOBAL kernel phase checks K4, K5, K5-ov, K17 (both twiddle
    modes), K18 and K19 at every (G1, G2) the tuned rows give them: K4 at
    256 x 256 and 512 x 256, K5, K5-ov and K19 at the five splits of
    large_1d and the ladder, K17 and K18 at those and the mixed 384 x 384
    and 512 x 384, at the rows' batches; each alone timing is one of those
    cases."""
    from portfft_tpu_torch.planner import plan_1d

    cfg = pf.DeviceConfig()
    cases = chip_smoke.tuned_cases(pf)
    splits = {}
    for kind, n, batch in cases:
        assert (n, batch) in {(m, b) for _, m, b in chip_smoke.TUNED_ROWS}
        g1, g2 = (s.n for s in plan_1d(n, cfg, 4).sub)
        splits.setdefault(kind, set()).add((g1, g2))
    assert splits["global_sq"] == {(256, 256), (512, 256)}
    bf = {(256, 256), (512, 256), (512, 512), (2048, 256), (2048, 512)}
    assert splits["global_bf"] == splits["global_bf_ov"] == splits["global_bf2"] == bf
    every = bf | {(384, 384), (512, 384)}
    assert splits["global_fused"] == splits["global_fused_ftw"] == every
    assert splits["global_ilv"] == every
    for kind, shape in chip_smoke.TUNED_ALONE.items():
        assert (kind, *shape) in cases


TUNED_CPU = sorted({(kind, n) for kind, n, _ in chip_smoke.tuned_cases(pf)})


def _tuned_case(kind, n, direction):
    plan = pf.Descriptor(lengths=[n], number_of_transforms=1, forward_scale=0.5,
                         backward_scale=2.0 / n).commit(device="cpu")
    kernel, args = chip_smoke.tuned_kernel(plan, kind, direction)
    x = chip_smoke.random_raw(2 * n, seed=n, device="cpu")
    return kernel, args, x


@pytest.mark.parametrize("kind,n", TUNED_CPU)
def test_tuned_checks_pass_and_reject_faults(kind, n):
    """At one transform: the check passes the plain version with both
    planted faults rejected by both checks, and fails a kernel run on the
    planted table or returning zeros."""
    for direction, sign in DIRECTIONS:
        kernel, args, x = _tuned_case(kind, n, direction)
        r = chip_smoke.check_kernel(kind, kernel, args, x, n, sign)
        assert r["rel"] == 0.0 and r["excess"] <= 1.0
        for rel, excess in r["caught"].values():
            assert rel > 100 * chip_smoke.KERNEL_TOL and excess > 100.0
    kernel, args, x = _tuned_case(kind, n, pf.Direction.FORWARD)
    for fault in ("conjugated table", "zeros"):
        def faulty(raw, *a, fault=fault):
            if fault == "zeros":
                return torch.zeros_like(raw)
            return kernel.plain(raw, *chip_smoke.planted(kind, a))

        faulty.plain = kernel.plain
        with pytest.raises(chip_smoke.SmokeFailure, match=r"max\|kernel - plain\|"):
            chip_smoke.check_kernel(kind, faulty, args, x, n, -1)


def test_bounds_of_the_tuned_kernels():
    """The tuned engines timed alone (K4, K5, K5-ov, K17 in both twiddle
    modes, K18, K19) move 2^31 bytes: 0.641 ms at 3.35 TB/s."""
    for kind, (n, batch) in chip_smoke.TUNED_ALONE.items():
        bound, by = chip_smoke.bound_of(chip_smoke.KERNEL_OF.get(kind, kind), n, batch)
        assert by == "bytes" and bound == pytest.approx(2**31 / 3.35e9)
        assert bound == pytest.approx(0.641, abs=1e-3)


def test_fused_cases_hold_the_tuned_fused_rows():
    """The FUSED kernel phase checks every engine a tuned FUSED row's entry
    can reach, at that row's shape: K2-v2 and K2-v3 at a = 8, 32, 64, 128
    (none takes a = 256), K2-v1 at the no-fold a = 24 and 96; beside them
    K2-v1 at a = 5 and at a = 32, which has a fold; each alone timing is one
    of the cases."""
    from portfft_tpu_torch.planner import plan_1d

    cfg = pf.DeviceConfig()
    cases = set(chip_smoke.FUSED_KERNEL_CASES)
    reached = {(kind, n, batch) for _, n, batch in chip_smoke.TUNED_FUSED_ROWS
               for kind in chip_smoke.fused_engines_reached(plan_1d(n, cfg, 4), batch)}
    assert reached <= cases
    assert {(k, n) for k, n, _ in reached} == {
        *((k, n) for k in ("fused2_v2", "fused2_v3") for n in (1024, 4096, 8192, 16384)),
        ("fused2_v1", 3072), ("fused2_v1", 12288)}
    assert cases - reached == {("fused2_v1", 640, 204800), ("fused2_v1", 4096, 32768)}
    for kind, shape in chip_smoke.FUSED_ALONE.items():
        assert (kind, *shape) in cases
    for _, n, batch in chip_smoke.TUNED_FUSED_ROWS:  # 0.75 to 1 GiB in
        assert 0.75 * 2**30 <= 8 * n * batch <= 2**30


FUSED_CPU = sorted({(kind, n) for kind, n, _ in chip_smoke.FUSED_KERNEL_CASES})


@pytest.mark.parametrize("kind,n", FUSED_CPU)
def test_fused_checks_pass_and_reject_faults(kind, n):
    """At two transforms: the check passes the plain version with both
    planted faults (the inner twiddle conjugated, zeros) rejected by both
    checks, and fails a kernel run on the planted table or returning
    zeros."""
    def case(direction):
        plan = pf.Descriptor(lengths=[n], number_of_transforms=2, forward_scale=0.5,
                             backward_scale=2.0 / n).commit(device="cpu")
        kernel, args = chip_smoke.fused_kernel(plan, kind, direction)
        assert kernel.__name__ == kind
        return kernel, args, chip_smoke.random_raw(4 * n, seed=n, device="cpu")

    for direction, sign in DIRECTIONS:
        kernel, args, x = case(direction)
        r = chip_smoke.check_kernel(kind, kernel, args, x, n, sign)
        assert r["rel"] == 0.0 and r["excess"] <= 1.0
        for rel, excess in r["caught"].values():
            assert rel > 100 * chip_smoke.KERNEL_TOL and excess > 100.0
    kernel, args, x = case(pf.Direction.FORWARD)
    for fault in ("conjugated table", "zeros"):
        def faulty(raw, *a, fault=fault):
            if fault == "zeros":
                return torch.zeros_like(raw)
            return kernel.plain(raw, *chip_smoke.planted(kind, a))

        faulty.plain = kernel.plain
        with pytest.raises(chip_smoke.SmokeFailure, match=r"max\|kernel - plain\|"):
            chip_smoke.check_kernel(kind, faulty, args, x, n, -1)


def test_fused_shipped_rows_take_the_engine_of_n4096():
    """real_large's half length and bi_in_4096 are n = 4096 FUSED entries:
    with tuning on they take the engine the shipped table names for n4096
    (K2 where it names none)."""
    from portfft_tpu_torch import fastpath, tuning

    with open(tuning._DEFAULTS_PATH) as f:
        params = json.load(f)["cuda_h100"].get("fused2", {}).get("n4096")
    plan = pf.Descriptor(lengths=[8192], number_of_transforms=2,
                         domain=pf.Domain.REAL).commit(device="cpu")
    want = "fused2" if params is None else fastpath._engine_of(params, plan.plans[4096])
    entry = plan._raw_fast[pf.Direction.FORWARD]
    inner = entry[1] if params is None else fastpath.with_engine(plan, entry, params)[1]
    assert inner[5] == want
    name, n, _, _, fields, _ = next(r for r in chip_smoke.LAYOUT_ROWS
                                    if r[0] == "bi_in_4096")
    assert set(chip_smoke.FUSED_SHIPPED) == {"real_large", name}
    lay = pf.Descriptor(lengths=[n], number_of_transforms=2, **{
        **fields, "forward_strides": [2]}).commit(device="cpu")
    entry = lay._raw_fast[pf.Direction.FORWARD]
    if params is not None:
        entry = fastpath.with_engine(lay, entry, params)
    assert chip_smoke.layout_kinds(entry) == ["destride", want]


def test_bounds_of_the_fused_kernels():
    """K2-v2 and K2-v3 timed alone at 4096 x 32Ki move 2^31 bytes (0.641 ms
    at 3.35 TB/s), K2-v1 at 3072 x 32768 three quarters of that; all three
    are bound by bytes at the nominal 5·n·log2(n) flops."""
    for kind, (n, batch) in chip_smoke.FUSED_ALONE.items():
        bound, by = chip_smoke.bound_of(kind, n, batch)
        assert by == "bytes"
        assert bound == pytest.approx(16 * n * batch / 3.35e9)
    assert chip_smoke.bound_of("fused2_v2", 4096, 32768)[0] == pytest.approx(0.641, abs=1e-3)


# The tensor-core kernel phase, cut on the CPU: K10-mm to bpre <= 2 and
# rest <= 8, K16 to one transform; L and n as on the card.
MMA_CPU = ([("col_mm", (min(b, 2), L, min(r, 8))) for b, L, r in chip_smoke.MMA_COL_CASES]
           + [("global3", (n, 1)) for n, _ in chip_smoke.MMA_GLOBAL_CASES])


def _mma_check(kind, case, direction, kernel=None):
    """Run the phase's check of one case, with ``kernel`` standing in for the
    wrapper where given."""
    sign = -1 if direction == pf.Direction.FORWARD else +1
    if kind == "col_mm":
        n = case[1]
        scale = 0.5 if sign < 0 else 2.0 / n
        wrapper, args = chip_smoke.md_kernel_case(pf, kind, case, sign, scale, "cpu")
        x = chip_smoke.random_raw(2 * math.prod(case), seed=sum(case), device="cpu")
        return chip_smoke.check_md(kind, kernel or wrapper, args, x, case, sign)
    n, batch = case
    plan = pf.Descriptor(lengths=[n], number_of_transforms=batch, forward_scale=0.5,
                         backward_scale=2.0 / n).commit(device="cpu")
    wrapper, args = chip_smoke.tuned_kernel(plan, kind, direction)
    assert wrapper.__name__ == kind
    x = chip_smoke.random_raw(2 * batch * n, seed=n, device="cpu")
    return chip_smoke.check_kernel(kind, kernel or wrapper, args, x, n, sign)


@pytest.mark.parametrize("kind,case", MMA_CPU)
def test_mma_checks_pass_and_reject_faults(kind, case):
    """The check passes the plain version with both planted faults (K10-mm:
    its roots or inner twiddle conjugated; K16: its twiddle factor B2
    conjugated; zeros) rejected by both checks, and fails a kernel run on
    the planted table or returning zeros."""
    from portfft_tpu_torch.ops import cuda_global, cuda_multidim

    for direction, _ in DIRECTIONS:
        r = _mma_check(kind, case, direction)
        assert r["rel"] == 0.0 and r["excess"] <= 1.0
        for rel, excess in r["caught"].values():
            assert rel > 100 * chip_smoke.KERNEL_TOL and excess > 100.0
    wrapper = getattr(cuda_multidim if kind == "col_mm" else cuda_global, kind)
    for fault in ("conjugated table", "zeros"):
        def faulty(raw, *a, fault=fault):
            if fault == "zeros":
                return torch.zeros_like(raw)
            return wrapper.plain(raw, *chip_smoke.planted(kind, a))

        faulty.plain = wrapper.plain
        with pytest.raises(chip_smoke.SmokeFailure, match=r"max\|kernel - plain\|"):
            _mma_check(kind, case, pf.Direction.FORWARD, faulty)


def test_bounds_of_the_mma_kernels():
    """The tensor-core kernels are bound as every C2C kernel is, by the
    function's work and not by their dense products: 16 bytes and
    5·log2(N) flops a point at the fp32 peak, bound by bytes (0.321 ms for
    K10-mm at (64, 1024, 1024), 0.641 for K16 at 65536 x 2048)."""
    for kind, want in (("col_mm", 0.321), ("global3", 0.641)):
        shape = chip_smoke.MMA_ALONE[kind]
        n, batch = (shape[1], shape[0] * shape[2]) if kind == "col_mm" else shape
        assert chip_smoke.work(kind, n, batch) == chip_smoke.work("global2", n, batch)
        bound, by = chip_smoke.bound_of(kind, n, batch)
        assert by == "bytes" and bound == pytest.approx(16 * n * batch / 3.35e9)
        assert bound == pytest.approx(want, abs=1e-3)


def test_mma_cases_hold_the_main_path_shapes():
    """The tensor-core kernel phase checks K10-mm at every column step a
    ``multidim`` or ``bi_col`` variant of an ``MD_ROWS`` row gives it
    (md_128^3's axis-1 step (4096, 128, 128) where K11 is off among them),
    and K16 at every tuned row its gate takes (``tuned_cases``)."""
    from portfft_tpu_torch import fastpath, tuning

    steps = set()
    for _, lengths, batch, dname, bi in chip_smoke.MD_ROWS:
        kw = dict(forward_strides=[batch], backward_strides=[batch],
                  forward_distance=1, backward_distance=1) if bi else {}
        plan = pf.Descriptor(lengths=list(lengths), number_of_transforms=batch,
                             **kw).commit(device="cpu")
        entry = plan._raw_fast[pf.Direction(dname)]
        for params in tuning._variants_for_entry(plan, entry):
            inner = fastpath.inner_entry(fastpath.with_engine(plan, entry, params))
            if inner[0] == "bi_col":
                if inner[6] == "col_mm":
                    steps.add((inner[1], inner[2].n, inner[3]))
            else:
                steps |= {(s[1], s[2].n, s[3]) for s in inner[2] if s[0] == "col_mm"}
    assert (4096, 128, 128) in steps and (1, 4096, 32768) in steps
    assert steps <= set(chip_smoke.MMA_COL_CASES)
    tuned = {(n, batch) for _, n, batch in chip_smoke.tuned_cases(pf, ("global3",))}
    assert len(tuned) == len(chip_smoke.TUNED_ROWS)
    assert tuned <= set(chip_smoke.MMA_GLOBAL_CASES)


def test_col_mm_declines_only_direct_lengths_off_128():
    """Among the lengths K10 takes, K10-mm's gate declines exactly the
    DIRECT ones that are no multiple of 128 (the phase prints them)."""
    assert chip_smoke.col_mm_declines(pf) == [n for n in range(2, 513) if n % 128]


def test_md_kinds_of_the_tuned_routes():
    """``md_kinds`` names every kernel of a multi-dim or ``bi_col`` entry:
    K10-mm where ``{"cm": 1}`` selects it."""
    from portfft_tpu_torch import fastpath

    plan = pf.Descriptor(lengths=[128, 128, 128]).commit(device="cpu")
    entry = plan._raw_fast[pf.Direction.FORWARD]
    assert chip_smoke.md_kinds(entry) == ["md2", "col"]
    assert chip_smoke.md_kinds(fastpath.with_engine(plan, entry, {"m2": 0, "cm": 1})) \
        == ["direct", "col_mm", "col_mm"]
    bi = pf.Descriptor(lengths=[4096], number_of_transforms=4, forward_strides=[4],
                       backward_strides=[4], forward_distance=1,
                       backward_distance=1).commit(device="cpu")
    entry = bi._raw_fast[pf.Direction.FORWARD]
    assert chip_smoke.md_kinds(entry) == ["col"]
    assert chip_smoke.md_kinds(fastpath.with_engine(bi, entry, {"cm": 1})) == ["col_mm"]
    assert chip_smoke.layout_kinds(fastpath.with_engine(bi, entry, {"cm": 1})) == ["col_mm"]
