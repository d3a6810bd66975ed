"""The checks of ``chip_smoke.py``, run on the CPU at every shape of its
kernel phase: they pass a correct result, and they reject a faulty kernel
and the faults the smoke run plants itself.

On the CPU a wrapper runs its plain version, so the correct "kernel" here
is the plain path.  A faulty kernel is a wrapper that runs the plain
version on a conjugated table (``chip_smoke.planted``) or returns zeros.
The batch is cut to 1 or 2 rows.
"""

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
