"""The checks of ``chip_smoke.py`` for the plane kernel phase (K6, K13, K15)
and the plane rows, run on the CPU at every shape of its phase: they pass a
correct result, and they reject a faulty kernel and the faults the smoke run
plants itself.

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

DIRECTIONS = [(pf.Direction.FORWARD, -1), (pf.Direction.BACKWARD, +1)]


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
        with pytest.raises(chip_smoke.SmokeFailure, match=r"max\|kernel - plain\|"):
            chip_smoke.check_plane(kind, faulty, args, x, n, 2, sign)
        y = chip_smoke.on_raw(faulty, n)(x, *args)
        assert chip_smoke.oracle_excess(y, x, n, 2, sign, 1.0) > 100.0


# K13's column form, cut on the CPU to one batch: (1, n, trailing).
COLS_CASES = [(1, n, trailing) for _, n, trailing in chip_smoke.CHAIN_COLS_CASES]


@pytest.mark.parametrize("shape", COLS_CASES)
def test_column_checks_pass_a_correct_result(shape):
    x = chip_smoke.random_raw(2 * math.prod(shape), seed=sum(shape), device="cpu")
    for _, sign in DIRECTIONS:
        r = chip_smoke.check_chain_cols(pf, shape, x, sign)
        assert r["rel"] == 0.0 and r["excess"] <= 1.0
        for rel, excess in r["caught"].values():
            assert rel > 100 * chip_smoke.KERNEL_TOL and excess > 100.0


@pytest.mark.parametrize("fault", ["conjugated table", "zeros", "rows",
                                   "unscaled"])
@pytest.mark.parametrize("shape", COLS_CASES)
def test_column_checks_reject_a_faulty_kernel(shape, fault, monkeypatch):
    """The column check rejects the planted faults, a kernel that runs the
    transform along the contiguous axis instead (the row geometry), and
    one that drops the scale."""
    from portfft_tpu_torch.ops import cuda_chain

    plain = cuda_chain.chain_cols.plain

    def faulty(xr, xi, bpre, trailing, tabs, scale):
        if fault == "zeros":
            return torch.zeros_like(xr), torch.zeros_like(xi)
        if fault == "rows":
            yr, yi = cuda_chain.chain_plain(xr.view(-1, tabs.n), xi.view(-1, tabs.n), tabs)
            return (yr * scale).reshape(xr.shape), (yi * scale).reshape(xi.shape)
        args = (bpre, trailing, tabs, 1.0 if fault == "unscaled" else scale)
        if fault == "conjugated table":
            args = chip_smoke.planted("chain_cols", args)
        return plain(xr, xi, *args)

    faulty.plain = plain
    monkeypatch.setattr(cuda_chain, "chain_cols", faulty)
    x = chip_smoke.random_raw(2 * math.prod(shape), seed=sum(shape), device="cpu")
    for _, sign in DIRECTIONS:
        with pytest.raises(chip_smoke.SmokeFailure, match=r"max\|kernel - plain\|"):
            chip_smoke.check_chain_cols(pf, shape, x, sign)


def test_column_form_timed_alone_runs_its_yardsticks(monkeypatch):
    """The column form's timing alone runs the kernel, its plain version,
    the row form on the moved planes, the move's copies and ``torch.fft``
    over the axis (timer stubbed), at fastMRI's 640 axis over 368 columns,
    cut to one batch."""
    calls = []
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn: (calls.append(fn()), 0.0)[1])
    shape = (1, *chip_smoke.CHAIN_COLS_ALONE[1:])
    x = chip_smoke.random_raw(2 * math.prod(shape), seed=5, device="cpu")
    assert chip_smoke.time_chain_cols(pf, shape, x, "cpu") == (0.0, 0.0, 0.0)
    (yr, yi), (pr, pi), _, _, yc = calls
    assert torch.equal(yr, pr) and torch.equal(yi, pi)
    assert torch.allclose(torch.complex(yr, yi).view(shape),
                          yc * chip_smoke.CHAIN_COLS_SCALE, atol=1e-3)


@pytest.mark.parametrize("n,trailing", chip_smoke.CHAIN_COLS_GATE)
def test_column_gate_times_the_same_transform_both_ways(n, trailing, monkeypatch):
    """The gate's measurement times the column form and the walk's move,
    row form and move back on the same planes (timer stubbed, a few
    thousand points): both give the same transform, in the same layout."""
    calls = []
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn: (calls.append(fn()), 1.0)[1])
    assert chip_smoke.time_cols_gate(pf, n, trailing, "cpu", points=2 * n * trailing,
                                     device="cpu") == (1.0, 1.0)
    (cr, ci), (wr, wi) = calls
    assert torch.equal(cr, wr.reshape(-1)) and torch.equal(ci, wi.reshape(-1))


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
    swapped.plain = cuda_io.deinterleave.plain
    monkeypatch.setattr(cuda_io, "deinterleave", swapped)
    with pytest.raises(chip_smoke.SmokeFailure, match="deinterleave"):
        chip_smoke.check_io(m, x, 0.5)
    monkeypatch.undo()
    unscaled = lambda re, im, scale: cuda_io.interleave_plain(re, im, 1.0)  # noqa: E731
    unscaled.plain = cuda_io.interleave.plain
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
    from portfft_tpu_torch import fastpath

    plan = pf.Descriptor(lengths=[n], number_of_transforms=batch).commit(device="cpu")
    x = chip_smoke.random_raw(2 * batch * n, 7, device="cpu")
    for direction, sign in DIRECTIONS:
        entry = plan._raw_fast[direction]
        assert isinstance(entry, fastpath.Plane)
        want = chip_smoke.plain_path(plan, entry)(x)
        got = torch.view_as_real(chip_smoke.library_call(x, n, batch, False, sign < 0)())
        assert torch.allclose(got.reshape(-1), want, atol=1e-3 * want.abs().max().item())
