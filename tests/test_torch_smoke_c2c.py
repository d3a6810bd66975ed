"""The checks of ``chip_smoke.py`` for the C2C kernel phase (K1, K2, K3) and
the bench rows' bounds and yardsticks, run on the CPU at every shape of its
phase: they pass a correct result, and they reject a faulty kernel and the
faults the smoke run plants itself.

On the CPU a wrapper runs its plain version, so the correct "kernel" here
is the plain path.  A faulty kernel is a wrapper that runs the plain
version on a conjugated table (``chip_smoke.planted``) or returns zeros.
The batch is cut to 1 or 2 rows.
"""

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
