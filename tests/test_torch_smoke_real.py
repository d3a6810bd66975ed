"""The checks of ``chip_smoke.py`` for the REAL kernel phase (K8a, K8b, K9),
run on the CPU at every shape of its phase: they pass a correct result, and
they reject a faulty kernel and the faults the smoke run plants itself.

On the CPU a wrapper runs its plain version, so the correct "kernel" here
is the plain path.  A faulty kernel is a wrapper that runs the plain
version on a conjugated table (``chip_smoke.planted``) or returns zeros.
The batch is cut to 1 or 2 rows.
"""

import pytest
import torch

import chip_smoke
import portfft_tpu_torch as pf

DIRECTIONS = [(pf.Direction.FORWARD, -1), (pf.Direction.BACKWARD, +1)]


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
