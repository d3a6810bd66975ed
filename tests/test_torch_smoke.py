"""The checks of ``chip_smoke.py``, run on the CPU at every shape of its
kernel phase: they pass a correct result, and they reject a faulty kernel
and the faults the smoke run plants itself.

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
