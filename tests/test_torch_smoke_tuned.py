"""The checks of ``chip_smoke.py`` for the tuned GLOBAL kernels (K4, K5,
K5-ov, K17, K18, K19), run on the CPU at every shape of its phase: they pass
a correct result, and they reject a faulty kernel and the faults the smoke
run plants itself.

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
