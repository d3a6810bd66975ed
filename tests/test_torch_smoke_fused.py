"""The checks of ``chip_smoke.py`` for the FUSED engines (K2-v1, K2-v2,
K2-v3), run on the CPU at every shape of its phase: they pass a correct
result, and they reject a faulty kernel and the faults the smoke run plants
itself.

On the CPU a wrapper runs its plain version, so the correct "kernel" here
is the plain path.  A faulty kernel is a wrapper that runs the plain
version on a conjugated table (``chip_smoke.planted``) or returns zeros.
The batch is cut to 1 or 2 rows.
"""

import json

import pytest
import torch

import chip_smoke
import portfft_tpu_torch as pf

DIRECTIONS = [(pf.Direction.FORWARD, -1), (pf.Direction.BACKWARD, +1)]


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
