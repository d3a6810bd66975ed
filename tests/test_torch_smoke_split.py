"""The checks of ``chip_smoke.py`` for the K14/K12 kernel phase and the
SPLIT and plane rows, run on the CPU at every shape of its phase: they pass
a correct result, and they reject a faulty kernel and the faults the smoke
run plants itself.

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
