"""The checks of ``chip_smoke.py`` for the REAL plane path, K8a-w, K8b's
flag, K15-bf and K3-ftw, run on the CPU at the shapes of its phases (the
batch cut): they pass a correct result, and they reject a faulty kernel
and the faults the smoke run plants itself.

On the CPU a wrapper runs its plain version, so the correct "kernel" here
is the plain path.  A faulty kernel is a wrapper that runs the plain
version on a conjugated table (``chip_smoke.planted``) or returns zeros.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke
import portfft_tpu_torch as pf
from portfft_tpu_torch import fastpath
from portfft_tpu_torch.ops import cuda_real
from portfft_tpu_torch.planner import plan_1d

CFG = pf.DeviceConfig()


def _faulty(kernel, kind, fault):
    def faulty(x, *a):
        if fault == "zeros":
            return torch.zeros_like(kernel.plain(x, *a))
        return kernel.plain(x, *chip_smoke.planted(kind, a))

    faulty.plain = kernel.plain
    return faulty


def _real_plane_case(n, batch):
    """K8a-w (forward) or K8b (backward, spectra whose Im X[0] and
    Im X[n/2] are not 0) as the REAL plane kernel phase runs it, the batch
    cut: ``(kind, kernel, args, input, finish, source, sign, scale)``."""
    wide = (n, batch) in chip_smoke.WIDE_CASES
    batch = 1 if n > 1 << 20 else min(batch, 3)
    plan = pf.Descriptor(lengths=[n], number_of_transforms=batch,
                         domain=pf.Domain.REAL, forward_scale=0.5,
                         backward_scale=2.0 / n).commit(device="cpu")
    x = chip_smoke.random_raw(batch * n, seed=n, device="cpu")
    spec = chip_smoke.random_raw(batch * (n + 2), seed=n + 1, device="cpu")
    direction = pf.Direction.FORWARD if wide else pf.Direction.BACKWARD
    kind, kernel, args, inp, finish = chip_smoke.real_case(plan, direction, x, spec)
    if wide:
        kind, kernel = "untangle_wide", cuda_real.untangle_wide
    sign, scale = (-1, 0.5) if wide else (+1, 2.0 / n)
    return kind, kernel, args, inp, finish, x if wide else spec, sign, scale


# 4222976 x 64 is the main path's K8a-w shape: on the CPU, one row of it
REAL_PLANE_CASES = chip_smoke.WIDE_CASES + chip_smoke.DROP_CASES


@pytest.mark.parametrize("n,batch", REAL_PLANE_CASES)
def test_real_plane_kernel_checks_pass_and_reject_faults(n, batch):
    kind, kernel, args, inp, finish, src, sign, scale = _real_plane_case(n, batch)
    assert kind in ("untangle_wide", "retangle")
    if kind == "retangle":
        assert args[-1] == (n < 1024)  # K8b's flag
    r = chip_smoke.check_real(kind, kernel, args, inp, finish, src, n, sign, scale)
    assert r["rel"] == 0.0 and r["excess"] <= 1.0
    for rel, excess in r["caught"].values():
        assert rel > 100 * chip_smoke.KERNEL_TOL and excess > 100.0
    for fault in ("conjugated table", "zeros"):
        with pytest.raises(chip_smoke.SmokeFailure, match=r"max\|kernel - plain\|"):
            chip_smoke.check_real(kind, _faulty(kernel, kind, fault), args, inp,
                                  finish, src, n, sign, scale)


@pytest.mark.parametrize("n", sorted({n for n, _ in chip_smoke.BLUESTEIN_BF_CASES}))
def test_bluestein_bf_checks_pass_and_reject_faults(n):
    """K15-bf at one transform of each convolution of the phase, both
    directions; its planted fault is the pass-1 chirp conjugated."""
    x = chip_smoke.random_raw(2 * n, seed=n, device="cpu")
    for sign in (-1, +1):
        kernel, args = chip_smoke.plane_case(pf, "bluestein_bf", n, sign, device="cpu")
        assert args[0].bf and args[0].f1.a and args[0].f2.a
        r = chip_smoke.check_plane("bluestein_bf", kernel, args, x, n, 1, sign)
        assert r["rel"] == 0.0 and r["excess"] <= 1.0
        for rel, excess in r["caught"].values():
            assert rel > 100 * chip_smoke.KERNEL_TOL and excess > 100.0


def _entries(n, batch, monkeypatch, bf):
    """The entries a commit of the REAL row fixes, from ``fastpath.register``
    on the plans alone (no tables are built)."""
    if bf:
        monkeypatch.setenv("PORTFFT_BLUESTEIN_BF", "1")
    d = pf.Descriptor(lengths=[n], number_of_transforms=batch, domain=pf.Domain.REAL)
    stub = SimpleNamespace(descriptor=d, precision=np.dtype(np.float32),
                           plans={m: plan_1d(m, CFG, 4) for m in {n, n // 2}},
                           config=CFG)
    out = fastpath.register(stub)
    monkeypatch.delenv("PORTFFT_BLUESTEIN_BF", raising=False)
    return out


def test_real_plane_rows_launch_every_kernel_of_the_path(monkeypatch):
    """The REAL plane rows are each about 1 GiB in and route through the REAL
    plane path, and together they launch every kernel the phase requires:
    K8a, K8a-w, K8b, K6, K13, K14, K15 and K15-bf."""
    kinds = set()
    for name, n, batch, dnames, bf in chip_smoke.REAL_PLANE_ROWS:
        assert 1.0e9 <= 4 * n * batch <= 1.3e9, name
        entries = _entries(n, batch, monkeypatch, bf)
        for dname in dnames:
            entry = entries[pf.Direction(dname)]
            assert entry[0] == "realplane", name
            kinds |= {entry[6], *chip_smoke.path_kinds(entry[1])}
    assert kinds == {"untangle", "untangle_wide", "retangle", "deinterleave",
                     "interleave", "chain", "global2_planes", "bluestein",
                     "bluestein_bf"}
    # the shapes the kernel phase times alone are the main path's
    wide = next(r for r in chip_smoke.REAL_PLANE_ROWS if r[0] == "real_plane_4222976")
    assert chip_smoke.REAL_PLANE_ALONE["untangle_wide"] == wide[1:3]
    assert chip_smoke.REAL_PLANE_ALONE["untangle_wide"] in chip_smoke.WIDE_CASES
    assert chip_smoke.REAL_PLANE_ALONE["bluestein_bf"] == (65537, 2048)


def test_real_plane_bounds_and_kernel_table_entries():
    """The REAL plane rows' bound is the REAL function's bytes (each input
    byte read once, each output byte written once); K8a-w moves K8a's
    bytes; K15-bf and K3-ftw every C2C kernel's (16 bytes a point)."""
    for name, n, batch, _, _ in chip_smoke.REAL_PLANE_ROWS:
        bound, by = chip_smoke.bound_of("small_real", n, batch)
        assert by == "bytes"
        assert bound == pytest.approx((4 * n + 8 * (n // 2 + 1)) * batch / 3.35e9)
    n, batch = chip_smoke.REAL_PLANE_ALONE["untangle_wide"]
    assert chip_smoke.bound_of("untangle_wide", n, batch) == chip_smoke.bound_of(
        "untangle", n, batch)
    for kind in ("bluestein_bf", "global2_ftw"):
        assert chip_smoke.work(kind, 65536, 2) == chip_smoke.work("global2", 65536, 2)
    assert set(chip_smoke.REAL_PLANE_KINDS) | {"global2_ftw"} <= set(chip_smoke.SOURCES)


def test_tuned_cases_hold_k3ftw():
    """The tuned GLOBAL phases check and race K3-ftw at every tuned row whose
    factored tables exist: all seven, DIRECT G1 (the Q tables) and FUSED
    [16, 128] G1 (ZQ)."""
    cases = [c for c in chip_smoke.tuned_cases(pf) if c[0] == "global2_ftw"]
    assert [(n, b) for _, n, b in cases] == [(n, b) for _, n, b in chip_smoke.TUNED_ROWS]
    assert ("global2_ftw", *chip_smoke.TUNED_ALONE["global2_ftw"]) in cases
    assert "global2_ftw" in chip_smoke.TUNED_KINDS


@pytest.mark.parametrize("n,batch", [(1200, 2), (2062, 1)])
def test_library_call_computes_the_real_plane_function(n, batch):
    """The yardstick ``rfft``/``irfft`` timed beside each REAL plane row
    computes the row's plain path forward, and backward on spectra whose
    Im X[0] and Im X[n/2] are 0 (where the kept bins add nothing)."""
    plan = pf.Descriptor(lengths=[n], number_of_transforms=batch,
                         domain=pf.Domain.REAL).commit(device="cpu")
    for direction, forward in ((pf.Direction.FORWARD, True),
                               (pf.Direction.BACKWARD, False)):
        assert plan._raw_fast[direction][0] == "realplane"
        x = (chip_smoke.random_raw(batch * n, 7, device="cpu") if forward
             else chip_smoke.half_spectra(batch, n, 7, device="cpu"))
        want = chip_smoke.plain_path(plan, plan._raw_fast[direction])(x)
        got = chip_smoke.library_call(x, n, batch, True, forward)()
        got = torch.view_as_real(got).reshape(-1) if got.is_complex() else got.reshape(-1)
        assert torch.allclose(got, want, atol=1e-3 * want.abs().max().item())
