"""The REAL plane path of portfft_tpu_torch (1D REAL lengths whose half
length h needs the plane path: ``("realplane", ...)`` entries) and the C2R
treatment of Im X[0] and Im X[n/2], against portfft_tpu
(``commit(use_pallas=True)``, Pallas kernels in interpret mode) and
``np.fft``, on the CPU.

The reference runs these lengths through ``_core_real_forward``/
``_core_real_backward``: the half-length ``exec_plan``, then the untangle or
retangle.  Its C2R drops Im X[0] and Im X[n/2] below n = 1024 (a C2C of the
Hermitian extension, real part kept) and uses them from n = 1024 on (its
retangle).  The port does the same: K8b's ``drop`` flag, set at commit.

Tolerances: every element of both packages within 2·eps·N·log2N·|scale|
(absolute, or relative to the element; ``oracle.tolerance``) of the
float64 result — ``np.fft.rfft`` forward, ``chip_smoke.c2r_reference``
(``irfft`` plus, from n = 1024 on, the two bins' known contribution)
backward — and the port within the same bound of the reference.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke
import oracle
import portfft_tpu as ref
import portfft_tpu_torch as pt
from portfft_tpu.ops import pallas_bluestein
from portfft_tpu_torch import fastpath
from portfft_tpu_torch.config import DeviceConfig
from portfft_tpu_torch.ops import cuda_real
from portfft_tpu_torch.planner import plan_1d

CFG = DeviceConfig()


def _descs(n, batch, fs, bs):
    kw = dict(lengths=[n], number_of_transforms=batch, forward_scale=fs,
              backward_scale=bs)
    return (ref.Descriptor(domain=ref.Domain.REAL, **kw),
            pt.Descriptor(domain=pt.Domain.REAL, **kw))


def _spectra(batch, n, seed):
    """complex64 half spectra with nonzero Im X[0] and Im X[n/2]."""
    rng = np.random.default_rng(seed)
    spec = rng.uniform(-1, 1, (batch, n // 2 + 1, 2)).astype(np.float32)
    assert np.all(spec[:, [0, -1], 1] != 0)
    return spec.view(np.complex64)[..., 0]


def _c2r(spec, n):
    """The float64 C2R that keeps the two bins from n = 1024 on."""
    return chip_smoke.c2r_reference(torch.from_numpy(spec.astype(np.complex128)),
                                    n).numpy()


def _close(got, want, tol):
    """Every element within ``tol``, absolute or relative to ``want``."""
    got = np.asarray(got).reshape(want.shape)
    diff = np.abs(got.astype(want.dtype) - want)
    assert np.all((diff <= tol) | (diff <= tol * np.abs(want))), diff.max()


def _run_both(n, batch, fs, bs, seed):
    """Forward reals and backward spectra through both packages: ``[(port,
    reference, float64 oracle, tolerance), ...]`` per direction."""
    rdesc, pdesc = _descs(n, batch, fs, bs)
    rplan, plan = rdesc.commit(use_pallas=True), pdesc.commit(device="cpu")
    x = np.random.default_rng(seed).uniform(-1, 1, (batch, n)).astype(np.float32)
    spec = _spectra(batch, n, seed + 1)
    tol = oracle.tolerance(rdesc)
    return plan, [
        (plan.compute_forward(x.reshape(-1)).reshape(batch, -1),
         np.asarray(rplan.compute_forward(x.reshape(-1))).reshape(batch, -1),
         fs * np.fft.rfft(x.astype(np.float64), axis=1), tol * abs(fs)),
        (plan.compute_backward(spec.reshape(-1)).reshape(batch, n),
         np.asarray(rplan.compute_backward(spec.reshape(-1))).reshape(batch, n),
         bs * _c2r(spec, n), tol * abs(bs)),
    ]


# (n, batch, the plane route of h): h = 600 FUSED [120, 5] on K13's chain
# mode; h = 1031 a generic Bluestein over K13 [24, 128]; h = 2062 GLOBAL
# 2 x Bluestein 1031.
PLANE_CASES = [
    (1200, 3, {600: "chain"}),
    (2062, 2, {1031: "generic", 3072: "two_stage"}),
    (4124, 2, {2062: "generic", 2: "direct", 1031: "generic", 3072: "two_stage"}),
]


@pytest.mark.parametrize("n,batch,routes", PLANE_CASES)
@pytest.mark.parametrize("fs,bs", [(0.5, "2/n"), (1.0, 1.0)])
def test_real_plane_matches_reference(n, batch, routes, fs, bs):
    """The REAL plane path both ways against the reference and the oracle;
    backward spectra carry nonzero Im X[0] and Im X[n/2], which both
    packages keep at these lengths."""
    bs = 2.0 / n if bs == "2/n" else bs
    plan, runs = _run_both(n, batch, fs, bs, n)
    for direction in pt.Direction:
        entry = plan._raw_fast[direction]
        assert entry[0] == "realplane" and entry[1][0] == "plane"
        assert entry[1][1] is plan.plans[n // 2] and entry[1][5] == routes
        assert entry[6] == ("untangle" if direction == pt.Direction.FORWARD
                            else "retangle")
        assert entry[7] is False
    for got, want, exact, tol in runs:
        _close(got, exact, tol)
        _close(want, exact, tol)
        _close(got, want.astype(np.complex128 if want.dtype.kind == "c"
                                else np.float64), tol)


@pytest.mark.parametrize("n", [768, 1000, 1024, 1200, 4096])
@pytest.mark.parametrize("scale", [1.0, "2/n"])
def test_c2r_bins_match_reference(n, scale):
    """C2R of spectra with nonzero Im X[0] and Im X[n/2]: below n = 1024 both
    packages drop the two parts (K8b's flag), from 1024 on both use them."""
    scale = 2.0 / n if scale == "2/n" else scale
    rdesc, pdesc = _descs(n, 2, 1.0, scale)
    rplan, plan = rdesc.commit(use_pallas=True), pdesc.commit(device="cpu")
    entry = plan._raw_fast[pt.Direction.BACKWARD]
    assert entry[-1] == (n < 1024)
    spec = _spectra(2, n, n)
    got = plan.compute_backward(spec.reshape(-1)).reshape(2, n)
    want = np.asarray(rplan.compute_backward(spec.reshape(-1))).reshape(2, n)
    tol = oracle.tolerance(rdesc) * scale
    _close(got, want.astype(np.float64), tol)
    exact = scale * _c2r(spec, n)
    _close(got, exact, tol)
    _close(want, exact, tol)
    if n < 1024:  # the dropped parts: irfft semantics
        _close(got, scale * np.fft.irfft(spec.astype(np.complex128), n) * n, tol)


def _register(n, batch):
    """The REAL entries a commit of (n, batch) fixes, from ``fastpath.register``
    on the plans alone (no tables are built)."""
    d = pt.Descriptor(lengths=[n], number_of_transforms=batch,
                      domain=pt.Domain.REAL)
    plans = {m: plan_1d(m, CFG, 4) for m in {n, n // 2}}
    stub = SimpleNamespace(descriptor=d, precision=np.dtype(np.float32),
                           plans=plans, config=CFG)
    return fastpath.register(stub), plans[n // 2]


# The REAL lengths the port raised for before its REAL plane path (n, batch,
# the untangle, the kinds h's route holds): 2·65537 (h a Bluestein prime on
# K15), 1200 (h = 600 FUSED [120, 5]), 4·65537 (GLOBAL 2 x 65537), 2^28
# (h = 2^27 on K14), 263936 (GLOBAL [128] x Bluestein 1031), and 4222976
# (GLOBAL [16, 128] x Bluestein 1031) at batch 64, where K8a-w's gate takes
# h, and at batch 4, where it does not.
ROUTE_CASES = [
    (2 * 65537, 2, "untangle", {"bluestein"}),
    (1200, 2, "untangle", {"chain"}),
    (4 * 65537, 2, "untangle", {"generic", "direct", "bluestein"}),
    (1 << 28, 1, "untangle", {"global2"}),
    (263936, 8, "untangle", {"generic", "two_stage", "direct"}),
    (4222976, 64, "untangle_wide", {"generic", "two_stage"}),
    (4222976, 4, "untangle", {"generic", "two_stage"}),
]


@pytest.mark.parametrize("n,batch,untangle,kinds", ROUTE_CASES)
def test_real_plane_routes_at_commit(n, batch, untangle, kinds):
    """Each REAL plane entry names its un/retangle kernel and the plane route
    of h (K13 chain, K14, K15, generic glue); K8a-w where its gate takes
    (h, batch); K8b keeps the two bins (n >= 1024)."""
    entries, plan_h = _register(n, batch)
    fwd, bwd = entries[pt.Direction.FORWARD], entries[pt.Direction.BACKWARD]
    assert fwd[:6] == ("realplane", fwd[1], n // 2, batch, -1, 1.0)
    assert bwd[:6] == ("realplane", bwd[1], n // 2, batch, +1, 1.0)
    assert (fwd[6], bwd[6], fwd[7], bwd[7]) == (untangle, "retangle", False, False)
    for entry, sign in ((fwd, -1), (bwd, +1)):
        assert entry[1] == ("plane", plan_h, batch, sign, 1.0,
                            fastpath.plane_routes(plan_h, CFG))
    assert set(fwd[1][5].values()) == kinds
    assert cuda_real.wide_supported(n, batch) == (untangle == "untangle_wide")


def test_wide_gate_is_the_reference_shape_rule():
    """``wide_supported`` is ``pallas_real.wide_bt_ct`` without its VMEM
    term: it takes every shape the reference takes, and the shapes only its
    VMEM declines (ROADMAP Queue 3)."""
    from portfft_tpu.config import DeviceConfig as RefConfig
    from portfft_tpu.ops import pallas_real

    cfg = RefConfig()
    vmem_only = []
    for n in (256, 512, 4096, 16384, 131072, 131072 + 256, 1 << 20, 4222976,
              2 * 2048 * 521, 1 << 28):
        for batch in (1, 4, 8, 64):
            theirs = pallas_real.wide_bt_ct(n, batch, cfg)
            ours = cuda_real.wide_supported(n, batch)
            if theirs is not None:
                assert ours, (n, batch)
            elif ours:
                vmem_only.append((n, batch))
    assert {n for n, _ in vmem_only} == {1 << 20, 4222976, 2 * 2048 * 521, 1 << 28}


def test_real_plane_butterfly_mode_matches_reference(monkeypatch):
    """With ``PORTFFT_BLUESTEIN_BF`` set, a REAL length whose half length is
    a Bluestein prime on a 256 x 256 convolution runs K15-bf in both
    directions (the reference its butterfly mode), and the results agree."""
    monkeypatch.setenv("PORTFFT_BLUESTEIN_BF", "1")
    n, batch = 2 * 24977, 1
    seen = []
    dif = pallas_bluestein.blane_dif

    def recorded(*a, **k):
        seen.append("blane_dif")
        return dif(*a, **k)

    monkeypatch.setattr(pallas_bluestein, "blane_dif", recorded)
    plan, runs = _run_both(n, batch, 0.5, 2.0 / n, 11)
    assert seen  # the reference ran its butterfly mode
    for direction in pt.Direction:
        assert plan._raw_fast[direction][1][5] == {24977: "bluestein_bf"}
    for got, want, exact, tol in runs:
        _close(got, exact, tol)
        _close(want, exact, 30 * tol)  # the reference's bf16x3 products
        delta = np.abs(got - want).max()
        assert delta <= 1e-4 * np.abs(want).max(), delta


def test_real_plane_wide_untangle_end_to_end():
    """A REAL length whose half length needs the plane path and which
    K8a-w's gate takes (h = 2048 x 521, GLOBAL [16, 128] x Bluestein 521) at
    batch 8: the forward entry runs K8a-w's plain version, both ways
    against ``np.fft``."""
    n, batch = 2 * 2048 * 521, 8
    plan = pt.Descriptor(lengths=[n], number_of_transforms=batch,
                         domain=pt.Domain.REAL, forward_scale=0.5).commit(
        device="cpu")
    assert plan._raw_fast[pt.Direction.FORWARD][6] == "untangle_wide"
    x = np.random.default_rng(5).uniform(-1, 1, (batch, n)).astype(np.float32)
    y = plan.compute_forward(x.reshape(-1)).reshape(batch, -1)
    tol = oracle.tolerance(ref.Descriptor(lengths=[n]))
    _close(y, 0.5 * np.fft.rfft(x.astype(np.float64), axis=1), 0.5 * tol)
    spec = _spectra(batch, n, 6)
    back = plan.compute_backward(spec.reshape(-1)).reshape(batch, n)
    _close(back, _c2r(spec, n), tol)
