"""The last three Pallas pieces of portfft_tpu in portfft_tpu_torch, against
the JAX package on the CPU: K8a-w (``cuda_real.untangle_wide`` against
``pallas_real.untangle_wide_raw_call``), K3's factored-twiddle mode K3-ftw
(``cuda_global.global2_ftw`` against ``pallas_global.global2_raw_call(...,
use_ftw=True)`` with a DIRECT and a FUSED G1, and the tuned ``{"eng": 2,
"ftw": 1}`` route end to end) and K15's butterfly mode K15-bf
(``cuda_bluestein.bluestein_bf`` against ``pallas_bluestein.bluestein_call``
with ``PORTFFT_BLUESTEIN_BF`` set, as ``tests/test_bluestein3.py`` sets it;
its permuted tables bit for bit first).

The reference kernels run in interpret mode; the port's wrappers receive
CPU tensors and so run their plain versions.  Inputs are made with numpy
from a seed and handed to both.  Tolerances: every element of both within
``oracle.tolerance`` (2·eps·N·log2N, absolute or relative) of ``np.fft``
(the reference's Bluestein results within 30× that bound, as in
``tests/test_torch_plane.py``: its bf16×3 products), and the port within
a relative 2-norm of 1e-4 of the reference.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
import portfft_tpu as ref
from portfft_tpu import tuning as ref_tuning
from portfft_tpu.config import DeviceConfig as RefConfig
from portfft_tpu.enums import Level as RefLevel
from portfft_tpu.ops import pallas_bluestein, pallas_global, pallas_real, xla_fft
from portfft_tpu.planner import Plan1D as RefPlan1D
from portfft_tpu.planner import plan_1d as ref_plan_1d
import portfft_tpu_torch as pf
from portfft_tpu_torch import convert, fastpath, tuning
from portfft_tpu_torch.config import DeviceConfig
from portfft_tpu_torch.engines import ENGINES, engine_of
from portfft_tpu_torch.enums import Level
from portfft_tpu_torch.ops import cuda_bluestein, cuda_global, cuda_real, torch_fft
from portfft_tpu_torch.planner import Plan1D, plan_1d

CFG = DeviceConfig()
REF_CFG = RefConfig(name="cpu")
GLOBAL_CFG = RefConfig(name="cpu", vmem_bytes=64 * 2**20)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _close(got, exact, tol):
    diff = np.abs(np.asarray(got) - exact)
    assert np.all((diff <= tol) | (diff <= tol * np.abs(exact))), diff.max()


# -- K8a-w untangle_wide ------------------------------------------------------------


@pytest.mark.parametrize("n,batch,scale", [(16384, 8, 0.5), (8192, 16, 1.0)])
def test_k8aw_plain_matches_untangle_wide_raw_call(n, batch, scale):
    """K8a-w's plain version against ``untangle_wide_raw_call`` in
    interpret mode on the same Z spectrum and tables, as the reference's
    ``tests/test_real_raw.py`` calls it, and both against ``rfft``."""
    h = n // 2
    assert (pallas_real.wide_bt_ct(n, batch, REF_CFG) is not None) == cuda_real.wide_supported(
        n, batch)
    x = np.random.default_rng(3).standard_normal((batch, n)).astype(np.float32)
    z = np.fft.fft(x[:, 0::2] + 1j * x[:, 1::2], axis=1).astype(np.complex64)
    zraw = np.ascontiguousarray(z).view(np.float32).ravel()
    rbank = xla_fft.TwiddleBank(np.float32)
    rkey = rbank.rfft_untangle(n, -1)
    rarr = rbank.device_arrays()
    want = pallas_real.untangle_wide_raw_call(
        jnp.asarray(zraw), batch, n, [rarr[rkey + "r"], rarr[rkey + "i"]],
        REF_CFG, scale=scale)
    assert want is not None
    bank = torch_fft.TwiddleBank(np.float32)
    key = bank.rfft_untangle(n, -1)
    arr = bank.device_arrays("cpu")
    got = cuda_real.untangle_wide(torch.from_numpy(zraw), batch, h,
                                  arr[key + "r"], arr[key + "i"], scale).numpy()
    exact = scale * np.fft.rfft(x.astype(np.float64), axis=1)
    tol = oracle.tolerance(ref.Descriptor(lengths=[n]))
    for y in (got, np.asarray(want)):
        _close(y.view(np.complex64).reshape(batch, h + 1), exact, tol)
    assert _rel(got, want) < 1e-5
    # the same function as K8a's
    narrow = cuda_real.untangle(torch.from_numpy(zraw), batch, h,
                                arr[key + "r"], arr[key + "i"], scale).numpy()
    assert _rel(got, narrow) < 1e-6


# -- K3-ftw global2_ftw ----------------------------------------------------------------


def _plans(g1, g2):
    rplan = RefPlan1D(n=g1 * g2, level=RefLevel.GLOBAL, factors=[],
                      sub=(ref_plan_1d(g1, GLOBAL_CFG, 4), ref_plan_1d(g2, GLOBAL_CFG, 4)))
    plan = Plan1D(n=g1 * g2, level=Level.GLOBAL, factors=[],
                  sub=(plan_1d(g1, CFG, 4), plan_1d(g2, CFG, 4)))
    assert plan.describe() == rplan.describe()
    return rplan, plan


def _check_c2c(got, want, raw, batch, n, sign, scale):
    tol = oracle.tolerance(ref.Descriptor(lengths=[n], number_of_transforms=batch))
    xc = raw.view(np.complex64).reshape(batch, n).astype(np.complex128)
    exact = (np.fft.fft(xc) if sign < 0 else np.fft.ifft(xc) * n) * scale
    for y in (got, want):
        _close(np.asarray(y).view(np.complex64).reshape(batch, n), exact, tol)
    assert _rel(got, want) < 1e-4


@pytest.mark.parametrize("g1,g2,batch,sign,scale,factored", [
    (512, 128, 1, -1, 1.0, "_apply_factored_q"),   # DIRECT G1: the Q tables
    (1024, 128, 1, -1, 1.0, "_factored_ztw"),      # FUSED [8, 128] G1: ZQ
    (256, 256, 2, +1, 0.5, "_apply_factored_q"),   # backward, a scale
])
def test_k3ftw_plain_matches_global2_raw_call(monkeypatch, g1, g2, batch, sign,
                                              scale, factored):
    """K3-ftw's plain version against ``global2_raw_call(..., use_ftw=True)``
    at the factored tables' 64 columns, in interpret mode; the reference
    must take its factored branch (its dense fallback where a table is
    missing would compare K3-ftw with the dense K3)."""
    n = g1 * g2
    rplan, plan = _plans(g1, g2)
    assert cuda_global.global2_ftw_supported(plan)
    seen = []
    fn = getattr(pallas_global, factored)

    def recorded(*a, **k):
        seen.append(factored)
        return fn(*a, **k)

    monkeypatch.setattr(pallas_global, factored, recorded)
    raw = np.random.default_rng(n + batch).uniform(-1, 1, 2 * batch * n).astype(np.float32)
    rbank = xla_fft.TwiddleBank(np.float32)
    rkeys = xla_fft.collect_bank_keys(rplan, sign, rbank)
    want = pallas_global.global2_raw_call(
        jnp.asarray(raw), batch, rplan, sign, rkeys, rbank.device_arrays(),
        GLOBAL_CFG, scale=scale, t1_override=torch_fft.FTW_T1, use_ftw=True)
    assert want is not None and seen
    bank, keys = torch_fft.TwiddleBank(np.float32), {}
    torch_fft.collect_bank_keys(plan, sign, bank, keys)

    class Committed:
        _bank_keys, _bank_arrays = keys, bank.device_arrays("cpu")

    kernel, args = fastpath.Raw(plan, batch, sign, scale,
                                ENGINES["global2_ftw"]).kernel_args(Committed)
    assert kernel is cuda_global.global2_ftw
    got = kernel(torch.from_numpy(raw.copy()), *args).numpy()
    _check_c2c(got, np.asarray(want), raw, batch, n, sign, scale)


@pytest.fixture
def tmp_caches(tmp_path, monkeypatch):
    """Temporary tuning caches for both packages."""
    monkeypatch.delenv("PORTFFT_NO_TUNING", raising=False)
    monkeypatch.setattr(tuning, "_USER_PATH", str(tmp_path / "port.json"))
    monkeypatch.setattr(ref_tuning, "_USER_PATH", str(tmp_path / "ref.json"))
    tuning._reset_for_tests()
    ref_tuning._reset_for_tests()
    yield
    tuning._reset_for_tests()
    ref_tuning._reset_for_tests()


def test_k3ftw_tuned_route_matches_the_reference(tmp_caches, monkeypatch):
    """The reference's tuner entry ``{"eng": 2, "t1": 64, "t2": 256, "ftw":
    1}`` recorded in both caches: the port commits to K3-ftw, the reference
    runs ``global2_raw_call`` with its factored twiddle, and both
    directions agree at 65536 × 2."""
    n, batch = 65536, 2
    params = {"eng": 2, "t1": 64, "t2": 256, "ftw": 1}
    kw = dict(lengths=[n], number_of_transforms=batch, forward_scale=0.5)
    rdesc, desc = ref.Descriptor(**kw), pf.Descriptor(**kw)
    key = tuning._entry_key(desc.commit(device="cpu"), "global2")
    tuning.record("cpu", "global2", key, params)
    rprobe = rdesc.commit(use_pallas=True)
    assert ref_tuning._entry_key(rprobe, "global2") == key
    ref_tuning.record(rprobe.config.name, "global2", key, params)
    seen = []
    fn = pallas_global._apply_factored_q

    def recorded(*a, **k):
        seen.append(1)
        return fn(*a, **k)

    monkeypatch.setattr(pallas_global, "_apply_factored_q", recorded)
    rplan, plan = rdesc.commit(use_pallas=True), desc.commit(device="cpu")
    assert all(plan._raw_fast[d].engine.name == "global2_ftw" for d in pf.Direction)
    raw = np.random.default_rng(3).uniform(-1, 1, 2 * batch * n).astype(np.float32)
    for sign, scale, rcompute, compute in (
            (-1, 0.5, rplan.compute_forward, plan.compute_forward),
            (+1, 1.0, rplan.compute_backward, plan.compute_backward)):
        seen.clear()
        want = np.asarray(rcompute(raw.copy())).reshape(-1).view(np.float32)
        assert seen
        got = compute(torch.from_numpy(raw.copy())).numpy()
        _check_c2c(got, want, raw, batch, n, sign, scale)


def test_k3ftw_gate_and_variant():
    """K3-ftw takes the K3 plans whose factored tables exist (a DIRECT G1
    with 128 | G1 or a FUSED [a, 128] G1 with a | 128, and 64 | G2), as
    K17's factored mode; ``{"eng": 2, "ftw": 1}`` is raced under
    ``global2`` exactly there."""
    for g1, g2, takes in ((256, 256, True), (384, 384, True), (2048, 512, True),
                          (640, 256, False), (200, 256, False), (256, 96, False)):
        _, plan = _plans(g1, g2)
        assert ENGINES["global2_ftw"].gate(plan) == takes, (g1, g2)
        assert takes == ENGINES["global_fused_ftw"].gate(plan)
    assert ENGINES["global2_ftw"].params == {"eng": 2, "ftw": 1}
    assert engine_of({"eng": 2, "ftw": 1}) is ENGINES["global2_ftw"]
    assert engine_of({"eng": 2}) is ENGINES["global2"]


# -- K15-bf bluestein_bf ---------------------------------------------------------------


@pytest.mark.parametrize("n,sign", [(24593, -1), (65537, +1)])
def test_k15bf_plain_matches_bluestein_call(monkeypatch, n, sign):
    """K15-bf's plain version against ``bluestein_call`` with
    ``PORTFFT_BLUESTEIN_BF`` set (its butterfly mode: the 256 x 256 and the
    mixed-radix 384 x 384 convolutions) on the reference's own tables
    carried over, after the permuted tables compare bit for bit."""
    monkeypatch.setenv("PORTFFT_BLUESTEIN_BF", "1")
    seen = []
    dit = pallas_bluestein.blane_dit

    def recorded(*a, **k):
        seen.append(1)
        return dit(*a, **k)

    monkeypatch.setattr(pallas_bluestein, "blane_dit", recorded)
    rng = np.random.default_rng(n)
    xr, xi = (rng.standard_normal((1, n)).astype(np.float32) for _ in range(2))
    rplan = ref_plan_1d(n, REF_CFG, 4)
    rbank = xla_fft.TwiddleBank(np.float32)
    rkeys = xla_fft.collect_bank_keys(rplan, sign, rbank)
    want = pallas_bluestein.bluestein_call(
        jnp.asarray(xr), jnp.asarray(xi), rplan, sign, rkeys,
        rbank.device_arrays(), REF_CFG)
    assert want is not None and seen
    plan = plan_1d(n, CFG, 4)
    assert fastpath.plane_routes(plan, CFG) == {n: "bluestein_bf"}
    bank = torch_fft.TwiddleBank(np.float32)
    keys = torch_fft.collect_bank_keys(plan, sign, bank, {})
    for kind in ("BLT", "BLP", "BLB"):
        assert keys[(kind, n, sign)] == rkeys[(kind, n, sign)]
    arrays = convert.bank_from_reference(rbank.host, "cpu")
    tabs = cuda_bluestein.bluestein_tables(plan, sign, keys, arrays, bf=True)
    got = cuda_bluestein.bluestein_bf(torch.from_numpy(xr), torch.from_numpy(xi), tabs)
    exact = (np.fft.fft if sign < 0 else lambda v: np.fft.ifft(v) * n)(
        (xr + 1j * xi).astype(np.complex128))
    tol = oracle.tolerance(ref.Descriptor(lengths=[n]))
    y = got[0].numpy() + 1j * got[1].numpy()
    w = np.asarray(want[0]) + 1j * np.asarray(want[1])
    _close(y, exact, tol)
    _close(w, exact, 30 * tol)
    assert _rel(y, w) < 1e-4
    # the dense mode on the same input, for its own tables
    dense = cuda_bluestein.bluestein(
        torch.from_numpy(xr), torch.from_numpy(xi),
        cuda_bluestein.bluestein_tables(plan, sign, keys, arrays))
    assert _rel(y, dense[0].numpy() + 1j * dense[1].numpy()) < 1e-5


@pytest.mark.parametrize("n", [24593, 65537, 75277])
def test_butterfly_tables_bit_equal_and_carried(n):
    """The butterfly mode's tables (``BLT``, ``BLP``, ``BLB``, the digit
    twiddles ``U`` and the 128-point DFT of both directions) have the
    reference's key strings and arrays bit for bit, and
    ``bank_from_reference`` carries them.  The reference's bf16 Karatsuba
    stacks ``WK`` have no reader here: K15-bf reads the float32 ``W128``."""
    plan, rplan = plan_1d(n, CFG, 4), ref_plan_1d(n, REF_CFG, 4)
    assert plan.describe() == rplan.describe()
    for sign in (-1, +1):
        rbank = xla_fft.TwiddleBank(np.float32)
        rkeys = xla_fft.collect_bank_keys(rplan, sign, rbank)
        bank = torch_fft.TwiddleBank(np.float32)
        keys = torch_fft.collect_bank_keys(plan, sign, bank, {})
        a1, a2 = (torch_fft.ilv_factor(s.n) for s in plan.conv.sub)
        assert a1 and a2
        wanted = [("BLT", n, sign), ("BLP", n, sign), ("BLB", n, sign),
                  *[("U", a, 128, s) for a in (a1, a2) for s in (-1, +1)],
                  ("W", 128, -1), ("W", 128, +1)]
        carried = convert.bank_from_reference(rbank.host, "cpu")
        for key in wanted:
            name = keys[key]
            assert rkeys[key] == name, key
            parts = [nm for nm, arr in bank.host.items()
                     if arr is not None and nm.startswith(name)
                     and nm[len(name):] in ("r", "i", "fr", "fi")]
            assert parts, key
            for nm in parts:
                got, want = bank.host[nm], rbank.host[nm]
                assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
                assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), nm
                assert np.array_equal(carried[nm].numpy(), got), nm


def test_butterfly_mode_is_chosen_at_commit(monkeypatch):
    """The route takes K15-bf from the same flag and gate as the reference:
    ``PORTFFT_BLUESTEIN_BF`` set and both convolution subs A·128 with
    A = 2^a·3^b ≤ 16; the flag is read at commit, so a committed plan
    keeps its route."""
    plan65537, plan16411 = plan_1d(65537, CFG, 4), plan_1d(16411, CFG, 4)
    assert fastpath.plane_routes(plan65537, CFG) == {65537: "bluestein"}
    monkeypatch.setenv("PORTFFT_BLUESTEIN_BF", "1")
    assert fastpath.plane_routes(plan65537, CFG) == {65537: "bluestein_bf"}
    # a 192 x 192 convolution: 192 is no multiple of 128
    assert fastpath.plane_routes(plan16411, CFG) == {16411: "bluestein"}
    committed = pf.Descriptor(lengths=[24593], number_of_transforms=2).commit(
        device="cpu")
    monkeypatch.delenv("PORTFFT_BLUESTEIN_BF")
    assert fastpath.plane_routes(plan65537, CFG) == {65537: "bluestein"}
    assert committed._raw_fast[pf.Direction.FORWARD].routes == {24593: "bluestein_bf"}
    x = np.random.default_rng(1).standard_normal((2, 24593)).astype(np.complex64)
    y = committed.compute_forward(x.reshape(-1)).reshape(2, -1)
    tol = oracle.tolerance(ref.Descriptor(lengths=[24593]))
    _close(y, np.fft.fft(x.astype(np.complex128)), tol)
    with pytest.raises(pf.InvalidConfiguration, match="other mode"):
        tabs = cuda_bluestein.bluestein_tables(
            committed.plans[24593], -1, committed._bank_keys,
            committed._bank_arrays, bf=True)
        cuda_bluestein.bluestein(torch.zeros(24593), torch.zeros(24593), tabs)
