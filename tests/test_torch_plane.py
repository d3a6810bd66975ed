"""The plane path of portfft_tpu_torch (1D C2C lengths the raw kernels do
not take: BLUESTEIN plans, GLOBAL plans with a non-leaf sub, FUSED chains
that are not [a, 128]) against portfft_tpu (``commit(use_pallas=True)``,
Pallas kernels in interpret mode) and ``np.fft``.

On the CPU the JAX package does two things its TPU does not: it runs the
interleave/deinterleave around its executor as XLA slices instead of
``pallas_io``, and it runs a general factor chain through
``pallas_fft._generic_chain_call`` (interpret mode only; its TPU leaves
such chains to XLA).  So the kernel sequences compared here are the
reference's ``fused_chain`` and ``bluestein_call`` calls against the port's
K13 and K15 calls; K6 is checked on its own against ``pallas_io``.

Tolerances: the port within the oracle's per-element 2·eps·N·log2N of
``np.fft``; the reference within 30× that bound on its Bluestein lengths,
the bound of its own ``tests/test_bluestein3.py`` (its bf16×3 matrix
products through the chirp-z convolution), 1× elsewhere; port against
reference max|Δ| ≤ 1e-4·max|y_ref| (the reference's bf16×3 error, carried
through a convolution three times the length).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
import portfft_tpu as ref
import portfft_tpu_torch as pt
from portfft_tpu.config import DeviceConfig as RefConfig
from portfft_tpu.enums import Level as RefLevel
from portfft_tpu.ops import pallas_bluestein, pallas_fft, pallas_global, pallas_io
from portfft_tpu.ops import xla_fft
from portfft_tpu.planner import plan_1d as ref_plan_1d
from portfft_tpu_torch import convert, fastpath
from portfft_tpu_torch.config import DeviceConfig
from portfft_tpu_torch.ops import (
    cuda_bluestein,
    cuda_chain,
    cuda_io,
    torch_exec,
    torch_fft,
)
from portfft_tpu_torch.planner import plan_1d

REF_CFG = RefConfig(name="cpu")
CFG = DeviceConfig()

# (n, batch, the port's route, the kernels the reference and the port call
# in order on the CPU)
CASES = [
    (600, 3, {600: "chain"}, ("chain",)),  # FUSED [120, 5]
    (1000, 2, {1000: "chain"}, ("chain",)),  # FUSED [125, 8]
    # generic Bluestein on a FUSED [24, 128] convolution: K13 both ways
    (1031, 2, {1031: "generic", 3072: "two_stage"}, ("chain", "chain")),
    # GLOBAL direct 2 x bluestein 1031
    (2062, 2, {2062: "generic", 2: "direct", 1031: "generic",
               3072: "two_stage"}, ("chain", "chain", "chain")),
    (16411, 2, {16411: "bluestein"}, ("bluestein",)),  # conv 192 x 192
    (20011, 2, {20011: "bluestein"}, ("bluestein",)),  # conv 256 x 192
]
BLUESTEIN_LENGTHS = {1031, 2062, 16411, 20011}


@pytest.fixture
def calls(monkeypatch):
    """``{"ref": [...], "port": [...]}``: the kernel calls of each package
    that returned a result, in order."""
    seen = {"ref": [], "port": []}
    for mod, name, side, kind in (
        (pallas_fft, "fused_chain", "ref", "chain"),
        (pallas_bluestein, "bluestein_call", "ref", "bluestein"),
        (pallas_global, "global2_call", "ref", "K14"),
        (cuda_chain, "chain", "port", "chain"),
        (cuda_bluestein, "bluestein", "port", "bluestein"),
    ):
        fn = getattr(mod, name)

        def wrapped(*a, _fn=fn, _side=side, _kind=kind, **k):
            res = _fn(*a, **k)
            if res is not None:
                seen[_side].append(_kind)
            return res

        wrapped.plain = getattr(fn, "plain", None)
        monkeypatch.setattr(mod, name, wrapped)
    return seen


def _descs(n, batch, **kw):
    kw = dict(lengths=[n], number_of_transforms=batch, forward_scale=0.5,
              backward_scale=1.0 / n, **kw)
    r, p = dict(kw), dict(kw)
    if "placement" in kw:
        r["placement"] = ref.Placement[kw["placement"]]
        p["placement"] = pt.Placement[kw["placement"]]
    return ref.Descriptor(**r), pt.Descriptor(**p)


def _check(got, want_ref, desc, canon, direction, n):
    """The port against np.fft (1× the oracle bound) and the reference; the
    reference against np.fft (30× on Bluestein lengths, see the module
    docstring)."""
    expect = oracle.reference_output(desc, canon, direction)
    oracle.verify(desc, np.asarray(got), expect, direction, check_padding=False)
    want = np.asarray(want_ref).reshape(expect.shape).astype(np.complex128)
    tol = oracle.tolerance(desc) * (30 if n in BLUESTEIN_LENGTHS else 1)
    diff = np.abs(want - expect)
    assert np.all((diff <= tol) | (diff <= tol * np.abs(expect))), diff.max()
    delta = np.abs(np.asarray(got) - np.asarray(want_ref)).max()
    assert delta <= 1e-4 * np.abs(want_ref).max(), delta


@pytest.mark.parametrize("n,batch,routes,kinds", CASES)
def test_plane_route_and_values_match_reference(calls, n, batch, routes,
                                                kinds):
    rdesc, pdesc = _descs(n, batch)
    rplan = rdesc.commit(use_pallas=True)
    plan = pdesc.commit(device="cpu")
    assert plan.plan_description() == rplan.plan_description()
    canon = oracle.gen_input(rdesc, seed=n + batch)
    x = canon.reshape(-1)
    for rdir, pdir in zip(ref.Direction, pt.Direction):
        # the reference's raw fast path declines these lengths
        assert rdir not in rplan._raw_fast
        entry = plan._raw_fast[pdir]
        assert isinstance(entry, fastpath.Plane) and entry.routes == routes
        assert entry.scale == float(pdesc.get_scale(pdir))
        calls["ref"].clear()
        calls["port"].clear()
        want = (rplan.compute_forward if rdir == ref.Direction.FORWARD
                else rplan.compute_backward)(x)
        got = (plan.compute_forward if pdir == pt.Direction.FORWARD
               else plan.compute_backward)(x)
        assert tuple(calls["ref"]) == tuple(calls["port"]) == kinds
        assert isinstance(got, np.ndarray) and got.dtype == np.complex64
        assert got.shape == x.shape
        _check(got, want, rdesc, canon, rdir, n)


@pytest.mark.parametrize("n", [1000, 2062, 16411])
def test_plane_in_place_and_tensor_io(n):
    """IN_PLACE on a raw float32 tensor writes the caller's tensor and
    equals the reference's in-place result; the backward round trip
    (scales 0.5 and 1/n) gives x/2; a complex64 tensor gives a complex64
    tensor equal to the numpy result."""
    batch = 2
    rdesc, pdesc = _descs(n, batch, placement="IN_PLACE")
    rplan = rdesc.commit(use_pallas=True)
    plan = pdesc.commit(device="cpu")
    canon = oracle.gen_input(rdesc, seed=n)
    raw = canon.reshape(-1).view(np.float32).copy()
    want = np.asarray(rplan.compute_forward(raw.copy())).view(np.complex64)
    t = torch.from_numpy(raw.copy())
    assert plan.compute_forward(t) is t
    _check(t.numpy().view(np.complex64), want, rdesc, canon,
           ref.Direction.FORWARD, n)
    assert plan.compute_backward(t) is t
    back = t.numpy().view(np.complex64)
    assert np.abs(back - 0.5 * canon.reshape(-1)).max() <= 1e-5
    oop = pt.Descriptor(lengths=[n], number_of_transforms=batch,
                        forward_scale=0.5).commit(device="cpu")
    xc = torch.from_numpy(canon.reshape(-1).copy())
    yc = oop.compute_forward(xc)
    assert yc.dtype == torch.complex64 and yc.shape == xc.shape
    assert torch.equal(yc, torch.from_numpy(oop.compute_forward(canon.reshape(-1))))


def _port_tables(n, sign, rbank):
    """The port's keys for the length-n plan, with arrays carried over from
    the reference's bank where it holds them (it holds no (a, 128) twiddle
    ``U`` for a ∤ 128, which the port's [a, 128] kernels read)."""
    plan = plan_1d(n, CFG, 4)
    bank = torch_fft.TwiddleBank()
    keys = torch_fft.collect_bank_keys(plan, sign, bank, {})
    arrays = bank.device_arrays("cpu")
    arrays.update(convert.bank_from_reference(rbank.host, "cpu"))
    return plan, keys, arrays


def _planes(n, batch, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (batch, n)).astype(np.float32),
            rng.uniform(-1, 1, (batch, n)).astype(np.float32))


def _check_rows(got, want, xr, xi, sign, scale, factor):
    """(re, im) results against np.fft of the rows (``factor`` × the oracle
    bound) and the port against the reference."""
    n = xr.shape[-1]
    xc = (xr + 1j * xi).astype(np.complex128)
    expect = (np.fft.fft(xc, axis=-1) if sign < 0
              else np.fft.ifft(xc, axis=-1) * n) * scale
    tol = 2.0 * np.finfo(np.float32).eps * n * max(np.log2(n), 1.0)
    for (yr, yi), f in ((got, 1), (want, factor)):
        y = np.asarray(yr) + 1j * np.asarray(yi)
        diff = np.abs(y - expect)
        assert np.all((diff <= f * tol) | (diff <= f * tol * np.abs(expect)))
    delta = max(np.abs(np.asarray(got[i]) - np.asarray(want[i])).max()
                for i in (0, 1))
    assert delta <= 1e-4 * np.abs(expect).max(), delta


@pytest.mark.parametrize("n,sign", [(16411, -1), (20011, +1), (65537, -1),
                                    (65537, +1)])
def test_bluestein_matches_bluestein_call(n, sign):
    """K15's plain version against ``pallas_bluestein.bluestein_call`` on
    the reference's own tables (65537: the 384 x 384 convolution of the
    benchmark's Bluestein cell)."""
    xr, xi = _planes(n, 2, n)
    rplan = ref_plan_1d(n, REF_CFG, 4)
    rbank = xla_fft.TwiddleBank(np.float32)
    rkeys = xla_fft.collect_bank_keys(rplan, sign, rbank)
    want = pallas_bluestein.bluestein_call(
        jnp.asarray(xr), jnp.asarray(xi), rplan, sign, rkeys,
        rbank.device_arrays(), REF_CFG)
    assert want is not None
    plan, keys, arrays = _port_tables(n, sign, rbank)
    assert cuda_bluestein.supported(plan, CFG)
    tabs = cuda_bluestein.bluestein_tables(plan, sign, keys, arrays)
    got = cuda_bluestein.bluestein(torch.from_numpy(xr), torch.from_numpy(xi),
                                   tabs)
    _check_rows(tuple(g.numpy() for g in got), want, xr, xi, sign, 1.0, 30)


@pytest.mark.parametrize(
    "n,mode", [(100, "direct"), (512, "direct"), (3072, "two_stage"),
               (24576, "two_stage"), (600, "chain"), (1000, "chain")])
def test_chain_matches_fused_chain(n, mode):
    """K13's plain version against ``pallas_fft.fused_chain`` (its DIRECT
    kernel, its two-stage kernel, and in interpret mode
    ``_generic_chain_call``) on the reference's own tables."""
    sign = -1 if n % 2 else +1
    xr, xi = _planes(n, 3, n)
    rplan = ref_plan_1d(n, REF_CFG, 4)
    rbank = xla_fft.TwiddleBank(np.float32)
    rkeys = xla_fft.collect_bank_keys(rplan, sign, rbank)
    want = pallas_fft.fused_chain(jnp.asarray(xr), jnp.asarray(xi), rplan, sign,
                                  rkeys, rbank.device_arrays(), REF_CFG)
    assert want is not None
    plan, keys, arrays = _port_tables(n, sign, rbank)
    assert cuda_chain.leaf_mode(plan) == mode
    tabs = cuda_chain.chain_tables(plan, sign, keys, arrays)
    got = cuda_chain.chain(torch.from_numpy(xr), torch.from_numpy(xi), tabs)
    _check_rows(tuple(g.numpy() for g in got), want, xr, xi, sign, 1.0, 1)


@pytest.mark.parametrize("k", [1, 2])
def test_io_matches_pallas_io(k):
    """K6's plain versions against ``pallas_io`` in interpret mode at
    M = 16384·k, bit for bit; the scale multiplies every scalar."""
    m = 16384 * k
    raw = np.random.default_rng(k).uniform(-1, 1, 2 * m).astype(np.float32)
    wr, wi = pallas_io.deinterleave(jnp.asarray(raw), interpret=True)
    re, im = cuda_io.deinterleave(torch.from_numpy(raw))
    assert np.array_equal(re.numpy(), np.asarray(wr))
    assert np.array_equal(im.numpy(), np.asarray(wi))
    back = pallas_io.interleave(wr, wi, interpret=True)
    assert np.array_equal(cuda_io.interleave(re, im, 1.0).numpy(), np.asarray(back))
    out = torch.empty(2 * m)
    assert cuda_io.interleave(re, im, 0.5, out=out) is out
    assert torch.equal(out, torch.from_numpy(raw) * 0.5)


@pytest.mark.parametrize("n", [1031, 16411, 20011])
def test_bluestein_bank_is_bit_equal(n):
    """Every Bluestein table of the port (``B``, and for a GLOBAL
    convolution ``BPOST``, ``BPRE``, ``BFIN`` and T(g2, g1, +1)) has the
    reference's key string and equals its array bit for bit, as does every
    other table both banks hold; ``bank_from_reference`` carries them."""
    plan = plan_1d(n, CFG, 4)
    for sign in (-1, +1):
        rbank = xla_fft.TwiddleBank(np.float32)
        rkeys = xla_fft.collect_bank_keys(ref_plan_1d(n, REF_CFG, 4), sign, rbank)
        bank = torch_fft.TwiddleBank(np.float32)
        keys = torch_fft.collect_bank_keys(plan, sign, bank, {})
        blue = [k for k in keys if k[0] in ("B", "BPOST", "BPRE", "BFIN")]
        if plan.conv.level == pt.Level.GLOBAL:
            g1, g2 = (s.n for s in plan.conv.sub)
            blue.append(("T", g2, g1, +1))
        assert len(blue) == (5 if n > 16384 else 1)
        for k in blue:
            assert rkeys[k] == keys[k]
        for k in keys:
            assert rkeys.get(k, keys[k]) == keys[k]
        carried = convert.bank_from_reference(rbank.host, "cpu")
        names = [nm for nm, arr in bank.host.items() if arr is not None]
        blue_names = [nm for nm in names if nm[0] in "BOCD"]
        assert all(nm in rbank.host for nm in blue_names) and len(blue_names) >= 4
        for name in names:
            if name in rbank.host:
                assert np.array_equal(bank.host[name], rbank.host[name]), name
                assert np.array_equal(carried[name].numpy(), bank.host[name]), name


SPREAD = [513, 521, 600, 640 * 1031, 1000, 1031, 1152, 2062, 3000, 4099,
          10007, 16411, 19683, 20011, 65537, 131101, 2 * 65537, 3 * 20011,
          531441, 299993, 1 << 27]


@pytest.mark.parametrize("n", SPREAD)
def test_routes_follow_the_reference_gates(n):
    """``fastpath.plane_routes`` makes the reference's ``leaf_dispatch``
    choice at every node: K15 where ``pallas_bluestein.supported`` and its
    tiles take the plan, K13's mode as ``fused_chain`` picks it, and the
    plane GLOBAL kernel K14 where ``pallas_global.global2_supported`` takes
    a GLOBAL node (the reference's own VMEM tile budget aside, see
    ``test_torch_split.py``)."""
    plan, rplan = plan_1d(n, CFG, 4), ref_plan_1d(n, REF_CFG, 4)
    assert plan.describe() == rplan.describe()

    def k15(p):
        """The gate of ``bluestein_call`` the port copies (not its TPU
        tile budget: see ``test_bluestein_past_the_tpu_tile_budget``), and
        K15's own tile (convolution subs up to GLOBAL_SUB_MAX)."""
        return (pallas_bluestein.supported(p, REF_CFG)
                and max(s.n for s in p.conv.sub) <= fastpath.GLOBAL_SUB_MAX)

    routes = fastpath.plane_routes(plan, CFG)

    def walk(p):
        kind = routes[p.n]
        if p.level == RefLevel.BLUESTEIN:
            assert (kind == "bluestein") == k15(p)
            if kind != "bluestein":
                walk(p.conv)
        elif p.level == RefLevel.GLOBAL:
            k14 = pallas_global.global2_supported(p, REF_CFG.direct_threshold)
            assert kind == ("global2" if k14 else "generic")
            if not k14:
                walk(p.sub[0])
                walk(p.sub[1])
        else:
            f = p.factors
            two = len(f) == 2 and f[1] == 128 and f[0] >= 8
            assert kind == ("direct" if len(f) == 1 else
                            "two_stage" if two else "chain")

    walk(rplan)


def test_bluestein_past_the_tpu_tile_budget():
    """At n = 131101 (convolution FUSED [16, 128] x 144) the reference's
    ``bluestein_call`` declines, no lane tile fitting its planning VMEM, and
    the reference runs its plane GLOBAL kernel (K14) instead; the port's
    K15 takes the plan (its tiles hold a 2048-point sub) and matches
    np.fft."""
    n = 131101
    rplan = ref_plan_1d(n, REF_CFG, 4)
    assert pallas_bluestein.supported(rplan, REF_CFG)
    p1, p2 = rplan.conv.sub
    assert not pallas_global._pick_tile(p2.n, p1, p1.n,
                                        REF_CFG.vmem_bytes * 5 // 8, 512, 128)
    plan = pt.Descriptor(lengths=[n], backward_scale=0.5).commit(device="cpu")
    assert plan._raw_fast[pt.Direction.FORWARD].routes == {n: "bluestein"}
    xr, xi = _planes(n, 1, n)
    x = (xr + 1j * xi).astype(np.complex64).reshape(-1)
    for sign, fn, scale in ((-1, plan.compute_forward, 1.0),
                            (+1, plan.compute_backward, 0.5)):
        y = fn(x)
        _check_rows((y.real[None], y.imag[None]), (y.real[None], y.imag[None]),
                    xr, xi, sign, scale, 1)


def test_plain_executor_runs_no_library_fft(monkeypatch):
    """The executor reaches no ``torch.fft`` function on any level, with
    the leaf hook or without it; without it (a two-stage leaf's twiddle
    read from its ``U`` table) it computes what the hooked path does."""
    def boom(*a, **k):
        raise AssertionError("torch.fft called")

    for name in ("fft", "ifft", "fftn", "ifftn", "rfft", "irfft"):
        monkeypatch.setattr(torch.fft, name, boom)
    for n in (1000, 2062, 20011):
        plan = pt.Descriptor(lengths=[n]).commit(device="cpu")
        x = torch.rand(2 * n)
        y = plan.compute_forward(x).view(1, n, 2)
        keys, arrays = plan._bank_keys, plan._bank_arrays
        xr, xi = x.view(1, n, 2).unbind(-1)
        hr, hi = torch_exec.exec_plan(xr, xi, plan.plans[n], -1, keys, arrays)
        tol = 1e-5 * y.abs().max().item()
        assert torch.allclose(hr, y[..., 0], atol=tol)
        assert torch.allclose(hi, y[..., 1], atol=tol)
