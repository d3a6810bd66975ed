"""SPLIT_COMPLEX storage and the multi-dimensional plane path of
portfft_tpu_torch against portfft_tpu (``commit(use_pallas=True)``, Pallas
kernels in interpret mode) and ``np.fft``.

The kernel sequences compared are the reference's ``global2_call`` (K14),
``fft_axis_m2_call`` / ``fft_axis_m2_fused_call`` (K12), ``fused_chain``
(K13) and ``bluestein_call`` (K15) calls that returned a result, against
the port's ``cuda_global.global2_planes``, ``cuda_axis.axis_m2``,
``cuda_chain.chain`` and ``cuda_bluestein.bluestein`` calls, in order.

Tolerances, as ``tests/test_torch_plane.py``: the port within the oracle's
per-element 2·eps·N·log2N of ``np.fft``; the reference within 30× that
bound on its Bluestein lengths (its bf16×3 matrix products through the
chirp-z convolution), 1× elsewhere; port against reference
max|Δ| ≤ 1e-4·max|y_ref|.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
import portfft_tpu as ref
import portfft_tpu_torch as pt
from portfft_tpu.config import DeviceConfig as RefConfig
from portfft_tpu.ops import pallas_bluestein, pallas_fft, pallas_global, xla_fft
from portfft_tpu.planner import plan_1d as ref_plan_1d
from portfft_tpu_torch import convert, fastpath
from portfft_tpu_torch.config import DeviceConfig
from portfft_tpu_torch.ops import (
    cuda_axis,
    cuda_bluestein,
    cuda_chain,
    cuda_fft,
    cuda_global,
    torch_exec,
    torch_fft,
)
from portfft_tpu_torch.planner import plan_1d

REF_CFG = RefConfig(name="cpu")
CFG = DeviceConfig()
BLUESTEIN_LENGTHS = {1031, 65537}

# (lengths, batch, the port's K12 axes, its executor routes, the kernels
# the reference and the port call in order on the CPU)
SPLIT_CASES = [
    ([64], 3, (), {64: "direct"}, ("chain",)),
    ([2048], 2, (), {2048: "two_stage"}, ("chain",)),
    ([1000], 2, (), {1000: "chain"}, ("chain",)),
    ([65536], 1, (), {65536: "global2"}, ("K14",)),  # DIRECT 256 x 256 subs
    ([1031], 2, (), {1031: "generic", 3072: "two_stage"}, ("chain", "chain")),
    ([65537], 1, (), {65537: "bluestein"}, ("bluestein",)),
    ([128, 256], 2, ((0, "direct"),), {256: "direct"}, ("chain", "K12")),
    ([1024, 128], 1, ((0, "fused"),), {128: "direct"}, ("chain", "K12")),
    ([3072, 128], 1, ((0, "fused"),), {128: "direct"}, ("chain", "K12")),
    ([16, 32, 128], 2, ((0, "direct"), (1, "direct")), {128: "direct"},
     ("chain", "K12", "K12")),
]
# Interleaved multi-dim shapes the raw route declines: an outer FUSED
# [5, 128] axis (movedim + K13's chain mode; the DIRECT 16 on K12), and a
# Bluestein last axis whose outer axis K12 declines (L2 = 1031 has no lane
# tile).
PLANE_MD_CASES = [
    ([16, 640, 128], 1, ((0, "direct"),), {640: "chain", 128: "direct"},
     ("chain", "chain", "K12")),
    ([8, 1031], 2, (), {8: "direct", 1031: "generic", 3072: "two_stage"},
     ("chain", "chain", "chain")),
]


@pytest.fixture
def calls(monkeypatch):
    """``{"ref": [...], "port": [...]}``: the kernel calls of each package
    that returned a result, in order."""
    seen = {"ref": [], "port": []}
    for mod, name, side, kind in (
        (pallas_fft, "fused_chain", "ref", "chain"),
        (pallas_bluestein, "bluestein_call", "ref", "bluestein"),
        (pallas_global, "global2_call", "ref", "K14"),
        (pallas_global, "fft_axis_m2_call", "ref", "K12"),
        (pallas_global, "fft_axis_m2_fused_call", "ref", "K12"),
        (cuda_chain, "chain", "port", "chain"),
        (cuda_bluestein, "bluestein", "port", "bluestein"),
        (cuda_global, "global2_planes", "port", "K14"),
        (cuda_axis, "axis_m2", "port", "K12"),
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


def _descs(lengths, batch, split=True, **kw):
    n = int(np.prod(lengths))
    kw = dict(lengths=lengths, number_of_transforms=batch, forward_scale=0.5,
              backward_scale=1.0 / n, **kw)
    r, p = dict(kw), dict(kw)
    if split:
        r["complex_storage"] = ref.ComplexStorage.SPLIT_COMPLEX
        p["complex_storage"] = pt.ComplexStorage.SPLIT_COMPLEX
    if "placement" in kw:
        r["placement"] = ref.Placement[kw["placement"]]
        p["placement"] = pt.Placement[kw["placement"]]
    return ref.Descriptor(**r), pt.Descriptor(**p)


def _check(got, want_ref, desc, canon, direction, bluestein=False):
    """The port (flat complex) against np.fft and the reference; the
    reference against np.fft."""
    expect = oracle.reference_output(desc, canon, direction)
    oracle.verify(desc, np.asarray(got), expect, direction, check_padding=False)
    want = np.asarray(want_ref).reshape(expect.shape).astype(np.complex128)
    tol = oracle.tolerance(desc) * (30 if bluestein else 1)
    diff = np.abs(want - expect)
    assert np.all((diff <= tol) | (diff <= tol * np.abs(expect))), diff.max()
    delta = np.abs(np.asarray(got) - np.asarray(want_ref)).max()
    assert delta <= 1e-4 * np.abs(want_ref).max(), delta


def _directions(rplan, plan):
    return (
        (ref.Direction.FORWARD, rplan.compute_forward, pt.Direction.FORWARD,
         plan.compute_forward),
        (ref.Direction.BACKWARD, rplan.compute_backward, pt.Direction.BACKWARD,
         plan.compute_backward),
    )


@pytest.mark.parametrize("lengths,batch,k12,routes,kinds", SPLIT_CASES)
def test_split_route_and_values_match_reference(calls, lengths, batch, k12,
                                                routes, kinds):
    """SPLIT planes (numpy float32) in, planes out, both directions with
    their scales: the port's route runs the reference's kernels in order
    and matches its values."""
    rdesc, pdesc = _descs(lengths, batch)
    rplan = rdesc.commit(use_pallas=True)
    plan = pdesc.commit(device="cpu")
    assert plan.plan_description() == rplan.plan_description()
    canon = oracle.gen_input(rdesc, seed=sum(lengths) + batch)
    xr = np.ascontiguousarray(canon.real).reshape(-1)
    xi = np.ascontiguousarray(canon.imag).reshape(-1)
    for rdir, rfn, pdir, pfn in _directions(rplan, plan):
        entry = plan._raw_fast[pdir]
        assert isinstance(entry, fastpath.Core) and entry.split and entry.k12 == k12
        assert entry.scale == float(pdesc.get_scale(pdir)) and entry.routes == routes
        calls["ref"].clear()
        calls["port"].clear()
        wr, wi = rfn(xr, xi)
        gr, gi = pfn(xr, xi)
        assert tuple(calls["ref"]) == tuple(calls["port"]) == kinds
        for g in (gr, gi):
            assert isinstance(g, np.ndarray) and g.dtype == np.float32
            assert g.shape == xr.shape
        _check(gr + 1j * gi, np.asarray(wr) + 1j * np.asarray(wi), rdesc, canon,
               rdir, lengths[-1] in BLUESTEIN_LENGTHS)


@pytest.mark.parametrize("lengths,batch,k12,routes,kinds", PLANE_MD_CASES)
def test_plane_multidim_route_and_values_match_reference(calls, lengths, batch,
                                                         k12, routes, kinds):
    """Interleaved multi-dim shapes the raw route declines run the same
    per-axis walk between K6, as the reference's ``_traced_interleaved``."""
    rdesc, pdesc = _descs(lengths, batch, split=False)
    rplan = rdesc.commit(use_pallas=True)
    plan = pdesc.commit(device="cpu")
    canon = oracle.gen_input(rdesc, seed=sum(lengths))
    x = canon.reshape(-1)
    for rdir, rfn, pdir, pfn in _directions(rplan, plan):
        assert rdir not in rplan._raw_fast
        entry = plan._raw_fast[pdir]
        assert isinstance(entry, fastpath.Core) and not entry.split
        assert entry.k12 == k12 and entry.routes == routes
        calls["ref"].clear()
        calls["port"].clear()
        want = rfn(x)
        got = pfn(x)
        assert tuple(calls["ref"]) == tuple(calls["port"]) == kinds
        assert isinstance(got, np.ndarray) and got.dtype == np.complex64
        _check(got, want, rdesc, canon, rdir, lengths[-1] in BLUESTEIN_LENGTHS)


def test_k14_past_the_tpu_tile_budget(calls):
    """At 270336 = FUSED [8, 128] x 264, the smallest GLOBAL plan with a
    FUSED sub, the reference's ``global2_call`` finds no lane tile within
    its planning VMEM and declines, and the reference runs the four-step in
    XLA around two ``fused_chain`` leaves; the port's K14 takes the plan
    (the routing difference of PERF.md §7).  Both match np.fft."""
    n = 270336
    rdesc, pdesc = _descs([n], 1)
    rplan = rdesc.commit(use_pallas=True)
    g1, g2 = rplan.plans[n].sub
    assert g1.factors == [8, 128] and g2.n == 264
    assert not pallas_global._pick_tile(g2.n, g1, g1.n,
                                        REF_CFG.vmem_bytes * 3 // 4, 512, 128)
    plan = pdesc.commit(device="cpu")
    canon = oracle.gen_input(rdesc, seed=n)
    xr = np.ascontiguousarray(canon.real).reshape(-1)
    xi = np.ascontiguousarray(canon.imag).reshape(-1)
    for rdir, rfn, pdir, pfn in _directions(rplan, plan):
        assert plan._raw_fast[pdir].routes == {n: "global2"}
        calls["ref"].clear()
        calls["port"].clear()
        wr, wi = rfn(xr, xi)
        gr, gi = pfn(xr, xi)
        assert calls["ref"] == ["chain", "chain"] and calls["port"] == ["K14"]
        _check(gr + 1j * gi, np.asarray(wr) + 1j * np.asarray(wi), rdesc, canon,
               rdir)


@pytest.mark.parametrize("n", [2048, 65536])
def test_split_in_place_and_tensor_io(n):
    """IN_PLACE on float32 tensors writes the caller's two tensors and
    equals the reference's in-place result; the backward round trip
    (scales 0.5 and 1/n) gives x/2; float64 numpy planes in place are
    written back; out of place, tensors give tensors equal to the numpy
    result."""
    batch = 2
    rdesc, pdesc = _descs([n], batch, placement="IN_PLACE")
    rplan = rdesc.commit(use_pallas=True)
    plan = pdesc.commit(device="cpu")
    canon = oracle.gen_input(rdesc, seed=n).reshape(-1)
    xr, xi = canon.real.copy(), canon.imag.copy()
    wr, wi = rplan.compute_forward(xr.copy(), xi.copy())
    tr, ti = torch.from_numpy(xr.copy()), torch.from_numpy(xi.copy())
    yr, yi = plan.compute_forward(tr, ti)
    assert yr is tr and yi is ti
    _check(tr.numpy() + 1j * ti.numpy(), np.asarray(wr) + 1j * np.asarray(wi),
           rdesc, canon.reshape(batch, n), ref.Direction.FORWARD)
    fwd = (tr.numpy().copy(), ti.numpy().copy())
    res = plan.compute_backward(tr, ti)
    assert res[0] is tr and res[1] is ti
    back = tr.numpy() + 1j * ti.numpy()
    assert np.abs(back - 0.5 * canon).max() <= 1e-5
    dr, di = xr.astype(np.float64), xi.astype(np.float64)
    res = plan.compute_forward(dr, di)
    assert res[0] is dr and res[1] is di
    assert np.array_equal(dr, fwd[0]) and np.array_equal(di, fwd[1])
    oop = _descs([n], batch)[1].commit(device="cpu")
    got_t = oop.compute_forward(torch.from_numpy(xr), torch.from_numpy(xi))
    got_np = oop.compute_forward(xr, xi)
    for t, a in zip(got_t, got_np):
        assert isinstance(t, torch.Tensor) and t.dtype == torch.float32
        assert torch.equal(t, torch.from_numpy(a))


def test_split_buffer_errors():
    plan = _descs([16], 4)[1].commit(device="cpu")
    with pytest.raises(pt.InvalidConfiguration, match="both real and imaginary"):
        plan.compute_forward(np.zeros(64, np.float32))
    with pytest.raises(pt.InvalidConfiguration, match="need 64"):
        plan.compute_forward(np.zeros(63, np.float32), np.zeros(64, np.float32))
    with pytest.raises(pt.InvalidConfiguration, match="real planes"):
        plan.compute_forward(np.zeros(64, np.complex64), np.zeros(64, np.float32))
    # an out= pair gets the result in place (tests/test_torch_layout.py
    # holds out= layouts to the JAX package)
    xr, xi = _planes(64, 5)
    out = (np.zeros(64, np.float32), np.zeros(64, np.float32))
    res = plan.compute_forward(xr, xi, out=out)
    assert res[0] is out[0] and res[1] is out[1]
    for got, want in zip(out, plan.compute_forward(xr, xi)):
        assert np.array_equal(got, want)
    with pytest.raises(pt.InvalidConfiguration, match="output buffers need 64"):
        plan.compute_forward(xr, xi, out=np.zeros(63, np.float32),
                             out_imag=np.zeros(64, np.float32))


def _port_tables(n, sign, rbank):
    """The port's keys and arrays for the length-n plan, the arrays carried
    over from the reference's bank where it holds them."""
    plan = plan_1d(n, CFG, 4)
    bank = torch_fft.TwiddleBank()
    keys = torch_fft.collect_bank_keys(plan, sign, bank, {})
    arrays = bank.device_arrays("cpu")
    arrays.update(convert.bank_from_reference(rbank.host, "cpu"))
    return plan, keys, arrays


def _planes(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, shape).astype(np.float32),
            rng.uniform(-1, 1, shape).astype(np.float32))


def _close(got, want, xr, xi, axis, sign, scale, factor=1):
    """(re, im) pairs against np.fft over ``axis`` (``factor`` × the oracle
    bound for the reference, 1× for the port) and each other."""
    n = xr.shape[axis]
    xc = (xr + 1j * xi).astype(np.complex128)
    expect = (np.fft.fft(xc, axis=axis) if sign < 0
              else np.fft.ifft(xc, axis=axis) * n) * scale
    tol = 2.0 * np.finfo(np.float32).eps * n * max(np.log2(n), 1.0)
    for (yr, yi), f in ((got, 1), (want, factor)):
        y = np.asarray(yr).reshape(expect.shape) + 1j * np.asarray(yi).reshape(
            expect.shape)
        diff = np.abs(y - expect)
        assert np.all((diff <= f * tol) | (diff <= f * tol * np.abs(expect)))
    delta = max(np.abs(np.asarray(got[i]).reshape(-1)
                       - np.asarray(want[i]).reshape(-1)).max() for i in (0, 1))
    assert delta <= 1e-4 * np.abs(expect).max(), delta


@pytest.mark.parametrize("n,sign,scale", [(65536, -1, 0.5), (1 << 17, +1, 2.0)])
def test_global2_planes_matches_global2_call(n, sign, scale):
    """K14's wrapper equals its plain version on the CPU, and both match
    ``pallas_global.global2_call`` on the reference's own tables."""
    xr, xi = _planes((2, n), n)
    rplan = ref_plan_1d(n, REF_CFG, 4)
    rbank = xla_fft.TwiddleBank(np.float32)
    rkeys = xla_fft.collect_bank_keys(rplan, sign, rbank)
    want = pallas_global.global2_call(
        jnp.asarray(xr), jnp.asarray(xi), rplan, sign, rkeys,
        rbank.device_arrays(), REF_CFG, scale=scale)
    assert want is not None
    plan, keys, arrays = _port_tables(n, sign, rbank)
    tabs = cuda_global.global2_tables(plan, sign, keys, arrays)
    x = (torch.from_numpy(xr), torch.from_numpy(xi))
    got = cuda_global.global2_planes(*x, tabs, scale)
    plain = cuda_global.global2_planes.plain(*x, tabs, scale)
    assert all(torch.equal(g, p) for g, p in zip(got, plain))
    _close(tuple(g.numpy() for g in got), want, xr, xi, 1, sign, scale)


@pytest.mark.parametrize("shape,sign", [((2, 128, 64), -1), ((1, 3072, 8), +1)])
def test_axis_m2_matches_fft_axis_m2(shape, sign):
    """K12's wrapper equals its plain version on the CPU, and both match
    the reference's ``fft_axis_m2_call`` (DIRECT 128) or
    ``fft_axis_m2_fused_call`` ([24, 128]: 24 does not divide 128)."""
    bpre, n, rest = shape
    xr, xi = _planes(shape, n)
    rplan = ref_plan_1d(n, REF_CFG, 4)
    rbank = xla_fft.TwiddleBank(np.float32)
    rkeys = xla_fft.collect_bank_keys(rplan, sign, rbank)
    call = (pallas_global.fft_axis_m2_call if n <= 256
            else pallas_global.fft_axis_m2_fused_call)
    want = call(jnp.asarray(xr), jnp.asarray(xi), rplan, sign, rkeys,
                rbank.device_arrays(), REF_CFG)
    assert want is not None
    plan, keys, arrays = _port_tables(n, sign, rbank)
    assert cuda_axis.axis_m2_mode(plan, rest) == ("direct" if n <= 256 else "fused")
    sub = cuda_fft.sub_tables(plan, sign, keys, arrays)
    x = (torch.from_numpy(xr.reshape(-1)), torch.from_numpy(xi.reshape(-1)))
    got = cuda_axis.axis_m2(*x, bpre, rest, sub)
    assert all(torch.equal(g, p) for g, p in
               zip(got, cuda_axis.axis_m2.plain(*x, bpre, rest, sub)))
    _close(tuple(g.numpy() for g in got), want, xr, xi, 1, sign, 1.0)


def test_k12_gates_match_the_reference():
    """``axis_m2_mode`` takes exactly the (L1, L2) the reference's two
    column kernels take (their L2 lane tile included)."""
    l2s = [1, 100, 128, 300, 640, 1031, 81920]
    for l1 in (8, 100, 256, 384, 640, 1024, 3072, 16384):
        plan, rplan = plan_1d(l1, CFG, 4), ref_plan_1d(l1, REF_CFG, 4)
        rbank = xla_fft.TwiddleBank(np.float32)
        rkeys = xla_fft.collect_bank_keys(rplan, -1, rbank)
        arrays = rbank.device_arrays()
        for l2 in l2s:
            x = jnp.zeros((1, l1, l2), jnp.float32)
            # the gates run before any kernel: trace shapes only
            direct = functools.partial(pallas_global.fft_axis_m2_call, x, x,
                                       rplan, -1, rkeys, arrays, REF_CFG)
            fused = functools.partial(pallas_global.fft_axis_m2_fused_call, x, x,
                                      rplan, -1, rkeys, arrays, REF_CFG)
            want = ("direct" if jax.eval_shape(direct) is not None else
                    "fused" if jax.eval_shape(fused) is not None else None)
            assert cuda_axis.axis_m2_mode(plan, l2) == want, (l1, l2)


def test_bluestein_post_branch_matches_the_reference(calls):
    """``exec_bluestein`` with a hook that runs the 384 x 384 convolution of
    65537 on K14 takes the ``post`` branch (b̂ in the forward convolution's
    pass 2, the final chirp and the scale in the backward's), as the
    reference's ``_exec_bluestein`` does with its leaf hook, which skips
    ``bluestein_call`` when called directly: both call K14 twice with post
    tables and match np.fft."""
    n, sign, scale = 65537, -1, 0.5
    xr, xi = _planes((1, n), n)
    rplan = ref_plan_1d(n, REF_CFG, 4)
    rbank = xla_fft.TwiddleBank(np.float32)
    rkeys = xla_fft.collect_bank_keys(rplan, sign, rbank)
    assert ("BPOST", n, sign) in rkeys
    leaf = functools.partial(pallas_fft.leaf_dispatch, bank_keys=rkeys,
                             config=REF_CFG)
    want = xla_fft._exec_bluestein(jnp.asarray(xr), jnp.asarray(xi), rplan, sign,
                                   rkeys, rbank.device_arrays(), leaf)
    want = tuple(np.asarray(w) * scale for w in want)
    plan = pt.Descriptor(lengths=[n]).commit(device="cpu")
    conv = plan.plans[n].conv
    steps = fastpath.plane_steps(plan, [conv], {conv.n: "global2"})
    got = torch_exec.exec_bluestein(
        torch.from_numpy(xr), torch.from_numpy(xi), plan.plans[n], sign,
        plan._bank_keys, plan._bank_arrays, fastpath.leaf_hook(steps), scale)
    assert calls["ref"] == ["K14", "K14"] and calls["port"] == ["K14", "K14"]
    _close(tuple(g.numpy() for g in got), want, xr, xi, 1, sign, scale, 30)


@pytest.mark.parametrize(
    "n,routes",
    [
        # GLOBAL(GLOBAL(240 x 184) x 277): K14 on the inner GLOBAL node
        (12232320, {12232320: "generic", 240 * 184: "global2", 277: "direct"}),
        # Bluestein over GLOBAL FUSED [128, 128] x [64, 128]: K15's tile
        # declines the 16384 sub, K14 takes the convolution with post
        (50431897, {50431897: "generic", 1 << 27: "global2"}),
    ],
)
def test_large_length_routes(n, routes):
    """The routes of two lengths past the CPU tests' sizes, by
    ``plane_routes`` only, and the reference's gates at their nodes."""
    plan, rplan = plan_1d(n, CFG, 4), ref_plan_1d(n, REF_CFG, 4)
    assert plan.describe() == rplan.describe()
    assert fastpath.plane_routes(plan, CFG) == routes
    if rplan.level == ref.Level.GLOBAL:
        inner = rplan.sub[0]
        assert not pallas_global.global2_supported(rplan, REF_CFG.direct_threshold)
        assert pallas_global.global2_supported(inner, REF_CFG.direct_threshold)
    else:
        assert pallas_bluestein.supported(rplan, REF_CFG)
        assert max(s.n for s in rplan.conv.sub) > fastpath.GLOBAL_SUB_MAX
        assert pallas_global.global2_supported(rplan.conv,
                                               REF_CFG.direct_threshold)


def _read_keys(plan, sign):
    """The bank keys of the tables K14 (a GLOBAL plan, or a Bluestein
    plan's convolution both ways with its post tables) or K12 (a DIRECT or
    [a, 128] plan) reads in the direction ``sign``."""
    def sub(p, s):
        if p.level == pt.Level.DIRECT:
            return [("W", p.n, s)]
        a = p.factors[0]
        return [("W", a, s), ("W", 128, s), ("U", a, 128, s)]

    if plan.level == pt.Level.GLOBAL:
        g1, g2 = plan.sub
        return sub(g1, sign) + sub(g2, sign) + [("T", g1.n, g2.n, sign)]
    if plan.level == pt.Level.BLUESTEIN:
        return [("BPOST", plan.n, sign)] + [
            k for s in (-1, +1) for k in _read_keys(plan.conv, s)]
    return sub(plan, sign)


@pytest.mark.parametrize("n", [65536, 270336, 1 << 20, 65537, 128, 1024, 3072])
def test_k14_and_k12_tables_are_bit_equal(n):
    """Every table K14 reads (its subs' W, W_a, W_128 and U, the inter-pass
    twiddle T, a Bluestein convolution's post tables) and every table K12
    reads (W_L1; W_a, W_128 and U) has the reference's name and equals its
    array bit for bit; for [a, 128] with a not dividing 128 the reference
    banks no U, and the port's U is its T transposed."""
    plan = plan_1d(n, CFG, 4)
    for sign in (-1, +1):
        rbank = xla_fft.TwiddleBank(np.float32)
        rkeys = xla_fft.collect_bank_keys(ref_plan_1d(n, REF_CFG, 4), sign, rbank)
        bank = torch_fft.TwiddleBank(np.float32)
        keys = torch_fft.collect_bank_keys(plan, sign, bank, {})
        for key in _read_keys(plan, sign):
            name = keys[key]
            suffixes = ("fr", "fi", "gr", "gi") if key[0] == "BPOST" else "ri"
            if key[0] == "U" and 128 % key[1]:
                t = rkeys[("T", key[1], 128, key[3])]
                for s in suffixes:
                    assert np.array_equal(bank.host[name + s], rbank.host[t + s].T)
                continue
            assert rkeys[key] == name
            for s in suffixes:
                assert np.array_equal(bank.host[name + s], rbank.host[name + s]), (
                    name + s)
