"""The last GLOBAL engines of portfft_tpu_torch against the Pallas kernels
they replace, on the CPU: K17 (``cuda_global.global_fused``, dense and
factored twiddle) against ``pallas_global.global_fused_raw_call``, K18
(``cuda_global_ilv.global_ilv``) against
``pallas_global_ilv.global_ilv_raw_call`` and K19
(``cuda_global_bf.global_bf2``) against
``pallas_global_bf.global_bf2_raw_call``.

The reference kernels run in interpret mode at the splits of the JAX
package's own tests (``tests/test_mm_kernels.py``,
``tests/test_ilv_engine.py``, ``tests/test_bf_engine.py``); the port's
wrappers receive CPU tensors and so run their plain versions.  Inputs are
made with numpy from a seed and handed to both.  Then the tuned route end
to end (``{"eng": 6}``, ``{"eng": 6, "ftw": 1}``, ``{"eng": 8}``,
``{"eng": 7, "bf2": 1}`` recorded in temporary caches of both packages),
the gates against the reference's, the variants, the mixed-radix slab DFT
and the tables carried from the reference's bank.

Tolerance: the reference's own, relative 2-norm error below 1e-4 between
the port and the reference, and every element of both within
``oracle.tolerance`` (2·eps·N·log2N, absolute or relative) of ``np.fft``.
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
from portfft_tpu.ops import pallas_global, pallas_global_bf, pallas_global_ilv, xla_fft
from portfft_tpu.planner import Plan1D as RefPlan1D
from portfft_tpu.planner import plan_1d as ref_plan_1d
import portfft_tpu_torch as pf
from portfft_tpu_torch import convert, fastpath, race, tuning
from portfft_tpu_torch.config import H100_SMEM_PER_BLOCK, DeviceConfig
from portfft_tpu_torch.engines import ENGINES, engine_of
from portfft_tpu_torch.enums import Level
from portfft_tpu_torch.ops import cuda_global, cuda_global_bf, cuda_global_ilv, torch_fft
from portfft_tpu_torch.planner import Plan1D, plan_1d

CFG = DeviceConfig()
REF_CFG = RefConfig(name="cpu", vmem_bytes=64 * 2**20)
BIG_CFG = RefConfig(name="cpu", vmem_bytes=256 * 2**20)


def _plans(g1, g2, ref_cfg):
    rplan = RefPlan1D(n=g1 * g2, level=RefLevel.GLOBAL, factors=[],
                      sub=(ref_plan_1d(g1, ref_cfg, 4), ref_plan_1d(g2, ref_cfg, 4)))
    plan = Plan1D(n=g1 * g2, level=Level.GLOBAL, factors=[],
                  sub=(plan_1d(g1, CFG, 4), plan_1d(g2, CFG, 4)))
    assert plan.describe() == rplan.describe()
    return rplan, plan


def _port_arrays(plan, sign):
    bank, keys = torch_fft.TwiddleBank(np.float32), {}
    torch_fft.collect_bank_keys(plan, sign, bank, keys)
    return keys, bank.device_arrays("cpu")


def _ref_arrays(plan, sign):
    bank = xla_fft.TwiddleBank(np.float32)
    keys = xla_fft.collect_bank_keys(plan, sign, bank)
    return keys, bank.device_arrays()


def _input(batch, n, seed):
    return np.random.default_rng(seed).uniform(-1, 1, 2 * batch * n).astype(np.float32)


def _check(got, want, raw, batch, n, sign, scale):
    """Port against reference (relative 2-norm < 1e-4) and both against
    np.fft at the oracle tolerance."""
    tol = oracle.tolerance(ref.Descriptor(lengths=[n], number_of_transforms=batch))
    xc = raw.view(np.complex64).reshape(batch, n).astype(np.complex128)
    exact = (np.fft.fft(xc) if sign < 0 else np.fft.ifft(xc) * n) * scale
    ys = [np.asarray(y).view(np.complex64).reshape(batch, n) for y in (got, want)]
    for y in ys:
        diff = np.abs(y - exact)
        assert np.all((diff <= tol) | (diff <= tol * np.abs(exact))), diff.max()
    rel = np.linalg.norm(ys[0] - ys[1]) / np.linalg.norm(ys[1])
    assert rel < 1e-4, rel


def _port_run(engine, plan, raw, batch, sign, scale, arrays=None):
    """The port's ``engine`` on ``raw`` through its raw route's
    ``kernel_args`` (its wrapper, on a CPU tensor: the plain version)."""
    keys, own = _port_arrays(plan, sign)

    class Committed:
        _bank_keys, _bank_arrays = keys, own if arrays is None else arrays

    kernel, args = fastpath.Raw(plan, batch, sign, scale,
                                ENGINES[engine]).kernel_args(Committed)
    return kernel(torch.from_numpy(raw.copy()), *args).numpy()


# -- K17 global_fused ---------------------------------------------------------------


@pytest.mark.parametrize("g1,g2,batch,sign,scale,ftw", [
    (256, 256, 3, -1, 0.5, False),   # the 65536 split, multi-tile, scale
    (1024, 128, 1, -1, 1.0, False),  # FUSED [8, 128] G1
    (512, 256, 1, +1, 1.0, False),   # backward, distinct DIRECT subs
    (512, 128, 1, -1, 1.0, True),    # factored, DIRECT G1 (the Q tables)
    (1024, 128, 1, -1, 1.0, True),   # factored, FUSED G1 (the ZQ tables)
    (256, 256, 2, +1, 0.5, True),    # factored, backward
])
def test_k17_plain_matches_global_fused_raw_call(g1, g2, batch, sign, scale, ftw):
    """K17's plain version, in both twiddle modes, against
    ``global_fused_raw_call`` (``use_ftw``) in interpret mode."""
    n = g1 * g2
    rplan, plan = _plans(g1, g2, REF_CFG)
    assert pallas_global.global_fused_supported(rplan, REF_CFG)
    assert cuda_global.global_fused_supported(plan, ftw=ftw)
    raw = _input(batch, n, n + batch)
    rkeys, rarrs = _ref_arrays(rplan, sign)
    want = pallas_global.global_fused_raw_call(
        jnp.asarray(raw), batch, rplan, sign, rkeys, rarrs, REF_CFG, scale=scale,
        use_ftw=ftw, **({"t1_override": 64, "t2_override": 128} if batch == 3 else {}))
    assert want is not None
    got = _port_run("global_fused_ftw" if ftw else "global_fused", plan, raw,
                    batch, sign, scale)
    _check(got, want, raw, batch, n, sign, scale)


def test_k17_chunks_and_twiddle():
    """K17's chunks are K5's (a quarter of the 50 MB L2: one 2^20
    transform), its tiles are powers of two dividing the factored tables'
    width, and its factored twiddle is the dense one within a few float32
    roundings."""
    _, plan = _plans(65536 // 256, 256, REF_CFG)
    keys, arrays = _port_arrays(plan, -1)
    t = cuda_global.global_fused_tables(plan, -1, keys, arrays, 2048)
    assert t.chunk == cuda_global_bf.bf_chunk(65536, 2048) == 23
    assert [cuda_global.fused_tile(m, 4096) for m in (256, 384, 768, 2048, 4096)] \
        == [8, 8, 4, 2, 1]
    for g1, g2 in ((256, 256), (2048, 512), (384, 384)):
        _, plan = _plans(g1, g2, REF_CFG)
        keys, arrays = _port_arrays(plan, -1)
        t = cuda_global.global_fused_tables(plan, -1, keys, arrays, 1, ftw=True)
        (c1r, c1i), (c2r, c2i) = cuda_global.fused_twiddle(t)
        tr, ti = torch_fft.complex_mul(c1r, c1i, c2r, c2i)
        dense = keys[("T", g1, g2, -1)]
        assert (tr - arrays[dense + "r"]).abs().max() <= 4e-7
        assert (ti - arrays[dense + "i"]).abs().max() <= 4e-7



def test_k17_gate_counts_both_root_tables():
    """K17 keeps both passes' root tables in shared memory and its gate
    counts both.  That costs it no plan whose tiles fit beside the larger
    table alone, in either twiddle mode: over the GLOBAL lengths 128·a·g
    (a = 8 … 128, g = 8 … 512) and 12288·p (the FUSED [96, 128] sub beside
    a prime DIRECT one, p = 131 … 509), the largest plan it takes,
    [96, 128] x 509, leaves over 27 KiB of shared memory free, more than
    both root tables take (at most 2 x 4 KiB: 512 DIRECT roots)."""
    lengths = {128 * a * g for a in (8, 16, 32, 64, 96, 128)
               for g in range(8, 513, 8)}
    lengths |= {12288 * p for p in range(131, 510, 2)
                if all(p % d for d in range(3, 23, 2))}
    largest = 0
    for n in sorted(lengths):
        plan = plan_1d(n, CFG, 4)
        if plan.level != Level.GLOBAL:
            continue
        s1, s2 = plan.sub
        (r1, e1), (r2, e2) = (
            cuda_global._pass_elems(s, cuda_global.fused_tile(s.n, o.n))
            for s, o in ((s1, s2), (s2, s1)))
        subs_ok = all(s.level == Level.DIRECT or torch_fft.is_two_stage(s)
                      for s in plan.sub)
        factors = torch_fft.ftw_factors(plan)
        for ftw in (False, True):
            if ftw and not factors:
                assert not cuda_global.global_fused_supported(plan, ftw)
                continue
            extra = sum(factors) * cuda_global.fused_tile(s1.n, s2.n) if ftw else 0
            tiles = 2 * max(e1, e2) + extra
            assert cuda_global.global_fused_smem(plan, ftw) == 8 * (r1 + r2 + tiles)
            fits = subs_ok and 8 * (max(r1, r2) + tiles) <= H100_SMEM_PER_BLOCK
            assert cuda_global.global_fused_supported(plan, ftw) == fits, (n, ftw)
            if fits:
                largest = max(largest, cuda_global.global_fused_smem(plan, ftw))
    assert largest == cuda_global.global_fused_smem(plan_1d(12288 * 509, CFG, 4))
    assert H100_SMEM_PER_BLOCK - largest > 27 * 2**10 > 2 * 8 * 512

# -- K18 global_ilv ------------------------------------------------------------------


@pytest.mark.parametrize("g1,g2,sign,scale", [
    (256, 256, -1, 1.0),   # A1 = A2 = 2
    (512, 256, -1, 0.5),   # A1 = 4, folded scale
    (256, 512, +1, 1.0),   # backward, A2 = 4
    (128, 256, -1, 1.0),   # degenerate A1 = 1
    (384, 384, -1, 1.0),   # A = 3 both
    (384, 768, +1, 1.0),   # A1 = 3, A2 = 6, backward
    (256, 1536, -1, 1.0),  # A2 = 12
    (1536, 384, -1, 1.0),  # A1 = 12
])
def test_k18_plain_matches_global_ilv_raw_call(g1, g2, sign, scale):
    """K18's plain version against ``global_ilv_raw_call`` in interpret
    mode, A = 1 … 12, the mixed radices among them."""
    n, batch = g1 * g2, 1
    rplan, plan = _plans(g1, g2, BIG_CFG)
    assert pallas_global_ilv.global_ilv_supported(rplan, BIG_CFG)
    assert cuda_global_ilv.global_ilv_supported(plan)
    raw = _input(batch, n, 7)
    rkeys, rarrs = _ref_arrays(rplan, sign)
    want = pallas_global_ilv.global_ilv_raw_call(
        jnp.asarray(raw), batch, rplan, sign, rkeys, rarrs, BIG_CFG, scale=scale)
    assert want is not None
    got = _port_run("global_ilv", plan, raw, batch, sign, scale)
    _check(got, want, raw, batch, n, sign, scale)


@pytest.mark.parametrize("a", [1, 2, 3, 4, 6, 8, 9, 12, 16])
def test_mixed_radix_dft_is_the_dft_matrix(a):
    """The slab DFT (radix 2, then radix 3, snapped constants, natural order
    in and out) is the A-point DFT matrix, both signs, and ``ilv_factor``
    is the reference's."""
    rng = np.random.default_rng(a)
    x = rng.uniform(-1, 1, (a, 5)) + 1j * rng.uniform(-1, 1, (a, 5))
    for sign in (-1, +1):
        slabs = [(torch.from_numpy(r.real.copy()), torch.from_numpy(r.imag.copy()))
                 for r in x]
        got = np.stack([r.numpy() + 1j * i.numpy()
                        for r, i in torch_fft.mixed_radix_dft(slabs, sign)])
        w = np.exp(sign * 2j * np.pi * np.outer(np.arange(a), np.arange(a)) / a)
        assert np.allclose(got, w @ x, atol=1e-12)
    assert torch_fft.ilv_factor(a * 128) == a
    assert torch_fft.ilv_factor(a * 128) == pallas_global_ilv.ilv_factor(a * 128)
    assert torch_fft.ilv_factor(5 * 128) == torch_fft.ilv_factor(18 * 128) == 0


# -- K19 global_bf2 ------------------------------------------------------------------


@pytest.mark.parametrize("g1,g2,sign,scale,batch", [
    (512, 256, -1, 1.0, 1),   # the 2^17 split
    (512, 256, -1, 0.5, 1),   # folded scale
    (256, 256, -1, 1.0, 1),   # A1 = A2 = 2
    (256, 512, +1, 1.0, 1),   # backward, A2 = 4
    (512, 512, -1, 1.0, 1),   # two columns of B2
])
def test_k19_plain_matches_global_bf2_raw_call(g1, g2, sign, scale, batch):
    """K19's plain version (GB formed from the factors B1ᵀ and B2) against
    ``global_bf2_raw_call`` in interpret mode at its own ``t1`` = 128."""
    n = g1 * g2
    rplan, plan = _plans(g1, g2, BIG_CFG)
    assert pallas_global_bf.global_bf_supported(rplan, BIG_CFG)
    assert cuda_global_bf.global_bf2_supported(plan)
    raw = _input(batch, n, 9)
    rkeys, rarrs = _ref_arrays(rplan, sign)
    want = pallas_global_bf.global_bf2_raw_call(
        jnp.asarray(raw), batch, rplan, sign, rkeys, rarrs, BIG_CFG, scale=scale,
        t1_override=torch_fft.BF2_T1)
    assert want is not None
    got = _port_run("global_bf2", plan, raw, batch, sign, scale)
    _check(got, want, raw, batch, n, sign, scale)


def test_k19_tiles_fit_beside_the_resident_tables():
    """B1ᵀ (128 KiB) and B2 leave one block an SM: 8 columns at 512 points,
    one at 2048; every plan K5 takes fits."""
    assert [cuda_global_bf.bf2_tile(g, 512) for g in (128, 512, 1024, 2048)] \
        == [8, 8, 4, 1]
    for n in (65536, 1 << 17, 1 << 18, 1 << 19, 1 << 20, 1 << 21, 1 << 22):
        plan = plan_1d(n, CFG, 4)
        assert (cuda_global_bf.global_bf2_supported(plan)
                == cuda_global_bf.global_bf_supported(plan))


# -- the tuned route end to end -------------------------------------------------------


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


@pytest.fixture
def ref_calls(monkeypatch):
    """The names of the reference's GLOBAL kernels that ran."""
    calls = []
    for mod, name in ((pallas_global, "global_fused_raw_call"),
                      (pallas_global, "global2_raw_call"),
                      (pallas_global_ilv, "global_ilv_raw_call"),
                      (pallas_global_bf, "global_bf2_raw_call"),
                      (pallas_global_bf, "global_bf_raw_call")):
        fn = getattr(mod, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            res = _fn(*a, **k)
            if res is not None:
                calls.append(_name)
            return res

        monkeypatch.setattr(mod, name, wrapped)
    return calls


@pytest.mark.parametrize("n,params,engine,call", [
    (65536, {"eng": 6, "t1": 64, "t2": 128}, "global_fused", "global_fused_raw_call"),
    (65536, {"eng": 6, "t1": 64, "t2": 128, "ftw": 1}, "global_fused_ftw",
     "global_fused_raw_call"),
    (65536, {"eng": 8, "t1": 128}, "global_ilv", "global_ilv_raw_call"),
    (65536, {"eng": 7, "bf2": 1, "t1": 128}, "global_bf2", "global_bf2_raw_call"),
    (147456, {"eng": 8, "t1": 128}, "global_ilv", "global_ilv_raw_call"),
])
def test_tuned_route_matches_the_reference(tmp_caches, ref_calls, n, params,
                                           engine, call):
    """The same tuned entry recorded in both packages' caches: the port's
    commit fixes the engine's kernel, the reference runs its Pallas kernel,
    and ``compute_forward``/``compute_backward`` agree at 65536 × 2 and at
    the mixed-radix 147456 = 384 × 384 (both planners' split)."""
    batch = 2 if n == 65536 else 1
    kw = dict(lengths=[n], number_of_transforms=batch, forward_scale=0.5)
    rdesc, desc = ref.Descriptor(**kw), pf.Descriptor(**kw)
    assert plan_1d(n, CFG, 4).describe() == ref_plan_1d(n, RefConfig(), 4).describe()
    probe = desc.commit(device="cpu")
    key = tuning._entry_key(probe, "global2")
    tuning.record("cpu", "global2", key, params)
    rprobe = rdesc.commit(use_pallas=True)
    assert ref_tuning._entry_key(rprobe, "global2") == key
    ref_tuning.record(rprobe.config.name, "global2", key, params)
    rplan = rdesc.commit(use_pallas=True)
    plan = desc.commit(device="cpu")
    assert plan._raw_fast[pf.Direction.FORWARD].engine.name == engine
    raw = _input(batch, n, 3)
    for sign, scale, rcompute, compute in (
            (-1, 0.5, rplan.compute_forward, plan.compute_forward),
            (+1, 1.0, rplan.compute_backward, plan.compute_backward)):
        ref_calls.clear()
        want = np.asarray(rcompute(raw.copy())).reshape(-1).view(np.float32)
        assert ref_calls == [call]
        got = compute(torch.from_numpy(raw.copy())).numpy()
        _check(got, want, raw, batch, n, sign, scale)


# -- gates, variants, tables ------------------------------------------------------------

#: The GLOBAL lengths up to 2^20 whose subs are multiples of 128 (the
#: planner's splits) where the reference's gate at its default 16 MiB of VMEM
#: declines a plan the port takes (ROADMAP Queue 3): engine 8 where
#: ``ilv_est_bytes`` at t1 = 128 overflows twice the VMEM (a FUSED [16, 128]
#: G1), bf2 where ``global_bf_supported``'s estimate does.  Engine 6's gate
#: takes all nine.
REF_DECLINES = {
    "global_fused": set(),
    "global_ilv": {524288, 786432, 1048576},
    "global_bf2": {524288, 1048576},
}


def test_gates_against_the_references():
    """Every GLOBAL length up to 2^20 whose subs are multiples of 128 (nine:
    65536 … 2^20, 98304, 147456, 196608, 786432): K17 takes every such
    plan (its factored mode where the factored tables exist), K18 every
    plan whose factors are 2^a·3^b ≤ 16, K19 every plan K5 takes; the
    reference's gates (``global_fused_supported``, ``global_ilv_supported``,
    ``global_bf_supported`` with ``bf2_est_bytes``) take a subset, and
    decline exactly the recorded lengths more."""
    cfg = RefConfig()
    lengths = [n for n in range(16384, (1 << 20) + 1, 16384)
               if plan_1d(n, CFG, 4).level == Level.GLOBAL
               and all(s.n % 128 == 0 for s in plan_1d(n, CFG, 4).sub)]
    assert len(lengths) == 9 and {147456, 196608, 786432} <= set(lengths)
    declines = {k: set() for k in REF_DECLINES}
    for n in lengths:
        plan, rplan = plan_1d(n, CFG, 4), ref_plan_1d(n, cfg, 4)
        assert plan.describe() == rplan.describe()
        g1, g2 = (s.n for s in plan.sub)
        mixed = bool(torch_fft.ilv_factor(g1) and torch_fft.ilv_factor(g2))
        assert cuda_global.global_fused_supported(plan)
        assert cuda_global.global_fused_supported(plan, ftw=True) == bool(
            torch_fft.ftw_factors(plan))
        assert cuda_global_ilv.global_ilv_supported(plan) == mixed
        assert (cuda_global_bf.global_bf2_supported(plan)
                == cuda_global_bf.global_bf_supported(plan))
        theirs = {
            "global_fused": pallas_global.global_fused_supported(rplan, cfg),
            "global_ilv": pallas_global_ilv.global_ilv_supported(rplan, cfg),
            "global_bf2": pallas_global_bf.global_bf_supported(rplan, cfg) and any(
                g2 % t1 == 0 and pallas_global_bf.bf2_est_bytes(rplan, t1)
                <= 2 * cfg.vmem_bytes for t1 in (128, 256, 512)),
        }
        for engine, takes in theirs.items():
            ours = ENGINES[engine].gate(plan, 1, 0)
            assert ours or not takes, (engine, n)
            if ours and not takes:
                declines[engine].add(n)
    assert declines == REF_DECLINES


@pytest.mark.parametrize("n", [65536, 1 << 17, 147456, 196608, 1 << 19, 1 << 20])
def test_variants_and_engines_of_the_references(n):
    """``_variants_1d`` lists each new engine exactly where its gate takes
    the plan, and ``engine_of`` maps every parameter set the reference's
    ``_variants_1d`` emits for ``global2`` to a kernel here (engine 2's
    ``ftw`` on K3-ftw)."""
    plan = pf.Descriptor(lengths=[n], number_of_transforms=2).commit(device="cpu")
    variants = race._variants_1d(plan, "global2", n, 2)
    p0 = plan.plans[n]
    for engine in ENGINES.values():
        if engine.kind == "global2":
            assert (engine.params in variants) == engine.gate(p0, 1, 0)
    assert {"eng": 6} in variants and {"eng": 6, "ftw": 1} in variants
    assert ({"eng": 8} in variants) == bool(
        torch_fft.ilv_factor(p0.sub[0].n) and torch_fft.ilv_factor(p0.sub[1].n))
    rplan = ref.Descriptor(lengths=[n], number_of_transforms=2).commit(use_pallas=True)
    emitted = ref_tuning._variants_1d(rplan, "global2", n)
    engines = {engine_of(p, p0).name for p in emitted}
    assert {"global2", "global3"} <= engines
    assert engine_of({"eng": 2, "t1": 64, "t2": 256, "ftw": 1}, p0).name \
        == "global2_ftw"
    for p in emitted:
        want = {2: "global2", 3: "global3", 5: "global_sq", 8: "global_ilv"}.get(
            p["eng"] if p else 2)
        if p.get("eng") == 2 and p.get("ftw"):
            want = "global2_ftw"
        if p.get("eng") == 6:
            want = "global_fused_ftw" if p.get("ftw") else "global_fused"
        if p.get("eng") == 7:
            want = ("global_bf2" if p.get("bf2") else
                    "global_bf_ov" if p.get("ov") else "global_bf")
        assert engine_of(p, p0).name == want, p


@pytest.mark.parametrize("n,engines", [
    (65536, ("global_fused", "global_fused_ftw", "global_ilv", "global_bf2")),
    (1 << 19, ("global_fused_ftw", "global_bf2")),
    (147456, ("global_fused_ftw", "global_ilv")),
])
def test_plain_runs_on_tables_carried_from_the_reference(n, engines):
    """The plain versions give the same result, bit for bit, on the tables
    carried from the reference's bank (``convert.bank_from_reference``:
    ``GA``, ``GB``, ``U``, ``Q``, ``ZQ``, ``G2L`` under the same names) as
    on the port's own.  For a mixed split the reference banks the 128-point
    DFT only as its stacked bf16 ``ILL``/``ILR``, so ``W128`` stays the
    port's."""
    rplan = ref_plan_1d(n, RefConfig(), 4)
    plan = plan_1d(n, CFG, 4)
    raw = _input(1, n, 13)
    for sign in (-1, +1):
        rbank = xla_fft.TwiddleBank(np.float32)
        xla_fft.collect_bank_keys(rplan, sign, rbank)
        carried = convert.bank_from_reference(rbank.host, "cpu")
        keys, own = _port_arrays(plan, sign)
        new = [keys[k] for k in keys if k[0] in ("GA", "GB", "U", "Q", "ZQ", "G2L")]
        assert len(new) >= 3
        for name in new:
            parts = [nm for nm in own if nm.startswith(name)]
            assert parts and all(torch.equal(own[nm], carried[nm]) for nm in parts)
        for engine in engines:
            want = _port_run(engine, plan, raw, 1, sign, 0.5)
            got = _port_run(engine, plan, raw, 1, sign, 0.5, {**own, **carried})
            assert np.array_equal(want, got), engine


def test_bank_bytes_of_the_new_tables():
    """The tables the new engines add to a plan's bank, per direction (PERF.md
    §3): K17's factored Q or ZQ (64 columns), K19's G2L (B1ᵀ 128 × 128 and
    B2), and for a mixed split K18's U, GA and GB."""
    def nbytes(n, kinds):
        plan = plan_1d(n, CFG, 4)
        bank, keys = torch_fft.TwiddleBank(np.float32), {}
        torch_fft.collect_bank_keys(plan, -1, bank, keys)
        names = {keys[k] for k in keys if k[0] in kinds}
        return sum(a.nbytes for k, a in bank.host.items()
                   if a is not None and any(k.startswith(m) for m in names))

    assert nbytes(65536, ("Q",)) == 8 * (64 * 128 + 64 * 2 + 4 * 128 + 4 * 2)
    assert nbytes(1 << 20, ("ZQ",)) == 8 * (2 * 64 * 128 + 2 * 8 * 128)
    assert nbytes(65536, ("G2L",)) == 8 * (128 * 128 + 2 * 128)
    assert nbytes(1 << 20, ("G2L",)) == 8 * (128 * 128 + 4 * 128)
    assert nbytes(147456, ("U", "GA", "GB")) == 8 * (3 * 128 + 3 * 384 + 128 * 384)
