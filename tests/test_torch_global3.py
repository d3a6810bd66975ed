"""K16 (``cuda_global.global3``, GLOBAL engine 3 on the tensor cores)
against the JAX package's ``pallas_global3.build_call`` (Pallas, interpret
mode) and ``np.fft``, on the CPU, where the wrapper runs its plain version:
the TF32 hi/lo split of ``csrc/fft_mma.cuh`` emulated in torch, and the
twiddle from the factored tables and per-tile factors as the kernel forms
it.

The reference runs as its own tests run it (``tests/test_v3_kernels.py``
``test_global3_via_fastpath_override``): ``fastpath.build_fn(...,
overrides={"eng": 3, "t1": 256, "t2": 256})``.  The port takes ``{"eng":
3}`` with the same TPU tile knobs, which it ignores.  Tolerances: both
within the oracle's per-element 2·eps·N·log2N of ``np.fft``; port against
reference a relative 2-norm of 1e-4, the reference's own bound.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
import portfft_tpu as ref
import portfft_tpu_torch as pt
from portfft_tpu import fastpath as ref_fastpath
from portfft_tpu.config import DeviceConfig as RefConfig
from portfft_tpu.ops import pallas_global, pallas_global3
from portfft_tpu.planner import plan_1d as ref_plan_1d
from portfft_tpu_torch import convert, fastpath
from portfft_tpu_torch.config import DeviceConfig
from portfft_tpu_torch.engines import ENGINES
from portfft_tpu_torch.ops import cuda_global, torch_fft
from portfft_tpu_torch.planner import plan_1d

REF_CFG = RefConfig(name="cpu")
CFG = DeviceConfig()
ENGINE3 = {"eng": 3, "t1": 256, "t2": 256}


@pytest.fixture
def ref_calls(monkeypatch):
    """The reference's GLOBAL kernels that its build ran: ``build_call``
    (both pallas_calls of engine 3) as "global3", its two-pass engine as
    "global2"."""
    calls = []

    def recording(mod, name, kind):
        fn = getattr(mod, name)

        def wrapped(*a, **k):
            res = fn(*a, **k)
            if res is not None:
                calls.append(kind)
            return res

        monkeypatch.setattr(mod, name, wrapped)

    recording(pallas_global3, "build_call", "global3")
    recording(pallas_global, "global2_raw_call", "global2")
    return calls


def _rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("n,batch,scale", [(65536, 2, 0.25), (524288, 1, 1.0)])
def test_engine3_matches_reference(ref_calls, n, batch, scale):
    """65536 = 256 x 256 both ways with scale 0.25, and 2^19 = [16, 128] x
    256 (a FUSED G1): the port's ``{"eng": 3}`` entry runs K16 once a
    direction where the reference's build runs engine 3 (its two
    pallas_calls), the values within the oracle bound and 1e-4 of each
    other."""
    kw = dict(lengths=[n], number_of_transforms=batch, forward_scale=scale,
              backward_scale=scale)
    rdesc, pdesc = ref.Descriptor(**kw), pt.Descriptor(**kw)
    rplan = rdesc.commit(use_pallas=True)
    plan = pdesc.commit(device="cpu")
    assert plan.plan_description() == rplan.plan_description()
    canon = oracle.gen_input(rdesc, seed=n + batch)
    raw = canon.reshape(-1).view(np.float32)
    for rdir, pdir in zip(ref.Direction, pt.Direction):
        ref_calls.clear()
        fn = ref_fastpath.build_fn(rplan, rdir, rplan._raw_fast[rdir],
                                   2 * batch * n, overrides=ENGINE3)
        want = np.asarray(fn(jnp.asarray(raw), rplan._bank_arrays))
        assert ref_calls == ["global3"]
        entry = fastpath.with_engine(plan, plan._raw_fast[pdir], ENGINE3)
        assert entry.tuning_kind == "global2" and entry.engine.name == "global3"
        kernel, args = entry.kernel_args(plan)
        assert kernel is cuda_global.global3 and args[-1] == scale
        got = fastpath.build_fn(plan, entry)(torch.from_numpy(raw.copy())).numpy()
        expect = oracle.reference_output(rdesc, canon, rdir)
        for y in (want, got):
            oracle.verify(rdesc, y.view(np.complex64), expect, rdir,
                          check_padding=False)
        assert _rel(got.view(np.complex64), want.view(np.complex64)) <= 1e-4


@pytest.mark.parametrize("n", [65536, 1 << 17, 1 << 18, 196608, 1 << 19, 1 << 20,
                               1 << 21, 327680, 100000])
def test_gate_is_the_references(n):
    """K16 takes the GLOBAL plans ``global3_supported`` takes, and its
    digits are the reference's."""
    plan, rplan = plan_1d(n, CFG, 4), ref_plan_1d(n, REF_CFG, 4)
    want = pallas_global3.global3_supported(rplan, REF_CFG)
    assert cuda_global.global3_supported(plan) == want
    if want:
        g1 = plan.sub[0]
        digits = (pallas_global3.digit_split(g1.n) if g1.level.name == "DIRECT"
                  else (g1.factors[0], 128))
        assert torch_fft.global3_digits(plan) == digits


def test_no_plan_needs_engine3():
    """The reference routes engine 3 statically where its two-pass engine
    declines the plan (``fastpath.py:741-745``).  In the port K3 takes
    every plan K16 takes (subs DIRECT or [a, 128] up to 8192), so no plan
    reaches K16 without a tuned entry: a sweep of every multiple of 128²
    up to 2^24 (128 divides both of K16's subs) finds none K3 declines."""
    found = []
    for n in range(16384, (1 << 24) + 1, 16384):
        plan = plan_1d(n, CFG, 4)
        if cuda_global.global3_supported(plan):
            found.append(n)
            assert ENGINES["global2"].gate(plan), n
    assert {65536, 1 << 17, 1 << 18, 196608, 1 << 19, 1 << 20} <= set(found)


def test_twiddle_is_the_four_step_twiddle():
    """The factored twiddle (tables at width 64 and per-tile factors) is
    w_n^(k1·n2) within a few float32 roundings: the bank's dense (G2, G1)
    table, which K3 streams."""
    for n in (65536, 1 << 19):
        plan = pt.Descriptor(lengths=[n]).commit(device="cpu")
        p = plan.plans[n]
        g1, g2 = p.sub
        for sign in (-1, +1):
            t = cuda_global.global3_tables(p, sign, plan._bank_keys,
                                           plan._bank_arrays)
            (c1r, c1i), (c2r, c2i) = cuda_global.global3_twiddle(t)
            tr, ti = torch_fft.complex_mul(c1r, c1i, c2r, c2i)
            dense = plan._bank_keys[("T", g1.n, g2.n, sign)]
            assert (tr - plan._bank_arrays[dense + "r"].T).abs().max() <= 4e-7
            assert (ti - plan._bank_arrays[dense + "i"].T).abs().max() <= 4e-7


def test_plain_runs_on_tables_carried_from_the_reference():
    """K16's plain version gives the same result on the ``G…`` tables
    carried from the reference's bank (``convert.bank_from_reference``) as
    on the port's own: the same keys and the same float32 arrays."""
    n, batch = 65536, 2
    kw = dict(lengths=[n], number_of_transforms=batch, forward_scale=0.5)
    rplan = ref.Descriptor(**kw).commit(use_pallas=True)
    plan = pt.Descriptor(**kw).commit(device="cpu")
    carried = convert.bank_from_reference(rplan._bank.host, "cpu")
    x = torch.from_numpy(oracle.gen_input(rplan.descriptor, seed=5)
                         .reshape(-1).view(np.float32).copy())
    for sign in (-1, +1):
        key = plan._bank_keys[("G3", 256, 256, sign)]
        assert key == f"G{'f' if sign < 0 else 'b'}16x16N65536t64"
        for suf in ("1r", "1i", "2r", "2i"):
            assert torch.equal(carried[key + suf], plan._bank_arrays[key + suf])
        want = cuda_global.global3(x, batch, cuda_global.global3_tables(
            plan.plans[n], sign, plan._bank_keys, plan._bank_arrays), 0.5)
        got = cuda_global.global3(x, batch, cuda_global.global3_tables(
            plan.plans[n], sign, plan._bank_keys, carried), 0.5)
        assert torch.equal(got, want)
