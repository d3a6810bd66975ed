"""K10-mm (``cuda_multidim.col_mm``, the tensor-core column kernel) against
the JAX package's ``col_raw_mm_call`` (Pallas, interpret mode) and
``np.fft``, on the CPU, where the wrapper runs its plain version: the TF32
hi/lo split of ``csrc/fft_mma.cuh`` emulated in torch.

The reference runs as its own tests run it (``tests/test_pallas_kernels.py``
``test_pallas_multidim_cm_variant``): ``fastpath.build_fn(...,
overrides=params)`` on the committed plan's entry.  The port takes the same
parameters through ``fastpath.with_engine``.  Tolerances: both within the
oracle's per-element 2·eps·N·log2N of ``np.fft``; port against reference a
relative 2-norm of 1e-4, the reference's own bound at its bf16×3 grade.
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
from portfft_tpu.ops import pallas_fft, pallas_multidim, xla_fft
from portfft_tpu.planner import plan_1d as ref_plan_1d
from portfft_tpu_torch import fastpath
from portfft_tpu_torch.config import DeviceConfig
from portfft_tpu_torch.ops import cuda_fft, cuda_multidim, torch_fft
from portfft_tpu_torch.planner import plan_1d

REF_CFG = RefConfig(name="cpu")
CFG = DeviceConfig()

# The reference's kernel functions and the port's step kinds they map to.
REF_KERNELS = {
    (pallas_fft, "direct_raw_call"): "direct",
    (pallas_fft, "fused2_raw_mm_call"): "fused2",
    (pallas_multidim, "col_raw_call"): "col",
    (pallas_multidim, "col_raw_mm_call"): "col_mm",
    (pallas_multidim, "md2_fused_raw_call"): "md2",
}


@pytest.fixture
def ref_calls(monkeypatch):
    """The port kinds of the reference's kernel calls that returned a
    result, in the order its fast path ran them."""
    calls = []
    for (mod, name), kind in REF_KERNELS.items():
        fn = getattr(mod, name)

        def wrapped(*a, _fn=fn, _kind=kind, **k):
            res = _fn(*a, **k)
            if res is not None:
                calls.append(_kind)
            return res

        monkeypatch.setattr(mod, name, wrapped)
    return calls


def _rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _run_both(rdesc, pdesc, params, seed):
    """Both packages' forward and backward results of ``params`` on the
    same seeded input, and the port's entries; yields per direction
    ``(rdir, canon, reference result, port result, port entry)``."""
    rplan = rdesc.commit(use_pallas=True)
    plan = pdesc.commit(device="cpu")
    assert plan.plan_description() == rplan.plan_description()
    canon = oracle.gen_input(rdesc, seed=seed)
    total = rdesc.number_of_transforms * rdesc.get_flattened_length()
    for rdir, pdir in zip(ref.Direction, pt.Direction):
        flat = oracle.materialize(rdesc, canon, rdir)
        raw = np.ascontiguousarray(flat).view(np.float32)
        fn = ref_fastpath.build_fn(rplan, rdir, rplan._raw_fast[rdir], 2 * total,
                                   overrides=params)
        want = np.asarray(fn(jnp.asarray(raw), rplan._bank_arrays)).view(np.complex64)
        entry = fastpath.with_engine(plan, plan._raw_fast[pdir], params)
        got = fastpath.build_fn(plan, entry)(torch.from_numpy(raw.copy()))
        yield rdir, canon, want, got.numpy().view(np.complex64), entry


def _descs(lengths, batch, **kw):
    n = int(np.prod(lengths))
    kw = dict(lengths=lengths, number_of_transforms=batch, forward_scale=0.5,
              backward_scale=1.0 / n, **kw)
    return ref.Descriptor(**kw), pt.Descriptor(**kw)


# (lengths, batch, params, kernels in order).  K11 takes both 2D shapes by
# default, so {"cm": 1} alone runs no column step there; {"m2": 0} turns it
# off.  L = 2 and L = 8 are no multiples of 128: both packages run K10.
CM_ROUTES = [
    ([128, 256], 2, {"cm": 1}, ("md2",)),
    ([128, 256], 2, {"m2": 0, "cm": 1}, ("direct", "col_mm")),
    ([1024, 128], 1, {"m2": 0, "cm": 1}, ("direct", "col_mm")),
    ([2, 128, 128], 1, {"cm": 1}, ("md2", "col")),
    ([256, 8, 32], 1, {"cm": 1}, ("direct", "col", "col_mm")),
]


@pytest.mark.parametrize("lengths,batch,params,kinds", CM_ROUTES)
def test_cm_route_and_values_match_reference(ref_calls, lengths, batch, params,
                                             kinds):
    """The same kernels, call for call, as the reference's ``{"cm": 1}``
    build; values within the oracle bound and 1e-4 of each other; the scale
    on the last step only."""
    rdesc, pdesc = _descs(lengths, batch)
    for rdir, canon, want, got, entry in _run_both(rdesc, pdesc, params,
                                                   sum(lengths) + batch):
        assert tuple(ref_calls) == kinds
        ref_calls.clear()
        assert entry[0] == "multidim"
        assert tuple(step[0] for step in entry[2]) == kinds
        scale = float(pdesc.get_scale(pt.Direction(rdir.value)))
        assert [step[-1] for step in entry[2]] == [1.0] * (len(kinds) - 1) + [scale]
        expect = oracle.reference_output(rdesc, canon, rdir)
        for y in (want, got):
            oracle.verify(rdesc, y, expect, rdir, check_padding=False)
        assert _rel(got, want) <= 1e-4


def test_bi_col_cm_matches_reference(ref_calls):
    """BATCH_INTERLEAVED 1D (n = 256, b = 128) through K10-mm, as the
    reference's ``bi_col`` entry with ``{"cm": 1}``."""
    n, b = 256, 128
    kw = dict(forward_strides=[b], forward_distance=1, backward_strides=[b],
              backward_distance=1)
    rdesc, pdesc = _descs([n], b, **kw)
    for rdir, canon, want, got, entry in _run_both(rdesc, pdesc, {"cm": 1}, 22):
        assert ref_calls == ["col_mm"]
        ref_calls.clear()
        assert entry[0] == "bi_col" and entry[6] == "col_mm"
        expect = oracle.reference_output(rdesc, canon, rdir)
        for y in (want, got):
            oracle.verify(rdesc, y, expect, rdir, check_padding=False)
        assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("length", [128, 384, 512, 1024, 2048])
@pytest.mark.parametrize("sign", [-1, +1])
def test_plain_matches_reference_kernel(length, sign):
    """K10-mm's plain version against ``col_raw_mm_call`` on one (bpre, L,
    rest) view: DIRECT 128, 384 and 512, FUSED [8, 128] and [16, 128], with
    a scale."""
    bpre, rest, scale = 2, 64, 0.5
    rplan = ref_plan_1d(length, REF_CFG, 4)
    bank = xla_fft.TwiddleBank(np.float32)
    names = pallas_multidim.col_mm_table_names(rplan, sign, bank)
    x = np.random.default_rng(length).uniform(
        -1, 1, 2 * bpre * length * rest).astype(np.float32)
    want = pallas_multidim.col_raw_mm_call(
        jnp.asarray(x), bpre, rplan, 2 * rest, sign, names, bank.device_arrays(),
        REF_CFG, None, scale)
    assert want is not None
    plan = pt.Descriptor(lengths=[length]).commit(device="cpu")
    sub = cuda_fft.sub_tables(plan.plans[length], sign, plan._bank_keys,
                              plan._bank_arrays)
    got = cuda_multidim.col_mm(torch.from_numpy(x), bpre, rest, sub, scale)
    got = got.numpy().view(np.complex64).reshape(bpre, length, rest)
    want = np.asarray(want).view(np.complex64).reshape(bpre, length, rest)
    xc = x.view(np.complex64).reshape(bpre, length, rest).astype(np.complex128)
    exact = (np.fft.fft(xc, axis=1) if sign < 0
             else np.fft.ifft(xc, axis=1) * length) * scale
    tol = oracle.tolerance(ref.Descriptor(lengths=[length]))
    for y in (got, want):
        diff = np.abs(y - exact)
        assert np.all((diff <= tol) | (diff <= tol * np.abs(exact))), diff.max()
    assert _rel(got, want) <= 1e-4


def test_gate_and_the_recorded_routing_differences():
    """K10-mm's gate is the reference's shape rule (128 | L; DIRECT ≤ 512 or
    FUSED [a, 128], a | 128): it declines every
    length that is no multiple of 128 (K10 runs them, as the reference's
    falls back) and takes 4096 … 16384, which the reference's VMEM
    estimate declines (ROADMAP Queue 3)."""
    for length in (100, 200, 640, 3072):
        assert not cuda_multidim.col_mm_supported(plan_1d(length, CFG, 4))
        rplan = ref_plan_1d(length, REF_CFG, 4)
        if rplan.level.name == "DIRECT":
            bank = xla_fft.TwiddleBank(np.float32)
            assert pallas_multidim.col_mm_table_names(rplan, -1, bank) is None
    for length in (128, 256, 384, 512, 1024, 2048):
        assert cuda_multidim.col_mm_supported(plan_1d(length, CFG, 4))
    for length in (4096, 8192, 16384):
        plan = plan_1d(length, CFG, 4)
        assert cuda_multidim.col_mm_supported(plan)
        rplan = ref_plan_1d(length, REF_CFG, 4)
        bank = xla_fft.TwiddleBank(np.float32)
        names = pallas_multidim.col_mm_table_names(rplan, -1, bank)
        raw = jnp.zeros(2 * length * 64, jnp.float32)
        assert pallas_multidim.col_raw_mm_call(
            raw, 1, rplan, 128, -1, names, bank.device_arrays(), REF_CFG) is None


@pytest.mark.parametrize("value,want", [
    (1.0 + 2.0**-11, 1.0 + 2.0**-10),    # a tie rounds away from zero
    (-(1.0 + 2.0**-11), -(1.0 + 2.0**-10)),
    (1.0 + 2.0**-12, 1.0),                # below the tie rounds down
    (1.0 + 3 * 2.0**-12, 1.0 + 2.0**-10),
    (0.0, 0.0),
])
def test_tf32_round_is_cvt_rna(value, want):
    """``tf32_round`` keeps 10 mantissa bits, rounding to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32``."""
    got = torch_fft.tf32_round(torch.tensor([value], dtype=torch.float32))
    assert got.item() == want


def test_tf32_split_keeps_22_bits():
    """hi + lo represents x to 2^-22 of x, hi and lo each with 10 mantissa
    bits: the three-term product misses the fp32 one by about 3·2^-22."""
    x = torch.from_numpy(np.random.default_rng(0).uniform(-4, 4, 4096)
                         .astype(np.float32))
    hi, lo = torch_fft.tf32_split(x)
    for part in (hi, lo):
        assert torch.all(part.view(torch.int32) & 0x1FFF == 0)
    assert torch.all((hi.double() + lo.double() - x.double()).abs()
                     <= 2.0**-22 * x.double().abs())
    w = torch.from_numpy(np.random.default_rng(1).uniform(-1, 1, (64, 64))
                         .astype(np.float32))
    y = torch.from_numpy(np.random.default_rng(2).uniform(-1, 1, (64, 8))
                         .astype(np.float32))
    zr, zi = torch_fft.dft_x3(w, torch.zeros_like(w), y, torch.zeros_like(y))
    exact = w.double() @ y.double()
    assert torch.all(zi == 0)
    assert (zr.double() - exact).abs().max() <= 64 * 4 * 2.0**-22
