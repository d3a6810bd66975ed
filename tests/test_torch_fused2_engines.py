"""The FUSED engines of portfft_tpu_torch against the Pallas kernels they
replace, on the CPU: K2-v1 (``cuda_fft.fused2_v1``) against
``pallas_fft.fused2_raw_call``, K2-v2 (``fused2_v2``) against
``fused2_raw_v2_call`` and K2-v3 (``fused2_v3``) against
``fused2_raw_v3_call``; then the ``fused2`` entry's engine, fixed at commit
from the tuning table, and ``autotune`` of the ``fused2`` kind.

The reference kernels run in interpret mode through the reference's own
fast path, as its tests run them (``tests/test_v3_kernels.py``:
``fastpath.build_fn(..., overrides={"eng": 2|3, "bt": ...})`` on
``commit(use_pallas=True)``); each case records which of its kernels ran.
The port's wrappers receive CPU tensors and so run their plain versions.
Inputs are made with numpy from a seed and handed to both.

Tolerance: every element of the port's and the reference's result within
``oracle.tolerance`` (2·eps·N·log2N, absolute or relative) of ``np.fft``,
and the port within the same bound of the reference.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
import portfft_tpu as ref
from portfft_tpu import fastpath as ref_fastpath
from portfft_tpu import tuning as ref_tuning
from portfft_tpu.enums import Direction as RefDirection
from portfft_tpu.ops import pallas_fft
import portfft_tpu_torch as pf
from portfft_tpu_torch import fastpath, race, tuning
from portfft_tpu_torch.engines import engine_of
from portfft_tpu_torch.config import DeviceConfig
from portfft_tpu_torch.ops import cuda_fft, torch_fft
from portfft_tpu_torch.planner import plan_1d

CFG = DeviceConfig()
FWD, BWD = pf.Direction.FORWARD, pf.Direction.BACKWARD
REF_FUSED = ("fused2_raw_call", "fused2_raw_v2_call", "fused2_raw_v3_call",
             "fused2_raw_mm_call")


@pytest.fixture
def ref_calls(monkeypatch):
    """``(kernel name, returned a result)`` of every reference FUSED kernel
    call, in order."""
    calls = []
    for name in REF_FUSED:
        fn = getattr(pallas_fft, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            res = _fn(*a, **k)
            calls.append((_name, res is not None))
            return res

        monkeypatch.setattr(pallas_fft, name, wrapped)
    return calls


@pytest.fixture
def tmp_caches(tmp_path, monkeypatch):
    """Temporary tuning caches for both packages."""
    monkeypatch.delenv("PORTFFT_NO_TUNING", raising=False)
    monkeypatch.setattr(tuning, "_USER_PATH", str(tmp_path / "port.json"))
    monkeypatch.setattr(ref_tuning, "_USER_PATH", str(tmp_path / "ref.json"))
    tuning._reset_for_tests()
    ref_tuning._reset_for_tests()
    yield tmp_path
    tuning._reset_for_tests()
    ref_tuning._reset_for_tests()


def _input(batch, n, seed):
    return np.random.default_rng(seed).uniform(-1, 1, 2 * batch * n).astype(np.float32)


def _scales(n):
    return {FWD: 0.5, BWD: 2.0 / n}


def _exact(raw, batch, n, sign, scale):
    xc = raw.view(np.complex64).reshape(batch, n).astype(np.complex128)
    return (np.fft.fft(xc) if sign < 0 else np.fft.ifft(xc) * n) * scale


def _within(y, want, tol):
    diff = np.abs(y - want)
    assert np.all((diff <= tol) | (diff <= tol * np.abs(want))), diff.max()


def _check(got, want, raw, batch, n, sign, scale):
    """Port and reference against np.fft, and the port against the
    reference, each at the oracle tolerance."""
    tol = oracle.tolerance(ref.Descriptor(lengths=[n], number_of_transforms=batch))
    exact = _exact(raw, batch, n, sign, scale)
    ys = [np.asarray(y).view(np.complex64).reshape(batch, n) for y in (got, want)]
    for y in ys:
        _within(y, exact, tol)
    _within(ys[0], ys[1].astype(np.complex128), tol)


def _ref_run(n, batch, direction, overrides, raw):
    """The reference's fast path for ``direction`` with ``overrides``."""
    rdesc = ref.Descriptor(lengths=[n], number_of_transforms=batch,
                           forward_scale=0.5, backward_scale=2.0 / n)
    rplan = rdesc.commit(use_pallas=True)
    rdir = RefDirection[direction.name]
    rroute = rplan._raw_fast[rdir]
    assert rroute[0] == "fused2"
    fn = ref_fastpath.build_fn(rplan, rdir, rroute, 2 * batch * n,
                               overrides=overrides)
    return np.asarray(fn(jnp.asarray(raw), rplan._bank_arrays))


def _port_sub(n, sign):
    plan = plan_1d(n, CFG, 4)
    bank, keys = torch_fft.TwiddleBank(np.float32), {}
    torch_fft.collect_bank_keys(plan, sign, bank, keys)
    return cuda_fft.sub_tables(plan, sign, keys, bank.device_arrays("cpu"))


# (port kernel, reference kernel, reference engine, n, batch, port bt,
# reference bt): a = 8, 32, 128 (fold 8, 2, 1) for K2-v2 and K2-v3 at the
# reference's own tiles ((bt·a) % 128 == 0 for v2, % 8 for v3); K2-v1 at
# the no-fold a = 5 and 24, which the reference's chain sends to v1.
PARITY = [
    ("fused2_v2", "fused2_raw_v2_call", 2, 1024, 16, 8, 16),
    ("fused2_v2", "fused2_raw_v2_call", 2, 4096, 4, 4, 4),
    ("fused2_v2", "fused2_raw_v2_call", 2, 16384, 2, 1, 1),
    ("fused2_v3", "fused2_raw_v3_call", 3, 1024, 4, 4, 1),
    ("fused2_v3", "fused2_raw_v3_call", 3, 4096, 4, 2, 4),
    ("fused2_v3", "fused2_raw_v3_call", 3, 16384, 2, 1, 1),
    ("fused2_v1", "fused2_raw_call", 2, 640, 8, None, None),
    ("fused2_v1", "fused2_raw_call", 2, 3072, 8, None, None),
]


@pytest.mark.parametrize("direction", [FWD, BWD], ids=["forward", "backward"])
@pytest.mark.parametrize("engine,ref_kernel,eng,n,batch,bt,ref_bt", PARITY)
def test_plain_matches_the_reference_kernel(ref_calls, engine, ref_kernel, eng, n,
                                            batch, bt, ref_bt, direction):
    """Each engine's plain version against the reference kernel it
    replaces, reached through the reference's fast path with the engine's
    override, in both directions with a scale."""
    sign, scale = (-1 if direction == FWD else +1), _scales(n)[direction]
    raw = _input(batch, n, n + batch + sign)
    overrides = {"eng": eng} if ref_bt is None else {"eng": eng, "bt": ref_bt}
    want = _ref_run(n, batch, direction, overrides, raw)
    assert (ref_kernel, True) in ref_calls, ref_calls
    sub = _port_sub(n, sign)
    kernel = getattr(cuda_fft, engine)
    args = (batch, sub, scale) if bt is None else (batch, sub, bt, scale)
    got = kernel(torch.from_numpy(raw), *args)
    _check(got.numpy(), want, raw, batch, n, sign, scale)


@pytest.mark.parametrize("n", [640, 3072])
def test_fold_zero_routes_differ_from_the_reference_as_recorded(ref_calls, n):
    """ROADMAP Queue 3: on a plan whose a has no fold the reference's static
    route declines v2 and runs v1 (``fused2_raw_v2_call`` → None, then
    ``fused2_raw_call``); the port's static route is K2.  Both agree with
    np.fft."""
    batch = 64
    raw = _input(batch, n, 5)
    want = _ref_run(n, batch, FWD, {}, raw)
    assert ref_calls == [("fused2_raw_v2_call", False), ("fused2_raw_call", True)]
    assert pallas_fft.fold_factor(n // 128) == torch_fft.fold_factor(n // 128) == 0
    plan = pf.Descriptor(lengths=[n], number_of_transforms=batch,
                         forward_scale=0.5, backward_scale=2.0 / n).commit(device="cpu")
    entry = plan._raw_fast[FWD]
    assert (entry.engine.name, entry.bt) == ("fused2", 0)
    kernel, _ = entry.kernel_args(plan)
    assert kernel is cuda_fft.fused2
    got = plan.compute_forward(torch.from_numpy(raw))
    _check(got.numpy(), want, raw, batch, n, -1, 0.5)


def test_fold_factor_is_the_reference_rule():
    for a in range(1, 300):
        assert torch_fft.fold_factor(a) == pallas_fft.fold_factor(a), a


# -- the fused2 entry's engine, fixed at commit ---------------------------------


def _commit(n, batch, **kw):
    return pf.Descriptor(lengths=[n], number_of_transforms=batch, **kw).commit(
        device="cpu")


def _fft_ok(plan, n, batch, seed=3):
    x = _input(batch, n, seed)
    y = plan.compute_forward(torch.from_numpy(x)).numpy()
    tol = oracle.tolerance(ref.Descriptor(lengths=[n], number_of_transforms=batch))
    _within(y.view(np.complex64).reshape(batch, n), _exact(x, batch, n, -1, 1.0), tol)


@pytest.mark.parametrize("n,batch,params,engine,bt", [
    (4096, 8, {"eng": 2, "bt": 4}, "fused2_v2", 4),
    (4096, 8, {"eng": 3, "bt": 2}, "fused2_v3", 2),
    (1024, 32, {"eng": 3, "bt": 16}, "fused2_v3", 16),
    (4096, 8, {"eng": 4, "bt": 8, "flat": 1}, "fused2", 0),  # the mm engine: K2
    (640, 4, {"eng": 2}, "fused2_v1", 0),   # no fold: engine 2 reaches v1
    (3072, 4, {"eng": 3, "bt": 8}, "fused2_v1", 0),  # and engine 3 too
])
def test_tuned_engine_is_fixed_at_commit(tmp_caches, n, batch, params, engine, bt):
    tuning.record("cpu", "fused2", f"n{n}", params)
    plan = _commit(n, batch)
    for direction in (FWD, BWD):
        route = plan._raw_fast[direction]
        assert (route.engine.name, route.bt) == (engine, bt)
    kernel, args = plan._raw_fast[FWD].kernel_args(plan)
    assert kernel is getattr(cuda_fft, engine)
    _fft_ok(plan, n, batch)


def test_a_tile_the_batch_cannot_take_is_dropped_not_stale(tmp_caches, monkeypatch):
    """The key holds no batch: a tuned bt of 4 at batch 6 is dropped with a
    trace, the kernel picks its tile (2), and the entry stays tuned."""
    from portfft_tpu_torch.utils import logging as plog

    msgs = []
    monkeypatch.setattr(plog, "trace", lambda *m: msgs.append(" ".join(map(str, m))))
    tuning.record("cpu", "fused2", "n4096", {"eng": 2, "bt": 4})
    plan = _commit(4096, 6)
    route = plan._raw_fast[FWD]
    assert (route.engine.name, route.bt) == ("fused2_v2", 0)
    _, (_, _, bt, _) = route.kernel_args(plan)
    assert bt == 2
    assert any("batch tile 4" in m for m in msgs), msgs
    assert tuning.lookup("cpu", "fused2", "n4096") == {"eng": 2, "bt": 4}
    assert not tuning.stale_entries("cpu")
    _fft_ok(plan, 4096, 6)


@pytest.mark.parametrize("n,params", [
    (32768, {"eng": 2, "bt": 1}),  # [256, 128]: one transform fits no block
    (14336, {"eng": 2}),           # [112, 128], no fold: K2-v1 does not fit
])
def test_a_declining_gate_marks_the_entry_stale(tmp_caches, monkeypatch, n, params):
    from portfft_tpu_torch.utils import logging as plog

    warns = []
    monkeypatch.setattr(plog, "warn", lambda *m: warns.append(" ".join(map(str, m))))
    tuning.record("cpu", "fused2", f"n{n}", params)
    plan = _commit(n, 2)
    route = plan._raw_fast[FWD]
    assert (route.engine.name, route.bt) == ("fused2", 0)
    assert any("stale tuned entry fused2" in w for w in warns), warns
    assert tuning.lookup("cpu", "fused2", f"n{n}") is None
    assert [k for (_, kind, k, _) in tuning.stale_entries("cpu")
            if kind == "fused2"] == [f"n{n}"]
    _fft_ok(plan, n, 2)


@pytest.mark.parametrize("params", [{"eng": 1}, {"eng": 5}, {"eng": 7, "ov": 1}])
def test_a_fused_engine_without_a_kernel_raises(tmp_caches, params):
    plan = _commit(4096, 2)
    with pytest.raises(pf.UnsupportedConfiguration, match="FUSED engine"):
        fastpath.with_engine(plan, plan._raw_fast[FWD], params)
    tuning.record("cpu", "fused2", "n4096", params)
    with pytest.raises(pf.UnsupportedConfiguration, match="FUSED engine"):
        _commit(4096, 2)


def test_explicit_tile_the_gate_declines_raises(tmp_caches):
    plan = _commit(4096, 8)
    with pytest.raises(pf.UnsupportedConfiguration, match="tile 8"):
        fastpath.with_engine(plan, plan._raw_fast[FWD], {"eng": 2, "bt": 8})


def test_real_and_layout_entries_take_the_tuned_engine(tmp_caches):
    """A REAL transform's half-length entry (n = 8192: h = 4096) and a
    strided descriptor's inner entry read the ``fused2`` key of their
    length, and their results hold."""
    tuning.record("cpu", "fused2", "n4096", {"eng": 3, "bt": 2})
    n, batch = 8192, 4
    plan = _commit(n, batch, domain=pf.Domain.REAL)
    entry = plan._raw_fast[FWD]
    assert isinstance(entry, fastpath.HalfReal) and entry.tangle == "untangle"
    assert (entry.inner.engine.name, entry.inner.bt) == ("fused2_v3", 2)
    x = np.random.default_rng(7).uniform(-1, 1, (batch, n)).astype(np.float32)
    y = plan.compute_forward(x.reshape(-1)).reshape(batch, -1)
    assert np.abs(y - np.fft.rfft(x)).max() <= oracle.tolerance(ref.Descriptor(lengths=[n]))
    lay = _commit(4096, 2, forward_strides=[2], forward_distance=2 * 4096)
    entry = lay._raw_fast[FWD]
    assert isinstance(entry, fastpath.Layout)
    assert (entry.inner.engine.name, entry.inner.bt) == ("fused2_v3", 2)
    x = _input(2, 2 * 4096, 4)
    y = lay.compute_forward(torch.from_numpy(x)).numpy()
    xs = x.view(np.complex64).reshape(2, 2 * 4096)[:, ::2]
    tol = oracle.tolerance(ref.Descriptor(lengths=[4096], number_of_transforms=2))
    _within(y.view(np.complex64).reshape(2, 4096), np.fft.fft(xs.astype(np.complex128)), tol)


def test_multidim_row_step_stays_k2(tmp_caches):
    tuning.record("cpu", "fused2", "n1024", {"eng": 2, "bt": 8})
    plan = pf.Descriptor(lengths=[4, 1024], number_of_transforms=2).commit(device="cpu")
    head = plan._raw_fast[FWD].steps[0]
    assert (head.engine.name, head.bt) == ("fused2", 0)


# -- variants and autotune --------------------------------------------------------


def test_variants_of_the_fused2_kind(tmp_caches):
    """``{}`` (K2) first, then engines 2 and 3 at each tile their gates take
    (K2-v2 up to 8, K2-v3 to what shared memory holds); on a plan with no
    fold ``{"eng": 2}`` (K2-v1) once; the reference races the same engines
    under the same kind and key."""
    v = [{"eng": e, "bt": b} for b in (1, 2, 4) for e in (2, 3)]
    cases = [(4096, 8, [{}, *v]), (4096, 6, [{}, *v[:4]]),
             (1024, 32, [{}, *[{"eng": e, "bt": b} for b in (1, 2, 4, 8)
                               for e in (2, 3)], {"eng": 3, "bt": 16}]),
             (16384, 4, [{}, {"eng": 2, "bt": 1}, {"eng": 3, "bt": 1}]),
             (640, 8, [{}, {"eng": 2}]), (12288, 3, [{}, {"eng": 2}])]
    for n, batch, want in cases:
        plan = _commit(n, batch)
        assert race._variants_for_entry(plan, plan._raw_fast[FWD]) == want, n
        assert tuning._entry_key(plan, "fused2") == f"n{n}"
    rplan = ref.Descriptor(lengths=[4096], number_of_transforms=8).commit(use_pallas=True)
    rvar = ref_tuning._variants_for_entry(rplan, rplan._raw_fast[RefDirection.FORWARD])
    assert {r.get("eng") for r in rvar} >= {2, 3}
    assert ref_tuning._entry_key(rplan, "fused2") == "n4096"


def test_autotune_records_under_the_fused2_key(tmp_caches):
    n, batch = 4096, 4
    plan = _commit(n, batch)
    times = {}
    won = plan.autotune(iters=1, times=times)
    assert len(times) == 7 and json.dumps(won, sort_keys=True) in times
    assert tuning.lookup("cpu", "fused2", "n4096") == won
    assert plan._raw_fast[BWD].engine == engine_of(won, plan.plans[n])
    _fft_ok(plan, n, batch)


def test_autotune_real_records_under_the_half_length(tmp_caches):
    """A REAL plan races its half-length FUSED transform and records under
    ``fused2/n{h}``, as the reference does."""
    n, batch = 1280, 2  # h = 640, no fold: K2 against K2-v1
    plan = _commit(n, batch, domain=pf.Domain.REAL)
    entry = plan._raw_fast[FWD]
    assert isinstance(entry, fastpath.HalfReal)
    assert entry.inner.tuning_kind == "fused2"
    assert race._variants_for_entry(plan, entry) == [{}, {"eng": 2}]
    won = plan.autotune(iters=1)
    assert tuning.lookup("cpu", "fused2", "n640") == won
    assert plan._raw_fast[FWD].inner.engine == engine_of(won, plan.plans[640])
    x = np.random.default_rng(8).uniform(-1, 1, (batch, n)).astype(np.float32)
    y = plan.compute_forward(x.reshape(-1)).reshape(batch, -1)
    assert np.abs(y - np.fft.rfft(x)).max() <= oracle.tolerance(ref.Descriptor(lengths=[n]))


def test_smem_estimate_matches_the_kernels_layout():
    """The gates' shared-memory estimate: roots, then K2-v1's two padded
    tiles or K2-v2/K2-v3's a rows of 129 elements a transform; 16384 fits
    K2-v2 at bt = 1 (129 KiB of planes), 32768 fits nothing."""
    from portfft_tpu_torch.config import H100_SMEM_PER_BLOCK
    from portfft_tpu_torch.planner import two_stage_smem_bytes

    assert two_stage_smem_bytes(128, 1, "fused2_v2") == 8 * (256 + 128 * 129)
    assert two_stage_smem_bytes(24, 2, "fused2_v1") == 8 * (152 + 2 * 2 * 128 * 25)
    assert two_stage_smem_bytes(128, 1, "fused2_v3") <= H100_SMEM_PER_BLOCK
    for engine in ("fused2_v1", "fused2_v2", "fused2_v3"):
        assert two_stage_smem_bytes(256, 1, engine) > H100_SMEM_PER_BLOCK
    assert cuda_fft.fused2_v1_supported(plan_1d(12288, CFG, 4))
    assert not cuda_fft.fused2_v1_supported(plan_1d(14336, CFG, 4))
