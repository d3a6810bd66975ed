"""The tuning table and ``autotune`` of portfft_tpu_torch against the JAX
package's (``portfft_tpu.tuning``), on the CPU, each package with its own
temporary cache file: the same record/lookup/stale/forget semantics, the
same tuned GLOBAL split, the GLOBAL and FUSED engine variants where the
port's gates take the plan, ``autotune`` recording its winner under the
GLOBAL kind and key (a REAL plan's under its half-length sub), the parity
gate, and at commit a tuned engine whose gate declines the plan (marked
stale, with a warning, and the static route computes) or that has no
kernel here (raises).
Values are held to ``np.fft`` at ``oracle.tolerance`` (2·eps·N·log2N).
"""

import json
import os

import numpy as np
import pytest
import torch

import oracle
import portfft_tpu as ref
from portfft_tpu import tuning as ref_tuning
from portfft_tpu.config import DeviceConfig as RefConfig
from portfft_tpu.enums import Direction as RefDirection
from portfft_tpu.planner import plan_1d as ref_plan_1d
import portfft_tpu_torch as pf
from portfft_tpu_torch import fastpath, tuning
from portfft_tpu_torch.config import DeviceConfig
from portfft_tpu_torch.planner import plan_1d

BOTH = (ref_tuning, tuning)


@pytest.fixture
def tmp_caches(tmp_path, monkeypatch):
    monkeypatch.delenv("PORTFFT_NO_TUNING", raising=False)
    monkeypatch.setattr(tuning, "_USER_PATH", str(tmp_path / "port.json"))
    monkeypatch.setattr(ref_tuning, "_USER_PATH", str(tmp_path / "ref.json"))
    for t in BOTH:
        t._reset_for_tests()
    yield tmp_path
    for t in BOTH:
        t._reset_for_tests()


def _fft_ok(y, x, n, batch, scale=1.0, sign=-1):
    tol = oracle.tolerance(ref.Descriptor(lengths=[n], number_of_transforms=batch))
    xc = np.asarray(x).view(np.complex64).reshape(batch, n).astype(np.complex128)
    want = (np.fft.fft(xc) if sign < 0 else np.fft.ifft(xc) * n) * scale
    got = np.asarray(y).view(np.complex64).reshape(batch, n)
    diff = np.abs(got - want)
    assert np.all((diff <= tol) | (diff <= tol * np.abs(want))), diff.max()


def _input(batch, n, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, 2 * batch * n).astype(np.float32)


def test_record_lookup_round_trip(tmp_caches):
    for t in BOTH:
        assert t.lookup("cpu", "global2", "n7") is None
        t.record("cpu", "global2", "n7", {"eng": 7})
        assert t.lookup("cpu", "global2", "n7") == {"eng": 7}
        t._reset_for_tests()  # persisted: a fresh load still sees it
        assert t.lookup("cpu", "global2", "n7") == {"eng": 7}
    assert (json.loads((tmp_caches / "port.json").read_text())
            == json.loads((tmp_caches / "ref.json").read_text()))


def test_no_tuning_env(tmp_caches, monkeypatch):
    for t in BOTH:
        monkeypatch.setenv("PORTFFT_NO_TUNING", "0")
        t.record("cpu", "global2", "n99", {"eng": 5})
        assert t.lookup("cpu", "global2", "n99") == {"eng": 5}
        monkeypatch.setenv("PORTFFT_NO_TUNING", "1")
        assert t.lookup("cpu", "global2", "n99") is None
        monkeypatch.delenv("PORTFFT_NO_TUNING")


def test_forget(tmp_caches):
    for t in BOTH:
        t.record("cpu", "global_split", "n999", {"g1": 3, "g2": 333})
        t.forget("cpu", "global_split", "n999")
        assert t.lookup("cpu", "global_split", "n999") is None
        t.forget("cpu", "global_split", "never_there")  # no-op


def test_stale_mark_masks_and_record_clears(tmp_caches):
    for t in BOTH:
        t.record("cpu", "global2", "n77", {"eng": 5})
        t.mark_stale("cpu", "global2", "n77", "synthetic" * 40)
        assert t.lookup("cpu", "global2", "n77") is None
        t._reset_for_tests()
        assert t.lookup("cpu", "global2", "n77") is None
        stale = [e for e in t.stale_entries("cpu") if e[2] == "n77"]
        assert len(stale) == 1 and len(stale[0][3]["stale"]) == 200
        assert stale[0][3]["eng"] == 5
        t.record("cpu", "global2", "n77", {"eng": 7})
        assert t.lookup("cpu", "global2", "n77") == {"eng": 7}
        assert not any(e[2] == "n77" for e in t.stale_entries("cpu"))


def test_stale_mark_masks_a_shipped_entry(tmp_caches, monkeypatch):
    """A stale mark in the user cache hides the shipped entry of the same
    key, in both packages."""
    for t in BOTH:
        t._reset_for_tests()
        t._load()
        monkeypatch.setitem(t._tables, "dev_x", {"global2": {"n5": {"eng": 7}}})
        assert t.lookup("dev_x", "global2", "n5") == {"eng": 7}
        t.mark_stale("dev_x", "global2", "n5", "gate")
        assert t.lookup("dev_x", "global2", "n5") is None


def test_tuned_global_split_plans_alike(tmp_caches):
    """A recorded split replaces the rule's in both planners; one that does
    not factor n is ignored."""
    n = 1 << 17
    cfg, rcfg = DeviceConfig(), RefConfig(name="cpu")
    for t in BOTH:
        t.record("cpu", "global_split", f"n{n}", {"g1": 1024, "g2": 128})
    for p in (plan_1d(n, cfg, 4), ref_plan_1d(n, rcfg, 4)):
        assert (p.sub[0].n, p.sub[1].n) == (1024, 128)
        assert p.sub[0].factors == [8, 128]
    for t in BOTH:
        t.record("cpu", "global_split", f"n{n}", {"g1": 999, "g2": 7})
    for p in (plan_1d(n, cfg, 4), ref_plan_1d(n, rcfg, 4)):
        assert (p.sub[0].n, p.sub[1].n) == (512, 256)


def test_shipped_table_is_consistent():
    """The port ships H100 winners only: every entry names an engine with a
    kernel here (a ``fused2`` entry one of K2-v1, K2-v2, K2-v3 whose gate
    takes its plan at its tile: a row K2 won has no entry; a ``multidim``
    or ``bi_col`` entry a variant that changes a kernel of its shape),
    splits factor their length, and no TPU key is present."""
    path = os.path.join(os.path.dirname(tuning.__file__), "tuning_defaults.json")
    with open(path) as f:
        ship = json.load(f)
    assert list(ship) == ["cuda_h100"]
    assert not any(dev.startswith("tpu") for dev in ship)
    table = ship["cuda_h100"]
    assert set(table) <= {"global2", "global_split", "fused2", "multidim", "bi_col"}
    assert table.get("fused2")
    for key, params in table["fused2"].items():
        plan = plan_1d(int(key[1:]), DeviceConfig(), 4)
        engine = fastpath._engine_of(params, plan)
        assert engine in fastpath.FUSED_ENGINE_PARAMS and engine != "fused2", key
        bt = params.get("bt", 0)
        assert fastpath.engine_supported(engine, plan, bt or 1, bt), (key, params)
    for key, params in table.get("global2", {}).items():
        assert params in fastpath.ENGINE_PARAMS.values(), (key, params)
        n, split = key[1:].split("_g")
        g1, g2 = map(int, split.split("x"))
        assert g1 * g2 == int(n)
    for key, params in table.get("global_split", {}).items():
        assert params["g1"] * params["g2"] == int(key[1:])
    for kind in ("multidim", "bi_col"):
        for key, params in table.get(kind, {}).items():
            lengths = [int(v) for v in key[1:].split("x")]
            plan = _md_desc(lengths, 4, kind == "bi_col").commit(device="cpu")
            variants = tuning._variants_for_entry(
                plan, plan._raw_fast[pf.Direction.FORWARD])
            assert params in variants[1:], (kind, key, params)


ENGINES = ({"eng": 2, "ftw": 1}, {"eng": 5}, {"eng": 7}, {"eng": 7, "ov": 1},
           {"eng": 3}, {"eng": 6}, {"eng": 6, "ftw": 1}, {"eng": 8},
           {"eng": 7, "bf2": 1})
NO_K4 = ENGINES[:1] + ENGINES[2:]
# FUSED at batch 2: K2-v2 and K2-v3 at bt 1 and 2 (a = 32); K2-v1 where a
# has no fold (a = 5).  The reference's tile rules ((bt·a) % 128 for its
# engine 2, % 8 for engine 3) take only engine 3 at 4096 × 2, nothing at 640.
FUSED_ENGINES = tuple({"eng": e, "bt": b} for b in (1, 2) for e in (2, 3))


@pytest.mark.parametrize("n,expect,ref_expect", [
    (65536, ENGINES, ENGINES), (1 << 17, ENGINES, ENGINES),
    # K4's cluster holds at most 2^17 points; the reference lists eng 5 on
    # its VMEM estimate (and its compiler rejects it there)
    (1 << 18, NO_K4, NO_K4),
    # the reference's VMEM estimates at its default 16 MiB decline eng 7 (bf2
    # with it) and eng 8 at 2048 x 512 (its TPU table, with more VMEM, runs
    # eng 7), not eng 3 or eng 6
    (1 << 20, NO_K4, ENGINES[:1] + ENGINES[4:7]),
    (4096, FUSED_ENGINES, FUSED_ENGINES[1::2]),
    (640, ({"eng": 2},), ()),
])
def test_variants_where_the_gates_take_the_plan(tmp_caches, n, expect, ref_expect):
    plan = pf.Descriptor(lengths=[n], number_of_transforms=2).commit(device="cpu")
    variants = tuning._variants_for_entry(plan, plan._raw_fast[pf.Direction.FORWARD])
    assert variants == [{}, *expect]
    rplan = ref.Descriptor(lengths=[n], number_of_transforms=2).commit(use_pallas=True)
    rvar = ref_tuning._variants_for_entry(rplan, rplan._raw_fast[RefDirection.FORWARD])
    for v in ref_expect:  # the reference races the same engines
        assert any(r.get("eng") == v["eng"] and all(
            bool(r.get(k)) == bool(v.get(k)) for k in ("ov", "ftw", "bf2"))
            for r in rvar), v
    kind = fastpath.inner_entry(plan._raw_fast[pf.Direction.FORWARD])[0]
    assert tuning._entry_key(plan, kind) == ref_tuning._entry_key(rplan, kind)


def test_no_variants_outside_global(tmp_caches):
    """Nothing to race outside the GLOBAL and FUSED entries (a DIRECT plan),
    nor on a FUSED plan only K2 takes (32768 = [256, 128]: one transform
    does not fit a block of K2-v1, K2-v2 or K2-v3)."""
    plan = pf.Descriptor(lengths=[256], number_of_transforms=2).commit(device="cpu")
    assert tuning._variants_for_entry(plan, plan._raw_fast[pf.Direction.FORWARD]) == []
    assert plan.autotune(iters=1) is None
    plan = pf.Descriptor(lengths=[32768], number_of_transforms=2).commit(device="cpu")
    assert tuning._variants_for_entry(plan, plan._raw_fast[pf.Direction.FORWARD]) == [{}]
    assert plan.autotune(iters=1) is None


def test_autotune_records_under_the_global_key(tmp_caches):
    n, batch = 65536, 2
    desc = pf.Descriptor(lengths=[n], number_of_transforms=batch)
    plan = desc.commit(device="cpu")
    times = {}
    won = plan.autotune(iters=1, times=times)
    assert won in [{}, *ENGINES]
    assert len(times) == 1 + len(ENGINES)  # {} and every engine, K3-ftw too
    key = tuning._entry_key(plan, "global2")
    assert key == "n65536_g256x256"
    assert tuning.lookup("cpu", "global2", key) == won
    assert plan._raw_fast[pf.Direction.BACKWARD][-1] == fastpath._engine_of(won)
    x = _input(batch, n, 1)
    _fft_ok(plan.compute_forward(x), x, n, batch)
    # a new commit takes the recorded engine
    assert desc.commit(device="cpu")._raw_fast[pf.Direction.FORWARD][-1] == \
        fastpath._engine_of(won)


def test_autotune_takes_iters_first_as_the_reference(tmp_caches):
    """``autotune``'s parameters are the reference's, ``iters`` first, so
    ``plan.autotune(1)`` races and records."""
    import inspect

    params = list(inspect.signature(pf.CommittedDescriptor.autotune).parameters)
    ref_params = list(inspect.signature(ref.CommittedDescriptor.autotune).parameters)
    assert params[:2] == ref_params[:2] == ["self", "iters"]
    plan = pf.Descriptor(lengths=[65536], number_of_transforms=1).commit(device="cpu")
    won = plan.autotune(1)
    assert won is not None
    assert tuning.lookup("cpu", "global2", "n65536_g256x256") == won


def test_global_entry_unwraps_real_and_layout_entries(tmp_caches):
    """``fastpath.inner_entry`` finds the GLOBAL entry inside a REAL or
    layout entry, and returns an unwrapped entry (a FUSED one) as it is."""
    for fields in (dict(domain=pf.Domain.REAL, lengths=[1 << 17]),
                   dict(lengths=[65536], forward_strides=[2],
                        forward_distance=2 * 65536)):
        plan = pf.Descriptor(number_of_transforms=2, **fields).commit(device="cpu")
        inner = fastpath.inner_entry(plan._raw_fast[pf.Direction.FORWARD])
        assert inner[0] == "global2" and inner[1].n == 65536
    plan = pf.Descriptor(lengths=[4096]).commit(device="cpu")
    entry = plan._raw_fast[pf.Direction.FORWARD]
    assert fastpath.inner_entry(entry) is entry and entry[0] == "fused2"


def test_autotune_real_records_under_its_sub(tmp_caches):
    """A REAL plan races the engines of its half-length GLOBAL transform and
    records under that length's ``global2`` key, as the reference does."""
    n, batch = 131072, 2
    plan = pf.Descriptor(lengths=[n], number_of_transforms=batch,
                         domain=pf.Domain.REAL).commit(device="cpu")
    entry = plan._raw_fast[pf.Direction.FORWARD]
    assert entry[0] == "realf" and entry[1][0] == "global2"
    assert tuning._variants_for_entry(plan, entry) == [{}, *ENGINES]
    won = plan.autotune(iters=1)
    assert tuning.lookup("cpu", "global2", "n65536_g256x256") == won
    assert plan._raw_fast[pf.Direction.FORWARD][1][-1] == fastpath._engine_of(won)
    x = np.random.default_rng(7).uniform(-1, 1, (batch, n)).astype(np.float32)
    y = plan.compute_forward(x.reshape(-1)).reshape(batch, -1)
    tol = oracle.tolerance(ref.Descriptor(lengths=[n]))
    assert np.abs(y - np.fft.rfft(x)).max() <= tol


def test_layout_entry_takes_the_tuned_engine(tmp_caches):
    """A strided descriptor's inner GLOBAL entry reads the same key, and its
    ``autotune`` records there."""
    n, batch = 65536, 2
    tuning.record("cpu", "global2", "n65536_g256x256", {"eng": 7})
    desc = pf.Descriptor(lengths=[n], number_of_transforms=batch,
                         forward_strides=[2], forward_distance=2 * n)
    plan = desc.commit(device="cpu")
    entry = plan._raw_fast[pf.Direction.FORWARD]
    assert entry[0] == "layout" and entry[1][-1] == "global_bf"
    x = _input(batch, 2 * n, 4)
    y = plan.compute_forward(x)
    xs = x.view(np.complex64).reshape(batch, 2 * n)[:, ::2].copy().view(np.float32)
    _fft_ok(y, xs, n, batch)
    won = plan.autotune(iters=1)
    assert tuning.lookup("cpu", "global2", "n65536_g256x256") == won


def test_autotune_drops_a_mismatching_variant(tmp_caches, monkeypatch):
    """A variant whose output leaves the ``{}`` baseline by more than 1e-3
    is dropped with a trace before it is timed."""
    from portfft_tpu_torch.utils import logging as plog

    plan = pf.Descriptor(lengths=[65536], number_of_transforms=2).commit(device="cpu")
    bad = {"eng": 7, "ov": 1}
    real_build = fastpath.build_fn

    def corrupting(committed, entry, plain=False):
        fn = real_build(committed, entry, plain)
        inner = entry[1] if entry[0] == "layout" else entry
        if inner[-1] == "global_bf_ov":
            return lambda *a, **k: fn(*a, **k) * 0.0
        return fn

    msgs = []
    monkeypatch.setattr(fastpath, "build_fn", corrupting)
    monkeypatch.setattr(plog, "trace", lambda *m: msgs.append(" ".join(map(str, m))))
    times = {}
    won = plan.autotune(iters=1, times=times)
    assert won != bad and json.dumps(bad, sort_keys=True) not in times
    assert len(times) == len(ENGINES)  # all but the dropped one
    assert any("output mismatch" in m for m in msgs), msgs


def test_declined_tuned_engine_is_marked_stale_at_commit(tmp_caches, monkeypatch):
    """A tuned K4 for 2^18 (past K4's cluster) is marked stale at commit
    with a warning, and K3 computes the right answer; later commits see no
    tuned entry.  The reference does the same when its kernel rejects the
    tuned engine at run time (``tests/test_tuning.py``)."""
    from portfft_tpu_torch.utils import logging as plog

    n, batch = 1 << 18, 1
    desc = pf.Descriptor(lengths=[n], number_of_transforms=batch)
    key = tuning._entry_key(desc.commit(device="cpu"), "global2")
    tuning.record("cpu", "global2", key, {"eng": 5})
    warns = []
    monkeypatch.setattr(plog, "warn", lambda *m: warns.append(" ".join(map(str, m))))
    plan = desc.commit(device="cpu")
    assert plan._raw_fast[pf.Direction.FORWARD][-1] == "global2"
    assert any("stale tuned entry" in w for w in warns), warns
    assert tuning.lookup("cpu", "global2", key) is None
    assert any(k == key for (_, _, k, _) in tuning.stale_entries("cpu"))
    x = _input(batch, n, 2)
    _fft_ok(plan.compute_forward(x), x, n, batch)


@pytest.mark.parametrize("params", [{"eng": 1}, {"eng": 4, "t1": 128},
                                    {"eng": 9, "bf2": 1}])
def test_engine_without_a_kernel_raises(tmp_caches, params):
    """A GLOBAL engine number the reference never emits for ``global2``
    (every one it emits has a kernel here since engines 6, 8 and bf2
    landed) raises at commit and in ``with_engine``."""
    desc = pf.Descriptor(lengths=[65536], number_of_transforms=2)
    plan = desc.commit(device="cpu")
    with pytest.raises(pf.UnsupportedConfiguration, match="has no kernel"):
        fastpath.with_engine(plan, plan._raw_fast[pf.Direction.FORWARD], params)
    tuning.record("cpu", "global2", tuning._entry_key(plan, "global2"), params)
    with pytest.raises(pf.UnsupportedConfiguration, match="has no kernel"):
        desc.commit(device="cpu")


def test_reference_engine_3_is_k16(tmp_caches):
    """The reference's engine 3 with its TPU tile knobs (its own shipped
    winner at 2^17) is K16 here, the knobs ignored; the tuned plan computes
    the transform."""
    n, batch = 1 << 17, 1
    desc = pf.Descriptor(lengths=[n], number_of_transforms=batch)
    plan = desc.commit(device="cpu")
    params = {"eng": 3, "t1": 128, "t2": 256}
    assert fastpath._engine_of(params) == "global3"
    assert fastpath.with_engine(plan, plan._raw_fast[pf.Direction.FORWARD],
                                params)[-1] == "global3"
    tuning.record("cpu", "global2", tuning._entry_key(plan, "global2"), params)
    plan = desc.commit(device="cpu")
    assert plan._raw_fast[pf.Direction.FORWARD][-1] == "global3"
    x = _input(batch, n, 3)
    _fft_ok(plan.compute_forward(x), x, n, batch)


def test_declined_engine_3_is_marked_stale_at_commit(tmp_caches, monkeypatch):
    """A tuned K16 for 2^21 ([16, 128] x [8, 128]: a FUSED G2, which
    ``global3_supported`` declines) is marked stale at commit with a
    warning, and K3 computes."""
    from portfft_tpu_torch.utils import logging as plog

    n = 1 << 21
    desc = pf.Descriptor(lengths=[n])
    key = tuning._entry_key(desc.commit(device="cpu"), "global2")
    assert key == "n2097152_g2048x1024"
    tuning.record("cpu", "global2", key, {"eng": 3})
    warns = []
    monkeypatch.setattr(plog, "warn", lambda *m: warns.append(" ".join(map(str, m))))
    plan = desc.commit(device="cpu")
    assert plan._raw_fast[pf.Direction.FORWARD][-1] == "global2"
    assert any("stale tuned entry" in w and "global3" in w for w in warns), warns
    assert tuning.lookup("cpu", "global2", key) is None
    x = _input(1, n, 4)
    _fft_ok(plan.compute_forward(x), x, n, 1)


# Multi-dim and BATCH_INTERLEAVED: (lengths, batch, BI, kind, key, variants,
# the kernels of each variant in order).
MD_TUNED = [
    ([512, 512], 2, False, "multidim", "n512x512",
     [{}, {"m2": 0}, {"m2": 0, "cm": 1}],
     [("md2",), ("direct", "col"), ("direct", "col_mm")]),
    ([1024, 1024], 1, False, "multidim", "n1024x1024", [{}, {"cm": 1}],
     [("fused2", "col"), ("fused2", "col_mm")]),
    ([128, 128, 128], 1, False, "multidim", "n128x128x128",
     [{}, {"cm": 1}, {"m2": 0}, {"m2": 0, "cm": 1}],
     [("md2", "col"), ("md2", "col_mm"), ("direct", "col", "col"),
      ("direct", "col_mm", "col_mm")]),
    ([100, 256], 2, False, "multidim", "n100x256", [{}], [("direct", "col")]),
    ([4096], 4, True, "bi_col", "n4096", [{}, {"cm": 1}], [("col",), ("col_mm",)]),
]


def _md_desc(lengths, batch, bi, **kw):
    if bi:
        kw.update(forward_strides=[batch], backward_strides=[batch],
                  forward_distance=1, backward_distance=1)
    return pf.Descriptor(lengths=lengths, number_of_transforms=batch, **kw)


def _md_kinds(entry):
    inner = fastpath.inner_entry(entry)
    return (inner[6],) if inner[0] == "bi_col" else tuple(s[0] for s in inner[2])


@pytest.mark.parametrize("lengths,batch,bi,kind,key,variants,routes", MD_TUNED)
def test_md_keys_variants_and_routes(tmp_caches, lengths, batch, bi, kind, key,
                                     variants, routes):
    """The ``multidim`` and ``bi_col`` kinds key as the reference's
    (``n{L0}x{L1}…``, ``n{n}``); the variants are ``{}`` and those that
    change a kernel (``{"cm": 1}`` where a column step takes K10-mm, the
    per-axis route where K11 runs); each recorded variant routes both
    directions at commit."""
    desc = _md_desc(lengths, batch, bi)
    plan = desc.commit(device="cpu")
    entry = plan._raw_fast[pf.Direction.FORWARD]
    assert fastpath.inner_entry(entry)[0] == kind
    assert tuning._key_of(plan, fastpath.inner_entry(entry)) == key
    rkw = dict(lengths=lengths, number_of_transforms=batch)
    if bi:
        rkw.update(forward_strides=[batch], backward_strides=[batch],
                   forward_distance=1, backward_distance=1)
    rplan = ref.Descriptor(**rkw).commit(use_pallas=True)
    assert ref_tuning._entry_key(rplan, kind) == key
    assert tuning._variants_for_entry(plan, entry) == variants
    for params, kinds in zip(variants, routes):
        tuning.record("cpu", kind, key, params)
        plan = desc.commit(device="cpu")
        for direction in pf.Direction:
            assert _md_kinds(plan._raw_fast[direction]) == kinds


@pytest.mark.parametrize("lengths,won", [([512, 512], {"m2": 0, "cm": 1}),
                                         ([128, 128, 128], {"m2": 0}),
                                         ([1024, 1024], {"cm": 1})])
def test_md_variants_do_not_depend_on_the_tuned_entry(tmp_caches, lengths, won):
    """A plan committed on a tuned entry (here one that turned K11 off)
    races the same variants as on the static route: ``autotune`` on a card
    whose shipped table holds a winner races them all again."""
    desc = pf.Descriptor(lengths=lengths)
    static = desc.commit(device="cpu")
    want = tuning._variants_for_entry(static, static._raw_fast[pf.Direction.FORWARD])
    tuning.record("cpu", "multidim", tuning._entry_key(static, "multidim"), won)
    plan = desc.commit(device="cpu")
    entry = plan._raw_fast[pf.Direction.FORWARD]
    assert _md_kinds(entry) != _md_kinds(static._raw_fast[pf.Direction.FORWARD])
    assert tuning._variants_for_entry(plan, entry) == want


@pytest.mark.parametrize("knobs", [{"ct": 128, "ds": 1}, {"mt1": 64, "mt2": 64},
                                   {"cm": 1, "ct": 256}])
def test_md_tpu_knobs_are_ignored(tmp_caches, knobs):
    """The reference's TPU tile knobs (``ct``, ``ds``, ``mt1``, ``mt2``) are
    read and ignored: only ``cm`` and ``m2`` change a route."""
    desc = pf.Descriptor(lengths=[1024, 1024])
    tuning.record("cpu", "multidim", "n1024x1024", knobs)
    kinds = _md_kinds(desc.commit(device="cpu")._raw_fast[pf.Direction.FORWARD])
    assert kinds == (("fused2", "col_mm") if knobs.get("cm") else ("fused2", "col"))


@pytest.mark.parametrize("lengths,batch,bi,fields,kind,key", [
    ([128, 128, 128], 1, False, {}, "multidim", "n128x128x128"),
    ([256], 8, True, {}, "bi_col", "n256"),
    # a layout entry around bi_col (offsets on the BI blocks) records there too
    ([256], 8, True, dict(forward_offset=3, backward_offset=5), "bi_col", "n256"),
])
def test_autotune_md_records_and_reregisters(tmp_caches, lengths, batch, bi,
                                             fields, kind, key):
    """``autotune`` on the CPU races the variants, records the winner under
    the ``multidim`` or ``bi_col`` kind and key, re-registers both
    directions on it, and the tuned plan computes the transform."""
    desc = _md_desc(lengths, batch, bi, **fields)
    plan = desc.commit(device="cpu")
    static = plan._raw_fast[pf.Direction.BACKWARD]
    assert static[0] == ("layout" if fields else kind)
    variants = tuning._variants_for_entry(plan, plan._raw_fast[pf.Direction.FORWARD])
    times = {}
    won = plan.autotune(iters=1, times=times)
    assert won in variants and len(times) == len(variants) > 1
    assert tuning.lookup("cpu", kind, key) == won
    want = _md_kinds(fastpath.with_engine(plan, static, won))
    assert _md_kinds(plan._raw_fast[pf.Direction.BACKWARD]) == want
    assert _md_kinds(desc.commit(device="cpu")._raw_fast[pf.Direction.BACKWARD]) == want
    n = int(np.prod(lengths))
    count = desc.get_input_count(pf.Direction.FORWARD)
    x = np.random.default_rng(5).uniform(-1, 1, 2 * count).astype(np.float32)
    y = np.asarray(plan.compute_forward(x)).view(np.complex64)
    off_in, off_out = fields.get("forward_offset", 0), fields.get("backward_offset", 0)
    xc = x.view(np.complex64)[off_in:off_in + batch * n]
    xc = xc.reshape(n, batch).T if bi else xc.reshape(batch, *lengths)
    axes = (1,) if bi else tuple(range(1, len(lengths) + 1))
    exact = np.fft.fftn(xc.astype(np.complex128), axes=axes)
    got = y[off_out:off_out + batch * n]
    got = got.reshape(n, batch).T if bi else got.reshape(batch, *lengths)
    tol = oracle.tolerance(ref.Descriptor(lengths=lengths))
    diff = np.abs(got - exact)
    assert np.all((diff <= tol) | (diff <= tol * np.abs(exact))), diff.max()


def test_reference_two_pass_engine_is_k3(tmp_caches):
    """The reference's engine 2 with its TPU tile knobs is K3 here."""
    desc = pf.Descriptor(lengths=[65536], number_of_transforms=2)
    tuning.record("cpu", "global2", "n65536_g256x256", {"eng": 2, "t1": 64, "t2": 256})
    assert desc.commit(device="cpu")._raw_fast[pf.Direction.FORWARD][-1] == "global2"


def test_explicit_engine_the_gate_declines_raises(tmp_caches):
    plan = pf.Descriptor(lengths=[1 << 18]).commit(device="cpu")
    with pytest.raises(pf.UnsupportedConfiguration, match="declines"):
        fastpath.with_engine(plan, plan._raw_fast[pf.Direction.FORWARD], {"eng": 5})


def test_commit_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(pf.UnsupportedConfiguration):
        pf.Descriptor(lengths=[65536]).commit()
