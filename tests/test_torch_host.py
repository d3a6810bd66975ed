"""Host layer of portfft_tpu_torch against portfft_tpu: descriptors, buffer
counts, serialization, validation errors, plans and constant tables.

The same inputs go through both packages; the port must give the same
numbers, the same exception classes, the same plans and bit-equal tables.
"""

import numpy as np
import pytest
import torch

import portfft_tpu as ref
import portfft_tpu_torch as pt
from portfft_tpu import planner as ref_planner
from portfft_tpu import validation as ref_validation
from portfft_tpu.config import DeviceConfig as RefConfig
from portfft_tpu.ops import xla_fft
from portfft_tpu_torch import convert, planner, validation
from portfft_tpu_torch.config import DeviceConfig, resolve_device_config
from portfft_tpu_torch.ops import torch_fft
from portfft_tpu_torch.utils import layout

REF_CFG = RefConfig(name="cpu")
CFG = DeviceConfig()

# Descriptor keyword sets: the cases of tests/test_descriptor.py and
# tests/test_validation.py, plus the slice's own shapes.
DESCRIPTOR_CASES = [
    dict(lengths=[4]),
    dict(lengths=[2, 3, 4]),
    dict(lengths=[8], number_of_transforms=3),
    dict(lengths=[2, 3], number_of_transforms=2),
    dict(lengths=[8], forward_scale=2.0, backward_scale=-1.0,
         forward_offset=3, backward_offset=7, forward_strides=[2],
         backward_strides=[5], forward_distance=16, backward_distance=40),
    dict(lengths=[4], number_of_transforms=3, forward_strides=[5],
         forward_distance=2, forward_offset=10),
    dict(lengths=[4096], number_of_transforms=32, placement="IN_PLACE"),
    dict(lengths=[1 << 20], number_of_transforms=128, backward_scale=0.5),
    dict(lengths=[8], domain="REAL"),
    dict(lengths=[8], domain="REAL", placement="IN_PLACE"),
    dict(lengths=[8], number_of_transforms=16, forward_strides=[16],
         forward_distance=1, backward_strides=[16], backward_distance=1),
    dict(lengths=[16], precision="fp64", complex_storage="SPLIT_COMPLEX"),
]

# Validation cases: kwargs -> expected exception class name (None = valid).
VALIDATION_CASES = [
    (dict(lengths=[8], domain="REAL"), None),
    (dict(lengths=[8], domain="REAL", placement="IN_PLACE"), None),
    (dict(lengths=[4, 8], domain="REAL", placement="IN_PLACE"),
     "UnsupportedConfiguration"),
    (dict(lengths=[9], domain="REAL"), "UnsupportedConfiguration"),
    (dict(lengths=[8], number_of_transforms=0), "InvalidConfiguration"),
    (dict(lengths=[0]), "InvalidConfiguration"),
    (dict(lengths=[4, 0]), "InvalidConfiguration"),
    (dict(lengths=[8], forward_strides=[0]), "InvalidConfiguration"),
    (dict(lengths=[8], forward_strides=[1, 1]), "InvalidConfiguration"),
    (dict(lengths=[8], number_of_transforms=2, forward_distance=0),
     "InvalidConfiguration"),
    (dict(lengths=[8], number_of_transforms=4, forward_strides=[4],
          forward_distance=8, backward_strides=[4], backward_distance=8),
     "InvalidConfiguration"),
    (dict(lengths=[8], number_of_transforms=16, forward_strides=[16],
          forward_distance=1, backward_strides=[16], backward_distance=1),
     None),
    (dict(lengths=[8], placement="IN_PLACE", forward_strides=[1],
          backward_strides=[2]), "InvalidConfiguration"),
    (dict(lengths=[8], number_of_transforms=2, placement="IN_PLACE",
          forward_distance=8, backward_distance=16), "InvalidConfiguration"),
    (dict(lengths=[4, 4], forward_strides=[2, 1], backward_strides=[2, 1]),
     "InvalidConfiguration"),
    (dict(lengths=[4, 4], forward_strides=[1, 4], backward_strides=[1, 4]),
     "UnsupportedConfiguration"),
    (dict(lengths=[16], number_of_transforms=4, forward_distance=-1,
          backward_distance=-1), "InvalidConfiguration"),
    (dict(lengths=[16], number_of_transforms=3, forward_strides=[2],
          forward_distance=16, backward_strides=[2], backward_distance=16),
     "InvalidConfiguration"),
    (dict(lengths=[16], number_of_transforms=4, forward_strides=[3],
          forward_distance=48, backward_strides=[3], backward_distance=48),
     None),
    (dict(lengths=[4096], number_of_transforms=8), None),
]

# Plan sizes: the slice's table (DIRECT, FUSED [a, 128], GLOBAL) and the
# shapes outside it (FUSED chain, prime-sided GLOBAL, BLUESTEIN).
PLAN_SIZES = [
    1, 3, 16, 100, 256, 512, 640, 4096, 12288, 16384, 32768, 65536,
    1 << 17, 1 << 18, 1 << 19, 1 << 20, 393216, 600, 2 * 65537, 65537,
    9800 * 16,
]


def _kwargs(module, kw):
    """Resolve enum names in a case for ``module``'s enums."""
    out = dict(kw)
    for field, enum in (("domain", "Domain"), ("placement", "Placement"),
                        ("complex_storage", "ComplexStorage")):
        if field in out:
            out[field] = getattr(module, enum)[out[field]]
    return out


@pytest.mark.parametrize("kw", DESCRIPTOR_CASES)
def test_descriptor_fields_counts_and_dict(kw):
    r = ref.Descriptor(**_kwargs(ref, kw))
    p = pt.Descriptor(**_kwargs(pt, kw))
    assert p.to_dict() == r.to_dict()
    for rd, pd in zip(ref.Direction, pt.Direction):
        assert rd.value == pd.value
        assert p.get_input_count(pd) == r.get_input_count(rd)
        assert p.get_output_count(pd) == r.get_output_count(rd)
        assert p.domain_lengths(pd) == r.domain_lengths(rd)
        assert layout.get_layout(p, pd).value == (
            ref.utils.layout.get_layout(r, rd).value
        )
    assert p.get_flattened_length() == r.get_flattened_length()
    assert pt.Descriptor.from_dict(p.to_dict()) == p
    assert convert.descriptor_from_reference(r.to_dict()) == p


def test_descriptor_construction_errors():
    for mod in (ref, pt):
        with pytest.raises(mod.InvalidConfiguration, match="at least 1"):
            mod.Descriptor(lengths=[])
        with pytest.raises(mod.InvalidConfiguration, match="at least 1"):
            mod.Descriptor(lengths=[], domain=mod.Domain.REAL)
        with pytest.raises(ValueError):
            mod.Descriptor(lengths=[4], precision="int8")
        assert mod.Descriptor(lengths=[4], precision="double").precision == (
            np.float64
        )


def _error_name(fn):
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 - the class is what is compared
        return type(exc).__name__
    return None


@pytest.mark.parametrize("kw,expected", VALIDATION_CASES)
def test_validation_raises_the_same_class(kw, expected):
    got_ref = _error_name(
        lambda: ref_validation.validate_descriptor(
            ref.Descriptor(**_kwargs(ref, kw))
        )
    )
    got = _error_name(
        lambda: validation.validate_descriptor(pt.Descriptor(**_kwargs(pt, kw)))
    )
    assert got_ref == expected
    assert got == expected


def test_enums_and_exceptions_match():
    for name in ("Domain", "ComplexStorage", "Placement", "Direction",
                 "Level", "Layout"):
        assert [e.value for e in getattr(pt, name)] == [
            e.value for e in getattr(ref, name)
        ]
    assert pt.inv(pt.Direction.FORWARD) == pt.Direction.BACKWARD
    assert issubclass(pt.OutOfVmemError, pt.UnsupportedConfiguration)
    for name in ("InternalError", "InvalidConfiguration",
                 "UnsupportedConfiguration", "OutOfVmemError"):
        assert issubclass(getattr(pt, name), pt.PortFFTError)


def test_cpu_config_keeps_the_reference_planning_geometry():
    cfg = resolve_device_config(torch.device("cpu"))
    for field in ("lane", "sublane", "vmem_bytes", "vmem_budget_fraction",
                  "max_factor", "direct_threshold"):
        assert getattr(cfg, field) == getattr(REF_CFG, field), field
    assert cfg.vmem_budget == REF_CFG.vmem_budget
    assert cfg.name == "cpu" and cfg.sm_count == 0


@pytest.mark.parametrize("n", PLAN_SIZES)
def test_plan_1d_matches_reference(n):
    got = planner.plan_1d(n, CFG, 4)
    want = ref_planner.plan_1d(n, REF_CFG, 4)
    assert got.describe() == want.describe()


def test_global_split_matches_reference():
    for n in (65536, 1 << 17, 1 << 18, 1 << 19, 1 << 20, 9800 * 16, 393216):
        assert planner._global_split(n, CFG, 4) == ref_planner._global_split(
            n, REF_CFG, 4
        )


def _ref_table(bank, key, n):
    """The reference bank's table name for one of the port's key tuples of
    a length-``n`` plan."""
    kind, *rest = key
    if kind == "W":
        f, sign = rest
        return bank.dft(f, sign)
    if kind == "T":
        f, m, sign = rest
        return bank.twiddle(f, m, sign)
    if kind in ("GA", "GB"):  # K5's and K18's factored twiddle of g1 x g2
        g1, g2, sign = rest
        a1 = torch_fft.ilv_factor(g1)
        if kind == "GA":
            return bank.bf_twiddle_hi(a1, g2, g1 * g2, sign)
        return bank.bf_twiddle_lo(g2, g1 * g2 // a1, sign)
    if kind == "G3":  # K16's factored twiddle of the split g1 x g2
        g1, g2, sign = rest
        digits = torch_fft.global3_digits(planner.plan_1d(g1 * g2, CFG, 4))
        return bank.global3_btw(*digits, g1 * g2, torch_fft.GLOBAL3_T1, sign)
    if kind == "Q":  # K17's factored twiddle, DIRECT G1
        g1, n_, sign, t1 = rest
        return bank.btw_planes(g1, n_ // g1, n_, t1, sign)
    if kind == "ZQ":  # K17's factored twiddle, FUSED [a, 128] G1
        g1, g2, sign, t1 = rest
        return bank.global_fused_twiddles_factored(g1 // 128, g2, g1 * g2, t1, sign)
    if kind == "G2L":  # K19's factors of GB
        g2, t1, sign = rest
        n_lo = n // torch_fft.bf_factor(n // g2)
        return bank.bf_lo_factored(n_lo, t1, g2 // t1, sign)
    f, m, sign = rest
    return bank.twiddle_fm(f, m, sign)


@pytest.mark.parametrize("n", [16, 100, 512, 640, 4096, 32768, 65536, 147456, 1 << 19])
def test_bank_tables_bit_equal(n):
    plan = planner.plan_1d(n, CFG, 4)
    bank, keys = torch_fft.TwiddleBank(np.float32), {}
    ref_bank, ref_keys = xla_fft.TwiddleBank(np.float32), {}
    for sign in (-1, +1):
        torch_fft.collect_bank_keys(plan, sign, bank, keys)
        xla_fft.collect_bank_keys(
            ref_planner.plan_1d(n, REF_CFG, 4), sign, ref_bank, ref_keys
        )
    assert keys
    parts_of = {"G3": ("1r", "1i", "2r", "2i"),
                "Q": tuple(f"{j}{p}" for j in "1234" for p in "ri"),
                "ZQ": tuple(f"{j}{p}" for j in "1234" for p in "ri"),
                "G2L": ("1tr", "1ti", "2r", "2i")}
    for key, name in keys.items():
        assert _ref_table(ref_bank, key, n) == name
        if key in ref_keys:
            assert ref_keys[key] == name
        for part in parts_of.get(key[0], ("r", "i")):
            got, want = bank.host[name + part], ref_bank.host[name + part]
            assert got.dtype == want.dtype == np.float32
            assert got.shape == want.shape
            assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    # the same tables carried over from the reference's bank
    carried = convert.bank_from_reference(ref_bank.host, "cpu")
    own = bank.device_arrays("cpu")
    for name, t in own.items():
        assert torch.equal(carried[name], t), name


def test_root_table_is_row_one_of_the_dft_matrix():
    """The kernels read w^((j*k) mod n) from row 1 of the bank's matrix;
    that equals the full matrix bit for bit."""
    for n in (16, 100, 512):
        bank = torch_fft.TwiddleBank(np.float32)
        key = bank.dft(n, -1)
        for part in ("r", "i"):
            w = bank.host[key + part]
            jk = np.mod(np.outer(np.arange(n), np.arange(n)), n)
            assert np.array_equal(w, w[1][jk] if n > 1 else w)


def test_logging_flags(monkeypatch, caplog):
    from portfft_tpu_torch.utils import logging as plog

    monkeypatch.setattr(plog, "TRACES_ENABLED", True)
    monkeypatch.setattr(plog, "WARNINGS_ENABLED", True)
    caplog.set_level("DEBUG", logger="portfft_tpu_torch")
    plog.trace("hello", 1)
    plog.warn("careful")
    assert "hello 1" in caplog.text and "careful" in caplog.text
    monkeypatch.setenv("PORTFFT_LOG_TRACES", "off")
    assert not plog._env_flag("PORTFFT_LOG_TRACES")
    monkeypatch.setenv("PORTFFT_LOG_TRACES", "1")
    assert plog._env_flag("PORTFFT_LOG_TRACES")
