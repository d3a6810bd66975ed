"""The 1D REAL-domain slice of portfft_tpu_torch (R2C forward, C2R backward)
against portfft_tpu (``commit(use_pallas=True)``, Pallas kernels in
interpret mode, as ``tests/test_real_raw.py`` runs them) and
``np.fft.rfft``/``irfft`` in float64, on the CPU.

Tolerances: both packages within 2·eps·N·log2N per element (absolute or
relative, as ``tests/oracle.py``) of the float64 oracle; port against
reference max|Δ| ≤ 5e-5·max|y_ref|, as in ``test_torch_slice.py``.

Backward inputs are half spectra of real signals (Im X[0] = Im X[n/2] = 0).
Other half spectra are held in ``test_torch_real_plane.py``: the reference
drops those two imaginary parts below n = 1024 and uses them from there on,
and so does the port (K8b's flag).
"""

import math
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import portfft_tpu as ref
import portfft_tpu_torch as pt
from portfft_tpu.config import DeviceConfig as RefConfig
from portfft_tpu.ops import pallas_real, xla_fft
from portfft_tpu_torch import convert, fastpath
from portfft_tpu_torch.ops import cuda_real, torch_fft

REF_CFG = RefConfig()
EPS32 = float(np.finfo(np.float32).eps)


def _tol(n):
    return 2.0 * EPS32 * n * max(math.log2(n), 1.0)


def _assert_oracle(got, want, n):
    """Every element within 2·eps·N·log2N, absolute or relative."""
    got = np.asarray(got, dtype=want.dtype).reshape(want.shape)
    diff = np.abs(got - want)
    tol = _tol(n)
    assert np.all((diff <= tol) | (diff <= tol * np.abs(want))), diff.max()


def _assert_parity(got, want_ref):
    delta = np.abs(np.asarray(got) - np.asarray(want_ref)).max()
    assert delta <= 5e-5 * np.abs(np.asarray(want_ref)).max(), delta


def _reals(batch, n, seed):
    return np.random.default_rng(seed).uniform(-1, 1, (batch, n)).astype(np.float32)


def _half_spectra(batch, n, seed):
    """complex64 half spectra of real signals (np.fft.rfft leaves the
    imaginary parts of bins 0 and n/2 exactly 0), as (batch, n/2+1)."""
    x = _reals(batch, n, seed).astype(np.float64)
    return np.fft.rfft(x, axis=1).astype(np.complex64)


def _raw(c):
    """complex -> flat float32 (re, im) pairs."""
    return np.ascontiguousarray(c.astype(np.complex64)).reshape(-1).view(np.float32)


def _port_rtabs(n, sign):
    bank = torch_fft.TwiddleBank(np.float32)
    key = bank.rfft_untangle(n, sign)
    return [torch.from_numpy(bank.host[key + s]) for s in "ri"]


# -- (a) each kernel's plain version against the reference's kernel ----------


@pytest.mark.parametrize("n,batch", [(1024, 64), (8192, 16)])
def test_untangle_matches_untangle_raw_call(n, batch):
    h, scale = n // 2, 0.75
    x = _reals(batch, n, n)
    z = np.fft.fft(x[:, 0::2] + 1j * x[:, 1::2], axis=1)  # the h-point spectrum
    zraw = _raw(z)
    rbank = xla_fft.TwiddleBank(np.float32)
    rkey = rbank.rfft_untangle(n, -1)
    want = pallas_real.untangle_raw_call(
        jnp.asarray(zraw), batch, n,
        [jnp.asarray(rbank.host[rkey + s]) for s in "ri"], REF_CFG, scale,
    )
    assert want is not None
    got = cuda_real.untangle(torch.from_numpy(zraw), batch, h,
                             *_port_rtabs(n, -1), scale).numpy()
    oracle = scale * np.fft.rfft(x.astype(np.float64), axis=1)
    for y in (got, np.asarray(want)):
        _assert_oracle(y.view(np.complex64), oracle, n)
    _assert_parity(got, want)


@pytest.mark.parametrize("n,batch", [(1024, 64), (8192, 16)])
def test_retangle_matches_retangle_raw_call(n, batch):
    """The retangled spectrum of rfft(x) is 2·scale·FFT_h(x_even + i·x_odd):
    the h-point backward transform then gives n·scale·x."""
    h, scale = n // 2, 1.5
    spec = _half_spectra(batch, n, n + 1)
    xraw = _raw(spec)
    x = np.fft.irfft(spec.astype(np.complex128), n, axis=1)  # its exact signal
    rbank = xla_fft.TwiddleBank(np.float32)
    rkey = rbank.rfft_untangle(n, +1)
    want = pallas_real.retangle_raw_call(
        jnp.asarray(xraw), batch, n,
        [jnp.asarray(rbank.host[rkey + s]) for s in "ri"], REF_CFG, scale,
    )
    assert want is not None
    got = cuda_real.retangle(torch.from_numpy(xraw), batch, h,
                             *_port_rtabs(n, +1), scale).numpy()
    oracle = 2 * scale * np.fft.fft(x[:, 0::2] + 1j * x[:, 1::2], axis=1)
    for y in (got, np.asarray(want)):
        _assert_oracle(y.view(np.complex64), oracle, n)
    _assert_parity(got, want)


@pytest.mark.parametrize("sign", [-1, +1])
@pytest.mark.parametrize("n", [32, 512])
def test_small_real_matches_small_real_raw_call(n, sign):
    """Backward at scale 2/n: the outputs are O(1), as the oracle's absolute
    tolerance assumes (at scale 1/4 the reference's bf16×3 matrix misses
    it on 0.1% of the elements at n = 32; the port does not)."""
    scale = 0.5 if sign < 0 else 2.0 / n
    g = pallas_real.small_group(n)
    batch = 8 * g  # a batch the reference's kernel groups
    rbank = xla_fft.TwiddleBank(np.float32)
    tab = rbank.real_small(n, g, sign, scale)
    if sign < 0:
        x = _reals(batch, n, n)
        raw = x.reshape(-1)
        oracle = scale * np.fft.rfft(x.astype(np.float64), axis=1)
    else:
        spec = _half_spectra(batch, n, n)
        raw = _raw(spec)
        oracle = scale * n * np.fft.irfft(spec.astype(np.complex128), n, axis=1)
    want = pallas_real.small_real_raw_call(
        jnp.asarray(raw), batch, n, sign, rbank.device_arrays()[tab + "k"],
        REF_CFG,
    )
    assert want is not None
    bank = torch_fft.TwiddleBank(np.float32)
    w, m = bank.dft(n, sign), bank.real_small(n, sign, scale)
    tabs = cuda_real.SmallRealTables(
        n, sign, scale, *(torch.from_numpy(bank.host[k])
                          for k in (w + "r", w + "i", m + "m")),
    )
    got = cuda_real.small_real(torch.from_numpy(raw), batch, tabs).numpy()
    for y in (got, np.asarray(want)):
        _assert_oracle(y.view(np.complex64) if sign < 0 else y, oracle, n)
    _assert_parity(got, want)
    # the reference keeps the same matrix as a bf16 pair (hi, lo) per block
    stack = np.asarray(rbank.host[tab + "k"], np.float32)
    kk, nn = tabs.mat.shape
    hi_lo = stack[:kk, :nn] + stack[2 * g * kk:2 * g * kk + kk, :nn]
    assert np.abs(hi_lo - tabs.mat.numpy()).max() <= 2.0**-14 * np.abs(hi_lo).max()


def test_small_real_backward_drops_the_imaginary_dc_and_nyquist():
    """K9's backward has irfft semantics, as the reference's matrix does."""
    n, batch = 32, 2
    spec = _half_spectra(batch, n, 3)
    bent = spec.copy()
    bent[:, 0] += 5j
    bent[:, -1] -= 7j
    plan = pt.Descriptor(lengths=[n], number_of_transforms=batch,
                         domain=pt.Domain.REAL).commit(device="cpu")
    assert np.array_equal(plan.compute_backward(bent), plan.compute_backward(spec))


# -- (b) the whole slice ------------------------------------------------------

# (n, batch, port entry, C2C kernel under it or None): small path at 32, 100
# and 512; half length on each C2C kernel (h = 512 K1, h = 4096 K2,
# h = 65536 K3); n = 1000 (h = 500) is a half length the reference's kernels
# do not take.
SLICE = [
    (32, 32, "realsf", None), (100, 8, "realsf", None), (512, 8, "realsf", None),
    (1000, 2, "realf", "direct"), (1024, 32, "realf", "direct"),
    (8192, 16, "realf", "fused2"), (1 << 17, 1, "realf", "global2"),
]


@pytest.mark.parametrize("n,batch,entry,c2c", SLICE)
def test_real_slice_matches_reference(n, batch, entry, c2c):
    fs, bs = 0.5, 3.0 / n
    kw = dict(lengths=[n], number_of_transforms=batch, forward_scale=fs,
              backward_scale=bs)
    rplan = ref.Descriptor(domain=ref.Domain.REAL, **kw).commit(use_pallas=True)
    plan = pt.Descriptor(domain=pt.Domain.REAL, **kw).commit(device="cpu")
    fwd, bwd = plan._raw_fast[pt.Direction.FORWARD], plan._raw_fast[pt.Direction.BACKWARD]
    route = {"realsf": fastpath.SmallReal, "realf": fastpath.HalfReal}[entry]
    assert isinstance(fwd, route) and isinstance(bwd, route)
    assert (fwd.sign, bwd.sign) == (-1, +1)
    if c2c is not None:
        assert fwd.inner.engine.name == bwd.inner.engine.name == c2c
        assert fwd.inner.plan is plan.plans[n // 2]
    described, want_described = plan.plan_description(), rplan.plan_description()
    if 512 < n < 1024:  # the reference adds the h plan only from n = 1024
        assert described.pop(n // 2) == plan.plans[n // 2].describe()
    assert described == want_described

    x = _reals(batch, n, n)
    y, y_ref = plan.compute_forward(x.reshape(-1)), rplan.compute_forward(x.reshape(-1))
    assert isinstance(y, np.ndarray) and y.dtype == np.complex64
    assert y.shape == np.shape(y_ref) == (batch * (n // 2 + 1),)
    oracle = fs * np.fft.rfft(x.astype(np.float64), axis=1)
    for got in (y, np.asarray(y_ref)):
        _assert_oracle(got, oracle, n)
    _assert_parity(y, y_ref)

    spec = _half_spectra(batch, n, n + 1).reshape(-1)
    b, b_ref = plan.compute_backward(spec), rplan.compute_backward(spec)
    assert isinstance(b, np.ndarray) and b.dtype == np.float32
    assert b.shape == np.shape(b_ref) == (batch * n,)
    oracle = bs * n * np.fft.irfft(spec.reshape(batch, -1).astype(np.complex128),
                                   n, axis=1)
    for got in (b, np.asarray(b_ref)):
        _assert_oracle(got, oracle, n)
    _assert_parity(b, b_ref)


def test_real_round_trip_through_tensors():
    n, batch = 8192, 3
    plan = pt.Descriptor(lengths=[n], number_of_transforms=batch,
                         domain=pt.Domain.REAL, backward_scale=1.0 / n).commit(
        device="cpu"
    )
    x = torch.from_numpy(_reals(batch, n, 5))
    back = plan.compute_backward(plan.compute_forward(x))
    assert torch.allclose(back.view(batch, n), x, atol=1e-5)


# -- (c) output kinds and errors -----------------------------------------------


def test_real_output_kinds():
    """numpy reals -> numpy complex64; a float tensor -> raw float32 pairs on
    its device; backward from numpy complex, numpy raw pairs, a complex
    tensor or a raw tensor -> float32 reals of the same kind; all equal."""
    n, batch = 1024, 2
    plan = pt.Descriptor(lengths=[n], number_of_transforms=batch,
                         domain=pt.Domain.REAL).commit(device="cpu")
    x = _reals(batch, n, 9)
    y_np = plan.compute_forward(x)  # any shape: the buffer is read flat
    y_t = plan.compute_forward(torch.from_numpy(x.astype(np.float64)))
    assert y_np.dtype == np.complex64 and y_np.shape == (batch * (n // 2 + 1),)
    assert y_t.dtype == torch.float32 and y_t.device.type == "cpu"
    assert y_t.shape == (batch * (n + 2),)
    assert np.array_equal(y_t.numpy().view(np.complex64), y_np)
    outs = [
        plan.compute_backward(y_np),
        plan.compute_backward(y_np.view(np.float32)),
        plan.compute_backward(torch.from_numpy(y_np.copy())),
        plan.compute_backward(y_t),
    ]
    assert all(isinstance(o, np.ndarray) for o in outs[:2])
    assert all(isinstance(o, torch.Tensor) for o in outs[2:])
    for o in outs:
        o = np.asarray(o)
        assert o.dtype == np.float32 and o.shape == (batch * n,)
        assert np.array_equal(o, np.asarray(outs[0]))
    # a longer buffer: the scalars past the input count are not read
    longer = np.concatenate([x.reshape(-1), np.full(7, 9.0, np.float32)])
    assert np.array_equal(plan.compute_forward(longer), y_np)


def test_real_buffer_errors():
    n, batch = 32, 2
    plan = pt.Descriptor(lengths=[n], number_of_transforms=batch,
                         domain=pt.Domain.REAL).commit(device="cpu")
    with pytest.raises(pt.InvalidConfiguration, match="real buffer"):
        plan.compute_forward(np.zeros(batch * n, np.complex64))
    with pytest.raises(pt.InvalidConfiguration, match="real buffer"):
        plan.compute_forward(torch.zeros(batch * n, dtype=torch.complex64))
    with pytest.raises(pt.InvalidConfiguration, match="needs 64"):
        plan.compute_forward(np.zeros(63, np.float32))
    with pytest.raises(pt.InvalidConfiguration, match="needs 34"):
        plan.compute_backward(np.zeros(33, np.complex64))
    with pytest.raises(pt.InvalidConfiguration, match="single complex"):
        plan.compute_forward(np.zeros(64, np.float32), np.zeros(64, np.float32))
    with pytest.raises(pt.UnsupportedConfiguration, match="item 9"):
        plan.compute_forward(np.zeros(64, np.float32),
                             out=np.zeros(34, np.complex64))
    with pytest.raises(pt.InvalidConfiguration, match="given to a plan"):
        plan.compute_forward(torch.zeros(64, device="meta"))


@pytest.mark.parametrize(
    "kw,item",
    [
        (dict(placement="IN_PLACE"), "item 9"),
        (dict(complex_storage="SPLIT_COMPLEX"), "item 9"),
        (dict(lengths=[8, 16]), "item 9"),
        (dict(precision="fp64"), "item 12"),
        (dict(forward_offset=4), "item 9"),
        (dict(number_of_transforms=2, forward_strides=[2], backward_strides=[2],
              forward_distance=64, backward_distance=34), "item 9"),
    ],
)
def test_real_outside_the_slice_raises_at_commit(kw, item):
    kw = {"lengths": [16], **kw}
    for field, enum in (("placement", pt.Placement),
                        ("complex_storage", pt.ComplexStorage)):
        if field in kw:
            kw[field] = enum[kw[field]]
    with pytest.raises(pt.UnsupportedConfiguration, match=item):
        pt.Descriptor(domain=pt.Domain.REAL, **kw).commit(device="cpu")


@pytest.mark.parametrize(
    "kw",
    [
        dict(lengths=[1000], number_of_transforms=3),
        dict(lengths=[32], number_of_transforms=5, placement="IN_PLACE"),
        dict(lengths=[8, 6], number_of_transforms=2),
        dict(lengths=[64], number_of_transforms=4, forward_distance=70,
             backward_distance=40),
    ],
)
def test_real_descriptor_counts_match(kw):
    """REAL buffer counts, distances and dict form equal the reference's."""
    descs = []
    for mod in (ref, pt):
        k = dict(kw, domain=mod.Domain.REAL)
        if "placement" in k:
            k["placement"] = mod.Placement[k["placement"]]
        descs.append(mod.Descriptor(**k))
    rd, d = descs
    assert d.to_dict() == rd.to_dict()
    for rdir, pdir in zip(ref.Direction, pt.Direction):
        assert d.get_input_count(pdir) == rd.get_input_count(rdir)
        assert d.get_output_count(pdir) == rd.get_output_count(rdir)


# -- (d) tables and plans ------------------------------------------------------


@pytest.mark.parametrize("n", [1000, 1024, 8192, 1 << 17])
def test_untangle_tables_bit_equal_and_carried_over(n):
    """The R tables equal the reference's bit for bit, and
    ``convert.bank_from_reference`` carries them (float32) and leaves the
    bf16 small-n stacks behind."""
    rbank = xla_fft.TwiddleBank(np.float32)
    bank = torch_fft.TwiddleBank(np.float32)
    for sign in (-1, +1):
        key = rbank.rfft_untangle(n, sign)
        assert bank.rfft_untangle(n, sign) == key
        for s in "ri":
            assert bank.host[key + s].dtype == np.float32
            assert np.array_equal(bank.host[key + s], rbank.host[key + s])
    small = rbank.real_small(32, 4, -1, 1.0)
    carried = convert.bank_from_reference(rbank.host, "cpu")
    assert small + "k" not in carried
    for sign in (-1, +1):
        key = bank.rfft_untangle(n, sign)
        for s in "ri":
            assert torch.equal(carried[key + s], torch.from_numpy(bank.host[key + s]))


def test_committed_plan_runs_on_carried_tables():
    """A REAL plan whose device tables are the reference's, carried over,
    computes what the same plan on its own tables computes."""
    n, batch = 8192, 2
    kw = dict(lengths=[n], number_of_transforms=batch, forward_scale=0.5)
    rplan = ref.Descriptor(domain=ref.Domain.REAL, **kw).commit(use_pallas=True)
    plan = pt.Descriptor(domain=pt.Domain.REAL, **kw).commit(device="cpu")
    x = torch.from_numpy(_reals(batch, n, 1).reshape(-1))
    want = plan.compute_forward(x)
    plan._bank_arrays = convert.bank_from_reference(rplan._bank.host, "cpu")
    fn = fastpath.build_fn(plan, plan._raw_fast[pt.Direction.FORWARD])
    assert torch.equal(fn(x), want)


def test_plain_versions_restore_the_tf32_setting():
    """The plain versions' TF32 switch is scoped: the caller's setting comes
    back on return and on an exception."""
    on_card = types.SimpleNamespace(is_cuda=True)
    allowed = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with torch_fft.full_fp32_matmuls(on_card):
            assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is True
        with pytest.raises(RuntimeError):
            with torch_fft.full_fp32_matmuls(on_card):
                raise RuntimeError
        assert torch.backends.cuda.matmul.allow_tf32 is True
        with torch_fft.full_fp32_matmuls(torch.zeros(1)):  # CPU: untouched
            assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allowed
