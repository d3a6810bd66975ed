"""Each kernel module of portfft_tpu_torch against the Pallas kernel it
replaces, on the CPU.

The reference kernels run in interpret mode as the JAX package's own tests
run them (``tests/test_mm_kernels.py``); the port's wrappers receive CPU
tensors and so run their plain PyTorch versions.  Inputs are made with
numpy from a seed and handed to both.

Tolerance: both within ``oracle.tolerance`` (2·eps·N·log2N) of ``np.fft``,
and port against reference max|Δ| ≤ 5e-5·max|y_ref| (the reference's bf16×3
matrix products measure about 1e-5 here).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
import portfft_tpu as ref
from portfft_tpu.config import DeviceConfig as RefConfig
from portfft_tpu.ops import pallas_fft, pallas_global, xla_fft
from portfft_tpu.planner import plan_1d as ref_plan_1d
from portfft_tpu_torch import convert
from portfft_tpu_torch.config import DeviceConfig
from portfft_tpu_torch.ops import cuda_fft, cuda_global, torch_fft
from portfft_tpu_torch.planner import plan_1d
from portfft_tpu_torch.utils import tracing

REF_CFG = RefConfig(name="cpu")
CFG = DeviceConfig()


def _input(batch, n, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, 2 * batch * n).astype(np.float32)


def _check(got_raw, ref_raw, x_raw, batch, n, sign, scale):
    """Both results against np.fft at the oracle tolerance, and the port
    against the reference."""
    desc = ref.Descriptor(lengths=[n], number_of_transforms=batch)
    tol = oracle.tolerance(desc)
    xc = x_raw.view(np.complex64).reshape(batch, n).astype(np.complex128)
    want = (np.fft.fft(xc) if sign < 0 else np.fft.ifft(xc) * n) * scale
    for raw in (got_raw, ref_raw):
        y = np.asarray(raw).view(np.complex64).reshape(batch, n)
        diff = np.abs(y - want)
        assert np.all((diff <= tol) | (diff <= tol * np.abs(want))), diff.max()
    y_ref = np.asarray(ref_raw)
    delta = np.abs(np.asarray(got_raw) - y_ref).max()
    assert delta <= 5e-5 * np.abs(y_ref).max(), delta


def _port_tables(plan, sign, host=None):
    """The port's keys and CPU tables for ``plan``; ``host`` (a reference
    ``TwiddleBank.host``) supplies the tables instead of the port's bank."""
    bank, keys = torch_fft.TwiddleBank(np.float32), {}
    torch_fft.collect_bank_keys(plan, sign, bank, keys)
    if host is None:
        return keys, bank.device_arrays("cpu")
    return keys, convert.bank_from_reference(host, "cpu")


@pytest.mark.parametrize(
    "n,batch,sign,scale",
    [
        (16, 64, -1, 1.0),
        (16, 128, +1, 0.25),
        (256, 8, -1, 0.5),
        (256, 8, +1, 1.0),
        (512, 8, -1, 1.0),
        (512, 16, +1, 1.0 / 512),
    ],
)
def test_direct_matches_direct_raw_call(n, batch, sign, scale):
    x = _input(batch, n, n + batch)
    sup = pallas_fft.direct_raw_supported(n, batch * n)
    assert sup is not None
    chunk, rt = sup
    rbank = xla_fft.TwiddleBank(np.float32)
    vkey = rbank.vmat(n, sign, chunk, scale)
    want = pallas_fft.direct_raw_call(
        jnp.asarray(x), n, rbank.device_arrays()[vkey + "v"], chunk, rt, REF_CFG
    )
    plan = plan_1d(n, CFG, 4)
    keys, arrays = _port_tables(plan, sign)
    sub = cuda_fft.sub_tables(plan, sign, keys, arrays)
    got = cuda_fft.direct(torch.from_numpy(x), batch, sub, scale)
    assert torch.equal(got, cuda_fft.direct.plain(torch.from_numpy(x), batch, sub, scale))
    _check(got.numpy(), want, x, batch, n, sign, scale)


def _mm_tables(a, sign, scale):
    bank = xla_fft.TwiddleBank(np.float32)
    g = pallas_fft.fold_factor(a)
    ks = bank.dft_kstack(a, sign)
    tu = bank.twiddle_fm(a, 128, sign)
    wb = bank.dft_permuted(128, sign, g) if g > 1 else bank.dft(128, sign)
    kq = bank.mat_kara(wb, scale)
    arrs = bank.device_arrays()
    names = [ks + "k", tu + "r", tu + "i"] + [kq + str(j) for j in range(1, 7)]
    return [arrs[nm] for nm in names]


@pytest.mark.parametrize(
    "n,batch,sign,scale",
    [
        (1024, 16, -1, 1.0),
        (4096, 4, -1, 1.0),
        (4096, 4, +1, 1.0 / 4096.0),
        (8192, 4, -1, 2.0),
        (32768, 1, +1, 0.5),
    ],
)
def test_fused2_matches_fused2_raw_mm_call(n, batch, sign, scale):
    x = _input(batch, n, n + batch)
    rplan = ref_plan_1d(n, REF_CFG, 4)
    want = pallas_fft.fused2_raw_mm_call(
        jnp.asarray(x), batch, rplan, _mm_tables(rplan.factors[0], sign, scale),
        REF_CFG,
    )
    assert want is not None
    plan = plan_1d(n, CFG, 4)
    keys, arrays = _port_tables(plan, sign)
    sub = cuda_fft.sub_tables(plan, sign, keys, arrays)
    assert sub.a == plan.factors[0] and sub.m == n
    got = cuda_fft.fused2(torch.from_numpy(x), batch, sub, scale)
    _check(got.numpy(), want, x, batch, n, sign, scale)


@pytest.mark.parametrize(
    "n,batch,sign,scale",
    [
        (65536, 2, -1, 1.0),
        (65536, 1, +1, 0.5),
        (1 << 17, 1, -1, 2.0),
        (1 << 19, 1, -1, 1.0),
        (1 << 19, 1, +1, 1.0 / (1 << 19)),
    ],
)
def test_global2_matches_global2_raw_call(n, batch, sign, scale):
    """K3's plain version on the reference's own tables (carried over with
    ``convert.bank_from_reference``) and on the port's, against
    ``global2_raw_call`` — DIRECT×DIRECT and FUSED [16, 128]×DIRECT."""
    x = _input(batch, n, n + batch)
    rplan = ref_plan_1d(n, REF_CFG, 4)
    rbank = xla_fft.TwiddleBank(np.float32)
    rkeys = xla_fft.collect_bank_keys(rplan, sign, rbank)
    want = pallas_global.global2_raw_call(
        jnp.asarray(x), batch, rplan, sign, rkeys, rbank.device_arrays(),
        REF_CFG, scale=scale,
    )
    assert want is not None
    plan = plan_1d(n, CFG, 4)
    g1, g2 = plan.sub
    outs = []
    for host in (None, rbank.host):
        keys, arrays = _port_tables(plan, sign, host)
        t = keys[("T", g1.n, g2.n, sign)]
        got = cuda_global.global2(
            torch.from_numpy(x), batch,
            cuda_fft.sub_tables(g1, sign, keys, arrays),
            cuda_fft.sub_tables(g2, sign, keys, arrays),
            arrays[t + "r"], arrays[t + "i"], scale,
        )
        outs.append(got)
        _check(got.numpy(), want, x, batch, n, sign, scale)
    assert torch.equal(outs[0], outs[1])  # the tables are bit-equal


@pytest.mark.parametrize("inplace", [False, True])
def test_wrapper_writes_out(inplace):
    """``out=`` (the in-place path passes the input itself) receives the
    result; without it the input is left untouched."""
    n, batch = 4096, 2
    plan = plan_1d(n, CFG, 4)
    keys, arrays = _port_tables(plan, -1)
    sub = cuda_fft.sub_tables(plan, -1, keys, arrays)
    x = torch.from_numpy(_input(batch, n, 1))
    x0 = x.clone()
    want = cuda_fft.fused2.plain(x0, batch, sub, 1.0)
    got = cuda_fft.fused2(x, batch, sub, 1.0, out=x if inplace else None)
    assert torch.equal(got, want)
    assert (got is x) == inplace
    assert torch.equal(x, want if inplace else x0)


def test_wrappers_refuse_other_devices_and_bad_buffers():
    """A tensor that is neither on the CPU nor on a CUDA device is refused,
    never sent to the plain version; so are wrong sizes and dtypes."""
    from portfft_tpu_torch import InvalidConfiguration

    plan = plan_1d(16, CFG, 4)
    keys, arrays = _port_tables(plan, -1)
    sub = cuda_fft.sub_tables(plan, -1, keys, arrays)
    with pytest.raises(InvalidConfiguration, match="not supported"):
        cuda_fft.direct(torch.empty(64, device="meta"), 2, sub, 1.0)
    with pytest.raises(InvalidConfiguration, match="scalars"):
        cuda_fft.direct(torch.zeros(62), 2, sub, 1.0)
    with pytest.raises(InvalidConfiguration, match="float32"):
        cuda_fft.direct(torch.zeros(64, dtype=torch.float64), 2, sub, 1.0)
    before = tracing.launches(cuda_fft.direct.kernel)
    cuda_fft.direct(torch.zeros(64), 2, sub, 1.0)
    assert tracing.launches(cuda_fft.direct.kernel) == before  # the plain version launches nothing


def test_kernel_build_is_lazy_and_reports_a_missing_compiler(monkeypatch, tmp_path):
    from portfft_tpu_torch.ops import _build

    assert _build.load.cache_info().currsize == 0  # importing built nothing
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: None)
    with pytest.raises(_build.BuildError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "build").exists()
    assert len(_build._digest()) == 16
    assert all(p.suffix in (".cu", ".cuh") for p in _build._sources())
