"""The single-sweep GLOBAL kernels of portfft_tpu_torch against the Pallas
kernels they replace, on the CPU: K4 (``cuda_global.global_sq``) against
``pallas_global.global_sq_raw_call``, K5 and K5-ov
(``cuda_global_bf.global_bf``, ``global_bf_ov``) against
``pallas_global_bf.global_bf_raw_call`` and ``global_bf_ov_raw_call``.

The reference kernels run in interpret mode at the shapes of the JAX
package's own tests (``tests/test_mm_kernels.py``, ``tests/test_bf_engine.py``);
the port's wrappers receive CPU tensors and so run their plain versions.
Inputs are made with numpy from a seed and handed to both.

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
from portfft_tpu import fastpath as ref_fastpath
from portfft_tpu import tuning as ref_tuning
from portfft_tpu.config import DeviceConfig as RefConfig
from portfft_tpu.enums import Direction as RefDirection
from portfft_tpu.enums import Level as RefLevel
from portfft_tpu.ops import pallas_global, pallas_global_bf, xla_fft
from portfft_tpu.planner import Plan1D as RefPlan1D
from portfft_tpu.planner import plan_1d as ref_plan_1d
import portfft_tpu_torch as pf
from portfft_tpu_torch import fastpath, tuning
from portfft_tpu_torch.config import DeviceConfig
from portfft_tpu_torch.enums import Level
from portfft_tpu_torch.ops import cuda_fft, cuda_global, cuda_global_bf, torch_fft
from portfft_tpu_torch.planner import Plan1D, plan_1d

CFG = DeviceConfig()


def _ref_global_plan(g1, g2, ref_cfg):
    return RefPlan1D(n=g1 * g2, level=RefLevel.GLOBAL, factors=[],
                     sub=(ref_plan_1d(g1, ref_cfg, 4), ref_plan_1d(g2, ref_cfg, 4)))


def _port_global_plan(g1, g2):
    return Plan1D(n=g1 * g2, level=Level.GLOBAL, factors=[],
                  sub=(plan_1d(g1, CFG, 4), plan_1d(g2, CFG, 4)))


def _port_arrays(plan, sign):
    bank, keys = torch_fft.TwiddleBank(np.float32), {}
    torch_fft.collect_bank_keys(plan, sign, bank, keys)
    return keys, bank.device_arrays("cpu")


def _ref_arrays(plan, sign):
    bank = xla_fft.TwiddleBank(np.float32)
    keys = xla_fft.collect_bank_keys(plan, sign, bank)
    return keys, bank.device_arrays()


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


def _input(batch, n, seed):
    return np.random.default_rng(seed).uniform(-1, 1, 2 * batch * n).astype(np.float32)


# -- K4 global_sq ---------------------------------------------------------------

SQ_CFG = RefConfig(name="cpu", vmem_bytes=64 * 2**20)


@pytest.mark.parametrize("g1,g2,batch,sign,scale", [
    (256, 256, 4, -1, 0.5),   # the 65536 split, folded scale
    (512, 256, 1, -1, 2.0),   # 2^17: two different DIRECT subs
    (1024, 128, 2, -1, 1.0),  # FUSED [8, 128] x DIRECT 128
    (256, 256, 2, +1, 1.0),   # backward
])
def test_k4_plain_matches_global_sq_raw_call(g1, g2, batch, sign, scale):
    """K4's plain version against ``global_sq_raw_call`` in interpret
    mode.  The reference gate takes all four plans; the port's kernel takes
    the DIRECT ones (``sq_cluster``)."""
    n = g1 * g2
    rplan, plan = _ref_global_plan(g1, g2, SQ_CFG), _port_global_plan(g1, g2)
    assert pallas_global.global_sq_supported(rplan, SQ_CFG)
    assert cuda_global.global_sq_supported(plan) == (g1 <= 512)
    raw = _input(batch, n, n + batch)
    rkeys, rarrs = _ref_arrays(rplan, sign)
    want = pallas_global.global_sq_raw_call(jnp.asarray(raw), batch, rplan, sign,
                                            rkeys, rarrs, SQ_CFG, scale=scale)
    assert want is not None
    keys, arrays = _port_arrays(plan, sign)
    t = keys[("T", g1, g2, sign)]
    got = cuda_global.global_sq(
        torch.from_numpy(raw), batch,
        cuda_fft.sub_tables(plan.sub[0], sign, keys, arrays),
        cuda_fft.sub_tables(plan.sub[1], sign, keys, arrays),
        arrays[t + "r"], arrays[t + "i"], scale)
    _check(got.numpy(), want, raw, batch, n, sign, scale)


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


@pytest.mark.parametrize("n,batch,scale", [(65536, 4, 0.5), (1 << 17, 1, 1.0)])
def test_k4_tuned_route_matches_the_reference_override(tmp_caches, n, batch, scale):
    """The reference's ``build_fn(..., overrides={"eng": 5})`` against the
    port's committed plan whose tuned entry selects K4."""
    rplan = ref.Descriptor(lengths=[n], number_of_transforms=batch,
                           forward_scale=scale).commit(use_pallas=True)
    entry = rplan._raw_fast[RefDirection.FORWARD]
    raw = _input(batch, n, 11)
    want = ref_fastpath.build_fn(rplan, RefDirection.FORWARD, entry, 2 * batch * n,
                                 overrides={"eng": 5, "bt": 1})(
        jnp.asarray(raw), rplan._bank_arrays)
    desc = pf.Descriptor(lengths=[n], number_of_transforms=batch, forward_scale=scale)
    probe = desc.commit(device="cpu")
    tuning.record("cpu", "global2", tuning._entry_key(probe, "global2"), {"eng": 5})
    plan = desc.commit(device="cpu")
    assert plan._raw_fast[pf.Direction.FORWARD][-1] == "global_sq"
    got = plan.compute_forward(torch.from_numpy(raw))
    _check(got.numpy(), want, raw, batch, n, -1, scale)


# -- K5 global_bf and K5-ov global_bf_ov -----------------------------------------

BF_CFG = RefConfig(name="cpu", vmem_bytes=256 * 2**20)


def _bf_case(g1, g2, sign, batch, scale, ov, t1=0):
    n = g1 * g2
    rplan, plan = _ref_global_plan(g1, g2, BF_CFG), _port_global_plan(g1, g2)
    assert pallas_global_bf.global_bf_supported(rplan, BF_CFG)
    assert cuda_global_bf.global_bf_supported(plan)
    raw = _input(batch, n, 7)
    rkeys, rarrs = _ref_arrays(rplan, sign)
    call = (pallas_global_bf.global_bf_ov_raw_call if ov
            else pallas_global_bf.global_bf_raw_call)
    want = call(jnp.asarray(raw), batch, rplan, sign, rkeys, rarrs, BF_CFG,
                scale=scale, t1_override=t1)
    assert want is not None
    keys, arrays = _port_arrays(plan, sign)
    tabs = cuda_global_bf.bf_tables(plan, sign, keys, arrays, batch)
    kernel = cuda_global_bf.global_bf_ov if ov else cuda_global_bf.global_bf
    got = kernel(torch.from_numpy(raw), batch, tabs, scale)
    _check(got.numpy(), want, raw, batch, n, sign, scale)


@pytest.mark.parametrize("g1,g2,sign,scale,batch", [
    (256, 256, -1, 1.0, 2),   # A1 = A2 = 2, the 65536 split
    (512, 256, -1, 0.5, 2),   # A1 = 4, folded scale (2^17)
    (256, 512, +1, 1.0, 2),   # backward, A2 = 4
    (128, 256, -1, 1.0, 2),   # degenerate A1 = 1
    (256, 1024, -1, 1.0, 1),  # A2 = 8
])
def test_k5_plain_matches_global_bf_raw_call(g1, g2, sign, scale, batch):
    _bf_case(g1, g2, sign, batch, scale, ov=False)


@pytest.mark.parametrize("g1,g2,sign,scale,t1", [
    (512, 256, -1, 1.0, 128),
    (512, 256, -1, 0.5, 256),
    (256, 512, +1, 1.0, 128),
    (128, 256, -1, 1.0, 256),
])
def test_k5_ov_plain_matches_global_bf_ov_raw_call(g1, g2, sign, scale, t1):
    """Batch 3: the reference's phase overlay runs three rows through its
    parity-dual scratch."""
    _bf_case(g1, g2, sign, 3, scale, ov=True, t1=t1)


def test_butterfly_is_the_a_point_dft():
    """The radix-2 butterfly (natural order in and out, snapped constants;
    the mixed-radix slab DFT ``torch_fft.mixed_radix_dft`` at A = 2^k) is
    the A-point DFT of its slabs, A = 1 … 16, both signs."""
    rng = np.random.default_rng(3)
    for a in (1, 2, 4, 8, 16):
        x = rng.uniform(-1, 1, (a, 5)) + 1j * rng.uniform(-1, 1, (a, 5))
        for sign in (-1, +1):
            slabs = [(torch.from_numpy(r.real.copy()), torch.from_numpy(r.imag.copy()))
                     for r in x]
            out = torch_fft.mixed_radix_dft(slabs, sign)
            got = np.stack([r.numpy() + 1j * i.numpy() for r, i in out])
            w = np.exp(sign * 2j * np.pi * np.outer(np.arange(a), np.arange(a)) / a)
            assert np.allclose(got, w @ x, atol=1e-12)


def test_bf_tiles_and_chunks():
    """K5's tiles fit half of the 227 KiB of shared memory (two blocks an
    SM) and its chunk a quarter of the 50 MB L2: 2^20 runs one transform a
    chunk with two columns per tile of its 2048-point pass; the gate takes
    only A·128 subs with A ≤ 16."""
    assert [cuda_global_bf.bf_tile(g) for g in (128, 512, 1024, 2048)] == [8, 8, 4, 2]
    assert cuda_global_bf.bf_chunk(1 << 20, 128) == 1
    assert cuda_global_bf.bf_chunk(1 << 17, 1024) == 11
    assert cuda_global_bf.bf_chunk(1 << 17, 5) == 5
    assert not cuda_global_bf.global_bf_supported(_port_global_plan(384, 256))
    assert not cuda_global_bf.global_bf_supported(plan_1d(4096, CFG, 4))
