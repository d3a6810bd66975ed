"""The radix sub-FFT of ``csrc/fft_radix.cuh`` (K11 ``md2``, K15
``bluestein`` and K17 ``global_fused`` run on it) through its plain version
``torch_fft.radix_sub_plain``, on the CPU.

Every sub length the two kernels' gates can hand it is held to the DFT:
DIRECT 2–512 (among them the prime 509, 508 = 4·127 with its generic
radix-127 stage and 384 = 3·2^7) against the DFT matrix, and FUSED [a, 128]
for a in {3, 4, 8, …, 256} against ``np.fft`` in float64, both directions,
on the port's own root tables.  Then the stage factorization the kernel
uses (``torch_fft.radix_stages`` mirrors its ``stages``), and K15's plain
version, whose four sub-transforms a row run on these stages, against
``np.fft`` at three convolutions: DIRECT 384 x 384 (65537), FUSED [16, 128]
x DIRECT 144 (131101) and DIRECT 40 x 56 (1109, a hand-made plan: the
planner's convolutions are 2^a·3^b, and 40 = 5·8 and 56 = 7·8 run generic
radix-5 and radix-7 stages).

Tolerance: max|y − DFT(x)| ≤ 4·eps·log2(n)·max|DFT(x)|, the growth of a
radix FFT's fp32 error with the number of stages (well inside the oracle's
2·eps·N·log2N).  For K15 n is the convolution's length M = g1·g2: its four
sub-transforms run 2·log2(M) stages between them, at 2·eps a stage, and
the chirp, b̂ and twiddle products add a few eps (measured: 0.13–0.16
eps·log2(M)).  Inputs are made with numpy from a seed.
"""

import math
import pathlib
import re

import numpy as np
import pytest
import torch

from portfft_tpu_torch.config import DeviceConfig
from portfft_tpu_torch.enums import Level
from portfft_tpu_torch.ops import cuda_bluestein, cuda_fft, torch_fft
from portfft_tpu_torch.planner import Plan1D, plan_1d

CFG = DeviceConfig()
EPS = float(np.finfo(np.float32).eps)
HEADER = pathlib.Path(torch_fft.__file__).parent.parent / "csrc" / "fft_radix.cuh"
# DIRECT 2 … 512 in groups of 32 lengths, one case each.
DIRECT_GROUPS = [list(range(lo, min(lo + 32, 513))) for lo in range(2, 513, 32)]


def _sub(plan, sign):
    bank, keys = torch_fft.TwiddleBank(np.float32), {}
    torch_fft.collect_bank_keys(plan, sign, bank, keys)
    return cuda_fft.sub_tables(plan, sign, keys, bank.device_arrays("cpu"))


def _check(sub, n, sign, ref_of):
    x = np.random.default_rng(n).uniform(-1, 1, (3, n, 2)).astype(np.float32)
    xc = x[..., 0].astype(np.complex128) + 1j * x[..., 1]
    got = torch_fft.radix_sub_plain(
        sub, torch.view_as_complex(torch.from_numpy(x))).numpy()
    want = ref_of(xc)
    tol = 4 * EPS * max(1.0, math.log2(n)) * np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol, (n, sign, err, tol)


@pytest.mark.parametrize("lengths", DIRECT_GROUPS,
                         ids=[f"{g[0]}-{g[-1]}" for g in DIRECT_GROUPS])
def test_direct_is_the_dft_matrix(lengths):
    for n in lengths:
        plan = plan_1d(n, CFG, 4)
        assert plan.level == Level.DIRECT
        k = np.arange(n)
        w = np.exp(-2j * np.pi * (np.outer(k, k) % n) / n)  # sign -1; +1 is w̄
        for sign in (-1, +1):
            ws = w if sign < 0 else w.conj()
            _check(_sub(plan, sign), n, sign, lambda xc: xc @ ws)


@pytest.mark.parametrize("a", [3, 4, 8, 16, 32, 64, 128, 256])
def test_fused_is_the_dft(a):
    n = a * 128
    plan = Plan1D(n=n, level=Level.FUSED, factors=[a, 128])
    for sign in (-1, +1):
        _check(_sub(plan, sign), n, sign,
               lambda xc: np.fft.fft(xc) if sign < 0 else np.fft.ifft(xc) * n)


def test_stages_are_the_kernel_factorization():
    """``radix_stages`` of every length up to ``pfft::kTileMax``: the
    product is the length; the prime factors above 3 come first in
    ascending order, then the 3s, then 8s, then one 4, two 4s or one 2;
    never more than the header's ``kMaxStages``; and the lengths the
    header names."""
    max_stages = int(re.search(r"kMaxStages = (\d+);", HEADER.read_text()).group(1))
    for n in range(1, 8193):
        st = torch_fft.radix_stages(n)
        assert math.prod(st) == n and len(st) <= max_stages, (n, st)
        big = [r for r in st if r not in (2, 3, 4, 8)]
        assert st[:len(big)] == sorted(big) and all(
            r > 3 and all(r % p for p in range(2, math.isqrt(r) + 1)) for r in big)
        tail = st[len(big):]
        assert tail == sorted(tail, key=(3, 8, 4, 2).index), (n, st)
        assert tail.count(2) + tail.count(4) <= 2 and tail.count(2) <= 1
        assert not (2 in tail and 4 in tail)
    assert torch_fft.radix_stages(128) == [8, 4, 4]
    assert torch_fft.radix_stages(384) == [3, 8, 4, 4]
    assert torch_fft.radix_stages(508) == [127, 4]
    assert torch_fft.radix_stages(509) == [509]
    assert torch_fft.radix_stages(512) == [8, 8, 8]
    for n in (128, 384, 508, 512):  # the header's own examples
        assert "*".join(map(str, torch_fft.radix_stages(n))) in HEADER.read_text()


def _direct(m):
    return Plan1D(n=m, level=Level.DIRECT, factors=[m])


# g1 x g2 -> (plan, batch): the convolutions of K15's three sub shapes.
BLUESTEIN_CASES = {
    "384x384": (lambda: plan_1d(65537, CFG, 4), 2),
    "2048x144": (lambda: plan_1d(131101, CFG, 4), 1),  # FUSED [16, 128] x 144
    "40x56": (lambda: Plan1D(n=1109, level=Level.BLUESTEIN, factors=[], conv=Plan1D(
        n=2240, level=Level.GLOBAL, factors=[], sub=(_direct(40), _direct(56)))), 3),
}


@pytest.mark.parametrize("case", list(BLUESTEIN_CASES))
def test_bluestein_on_the_stages_is_the_dft(case):
    """K15's plain version (``cuda_bluestein.bluestein`` on CPU planes: its
    sub-transforms through ``radix_sub_plain``) against ``np.fft`` in
    float64, both directions, with the scale 0.5; the plan is one K15's
    gate takes, with the convolution subs named by the case."""
    make, batch = BLUESTEIN_CASES[case]
    plan = make()
    assert cuda_bluestein.supported(plan, CFG)
    assert "x".join(str(s.n) for s in plan.conv.sub) == case
    n, m = plan.n, plan.conv.n
    rng = np.random.default_rng(n)
    xr, xi = (rng.uniform(-1, 1, (batch, n)).astype(np.float32) for _ in "ri")
    xc = xr.astype(np.complex128) + 1j * xi
    for sign in (-1, +1):
        bank, keys = torch_fft.TwiddleBank(np.float32), {}
        torch_fft.collect_bank_keys(plan, sign, bank, keys)
        tabs = cuda_bluestein.bluestein_tables(plan, sign, keys,
                                               bank.device_arrays("cpu"))
        yr, yi = cuda_bluestein.bluestein(torch.from_numpy(xr),
                                          torch.from_numpy(xi), tabs, 0.5)
        got = yr.numpy() + 1j * yi.numpy()
        want = 0.5 * (np.fft.fft(xc) if sign < 0 else np.fft.ifft(xc) * n)
        tol = 4 * EPS * math.log2(m) * np.abs(want).max()
        err = np.abs(got - want).max()
        assert err <= tol, (case, sign, err, tol)
