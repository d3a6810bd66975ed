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
radix-5 and radix-7 stages).  Then a model of ``stage_odd``'s butterfly
(the odd primes 5 .. 23 in registers, by pair sums over folded roots, where
K13 runs them; ``stage_p``'s sums elsewhere) against ``np.fft``.  Last, a
model of K13's chain mode on the
stages (``fft_chain.cu``'s ``radix_chain_kernel``: each factor's DFT by
``radix_plain``, the stage twiddle on its store) against ``np.fft`` at the
planner's factors of 640, 600, 1000, 3072 and 19683, and a model of K9's
``small_real`` kernels (``fft_real.cu``: each row as the h = n/2 point FFT
on the stages with the untangle, or the retangle and then the inverse)
against ``np.fft.rfft``/``irfft`` at every even length K9 serves that the
benchmark or a prime h gives.

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
from portfft_tpu_torch.planner import Plan1D, plan_1d, stage_shapes

CFG = DeviceConfig()
EPS = float(np.finfo(np.float32).eps)
HEADER = pathlib.Path(torch_fft.__file__).parent.parent / "csrc" / "fft_radix.cuh"
# DIRECT 2 … 512 in groups of 32 lengths, one case each.
DIRECT_GROUPS = [list(range(lo, min(lo + 32, 513))) for lo in range(2, 513, 32)]


def _sub(plan, sign):
    bank, keys = torch_fft.TwiddleBank(np.float32), {}
    torch_fft.collect_bank_keys(plan, sign, bank, keys)
    return cuda_fft.sub_tables(plan, sign, keys, bank.device_arrays("cpu"))


def _check(sub, n, sign, ref_of, run=None):
    """``run`` (default: ``radix_sub_plain`` of ``sub``) on three random
    complex rows of n against ``ref_of`` in float64."""
    x = np.random.default_rng(n).uniform(-1, 1, (3, n, 2)).astype(np.float32)
    xc = x[..., 0].astype(np.complex128) + 1j * x[..., 1]
    run = run or (lambda t: torch_fft.radix_sub_plain(sub, t))
    got = run(torch.view_as_complex(torch.from_numpy(x))).numpy()
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


def _chain_stage_tables(factors, sign):
    """Per stage the bank's (wr, wi, tr, ti): the f×f DFT planes and the
    (m, f) twiddle planes, None at the last stage (``cuda_chain.chain_tables``'
    tables for a chain plan)."""
    bank = torch_fft.TwiddleBank(np.float32)
    names = [(bank.dft(f, sign), bank.twiddle(f, m, sign) if m > 1 else None)
             for f, m in stage_shapes(factors)]
    arrays = bank.device_arrays("cpu")
    return [(arrays[w + "r"], arrays[w + "i"],
             None if t is None else arrays[t + "r"],
             None if t is None else arrays[t + "i"]) for w, t in names]


def chain_on_stages(x: torch.Tensor, factors, stages) -> torch.Tensor:
    """K13's chain mode on the radix stages, on the complex rows of ``x``:
    stage s views a row as L vectors of f·m elements, runs the f-point DFT
    of each vector (r, n2) over n1 by ``radix_plain`` on the factor's roots,
    multiplies output k by T_s[n2, k] on its store and writes it to
    (r + L·k)·m + n2, as ``radix_chain_kernel`` does in a tile."""
    *lead, n = x.shape
    L = 1
    for f, (wr, wi, tr, ti) in zip(factors, stages):
        m = n // (L * f)
        v = x.reshape(*lead, L, f, m).transpose(-1, -2)  # [r, n2, n1]
        y = torch_fft.radix_plain(v, torch_fft._root_table(wr, wi, f))  # [r, n2, k]
        if tr is not None:
            y = y * torch.complex(tr, ti).reshape(m, f)
        x = y.movedim(-1, -3).reshape(*lead, n)  # [k, r, n2]
        L *= f
    return x


@pytest.mark.parametrize("n,factors", [(640, [5, 128]), (600, [120, 5]),
                                       (1000, [125, 8]), (3072, [24, 128]),
                                       (19683, [81, 81, 3])])
def test_chain_on_the_stages_is_the_dft(n, factors):
    """The model of K13's chain mode at the planner's factors, both
    directions, against ``np.fft`` in float64 (640 = [5, 128] is fastMRI's
    640-point axis; 19683 runs three stages)."""
    assert plan_1d(n, CFG, 4).factors == factors
    for sign in (-1, +1):
        stages = _chain_stage_tables(factors, sign)
        _check(None, n, sign,
               lambda xc: np.fft.fft(xc) if sign < 0 else np.fft.ifft(xc) * n,
               run=lambda x: chain_on_stages(x, factors, stages))


def odd_butterfly(v: torch.Tensor, root: torch.Tensor) -> torch.Tensor:
    """``fft_radix.cuh``'s ``stage_odd`` P-point DFT of the last axis of
    ``v`` (P odd): a_r = v[r] + v[P-r], b_r = v[r] - v[P-r], y[q] = v[0] +
    Σ a_r·Re w^(rq) + i·Σ b_r·Im w^(rq) and y[P-q] with -i, the root index
    rq mod P folded to e ≤ (P-1)/2 (w^(P-e) = conj w^e).  ``root`` holds
    w_P^e at e."""
    P = v.shape[-1]
    H = (P - 1) // 2
    a = [v[..., r] + v[..., P - r] for r in range(1, H + 1)]
    b = [v[..., r] - v[..., P - r] for r in range(1, H + 1)]
    y = [v[..., 0] + sum(a)] + [None] * (P - 1)
    for q in range(1, H + 1):
        A, B = v[..., 0], torch.zeros_like(v[..., 0])
        for r in range(1, H + 1):
            e = r * q % P
            w = root[min(e, P - e)]
            A = A + a[r - 1] * w.real
            B = B + b[r - 1] * (w.imag if e <= H else -w.imag)
        y[q], y[P - q] = A + 1j * B, A - 1j * B
    return torch.stack(y, dim=-1)


@pytest.mark.parametrize("p", [5, 7, 11, 13, 17, 19, 23])
def test_odd_stage_is_the_dft(p):
    """The model of ``stage_odd`` on the bank's p-point roots, both
    directions, against ``np.fft`` in float64."""
    bank = torch_fft.TwiddleBank(np.float32)
    for sign in (-1, +1):
        w = bank.dft(p, sign)
        arrays = bank.device_arrays("cpu")
        root = torch_fft._root_table(arrays[w + "r"], arrays[w + "i"], p)
        _check(None, p, sign,
               lambda xc: np.fft.fft(xc) if sign < 0 else np.fft.ifft(xc) * p,
               run=lambda x: odd_butterfly(x, root))


def small_real_on_stages(x: torch.Tensor, n: int, sign: int, wr, wi,
                         scale: float) -> torch.Tensor:
    """K9 on the radix stages (``fft_real.cu``'s ``small_real_tiles``), on
    rows of ``x``, with the n x n DFT planes ``wr``/``wi`` of the direction
    (W^k = root[k], w_h^e = root[2e]).  Forward (``sign`` < 0): real rows of
    n -> z = x_even + i·x_odd, Z = ``radix_plain`` of z on the h-point roots,
    then the untangle of each bin pair, X[k] = E + W^k·O with E = (Z[k] +
    conj Z[(h−k) mod h])/2, O = −i(Z[k] − conj Z[(h−k) mod h])/2, and X[h] =
    Re Z[0] − Im Z[0].  Backward: complex rows of h + 1 bins with Im X[0]
    and Im X[h] dropped, the retangle Z[k] = E2 + i·W^k·N2 with E2 = X[k] +
    conj X[h−k] and N2 = X[k] − conj X[h−k], then ``radix_plain`` of Z,
    whose z are the n reals.  Both times ``scale``, on the store."""
    h = n // 2
    root = torch_fft._root_table(wr, wi, n)
    root_h, w = root[0::2][:h], root[:h]
    if sign < 0:
        z = torch.complex(x[..., 0::2], x[..., 1::2])
        zk = torch_fft.radix_plain(z, root_h)
        zr = zk[..., (h - torch.arange(h)) % h].conj()
        e, o = (zk + zr) / 2, -1j * (zk - zr) / 2
        nyq = (zk[..., :1].real - zk[..., :1].imag).to(zk.dtype)
        return torch.cat([e + w * o, nyq], -1) * scale
    im = x.imag.clone()
    im[..., [0, h]] = 0.0
    x = torch.complex(x.real, im)
    xr = x[..., h - torch.arange(h)].conj()
    e2, n2 = x[..., :h] + xr, x[..., :h] - xr
    z = torch_fft.radix_plain(e2 + 1j * w * n2, root_h)
    return torch.stack([z.real, z.imag], -1).reshape(*x.shape[:-1], n) * scale


@pytest.mark.parametrize("n", [2, 4, 32, 90, 100, 180, 254, 502, 512])
def test_small_real_on_the_stages_is_the_rfft(n):
    """The model of K9 at r2c's 32 and 512, AFNO's 180, the smallest
    lengths, h = 45 and 50, and the prime h = 127 and 251 (one stage: the
    model's sum, the kernel's pair sums), both directions with a scale,
    against ``np.fft.rfft`` and
    ``irfft`` in float64; the backward input's Im X[0] and Im X[h] are not
    0 and must be dropped."""
    scale = 0.5
    rng = np.random.default_rng(n)
    bank = torch_fft.TwiddleBank(np.float32)
    for sign in (-1, +1):
        w = bank.dft(n, sign)
        arrays = bank.device_arrays("cpu")
        wr, wi = arrays[w + "r"], arrays[w + "i"]
        if sign < 0:
            x = rng.uniform(-1, 1, (3, n)).astype(np.float32)
            got = small_real_on_stages(torch.from_numpy(x), n, sign, wr, wi, scale)
            want = np.fft.rfft(x.astype(np.float64)) * scale
        else:
            spec = rng.uniform(-1, 1, (3, n // 2 + 1, 2)).astype(np.float32)
            assert np.abs(spec[:, [0, -1], 1]).min() > 0
            xc = torch.view_as_complex(torch.from_numpy(spec))
            got = small_real_on_stages(xc, n, sign, wr, wi, scale)
            kept = spec[..., 0] + 1j * spec[..., 1].astype(np.float64)
            kept[:, [0, -1]] = kept[:, [0, -1]].real
            want = np.fft.irfft(kept, n) * n * scale
        got = got.numpy()
        tol = 4 * EPS * max(1.0, math.log2(n)) * np.abs(want).max()
        err = np.abs(got - want).max()
        assert err <= tol, (n, sign, err, tol)


DIRECT_SOURCE = HEADER.parent / "fft_direct.cu"


def test_k1_lengths_run_the_kernels_stages():
    """The stages of c2c_1d.bulk's two K1 lengths, as ``fft_direct.cu``'s
    header names them: 16 = 4·4, 256 = 8·8·4."""
    assert torch_fft.radix_stages(16) == [4, 4]
    assert torch_fft.radix_stages(256) == [8, 8, 4]
    text = DIRECT_SOURCE.read_text()
    for n in (16, 256, 512):
        assert f"{n} = " + "*".join(map(str, torch_fft.radix_stages(n))) in text, n


def direct_on_stages(raw: torch.Tensor, batch: int, sub, scale: float) -> torch.Tensor:
    """K1 on the radix stages (``fft_direct.cu``'s ``direct_radix_kernel``)
    on the PACKED interleaved buffer ``raw`` (2·batch·n floats): each row
    of n = ``sub.m`` complex elements by ``radix_sub_plain`` of its DIRECT
    tables, times ``scale`` on the store, interleaved as it was read."""
    x = torch.view_as_complex(raw.view(batch, sub.m, 2))
    return torch.view_as_real(torch_fft.radix_sub_plain(sub, x) * scale).reshape(-1)


@pytest.mark.parametrize("n", [1, 16, 256, 509, 512])
def test_direct_rows_on_the_stages_are_the_dft(n):
    """The model of K1 at the smallest length (no stage: a copy with the
    scale), bulk's 16 and 256, the prime 509 (one generic stage) and the
    largest DIRECT length, both directions at the scales 0.5 and 3/n,
    against ``np.fft`` in float64 at 4·eps·log2(n)·max|X|."""
    plan = plan_1d(n, CFG, 4)
    assert plan.level == Level.DIRECT
    batch = 5
    raw = np.random.default_rng(n).uniform(-1, 1, 2 * batch * n).astype(np.float32)
    xc = raw.reshape(batch, n, 2).astype(np.float64) @ np.array([1, 1j])
    for sign, scale in ((-1, 0.5), (+1, 3.0 / n)):
        got = direct_on_stages(torch.from_numpy(raw), batch, _sub(plan, sign), scale)
        got = got.numpy().reshape(batch, n, 2) @ np.array([1, 1j])
        want = (np.fft.fft(xc) if sign < 0 else np.fft.ifft(xc) * n) * scale
        tol = 4 * EPS * max(1.0, math.log2(n)) * np.abs(want).max()
        err = np.abs(got - want).max()
        assert err <= tol, (n, sign, err, tol)


def test_k1_path_rule_mirrors_the_kernel():
    """``cuda_fft.direct_path`` holds ``fft_direct.cu``'s plain lengths (2,
    6 and the primes from ``kDirectPlainMin`` on) and sends bulk's 16 and
    256 and every other length up to 512 to the radix stages."""
    text = DIRECT_SOURCE.read_text()
    least = int(re.search(r"kDirectPlainMin = (\d+);", text).group(1))
    small = re.search(r"kDirectPlainSmall\[\] = \{([\d, ]+)\};", text).group(1)
    assert cuda_fft.DIRECT_PLAIN_MIN == least
    assert cuda_fft.DIRECT_PLAIN_SMALL == tuple(int(v) for v in small.split(","))
    for n in range(1, 513):
        prime = n > 1 and all(n % p for p in range(2, math.isqrt(n) + 1))
        want = "plain" if (prime and n >= least) or n in (2, 6) else "radix"
        assert cuda_fft.direct_path(n) == want, n
    assert cuda_fft.direct_path(16) == cuda_fft.direct_path(256) == "radix"
