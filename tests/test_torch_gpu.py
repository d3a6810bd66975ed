"""portfft_tpu_torch on a CUDA card: each kernel against its plain PyTorch
version, and the committed C2C and REAL paths against ``torch.fft`` (oracle
only).

Skipped without a CUDA device.  On a machine with a card (and without JAX)
run ``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py``: the
repo's conftest.py configures JAX, which this file does not import.

Tolerance, as in ``chip_smoke.py``: max|kernel − plain| ≤ 1e-5·max|plain|,
and every element within the absolute 2·eps·N·log2(N)·|scale| of the
oracle.
"""

import json

import numpy as np
import pytest
import torch

import portfft_tpu_torch as pf
from chip_smoke import (
    KERNEL_TOL,
    MMA_COL_CASES,
    MMA_GLOBAL_CASES,
    md_kernel_case,
    md_kinds,
    oracle_tol,
    real_case,
)
from portfft_tpu_torch import fastpath, race
from portfft_tpu_torch.engines import ENGINES, engine_of
from portfft_tpu_torch.utils import tracing

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize(
    "n,batch,kind",
    [
        (1, 5, "direct"), (3, 7, "direct"), (16, 1000, "direct"),
        (100, 37, "direct"), (512, 9, "direct"),
        (640, 3, "fused2"), (4096, 4, "fused2"), (8192, 2, "fused2"),
        (16384, 2, "fused2"), (32768, 2, "fused2"),
        (65536, 2, "global2"), (1 << 17, 1, "global2"),
        (393216, 1, "global2"), (1 << 19, 1, "global2"),
    ],
)
@pytest.mark.parametrize("inplace", [False, True])
def test_kernel_matches_plain(cuda, n, batch, kind, inplace):
    plan = pf.Descriptor(
        lengths=[n], number_of_transforms=batch, forward_scale=0.5,
        backward_scale=3.0 / n,
    ).commit(device=cuda)
    rng = np.random.default_rng(n)
    x = torch.from_numpy(
        rng.uniform(-1, 1, 2 * batch * n).astype(np.float32)
    ).to(cuda)
    for direction in (pf.Direction.FORWARD, pf.Direction.BACKWARD):
        entry = plan._raw_fast[direction]
        assert entry.engine.name == kind
        kernel, args = entry.kernel_args(plan)
        before = tracing.launches(kernel.kernel)
        want = kernel.plain(x, *args)
        if inplace:
            got = x.clone()
            kernel(got, *args, out=got)
        else:
            got = kernel(x, *args)
        torch.cuda.synchronize()
        assert tracing.launches(kernel.kernel) == before + 1
        err = (got - want).abs().max().item()
        assert err <= KERNEL_TOL * want.abs().max().item(), (direction, err)


@pytest.mark.parametrize("n,batch", [(16, 64), (256, 8), (4096, 4), (65536, 2)])
def test_main_path_matches_oracle(cuda, n, batch):
    plan = pf.Descriptor(lengths=[n], number_of_transforms=batch).commit()
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(batch, n, dtype=torch.complex64, generator=gen, device=cuda)
    for direction, compute in (
        (pf.Direction.FORWARD, plan.compute_forward),
        (pf.Direction.BACKWARD, plan.compute_backward),
    ):
        y = compute(x)
        assert y.dtype == torch.complex64 and y.device == x.device
        xd = x.to(torch.complex128)
        ref = (torch.fft.fft(xd) if direction == pf.Direction.FORWARD
               else torch.fft.ifft(xd) * n)
        diff = (y.reshape(batch, n).to(torch.complex128) - ref).abs().max()
        assert diff.item() <= oracle_tol(n), diff.item()


def test_in_place_writes_caller_tensor(cuda):
    n, batch = 4096, 3
    plan = pf.Descriptor(
        lengths=[n], number_of_transforms=batch,
        placement=pf.Placement.IN_PLACE,
    ).commit(device="cuda")
    x = torch.randn(batch * n, dtype=torch.complex64, device=cuda)
    ref = torch.fft.fft(x.reshape(batch, n).to(torch.complex128))
    y = plan.compute_forward(x)
    assert y is x
    diff = (x.reshape(batch, n).to(torch.complex128) - ref).abs().max().item()
    assert diff <= oracle_tol(n), diff


def test_tensor_on_other_device_raises(cuda):
    plan = pf.Descriptor(lengths=[16]).commit(device="cuda")
    with pytest.raises(pf.InvalidConfiguration):
        plan.compute_forward(torch.zeros(16, dtype=torch.complex64))


def test_plain_versions_leave_the_tf32_setting_alone(cuda):
    plan = pf.Descriptor(lengths=[4096], number_of_transforms=2).commit()
    kernel, args = plan._raw_fast[pf.Direction.FORWARD].kernel_args(plan)
    x = torch.rand(2 * 2 * 4096, device=cuda)
    allowed = torch.backends.cuda.matmul.allow_tf32
    try:
        for setting in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = setting
            kernel.plain(x, *args)
            assert torch.backends.cuda.matmul.allow_tf32 is setting
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allowed


def _half_spectra(rng, batch, n, device):
    spec = rng.uniform(-1, 1, (batch, n // 2 + 1, 2)).astype(np.float32)
    spec[:, 0, 1] = spec[:, -1, 1] = 0.0  # the spectrum of a real signal
    return torch.from_numpy(spec.reshape(-1)).to(device)


@pytest.mark.parametrize(
    "n,batch,kinds",
    [
        (4, 9, ("small_real",) * 2), (32, 1000, ("small_real",) * 2),
        (100, 37, ("small_real",) * 2), (512, 9, ("small_real",) * 2),
        (1000, 3, ("untangle", "retangle")), (1022, 2, ("untangle", "retangle")),
        (8192, 2, ("untangle", "retangle")), (1 << 17, 1, ("untangle", "retangle")),
    ],
)
def test_real_kernel_matches_plain(cuda, n, batch, kinds):
    plan = pf.Descriptor(
        lengths=[n], number_of_transforms=batch, domain=pf.Domain.REAL,
        forward_scale=0.5, backward_scale=3.0 / n,
    ).commit(device=cuda)
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.uniform(-1, 1, batch * n).astype(np.float32)).to(cuda)
    spec = _half_spectra(rng, batch, n, cuda)
    for direction, want_kind in zip(pf.Direction, kinds):
        kind, kernel, args, inp, _ = real_case(plan, direction, x, spec)
        assert kind == want_kind
        before = tracing.launches(kernel.kernel)
        want = kernel.plain(inp, *args)
        got = kernel(inp, *args)
        torch.cuda.synchronize()
        assert tracing.launches(kernel.kernel) == before + 1
        err = (got - want).abs().max().item()
        assert err <= KERNEL_TOL * want.abs().max().item(), (direction, err)


@pytest.mark.parametrize("n,batch", [(32, 64), (512, 8), (1000, 4), (8192, 4),
                                     (1 << 17, 1)])
def test_real_main_path_matches_oracle(cuda, n, batch):
    plan = pf.Descriptor(lengths=[n], number_of_transforms=batch,
                         domain=pf.Domain.REAL).commit()
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(batch, n, generator=gen, device=cuda)
    y = plan.compute_forward(x)
    assert y.dtype == torch.float32 and y.shape == (batch * (n + 2),)
    ref = torch.fft.rfft(x.double())
    got = torch.view_as_complex(y.view(batch, n // 2 + 1, 2)).to(torch.complex128)
    assert (got - ref).abs().max().item() <= oracle_tol(n)
    # O(1) half spectra, as the absolute tolerance assumes
    spec = torch.view_as_complex(
        _half_spectra(np.random.default_rng(n), batch, n, cuda).view(batch, -1, 2)
    )
    back = plan.compute_backward(spec)
    assert back.dtype == torch.float32 and back.shape == (batch * n,)
    want = torch.fft.irfft(spec.to(torch.complex128), n, norm="forward")
    diff = (back.view(batch, n).double() - want).abs().max().item()
    assert diff <= oracle_tol(n), diff


def _steps(plan, direction):
    """The (kind, kernel, args) of each step of a multi-dim or BI route."""
    entry = plan._raw_fast[direction]
    steps = entry.steps if isinstance(entry, fastpath.MultiDim) else (entry,)
    return [(kind, *s.kernel_args(plan)) for kind, s in zip(md_kinds(entry), steps)]


@pytest.mark.parametrize(
    "lengths,batch,kinds",
    [
        ([16, 64], 2, ("direct", "col")), ([1024, 16], 1, ("direct", "col")),
        ([100, 24], 3, ("direct", "col")), ([4, 8, 32], 2, ("direct", "col", "col")),
        ([8192, 3], 1, ("direct", "col")), ([16384, 3], 2, ("direct", "col")),
        ([256, 128], 2, ("md2",)), ([1024, 128], 1, ("md2",)),
        ([128, 1024], 1, ("md2",)), ([512, 512], 2, ("md2",)),
        ([2, 128, 128], 3, ("md2", "col")), ([1024, 1024], 1, ("fused2", "col")),
    ],
)
@pytest.mark.parametrize("inplace", [False, True])
def test_multidim_kernels_match_plain(cuda, lengths, batch, kinds, inplace):
    n = int(np.prod(lengths))
    plan = pf.Descriptor(lengths=lengths, number_of_transforms=batch,
                         forward_scale=0.5, backward_scale=3.0 / n).commit(device=cuda)
    rng = np.random.default_rng(n)
    for direction in (pf.Direction.FORWARD, pf.Direction.BACKWARD):
        steps = _steps(plan, direction)
        assert tuple(s[0] for s in steps) == kinds
        for kind, kernel, args in steps:
            x = torch.from_numpy(
                rng.uniform(-1, 1, 2 * batch * n).astype(np.float32)).to(cuda)
            before = tracing.launches(kernel.kernel)
            want = kernel.plain(x, *args)
            if inplace:
                got = x.clone()
                kernel(got, *args, out=got)
            else:
                got = kernel(x, *args)
            torch.cuda.synchronize()
            assert tracing.launches(kernel.kernel) == before + 1
            err = (got - want).abs().max().item()
            assert err <= KERNEL_TOL * want.abs().max().item(), (kind, direction, err)


@pytest.mark.parametrize(
    "lengths,batch",
    [([16, 64], 2), ([1024, 16], 1), ([256, 128], 2), ([128, 1024], 1),
     ([4, 8, 32], 2), ([2, 128, 128], 1), ([1, 64, 32], 2), ([1, 128, 128], 1),
     ([512, 512], 2), ([1024, 1024], 1), ([16, 65536], 1)],
)
def test_multidim_main_path_matches_oracle(cuda, lengths, batch):
    plan = pf.Descriptor(lengths=lengths, number_of_transforms=batch).commit()
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(batch, *lengths, dtype=torch.complex64, generator=gen,
                    device=cuda)
    n = int(np.prod(lengths))
    dims = tuple(range(1, len(lengths) + 1))
    xd = x.to(torch.complex128)
    for direction, compute in (
        (pf.Direction.FORWARD, plan.compute_forward),
        (pf.Direction.BACKWARD, plan.compute_backward),
    ):
        y = compute(x)  # flat, as the JAX package returns it
        assert y.dtype == torch.complex64 and y.shape == (x.numel(),)
        ref = (torch.fft.fftn(xd, dim=dims) if direction == pf.Direction.FORWARD
               else torch.fft.ifftn(xd, dim=dims, norm="forward"))
        diff = (y.reshape(x.shape).to(torch.complex128) - ref).abs().max().item()
        assert diff <= oracle_tol(n), (direction, diff)


@pytest.mark.parametrize("n,batch", [(64, 8), (1024, 4), (4096, 33), (100, 7),
                                     (16384, 5)])
def test_bi_main_path_in_place_matches_oracle(cuda, n, batch):
    plan = pf.Descriptor(
        lengths=[n], number_of_transforms=batch, forward_strides=[batch],
        backward_strides=[batch], forward_distance=1, backward_distance=1,
        placement=pf.Placement.IN_PLACE,
    ).commit()
    assert isinstance(plan._raw_fast[pf.Direction.FORWARD], fastpath.Col)
    x = torch.randn(n, batch, dtype=torch.complex64, device=cuda)
    ref = torch.fft.fft(x.to(torch.complex128), dim=0)
    y = plan.compute_forward(x)
    assert y is x
    diff = (x.to(torch.complex128) - ref).abs().max().item()
    assert diff <= oracle_tol(n), diff


def test_kernels_launch_on_the_tensor_card(cuda):
    """A tensor on cuda:0 while another card is current: K10 and K11 launch
    on cuda:0 and agree with their plain versions."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    plan = pf.Descriptor(lengths=[4, 128, 128], number_of_transforms=1).commit(
        device="cuda:0")
    x = torch.rand(2 * 4 * 128 * 128, device="cuda:0")
    with torch.cuda.device(1):
        for _, kernel, args in _steps(plan, pf.Direction.FORWARD):
            got = kernel(x, *args)
            torch.cuda.synchronize(0)
            want = kernel.plain(x, *args)
            assert got.device == x.device
            err = (got - want).abs().max().item()
            assert err <= KERNEL_TOL * want.abs().max().item()


@pytest.mark.parametrize(
    "n,batch,kind",
    [(3, 9, "chain"), (100, 5, "chain"), (3072, 3, "chain"), (24576, 2, "chain"),
     (600, 7, "chain"), (1000, 3, "chain"), (19683, 2, "chain"),
     (368, 5, "chain"), (640, 3, "chain"),
     (16411, 2, "bluestein"), (20011, 3, "bluestein"), (65537, 2, "bluestein"),
     (131101, 2, "bluestein")],
)
def test_plane_kernel_matches_plain(cuda, n, batch, kind):
    """K13 (every mode: DIRECT 3, 100 and 368, [24, 128] and the chains
    [5, 128], [120, 5], [125, 8] on the radix stages, [192, 128] and
    [81, 81, 3] past one tile on plain sums) and K15 on planes against
    their plain versions; each K13 call counts one launch on its path."""
    from chip_smoke import plane_case
    from portfft_tpu_torch.ops import cuda_chain

    rng = np.random.default_rng(n)
    xr, xi = (torch.from_numpy(rng.uniform(-1, 1, (batch, n)).astype(np.float32))
              .to(cuda) for _ in range(2))
    for sign in (-1, +1):
        kernel, args = plane_case(pf, kind, n, sign)
        before = tracing.launches(kernel.kernel)
        paths = tracing.paths("K13")
        yr, yi = kernel(xr, xi, *args)
        wr, wi = kernel.plain(xr, xi, *args)
        torch.cuda.synchronize()
        assert tracing.launches(kernel.kernel) == before + 1
        if kind == "chain":
            path = cuda_chain.path_of(args[0])
            assert path == ("plain" if n in (24576, 19683) else "radix")
            paths[path] = paths.get(path, 0) + 1
            assert tracing.paths("K13") == paths
        peak = max(wr.abs().max().item(), wi.abs().max().item())
        err = max((yr - wr).abs().max().item(), (yi - wi).abs().max().item())
        assert err <= KERNEL_TOL * peak, (sign, err)


#: fastMRI's knee volume cut to a few slices: 640 × 368 (K13's chain
#: [5, 128] and its DIRECT 368) at the orthonormal scale.
FASTMRI = ([640, 368], 4, 1 / np.sqrt(640 * 368))


def test_k13_radix_kernels_are_named_k13_on_the_card(cuda):
    """Each of K13's radix ``__global__`` functions, as the profiler names
    the device operation, maps to K13 alone through ``tracing.kernels_of``,
    so ``glue_pct`` does not count it as glue."""
    from torch.profiler import ProfilerActivity, profile

    lengths, batch, scale = FASTMRI
    plan = pf.Descriptor(lengths=lengths, number_of_transforms=batch,
                         forward_scale=scale).commit()
    x = torch.randn(batch, *lengths, dtype=torch.complex64, device=cuda)
    plan.compute_forward(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        plan.compute_forward(x)
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()
             if "radix_pass_kernel" in e.key or "radix_chain_kernel" in e.key}
    assert any("radix_pass_kernel" in k for k in names), names
    assert any("radix_chain_kernel" in k for k in names), names
    assert all(tracing.kernels_of(k) == ("K13",) for k in names), names


def test_fastmri_walk_launches_k13_on_the_radix_path_alone(cuda):
    """A fastMRI-shaped commit, forward and backward: every K13 launch is a
    radix one (two a call: 368, then the chain at 640), and the result
    matches ``torch.fft`` at the orthonormal scale."""
    lengths, batch, scale = FASTMRI
    plan = pf.Descriptor(lengths=lengths, number_of_transforms=batch,
                         forward_scale=scale, backward_scale=scale).commit()
    assert plan._raw_fast[pf.Direction.FORWARD].routes == {640: "chain", 368: "direct"}
    x = torch.randn(batch, *lengths, dtype=torch.complex64, device=cuda)
    xd = x.to(torch.complex128)
    before = tracing.paths("K13")
    y = plan.compute_forward(x)
    back = plan.compute_backward(y)
    torch.cuda.synchronize()
    after = tracing.paths("K13")
    assert after.get("radix", 0) == before.get("radix", 0) + 4
    assert after.get("plain", 0) == before.get("plain", 0)
    n = int(np.prod(lengths))
    ref = torch.fft.fftn(xd, dim=(1, 2), norm="ortho")
    diff = (y.reshape(x.shape).to(torch.complex128) - ref).abs().max().item()
    assert diff <= oracle_tol(n) * scale, diff
    diff = (back.reshape(x.shape).to(torch.complex128) - xd).abs().max().item()
    assert diff <= 2 * oracle_tol(n) * scale, diff


@pytest.mark.parametrize("m", [1, 7, 1031 * 3, 1 << 16])
def test_io_kernels_are_exact(cuda, m):
    from portfft_tpu_torch.ops import cuda_io

    x = torch.rand(2 * m, device=cuda) * 2 - 1
    re, im = cuda_io.deinterleave(x)
    assert torch.equal(re, x[0::2]) and torch.equal(im, x[1::2])
    out = torch.empty_like(x)
    assert cuda_io.interleave(re, im, 0.25, out=out) is out
    assert torch.equal(out, x * 0.25)


@pytest.mark.parametrize("n,batch", [(600, 5), (1000, 3), (1031, 4), (2062, 2),
                                     (3000, 2), (10007, 2), (16411, 2),
                                     (65537, 2), (2 * 65537, 1)])
@pytest.mark.parametrize("inplace", [False, True])
def test_plane_main_path_matches_oracle(cuda, n, batch, inplace):
    """The plane path, out of place on a complex64 tensor and in place on
    a raw float32 tensor, with scales, against ``torch.fft``."""
    placement = pf.Placement.IN_PLACE if inplace else pf.Placement.OUT_OF_PLACE
    plan = pf.Descriptor(lengths=[n], number_of_transforms=batch,
                         placement=placement, forward_scale=0.5,
                         backward_scale=2.0 / n).commit()
    assert isinstance(plan._raw_fast[pf.Direction.FORWARD], fastpath.Plane)
    gen = torch.Generator(device="cuda").manual_seed(n)
    x = torch.randn(batch, n, dtype=torch.complex64, generator=gen, device=cuda)
    xd = x.to(torch.complex128)
    for direction, compute, ref in (
        (pf.Direction.FORWARD, plan.compute_forward, torch.fft.fft(xd) * 0.5),
        (pf.Direction.BACKWARD, plan.compute_backward,
         torch.fft.ifft(xd, norm="forward") * (2.0 / n)),
    ):
        if inplace:
            raw = torch.view_as_real(x.clone()).reshape(-1)
            assert compute(raw) is raw
            y = torch.view_as_complex(raw.view(-1, 2))
        else:
            y = compute(x)
            assert y.dtype == torch.complex64 and y.shape == (x.numel(),)
        scale = 0.5 if direction == pf.Direction.FORWARD else 2.0 / n
        diff = (y.reshape(x.shape).to(torch.complex128) - ref).abs().max().item()
        assert diff <= oracle_tol(n) * scale, (direction, diff)


@pytest.mark.parametrize(
    "g1,g2,batch,post_n",
    [(256, 256, 3, None), (512, 256, 2, None), (1024, 264, 2, None),
     (2048, 512, 2, None), (16384, 16, 2, None), (16, 16384, 2, None),
     (384, 384, 2, 65537)],
)
def test_global2_planes_matches_plain(cuda, g1, g2, batch, post_n):
    """K14 with DIRECT subs, FUSED subs, a [128, 128] sub in either pass
    (two launches) and a Bluestein convolution's post tables, against its
    plain version."""
    from chip_smoke import global2_planes_case

    rng = np.random.default_rng(g1 + g2)
    xr, xi = (torch.from_numpy(rng.uniform(-1, 1, (batch, g1 * g2)).astype(
        np.float32)).to(cuda) for _ in range(2))
    for sign in (-1, +1):
        kernel, args = global2_planes_case(pf, g1, g2, sign, post_n)
        before = tracing.launches(kernel.kernel)
        yr, yi = kernel(xr, xi, *args)
        wr, wi = kernel.plain(xr, xi, *args)
        torch.cuda.synchronize()
        assert tracing.launches(kernel.kernel) == before + 1
        peak = max(wr.abs().max().item(), wi.abs().max().item())
        err = max((yr - wr).abs().max().item(), (yi - wi).abs().max().item())
        assert err <= KERNEL_TOL * peak, (sign, err)


@pytest.mark.parametrize("shape", [(3, 8, 5), (2, 128, 64), (2, 256, 100),
                                   (1, 1024, 128), (2, 3072, 16),
                                   (1, 16384, 8), (1, 32768, 4)])
def test_axis_m2_matches_plain(cuda, shape):
    """K12 DIRECT, FUSED [a, 128] with a | 128 and a not dividing 128, and
    past 8192 points (two launches), against its plain version."""
    from chip_smoke import axis_case

    rng = np.random.default_rng(shape[1])
    numel = int(np.prod(shape))
    xr, xi = (torch.from_numpy(rng.uniform(-1, 1, numel).astype(np.float32))
              .to(cuda) for _ in range(2))
    for sign in (-1, +1):
        kernel, args = axis_case(pf, shape, sign)
        before = tracing.launches(kernel.kernel)
        yr, yi = kernel(xr, xi, *args)
        wr, wi = kernel.plain(xr, xi, *args)
        torch.cuda.synchronize()
        assert tracing.launches(kernel.kernel) == before + 1
        peak = max(wr.abs().max().item(), wi.abs().max().item())
        err = max((yr - wr).abs().max().item(), (yi - wi).abs().max().item())
        assert err <= KERNEL_TOL * peak, (sign, err)


@pytest.mark.parametrize(
    "lengths,batch",
    [([64], 3), ([2048], 2), ([1000], 2), ([65536], 2), ([270336], 1),
     ([1031], 2), ([65537], 2), ([128, 256], 2), ([1024, 128], 1),
     ([3072, 128], 1), ([16, 32, 128], 2), ([8, 1031], 2)],
)
@pytest.mark.parametrize("inplace", [False, True])
def test_split_main_path_matches_oracle(cuda, lengths, batch, inplace):
    """SPLIT_COMPLEX, out of place and in place on float32 planes on the
    card, with scales, against ``torch.fft``."""
    n = int(np.prod(lengths))
    placement = pf.Placement.IN_PLACE if inplace else pf.Placement.OUT_OF_PLACE
    plan = pf.Descriptor(lengths=lengths, number_of_transforms=batch,
                         complex_storage=pf.ComplexStorage.SPLIT_COMPLEX,
                         placement=placement, forward_scale=0.5,
                         backward_scale=2.0 / n).commit()
    gen = torch.Generator(device="cuda").manual_seed(n)
    x = torch.randn(batch, *lengths, dtype=torch.complex64, generator=gen,
                    device=cuda)
    xd, dims = x.to(torch.complex128), tuple(range(1, len(lengths) + 1))
    for direction, compute, scale in (
        (pf.Direction.FORWARD, plan.compute_forward, 0.5),
        (pf.Direction.BACKWARD, plan.compute_backward, 2.0 / n),
    ):
        re, im = x.real.contiguous().view(-1), x.imag.contiguous().view(-1)
        yr, yi = compute(re, im)
        if inplace:
            assert yr is re and yi is im
        assert yr.dtype == torch.float32 and yr.shape == (x.numel(),)
        ref = (torch.fft.fftn(xd, dim=dims) if direction == pf.Direction.FORWARD
               else torch.fft.ifftn(xd, dim=dims, norm="forward")) * scale
        y = torch.complex(yr, yi).reshape(x.shape).to(torch.complex128)
        diff = (y - ref).abs().max().item()
        assert diff <= oracle_tol(n) * scale, (direction, diff)


@pytest.mark.parametrize("lengths,batch", [([16, 640, 128], 1), ([8, 1031], 2),
                                           ([640, 16], 2), ([65536, 2], 1)])
def test_plane_multidim_main_path_matches_oracle(cuda, lengths, batch):
    """Interleaved multi-dim shapes the raw kernels decline, on the plane
    path's per-axis walk (K6, K13/K14/K15, K12, K6), against ``torch.fft``."""
    plan = pf.Descriptor(lengths=lengths, number_of_transforms=batch).commit()
    assert isinstance(plan._raw_fast[pf.Direction.FORWARD], fastpath.Core)
    x = torch.randn(batch, *lengths, dtype=torch.complex64, device=cuda)
    n, dims = int(np.prod(lengths)), tuple(range(1, len(lengths) + 1))
    y = plan.compute_forward(x)
    ref = torch.fft.fftn(x.to(torch.complex128), dim=dims)
    diff = (y.reshape(x.shape).to(torch.complex128) - ref).abs().max().item()
    assert diff <= oracle_tol(n), diff


# K7 layouts (o, s, dist, n, batch): row-major (s <= dist) with and without
# gaps, the minimal span, overlapping read rows, batch-innermost (dist < s:
# the tile mapping) dense and with gaps, one row, tiles past the edges.
K7_GPU_MAPS = [(0, 2, 2 * 1000, 1000, 7), (3, 3, 3 * 999 + 1, 1000, 5),
               (0, 1, 1000, 1000, 3), (5, 2, 3, 300, 9), (0, 33, 1, 100, 33),
               (2, 70, 2, 45, 33), (1, 2, 1, 1, 1), (7, 5, 11, 4099, 1),
               (0, 1, 100, 64, 70000)]


@pytest.mark.parametrize("m", K7_GPU_MAPS)
@pytest.mark.parametrize("split", [False, True], ids=["interleaved", "planes"])
def test_k7_matches_plain_exactly(cuda, m, split):
    """K7 destride, and restride with fill_gaps on and off, equal their
    plain versions bit for bit (exact copies), one launch each."""
    from portfft_tpu_torch.ops import cuda_stride

    o, s, dist, n, batch = m
    count = o + (batch - 1) * dist + (n - 1) * s + 1 + 5
    width = 1 if split else 2
    gen = torch.Generator(device="cuda").manual_seed(count)

    def buf(numel, fill=None):
        def one():
            if fill is not None:
                return torch.full((width * numel,), fill, device=cuda)
            return torch.rand(width * numel, generator=gen, device=cuda)
        return (one(), one()) if split else one()

    def planes(b):
        return b if split else (b,)

    x, y = buf(count), buf(batch * n)
    before = tracing.launches(cuda_stride.destride.kernel)
    got = cuda_stride.destride(x, *m)
    want = cuda_stride.destride.plain(x, *m)
    torch.cuda.synchronize()
    assert tracing.launches(cuda_stride.destride.kernel) == before + 1
    assert all(torch.equal(g, w) for g, w in zip(planes(got), planes(want)))
    overlapping = batch > 1 and s <= dist < (n - 1) * s + 1
    for fill in (True, False):
        if overlapping:
            break  # rows that overlap are read-only layouts
        out, ref = buf(count, -5.0), buf(count, -5.0)
        before = tracing.launches(cuda_stride.restride.kernel)
        assert cuda_stride.restride(y, *m, out, fill) is out
        cuda_stride.restride.plain(y, *m, ref, fill)
        torch.cuda.synchronize()
        assert tracing.launches(cuda_stride.restride.kernel) == before + 1
        assert all(torch.equal(g, w) for g, w in zip(planes(out), planes(ref)))


def _launch_counters():
    from portfft_tpu_torch.ops import (
        cuda_chain, cuda_fft, cuda_global, cuda_global_bf, cuda_multidim,
        cuda_stride)

    return {"direct": cuda_fft.direct, "fused2": cuda_fft.fused2,
            "global2": cuda_global.global2, "col": cuda_multidim.col,
            "chain": cuda_chain.chain, "destride": cuda_stride.destride,
            "restride": cuda_stride.restride,
            "global_bf_ov": cuda_global_bf.global_bf_ov,
            "global3": cuda_global.global3,
            "global_fused": cuda_global.global_fused}


# One layout per route: (n, batch, SPLIT, descriptor fields, out= given,
# in place, the kernels in order)
LAYOUT_ROUTES = [
    (65536, 3, False, dict(forward_strides=[2], forward_distance=2 * 65536),
     False, False, ("destride", "global2")),
    (512, 40, False, dict(backward_strides=[2], backward_distance=1100),
     False, False, ("direct", "restride")),
    (4096, 70, False, dict(forward_strides=[70], forward_distance=1),
     False, False, ("destride", "fused2")),
    (65536, 3, False, dict(forward_strides=[3], forward_distance=1,
                           backward_strides=[3], backward_distance=1),
     False, False, ("destride", "global2", "restride")),
    (65536, 2, False, dict(forward_offset=1000, backward_offset=3), True, False,
     ("global2",)),
    (4096, 9, True, dict(forward_strides=[2], backward_strides=[2],
                         forward_distance=8192, backward_distance=8192),
     False, False, ("destride", "chain", "restride")),
    (4096, 9, False, dict(forward_strides=[3], backward_strides=[3],
                          forward_distance=3 * 4096, backward_distance=3 * 4096,
                          forward_offset=2, backward_offset=5),
     False, True, ("destride", "fused2", "restride")),
    (4096, 5, False, dict(forward_offset=7, backward_offset=4200), False, True,
     ("fused2",)),
]


@pytest.mark.parametrize("n,batch,split,fields,give_out,in_place,kinds",
                         LAYOUT_ROUTES)
def test_layout_route_matches_oracle(cuda, n, batch, split, fields, give_out,
                                     in_place, kinds):
    """Each layout route on the card, forward: its kernels launch, every
    transform is within the oracle bound of ``torch.fft``, and every
    element outside the output layout is 0 (a new buffer), the sentinel
    (out=) or the input's own value (in place)."""
    _check_layout_route(n, batch, split, fields, give_out, in_place, kinds)


def _check_layout_route(n, batch, split, fields, give_out, in_place, kinds):
    from chip_smoke import SENTINEL, elements, layout_kinds, sampled, stride_buffer
    from portfft_tpu_torch.utils.layout import rows_1d

    fwd = pf.Direction.FORWARD
    desc = pf.Descriptor(
        lengths=[n], number_of_transforms=batch, **fields,
        complex_storage=(pf.ComplexStorage.SPLIT_COMPLEX if split
                         else pf.ComplexStorage.INTERLEAVED_COMPLEX),
        placement=pf.Placement.IN_PLACE if in_place else pf.Placement.OUT_OF_PLACE)
    plan = desc.commit()
    assert tuple(layout_kinds(plan._raw_fast[fwd])) == kinds
    src, dst = rows_1d(desc, fwd), rows_1d(desc, pf.Direction.BACKWARD)
    count = max(desc.get_input_count(fwd), desc.get_output_count(fwd))
    x = stride_buffer(count, split, n, "cuda")
    planes = x if split else (x,)
    before_x = tuple(p.clone() for p in planes)
    out = stride_buffer(count + 3, split, 0, "cuda", SENTINEL) if give_out else None
    rows = list(range(batch))
    ref = torch.fft.fft(sampled(x, src, rows))
    counters = _launch_counters()
    before = {k: tracing.launches(counters[k].kernel) for k in kinds}
    y = plan.compute_forward(*planes, out=out)
    torch.cuda.synchronize()
    assert all(tracing.launches(counters[k].kernel) > before[k] for k in kinds)
    if in_place or give_out:
        assert all(a is b for a, b in zip(planes if in_place else
                                          (out if split else (out,)),
                                          y if split else (y,)))
    diff = (sampled(y, dst, rows) - ref).abs().max().item()
    assert diff <= oracle_tol(n), diff
    rest = tuple(p.clone() for p in (y if split else (y,)))
    for p in (elements(rest, dst) if split else (elements(rest[0], dst),)):
        p.fill_(0.0)
    if in_place:  # the input's own values, where the output lands nowhere
        keep = tuple(p.clone() for p in before_x)
        for p in (elements(keep, dst) if split else (elements(keep[0], dst),)):
            p.fill_(0.0)
        assert all(torch.equal(r, k) for r, k in zip(rest, keep))
    else:
        gap = SENTINEL if give_out else 0.0
        mask = tuple(torch.full_like(r, gap) for r in rest)
        for p in (elements(mask, dst) if split else (elements(mask[0], dst),)):
            p.fill_(0.0)
        assert all(torch.equal(r, k) for r, k in zip(rest, mask))


# -- the tuned GLOBAL engines: K4 global_sq, K5 global_bf, K5-ov global_bf_ov --

# Layouts at 65536, whose plan (256 x 256) the shipped table sends to K17.
SHIPPED_LAYOUTS = [
    (65536, 3, False, dict(forward_strides=[2], forward_distance=2 * 65536),
     False, False, ("destride", "global_fused")),
    (65536, 2, False, dict(forward_offset=1000, backward_offset=3), True, False,
     ("global_fused",)),
]

ENGINE_CASES = [
    ("global_sq", {"eng": 5}, 65536, 3), ("global_sq", {"eng": 5}, 1 << 17, 2),
    ("global_bf", {"eng": 7}, 65536, 3), ("global_bf", {"eng": 7}, 1 << 17, 25),
    ("global_bf", {"eng": 7}, 1 << 18, 2), ("global_bf", {"eng": 7}, 1 << 19, 2),
    ("global_bf", {"eng": 7}, 1 << 20, 3),
    ("global_bf_ov", {"eng": 7, "ov": 1}, 65536, 3),
    ("global_bf_ov", {"eng": 7, "ov": 1}, 1 << 17, 25),
    ("global_bf_ov", {"eng": 7, "ov": 1}, 1 << 18, 2),
    ("global_bf_ov", {"eng": 7, "ov": 1}, 1 << 19, 2),
    ("global_bf_ov", {"eng": 7, "ov": 1}, 1 << 20, 3),
    # K16: DIRECT G1 256 and 512 beside G2 256, 384 and 512; FUSED [16, 128]
    ("global3", {"eng": 3}, 65536, 3), ("global3", {"eng": 3}, 1 << 17, 2),
    ("global3", {"eng": 3}, 1 << 18, 1), ("global3", {"eng": 3}, 196608, 2),
    ("global3", {"eng": 3}, 1 << 19, 2), ("global3", {"eng": 3}, 1 << 20, 1),
    # and at chip_smoke's kernel-phase shapes, 2^27 points each
    *(("global3", {"eng": 3}, n, b) for n, b in MMA_GLOBAL_CASES),
]


@pytest.fixture(autouse=True)
def _static_routes(monkeypatch):
    """The tests above hold the static routes (K3 for GLOBAL plans): the
    shipped tuning table stays out of them.  The tuned engines are tested
    below, each selected explicitly."""
    monkeypatch.setenv("PORTFFT_NO_TUNING", "1")


@pytest.mark.parametrize("n,batch,split,fields,give_out,in_place,kinds",
                         SHIPPED_LAYOUTS)
def test_layout_on_the_shipped_route(cuda, tmp_path, monkeypatch, n, batch, split,
                                     fields, give_out, in_place, kinds):
    """With tuning on and only the shipped table, a layout descriptor's
    GLOBAL entry takes the shipped engine (K17 at 65536), which launches
    with K7, and the result holds as on the static route."""
    from portfft_tpu_torch import tuning

    monkeypatch.delenv("PORTFFT_NO_TUNING")
    monkeypatch.setattr(tuning, "_USER_PATH", str(tmp_path / "tune.json"))
    tuning._reset_for_tests()
    try:
        plan = pf.Descriptor(lengths=[n], number_of_transforms=batch,
                             **fields).commit()
        shipped = tuning.lookup(plan.config.name, "global2",
                                tuning._entry_key(plan, "global2"))
        assert engine_of(shipped).name == "global_fused"
        _check_layout_route(n, batch, split, fields, give_out, in_place, kinds)
    finally:
        tuning._reset_for_tests()


@pytest.mark.parametrize("engine,params,n,batch", ENGINE_CASES)
@pytest.mark.parametrize("inplace", [False, True])
def test_tuned_engine_matches_plain_and_oracle(cuda, engine, params, n, batch,
                                               inplace):
    """K4, K5, K5-ov and K16 against their plain versions (1e-5·max|plain|) and
    ``torch.fft`` (the absolute 2·eps·N·log2N·|scale|), both directions
    with a folded scale, out of place and in place; 2^17 × 25 and 2^20 × 3
    run K5 in several chunks, the last one short."""
    plan = pf.Descriptor(lengths=[n], number_of_transforms=batch,
                         forward_scale=0.5, backward_scale=3.0 / n).commit()
    x = torch.rand(2 * batch * n, device=cuda) * 2 - 1
    xc = torch.view_as_complex(x.view(batch, n, 2)).to(torch.complex128)
    for direction, scale in ((pf.Direction.FORWARD, 0.5),
                             (pf.Direction.BACKWARD, 3.0 / n)):
        entry = fastpath.with_engine(plan, plan._raw_fast[direction], params)
        kernel, args = entry.kernel_args(plan)
        assert kernel.__name__ == engine
        before = tracing.launches(kernel.kernel)
        want = kernel.plain(x, *args)
        if inplace:
            got = x.clone()
            assert kernel(got, *args, out=got) is got
        else:
            got = kernel(x, *args)
        torch.cuda.synchronize()
        assert tracing.launches(kernel.kernel) == before + 1
        err = (got - want).abs().max().item()
        assert err <= KERNEL_TOL * want.abs().max().item(), (direction, err)
        ref = (torch.fft.fft(xc) if direction == pf.Direction.FORWARD
               else torch.fft.ifft(xc, norm="forward")) * scale
        diff = (torch.view_as_complex(got.view(batch, n, 2)) - ref).abs().max()
        assert diff.item() <= oracle_tol(n) * scale, (direction, diff.item())


@pytest.mark.parametrize("engine,params,n,batch", [
    ("global_sq", {"eng": 5}, 65536, 2), ("global_bf", {"eng": 7}, 1 << 18, 2),
    ("global_bf_ov", {"eng": 7, "ov": 1}, 1 << 17, 13),
    ("global3", {"eng": 3}, 1 << 20, 2)])
def test_tuned_entry_runs_its_kernel_on_the_main_path(cuda, tmp_path, monkeypatch,
                                                      engine, params, n, batch):
    """A recorded winner routes ``compute_forward`` through its kernel, and
    ``autotune`` on the card records one of the raced engines."""
    from portfft_tpu_torch import tuning
    from portfft_tpu_torch.ops import cuda_global, cuda_global_bf

    monkeypatch.delenv("PORTFFT_NO_TUNING")
    monkeypatch.setattr(tuning, "_USER_PATH", str(tmp_path / "tune.json"))
    tuning._reset_for_tests()
    try:
        desc = pf.Descriptor(lengths=[n], number_of_transforms=batch)
        probe = desc.commit()
        key = tuning._entry_key(probe, "global2")
        tuning.record(probe.config.name, "global2", key, params)
        plan = desc.commit()
        kernel = getattr(cuda_global if engine in ("global_sq", "global3")
                         else cuda_global_bf, engine)
        x = torch.randn(batch, n, dtype=torch.complex64, device=cuda)
        before = tracing.launches(kernel.kernel)
        y = plan.compute_forward(x)
        torch.cuda.synchronize()
        assert tracing.launches(kernel.kernel) == before + 1
        ref = torch.fft.fft(x.to(torch.complex128))
        diff = (y.reshape(batch, n).to(torch.complex128) - ref).abs().max()
        assert diff.item() <= oracle_tol(n)
        times = {}
        won = plan.autotune(iters=1, times=times)
        assert won in [e.params for e in ENGINES.values() if e.kind == "global2"]
        assert len(times) >= 3 and tuning.lookup(plan.config.name, "global2", key) == won
        y = plan.compute_forward(x).reshape(batch, n)
        assert (y.to(torch.complex128) - ref).abs().max().item() <= oracle_tol(n)
    finally:
        tuning._reset_for_tests()


# -- the FUSED engines: K2-v1 fused2_v1, K2-v2 fused2_v2, K2-v3 fused2_v3 -------

# (kernel, n, batch, bt): K2-v1 at the no-fold a = 5, 7, 24, 96 and one a
# with a fold, with a batch that leaves a short last tile; K2-v2 and K2-v3
# at a = 8 … 192 and every register tile, bt 0 letting the wrapper pick.
FUSED_ENGINE_CASES = [
    ("fused2_v1", 640, 13, None), ("fused2_v1", 896, 5, None),
    ("fused2_v1", 3072, 7, None), ("fused2_v1", 12288, 3, None),
    ("fused2_v1", 4096, 4, None),
    ("fused2_v2", 1024, 16, 8), ("fused2_v2", 1024, 6, 2), ("fused2_v2", 4096, 8, 4),
    ("fused2_v2", 4096, 3, 1), ("fused2_v2", 8192, 4, 2), ("fused2_v2", 16384, 3, 1),
    ("fused2_v2", 24576, 4, 1), ("fused2_v2", 2048, 12, 0),
    ("fused2_v3", 1024, 32, 16), ("fused2_v3", 1024, 5, 1), ("fused2_v3", 4096, 8, 4),
    ("fused2_v3", 8192, 4, 2), ("fused2_v3", 16384, 3, 1), ("fused2_v3", 24576, 2, 1),
    ("fused2_v3", 2048, 12, 0),
]


@pytest.mark.parametrize("engine,n,batch,bt", FUSED_ENGINE_CASES)
@pytest.mark.parametrize("inplace", [False, True])
def test_fused2_engine_matches_plain_and_oracle(cuda, engine, n, batch, bt, inplace):
    """K2-v1, K2-v2 and K2-v3 against their plain versions
    (1e-5·max|plain|) and ``torch.fft`` (the absolute 2·eps·N·log2N·|scale|),
    both directions with a scale, out of place and in place."""
    from portfft_tpu_torch.ops import cuda_fft

    plan = pf.Descriptor(lengths=[n], number_of_transforms=batch,
                         forward_scale=0.5, backward_scale=3.0 / n).commit()
    x = torch.rand(2 * batch * n, device=cuda) * 2 - 1
    xc = torch.view_as_complex(x.view(batch, n, 2)).to(torch.complex128)
    kernel = getattr(cuda_fft, engine)
    for direction, scale in ((pf.Direction.FORWARD, 0.5),
                             (pf.Direction.BACKWARD, 3.0 / n)):
        _, args = plan._raw_fast[direction].kernel_args(plan)
        batch_, sub, scale_ = args
        assert scale_ == scale
        args = (batch_, sub, scale) if bt is None else (batch_, sub, bt, scale)
        before = tracing.launches(kernel.kernel)
        plain_args = args if bt != 0 else (batch_, sub, cuda_fft.pick_tile(
            engine, sub.a, batch), scale)
        want = kernel.plain(x, *plain_args)
        if inplace:
            got = x.clone()
            assert kernel(got, *args, out=got) is got
        else:
            got = kernel(x, *args)
        torch.cuda.synchronize()
        assert tracing.launches(kernel.kernel) == before + 1
        err = (got - want).abs().max().item()
        assert err <= KERNEL_TOL * want.abs().max().item(), (direction, err)
        ref = (torch.fft.fft(xc) if direction == pf.Direction.FORWARD
               else torch.fft.ifft(xc, norm="forward")) * scale
        diff = (torch.view_as_complex(got.view(batch, n, 2)) - ref).abs().max()
        assert diff.item() <= oracle_tol(n) * scale, (direction, diff.item())


# (descriptor fields, tuned parameters, the kernel that must launch): a 1D,
# a REAL (the half length's entry) and a layout descriptor.
TUNED_FUSED_ROUTES = [
    (dict(lengths=[4096], number_of_transforms=8), {"eng": 2, "bt": 4}, "fused2_v2"),
    (dict(lengths=[3072], number_of_transforms=6), {"eng": 3, "bt": 2}, "fused2_v1"),
    (dict(lengths=[8192], number_of_transforms=4, domain=pf.Domain.REAL),
     {"eng": 3, "bt": 2}, "fused2_v3"),
    (dict(lengths=[4096], number_of_transforms=5, forward_strides=[2],
          forward_distance=2 * 4096), {"eng": 2, "bt": 1}, "fused2_v2"),
]


@pytest.mark.parametrize("fields,params,engine", TUNED_FUSED_ROUTES)
def test_tuned_fused2_route_runs_its_kernel(cuda, tmp_path, monkeypatch, fields,
                                            params, engine):
    """A recorded ``fused2`` winner routes ``compute_forward`` through its
    kernel (once), the result holds against ``torch.fft``, and ``autotune``
    on the card records one of the raced variants."""
    from portfft_tpu_torch import tuning
    from portfft_tpu_torch.ops import cuda_fft

    monkeypatch.delenv("PORTFFT_NO_TUNING")
    monkeypatch.setattr(tuning, "_USER_PATH", str(tmp_path / "tune.json"))
    tuning._reset_for_tests()
    try:
        desc = pf.Descriptor(**fields)
        real = desc.domain == pf.Domain.REAL
        n, batch = desc.lengths[0], desc.number_of_transforms
        h = n // 2 if real else n
        probe = desc.commit()
        key = tuning._entry_key(probe, "fused2", h)
        tuning.record(probe.config.name, "fused2", key, params)
        plan = desc.commit()
        kernel = getattr(cuda_fft, engine)
        stride = fields.get("forward_strides", [1])[0]
        x = torch.rand(batch * n * stride * (1 if real else 2), device=cuda) * 2 - 1
        before = tracing.launches(kernel.kernel)
        y = plan.compute_forward(x)
        torch.cuda.synchronize()
        assert tracing.launches(kernel.kernel) == before + 1
        if real:
            ref = torch.fft.rfft(x.view(batch, n).double())
            got = torch.view_as_complex(y.view(batch, n // 2 + 1, 2))
        else:
            xc = torch.view_as_complex(x.view(batch, n * stride, 2))[:, ::stride]
            ref = torch.fft.fft(xc.to(torch.complex128))
            got = torch.view_as_complex(y.view(batch, n, 2))
        assert (got.to(torch.complex128) - ref).abs().max().item() <= oracle_tol(n)
        times = {}
        won = plan.autotune(iters=1, times=times)
        assert len(times) >= 2 and tuning.lookup(plan.config.name, "fused2", key) == won
    finally:
        tuning._reset_for_tests()


# -- the tensor-core kernels: K10-mm col_mm, K16 global3 (above) -------------

# K10-mm at (bpre, L, rest): every DIRECT length its gate takes and FUSED
# a = 8 … 128, with short last tiles (rest no multiple of the tile) and a
# single column, then chip_smoke's kernel-phase shapes.
COL_MM_CASES = [(3, 128, 5), (2, 256, 17), (2, 384, 16), (2, 512, 33),
                (3, 1024, 9), (2, 2048, 5), (1, 4096, 7), (2, 8192, 3),
                (1, 16384, 2), (4, 1024, 1), *MMA_COL_CASES]


@pytest.mark.parametrize("shape", COL_MM_CASES)
@pytest.mark.parametrize("inplace", [False, True])
def test_col_mm_matches_plain_and_oracle(cuda, shape, inplace):
    """K10-mm against its plain version (1e-5·max|plain|) and ``torch.fft``
    along L (the absolute 2·eps·L·log2L·|scale|), both directions with a
    scale, out of place and in place."""
    bpre, n, rest = shape
    x = torch.rand(2 * bpre * n * rest, device=cuda) * 2 - 1
    xc = torch.view_as_complex(x.view(bpre, n, rest, 2)).to(torch.complex128)
    for sign, scale in ((-1, 0.5), (+1, 3.0 / n)):
        kernel, args = md_kernel_case(pf, "col_mm", shape, sign, scale)
        before = tracing.launches(kernel.kernel)
        want = kernel.plain(x, *args)
        if inplace:
            got = x.clone()
            assert kernel(got, *args, out=got) is got
        else:
            got = kernel(x, *args)
        torch.cuda.synchronize()
        assert tracing.launches(kernel.kernel) == before + 1
        err = (got - want).abs().max().item()
        assert err <= KERNEL_TOL * want.abs().max().item(), (sign, err)
        ref = (torch.fft.fft(xc, dim=1) if sign < 0
               else torch.fft.ifft(xc, dim=1, norm="forward")) * scale
        diff = (torch.view_as_complex(got.view(bpre, n, rest, 2)) - ref).abs().max()
        assert diff.item() <= oracle_tol(n) * scale, (sign, diff.item())
        del want, got


@pytest.mark.parametrize("lengths,batch,bi,params,kinds", [
    ([1024, 1024], 1, False, {"cm": 1}, ("fused2", "col_mm")),
    ([128, 128, 128], 2, False, {"cm": 1}, ("md2", "col_mm")),
    ([128, 128, 128], 2, False, {"m2": 0, "cm": 1}, ("direct", "col_mm", "col_mm")),
    ([512, 512], 2, False, {"m2": 0}, ("direct", "col")),
    ([100, 256], 2, False, {"cm": 1}, ("direct", "col")),
    ([4096], 16, True, {"cm": 1}, ("col_mm",)),
])
def test_tuned_md_route_runs_its_kernels(cuda, tmp_path, monkeypatch, lengths,
                                         batch, bi, params, kinds):
    """A recorded ``multidim`` or ``bi_col`` entry routes both directions
    through its kernels (K10-mm where its gate takes the axis, K10 at
    L = 100), each launched, the results within the oracle bound of
    ``torch.fft``; ``autotune`` on the card records one of the raced
    variants under the same kind and key."""
    from portfft_tpu_torch import tuning
    from portfft_tpu_torch.ops import cuda_multidim

    monkeypatch.delenv("PORTFFT_NO_TUNING")
    monkeypatch.setattr(tuning, "_USER_PATH", str(tmp_path / "tune.json"))
    tuning._reset_for_tests()
    try:
        kw = dict(forward_strides=[batch], backward_strides=[batch],
                  forward_distance=1, backward_distance=1) if bi else {}
        desc = pf.Descriptor(lengths=lengths, number_of_transforms=batch, **kw)
        probe = desc.commit()
        kind = "bi_col" if bi else "multidim"
        key = tuning._entry_key(probe, kind)
        tuning.record(probe.config.name, kind, key, params)
        plan = desc.commit()
        n = int(np.prod(lengths))
        shape = (n, batch) if bi else (batch, *lengths)
        dims = (0,) if bi else tuple(range(1, len(shape)))
        x = torch.rand(2 * batch * n, device=cuda) * 2 - 1
        xc = torch.view_as_complex(x.view(*shape, 2)).to(torch.complex128)
        for direction, compute in ((pf.Direction.FORWARD, plan.compute_forward),
                                   (pf.Direction.BACKWARD, plan.compute_backward)):
            assert tuple(md_kinds(plan._raw_fast[direction])) == kinds
            before = tracing.launches(cuda_multidim.col_mm.kernel)
            y = compute(x)
            torch.cuda.synchronize()
            rose = tracing.launches(cuda_multidim.col_mm.kernel) - before
            assert rose == kinds.count("col_mm")
            ref = (torch.fft.fftn(xc, dim=dims) if direction == pf.Direction.FORWARD
                   else torch.fft.ifftn(xc, dim=dims, norm="forward"))
            diff = (torch.view_as_complex(y.view(*shape, 2)) - ref).abs().max()
            assert diff.item() <= oracle_tol(n), (direction, diff.item())
        variants = race._variants_for_entry(plan, plan._raw_fast[pf.Direction.FORWARD])
        times = {}
        won = plan.autotune(iters=1, times=times)
        if len(variants) > 1:
            assert json.dumps(won, sort_keys=True) in times
            assert tuning.lookup(plan.config.name, kind, key) == won
        else:  # K10-mm declines L = 100: nothing to race
            assert won is None and variants == [{}]
    finally:
        tuning._reset_for_tests()


def test_real_half_length_takes_the_shipped_engine(cuda, tmp_path, monkeypatch):
    """With tuning on and only the shipped table, a REAL 131072 plan's
    half-length GLOBAL entry (65536 = 256 x 256) runs the shipped engine,
    K17 since the radix redesign (K16 before), launched once per
    direction, and both directions hold against ``rfft``/``irfft``."""
    from portfft_tpu_torch import tuning
    from portfft_tpu_torch.ops import cuda_global

    monkeypatch.delenv("PORTFFT_NO_TUNING")
    monkeypatch.setattr(tuning, "_USER_PATH", str(tmp_path / "tune.json"))
    tuning._reset_for_tests()
    try:
        n, batch = 131072, 3
        plan = pf.Descriptor(lengths=[n], number_of_transforms=batch,
                             domain=pf.Domain.REAL).commit()
        for direction in pf.Direction:
            assert plan._raw_fast[direction].inner.engine.name == "global_fused"
        x = torch.rand(batch, n, device=cuda) * 2 - 1
        before = tracing.launches(cuda_global.global_fused.kernel)
        spec = plan.compute_forward(x.reshape(-1))
        back = plan.compute_backward(spec)
        torch.cuda.synchronize()
        assert tracing.launches(cuda_global.global_fused.kernel) == before + 2
        ref = torch.fft.rfft(x.double())
        got = torch.view_as_complex(spec.view(batch, n // 2 + 1, 2))
        assert (got.to(torch.complex128) - ref).abs().max().item() <= oracle_tol(n)
        want = torch.fft.irfft(ref, n, norm="forward")
        assert (back.view(batch, n).double() - want).abs().max().item() <= oracle_tol(n)
    finally:
        tuning._reset_for_tests()


# -- the last GLOBAL engines: K17 global_fused, K18 global_ilv, K19 global_bf2 --

# (engine, G1, G2, batch) at the splits of the parity tests
# (test_torch_global_engines.py) and of chip_smoke's tuned rows; batches that
# leave several chunks, the last one short, at 2^19 and 2^20 (K17: more
# transforms than scratch slots).
SWEEP_CASES = [
    *((e, g1, g2, b) for e in ("global_fused", "global_fused_ftw")
      for g1, g2, b in ((256, 256, 3), (1024, 128, 2), (512, 256, 2),
                        (384, 384, 2), (512, 384, 2), (2048, 256, 3),
                        (2048, 512, 3), (512, 512, 2))),
    ("global_fused", 200, 384, 2),  # K3's DIRECT subs off 128ℤ, dense only
    # K17's scratch ring wraps (23 slots at 65536) and the generic radix
    # stages of a prime sub (509) and 508 = 127·4
    ("global_fused", 256, 256, 64), ("global_fused_ftw", 256, 256, 64),
    ("global_fused", 508, 509, 2),
    *(("global_ilv", g1, g2, b) for g1, g2, b in (
        (256, 256, 3), (512, 256, 2), (256, 512, 2), (128, 256, 2),
        (384, 384, 2), (384, 768, 2), (256, 1536, 2), (1536, 384, 2),
        (512, 384, 2), (1152, 256, 2), (2048, 512, 3), (768, 1024, 1))),
    *(("global_bf2", g1, g2, b) for g1, g2, b in (
        (256, 256, 3), (512, 256, 2), (256, 512, 2), (128, 256, 2),
        (512, 512, 2), (256, 1024, 2), (2048, 256, 3), (2048, 512, 3),
        (1024, 2048, 1))),
]


def _sweep_case(engine, g1, g2, batch, sign, scale):
    """``(kernel, args)`` of ``engine`` on the split g1 x g2 (subs planned
    as the planner plans them), through its raw route's ``kernel_args`` on a
    bank built for the split."""
    from types import SimpleNamespace

    from portfft_tpu_torch.config import DeviceConfig
    from portfft_tpu_torch.enums import Level
    from portfft_tpu_torch.ops import torch_fft
    from portfft_tpu_torch.planner import Plan1D, plan_1d

    cfg = DeviceConfig()
    plan = Plan1D(n=g1 * g2, level=Level.GLOBAL, factors=[],
                  sub=(plan_1d(g1, cfg, 4), plan_1d(g2, cfg, 4)))
    assert ENGINES[engine].gate(plan)
    bank, keys = torch_fft.TwiddleBank(), {}
    torch_fft.collect_bank_keys(plan, sign, bank, keys)
    committed = SimpleNamespace(_bank_keys=keys,
                                _bank_arrays=bank.device_arrays("cuda"))
    return fastpath.Raw(plan, batch, sign, scale,
                        ENGINES[engine]).kernel_args(committed)


@pytest.mark.parametrize("engine,g1,g2,batch", SWEEP_CASES)
def test_sweep_engine_matches_plain_and_oracle(cuda, engine, g1, g2, batch):
    """K17 (both twiddle modes), K18 and K19 against their plain versions
    (1e-5·max|plain|) and ``torch.fft`` (the absolute 2·eps·N·log2N·|scale|),
    both directions with a folded scale, out of place and in place."""
    n = g1 * g2
    x = torch.rand(2 * batch * n, device=cuda) * 2 - 1
    xc = torch.view_as_complex(x.view(batch, n, 2)).to(torch.complex128)
    for sign, scale, inplace in ((-1, 0.5, False), (+1, 3.0 / n, True)):
        kernel, args = _sweep_case(engine, g1, g2, batch, sign, scale)
        assert kernel.__name__ == engine.removesuffix("_ftw")
        before = tracing.launches(kernel.kernel)
        want = kernel.plain(x, *args)
        if inplace:
            got = x.clone()
            assert kernel(got, *args, out=got) is got
        else:
            got = kernel(x, *args)
        torch.cuda.synchronize()
        assert tracing.launches(kernel.kernel) == before + 1
        err = (got - want).abs().max().item()
        assert err <= KERNEL_TOL * want.abs().max().item(), (sign, err)
        ref = (torch.fft.fft(xc) if sign < 0
               else torch.fft.ifft(xc, norm="forward")) * scale
        diff = (torch.view_as_complex(got.view(batch, n, 2)) - ref).abs().max()
        assert diff.item() <= oracle_tol(n) * scale, (sign, diff.item())


@pytest.mark.parametrize("engine,params,n,batch", [
    ("global_fused", {"eng": 6, "t1": 64, "t2": 128}, 1 << 17, 3),
    ("global_fused", {"eng": 6, "ftw": 1, "t1": 64, "t2": 256}, 1 << 20, 2),
    ("global_ilv", {"eng": 8, "t1": 128}, 147456, 2),
    ("global_ilv", {"eng": 8}, 196608, 2),
    ("global_bf2", {"eng": 7, "bf2": 1, "t1": 128, "st3": 0}, 1 << 18, 2)])
def test_sweep_entry_runs_its_kernel_on_the_main_path(cuda, tmp_path, monkeypatch,
                                                      engine, params, n, batch):
    """A recorded ``{"eng": 6}``, ``{"eng": 8}`` or ``{"eng": 7, "bf2": 1}``
    (with the reference's TPU knobs, which are ignored) routes both
    directions through its kernel; ``autotune`` on the card races it and
    records a winner."""
    from portfft_tpu_torch import tuning
    from portfft_tpu_torch.ops import cuda_global, cuda_global_bf, cuda_global_ilv

    monkeypatch.delenv("PORTFFT_NO_TUNING")
    monkeypatch.setattr(tuning, "_USER_PATH", str(tmp_path / "tune.json"))
    tuning._reset_for_tests()
    try:
        desc = pf.Descriptor(lengths=[n], number_of_transforms=batch)
        probe = desc.commit()
        key = tuning._entry_key(probe, "global2")
        tuning.record(probe.config.name, "global2", key, params)
        plan = desc.commit()
        kernel = {"global_fused": cuda_global.global_fused,
                  "global_ilv": cuda_global_ilv.global_ilv,
                  "global_bf2": cuda_global_bf.global_bf2}[engine]
        x = torch.randn(batch, n, dtype=torch.complex64, device=cuda)
        before = tracing.launches(kernel.kernel)
        y = plan.compute_forward(x)
        back = plan.compute_backward(x)
        torch.cuda.synchronize()
        assert tracing.launches(kernel.kernel) == before + 2
        xd = x.to(torch.complex128)
        for got, ref in ((y, torch.fft.fft(xd)),
                         (back, torch.fft.ifft(xd, norm="forward"))):
            diff = (got.reshape(batch, n).to(torch.complex128) - ref).abs().max()
            assert diff.item() <= oracle_tol(n)
        times = {}
        won = plan.autotune(iters=1, times=times)
        assert json.dumps(engine_of(params).params, sort_keys=True) in times
        assert tuning.lookup(plan.config.name, "global2", key) == won
    finally:
        tuning._reset_for_tests()


# -- the REAL plane path, K8a-w, K8b's drop flag, K3-ftw and K15-bf -----------


@pytest.mark.parametrize("n,batch", [(1024, 8), (16384, 8), (16384, 3),
                                     (4222976, 8), (1 << 17, 17)])
def test_untangle_wide_matches_plain_and_oracle(cuda, n, batch):
    """K8a-w against its plain version and K8a (the same function), and the
    untangled C2C spectrum of reals against ``rfft``; odd batches and a
    short last chunk included (the kernel takes any shape)."""
    from chip_smoke import real_oracle_excess
    from portfft_tpu_torch.ops import cuda_real

    h = n // 2
    x = torch.rand(batch * n, device=cuda) * 2 - 1
    z = torch.view_as_real(torch.fft.fft(torch.view_as_complex(
        x.view(batch, h, 2)))).reshape(-1).contiguous()
    plan = pf.Descriptor(lengths=[n], number_of_transforms=batch,
                         domain=pf.Domain.REAL).commit()
    r = plan._bank_keys[("R", n, -1)]
    tabs = (plan._bank_arrays[r + "r"], plan._bank_arrays[r + "i"])
    before = tracing.launches(cuda_real.untangle_wide.kernel)
    got = cuda_real.untangle_wide(z, batch, h, *tabs, 0.5)
    want = cuda_real.untangle_wide.plain(z, batch, h, *tabs, 0.5)
    narrow = cuda_real.untangle(z, batch, h, *tabs, 0.5)
    torch.cuda.synchronize()
    assert tracing.launches(cuda_real.untangle_wide.kernel) == before + 1
    peak = want.abs().max().item()
    assert (got - want).abs().max().item() <= KERNEL_TOL * peak
    assert (got - narrow).abs().max().item() <= KERNEL_TOL * peak
    assert real_oracle_excess(got, x, n, batch, -1, 0.5) <= 1.0


@pytest.mark.parametrize("n,batch", [(768, 3), (1000, 2), (1024, 2), (4096, 3)])
def test_retangle_drop_flag_matches_plain_and_oracle(cuda, n, batch):
    """K8b with and without its flag against its plain version, and the
    committed C2R on spectra with nonzero Im X[0] and Im X[n/2] against
    ``irfft`` plus the two bins' contribution from n = 1024 on."""
    from chip_smoke import c2r_reference, random_raw
    from portfft_tpu_torch.ops import cuda_real

    h = n // 2
    plan = pf.Descriptor(lengths=[n], number_of_transforms=batch,
                         domain=pf.Domain.REAL, backward_scale=2.0 / n).commit()
    entry = plan._raw_fast[pf.Direction.BACKWARD]
    assert entry.tangle == "retangle" and entry.drop == (n < 1024)
    spec = random_raw(batch * (n + 2), seed=n)
    r = plan._bank_keys[("R", n, +1)]
    tabs = (plan._bank_arrays[r + "r"], plan._bank_arrays[r + "i"])
    for drop in (False, True):
        got = cuda_real.retangle(spec, batch, h, *tabs, 0.5, drop)
        want = cuda_real.retangle.plain(spec, batch, h, *tabs, 0.5, drop)
        assert (got - want).abs().max().item() <= KERNEL_TOL * want.abs().max().item()
    back = plan.compute_backward(spec)
    ref = c2r_reference(torch.view_as_complex(spec.view(batch, h + 1, 2)).to(
        torch.complex128), n) * (2.0 / n)
    diff = (back.view(batch, n).double() - ref).abs().max().item()
    assert diff <= oracle_tol(n) * 2.0 / n, diff


def _ftw_case(g1, g2, batch, sign, scale):
    """``(kernel, args)`` of K3-ftw on the split g1 x g2."""
    return _sweep_case("global2_ftw", g1, g2, batch, sign, scale)


@pytest.mark.parametrize("g1,g2,batch", [(256, 256, 3), (512, 128, 2), (384, 384, 2),
                                         (1024, 128, 2), (2048, 512, 2),
                                         (4096, 256, 1), (128, 8192, 1)])
def test_global2_ftw_matches_plain_and_oracle(cuda, g1, g2, batch):
    """K3-ftw against its plain version and K3 and ``torch.fft``, both
    directions with a folded scale, out of place and in place: DIRECT G1
    (the Q tables) and FUSED G1 [8, 128], [16, 128], [32, 128] (ZQ)."""
    n = g1 * g2
    x = torch.rand(2 * batch * n, device=cuda) * 2 - 1
    xc = torch.view_as_complex(x.view(batch, n, 2)).to(torch.complex128)
    for sign, scale, inplace in ((-1, 0.5, False), (+1, 3.0 / n, True)):
        kernel, args = _ftw_case(g1, g2, batch, sign, scale)
        assert kernel.__name__ == "global2_ftw"
        before = tracing.launches(kernel.kernel)
        want = kernel.plain(x, *args)
        if inplace:
            got = x.clone()
            assert kernel(got, *args, out=got) is got
        else:
            got = kernel(x, *args)
        torch.cuda.synchronize()
        assert tracing.launches(kernel.kernel) == before + 1
        err = (got - want).abs().max().item()
        assert err <= KERNEL_TOL * want.abs().max().item(), (sign, err)
        ref = (torch.fft.fft(xc) if sign < 0
               else torch.fft.ifft(xc, norm="forward")) * scale
        diff = (torch.view_as_complex(got.view(batch, n, 2)) - ref).abs().max()
        assert diff.item() <= oracle_tol(n) * scale, (sign, diff.item())


def test_global2_ftw_entry_runs_on_the_main_path(cuda, tmp_path, monkeypatch):
    """A recorded ``{"eng": 2, "ftw": 1}`` (with the reference's tile knobs)
    routes both directions through K3-ftw; ``autotune`` races it."""
    from portfft_tpu_torch import tuning
    from portfft_tpu_torch.ops import cuda_global

    monkeypatch.delenv("PORTFFT_NO_TUNING")
    monkeypatch.setattr(tuning, "_USER_PATH", str(tmp_path / "tune.json"))
    tuning._reset_for_tests()
    try:
        n, batch = 65536, 2
        desc = pf.Descriptor(lengths=[n], number_of_transforms=batch)
        probe = desc.commit()
        key = tuning._entry_key(probe, "global2")
        tuning.record(probe.config.name, "global2", key,
                      {"eng": 2, "t1": 64, "t2": 256, "ftw": 1})
        plan = desc.commit()
        assert plan._raw_fast[pf.Direction.FORWARD].engine.name == "global2_ftw"
        x = torch.randn(batch, n, dtype=torch.complex64, device=cuda)
        before = tracing.launches(cuda_global.global2_ftw.kernel)
        y, back = plan.compute_forward(x), plan.compute_backward(x)
        torch.cuda.synchronize()
        assert tracing.launches(cuda_global.global2_ftw.kernel) == before + 2
        xd = x.to(torch.complex128)
        for got, ref in ((y, torch.fft.fft(xd)),
                         (back, torch.fft.ifft(xd, norm="forward"))):
            diff = (got.reshape(batch, n).to(torch.complex128) - ref).abs().max()
            assert diff.item() <= oracle_tol(n)
        times = {}
        plan.autotune(iters=1, times=times)
        assert json.dumps({"eng": 2, "ftw": 1}, sort_keys=True) in times
    finally:
        tuning._reset_for_tests()


#: Bluestein lengths whose convolution's subs are both A·128 (slab factors
#: (A1, A2)): (2, 2), (3, 2), (4, 2), (3, 3), (4, 3), (4, 4), (16, 2),
#: (16, 3), (16, 8), (16, 16).
BF_LENGTHS = [(24977, 2), (37951, 2), (49597, 2), (66821, 2), (75277, 2),
              (101267, 1), (200191, 1), (302891, 1), (803893, 1), (1586939, 1)]


@pytest.mark.parametrize("n,batch", BF_LENGTHS)
def test_bluestein_bf_matches_plain_and_oracle(cuda, monkeypatch, n, batch):
    """K15-bf against its plain version, K15 and ``torch.fft``, both
    directions with a scale."""
    from chip_smoke import plane_case

    monkeypatch.setenv("PORTFFT_BLUESTEIN_BF", "1")
    gen = torch.Generator(device="cuda").manual_seed(n)
    x = torch.randn(batch, n, dtype=torch.complex64, generator=gen, device=cuda)
    xr, xi = x.real.contiguous(), x.imag.contiguous()
    for sign, scale in ((-1, 0.5), (+1, 2.0 / n)):
        kernel, args = plane_case(pf, "bluestein_bf", n, sign)
        dense, dargs = plane_case(pf, "bluestein", n, sign)
        before = tracing.launches(kernel.kernel)
        yr, yi = kernel(xr, xi, *args, scale=scale)
        wr, wi = kernel.plain(xr, xi, *args, scale=scale)
        dr, di = dense(xr, xi, *dargs, scale=scale)
        torch.cuda.synchronize()
        assert tracing.launches(kernel.kernel) == before + 1
        peak = max(wr.abs().max().item(), wi.abs().max().item())
        for ar, ai in ((wr, wi), (dr, di)):
            err = max((yr - ar).abs().max().item(), (yi - ai).abs().max().item())
            assert err <= KERNEL_TOL * peak, (sign, err)
        xd = x.to(torch.complex128)
        ref = (torch.fft.fft(xd) if sign < 0
               else torch.fft.ifft(xd, norm="forward")) * scale
        diff = (torch.complex(yr, yi).to(torch.complex128) - ref).abs().max().item()
        assert diff <= oracle_tol(n) * scale, (sign, diff)


def _k15_plan(n):
    """The length-n plan K15 runs; 1109 on a hand-made 40 x 56 convolution
    (generic radix-5 and radix-7 stages), which the planner never picks."""
    from portfft_tpu_torch.enums import Level
    from portfft_tpu_torch.planner import Plan1D

    if n != 1109:
        return pf.Descriptor(lengths=[n]).commit(device="cuda").plans[n]
    subs = tuple(Plan1D(n=m, level=Level.DIRECT, factors=[m]) for m in (40, 56))
    conv = Plan1D(n=2240, level=Level.GLOBAL, factors=[], sub=subs)
    return Plan1D(n=n, level=Level.BLUESTEIN, factors=[], conv=conv)


#: K15 on the radix stages: 65537 (384 x 384) at 37 rows, 444 tiles a pass,
#: which no resident grid of the card divides, so the last round of tiles
#: is ragged; 200191 (FUSED [16, 128] x 256: passes 1 and 3 in tiles of 6
#: of the 256 columns, the last one ragged); 1109 (40 x 56, 56 columns in
#: tiles of 32).
K15_CASES = [(65537, 37), (200191, 2), (1109, 5)]


@pytest.mark.parametrize("n,batch", K15_CASES)
def test_bluestein_matches_plain_and_oracle(cuda, n, batch):
    """K15 against its plain version (the same radix stages in PyTorch) and
    ``torch.fft``, both directions with a scale; each call counts one K15
    launch."""
    from portfft_tpu_torch.ops import cuda_bluestein, torch_fft

    plan = _k15_plan(n)
    assert cuda_bluestein.supported(plan, pf.DeviceConfig())
    gen = torch.Generator(device="cuda").manual_seed(n)
    x = torch.randn(batch, n, dtype=torch.complex64, generator=gen, device=cuda)
    xr, xi = x.real.contiguous(), x.imag.contiguous()
    for sign, scale in ((-1, 0.5), (+1, 2.0 / n)):
        bank, keys = torch_fft.TwiddleBank(np.float32), {}
        torch_fft.collect_bank_keys(plan, sign, bank, keys)
        t = cuda_bluestein.bluestein_tables(plan, sign, keys,
                                            bank.device_arrays(cuda))
        before = tracing.launches()["K15"]
        yr, yi = cuda_bluestein.bluestein(xr, xi, t, scale=scale)
        wr, wi = cuda_bluestein.bluestein.plain(xr, xi, t, scale=scale)
        torch.cuda.synchronize()
        assert tracing.launches()["K15"] == before + 1
        peak = max(wr.abs().max().item(), wi.abs().max().item())
        err = max((yr - wr).abs().max().item(), (yi - wi).abs().max().item())
        assert err <= KERNEL_TOL * peak, (sign, err)
        xd = x.to(torch.complex128)
        ref = (torch.fft.fft(xd) if sign < 0
               else torch.fft.ifft(xd, norm="forward")) * scale
        diff = (torch.complex(yr, yi).to(torch.complex128) - ref).abs().max().item()
        assert diff <= oracle_tol(n) * scale, (sign, diff)


@pytest.mark.parametrize("n,batch,bf", [(1200, 5, False), (2062, 2, False),
                                        (4124, 2, False), (2 * 65537, 1, False),
                                        (2 * 65537, 2, True), (4 * 65537, 1, True),
                                        (4222976, 8, False), (4222976, 3, False)])
def test_real_plane_main_path_matches_oracle(cuda, monkeypatch, n, batch, bf):
    """The REAL plane path both ways against ``rfft`` and the port's C2R
    (``c2r_reference``: backward spectra with nonzero Im X[0] and
    Im X[n/2]), with scales; its kernels launch (K8a-w where its gate takes
    the shape, K15-bf with the flag, K15 once a direction where h's plane
    path takes it, as at 2·65537 without the flag)."""
    from chip_smoke import c2r_reference, real_oracle_excess, random_raw
    from portfft_tpu_torch.ops import cuda_bluestein, cuda_real

    if bf:
        monkeypatch.setenv("PORTFFT_BLUESTEIN_BF", "1")
    plan = pf.Descriptor(lengths=[n], number_of_transforms=batch,
                         domain=pf.Domain.REAL, forward_scale=0.5,
                         backward_scale=2.0 / n).commit()
    fwd, bwd = (plan._raw_fast[d] for d in pf.Direction)
    assert isinstance(fwd.inner, fastpath.Plane) and isinstance(bwd.inner, fastpath.Plane)
    wide = cuda_real.wide_supported(n, batch)
    assert fwd.tangle == ("untangle_wide" if wide else "untangle")
    counters = [cuda_real.untangle_wide if wide else cuda_real.untangle,
                cuda_real.retangle]
    if bf:
        assert "bluestein_bf" in fwd.inner.routes.values()
        counters.append(cuda_bluestein.bluestein_bf)
    k15 = "bluestein" in fwd.inner.routes.values()  # h's plane path runs K15
    before = [tracing.launches(c.kernel) for c in counters]
    k15_before = tracing.launches()["K15"]
    x = random_raw(batch * n, seed=n)
    y = plan.compute_forward(x)
    spec = random_raw(batch * (n + 2), seed=n + 1)
    back = plan.compute_backward(spec)
    torch.cuda.synchronize()
    assert all(tracing.launches(c.kernel) > b for c, b in zip(counters, before))
    assert tracing.launches()["K15"] == k15_before + (2 if k15 else 0)
    assert y.shape == (batch * (n + 2),) and back.shape == (batch * n,)
    assert real_oracle_excess(y, x, n, batch, -1, 0.5) <= 1.0
    ref = c2r_reference(torch.view_as_complex(spec.view(batch, -1, 2)).to(
        torch.complex128), n) * (2.0 / n)
    diff = (back.view(batch, n).double() - ref).abs().max().item()
    assert diff <= oracle_tol(n) * 2.0 / n, diff
