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

import numpy as np
import pytest
import torch

import portfft_tpu_torch as pf
from chip_smoke import KERNEL_TOL, oracle_tol, real_case
from portfft_tpu_torch import fastpath

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
        assert entry[0] == kind
        kernel, args = fastpath.kernel_args(plan, entry)
        before = kernel.launches
        want = kernel.plain(x, *args)
        if inplace:
            got = x.clone()
            kernel(got, *args, out=got)
        else:
            got = kernel(x, *args)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
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
    kernel, args = fastpath.kernel_args(plan, plan._raw_fast[pf.Direction.FORWARD])
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
        before = kernel.launches
        want = kernel.plain(inp, *args)
        got = kernel(inp, *args)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
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
    """The (kind, kernel, args) of each step of a multi-dim or BI entry."""
    entry = plan._raw_fast[direction]
    steps = entry[2] if entry[0] == "multidim" else (entry,)
    return [(s[0], *fastpath.kernel_args(plan, s)) for s in steps]


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
            before = kernel.launches
            want = kernel.plain(x, *args)
            if inplace:
                got = x.clone()
                kernel(got, *args, out=got)
            else:
                got = kernel(x, *args)
            torch.cuda.synchronize()
            assert kernel.launches == before + 1
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
    assert plan._raw_fast[pf.Direction.FORWARD][0] == "bi_col"
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
     (16411, 2, "bluestein"), (20011, 3, "bluestein"), (65537, 2, "bluestein"),
     (131101, 2, "bluestein")],
)
def test_plane_kernel_matches_plain(cuda, n, batch, kind):
    """K13 (every mode) and K15 on planes against their plain versions."""
    from chip_smoke import plane_case

    rng = np.random.default_rng(n)
    xr, xi = (torch.from_numpy(rng.uniform(-1, 1, (batch, n)).astype(np.float32))
              .to(cuda) for _ in range(2))
    for sign in (-1, +1):
        kernel, args = plane_case(pf, kind, n, sign)
        before = kernel.launches
        yr, yi = kernel(xr, xi, *args)
        wr, wi = kernel.plain(xr, xi, *args)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        peak = max(wr.abs().max().item(), wi.abs().max().item())
        err = max((yr - wr).abs().max().item(), (yi - wi).abs().max().item())
        assert err <= KERNEL_TOL * peak, (sign, err)


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
    assert plan._raw_fast[pf.Direction.FORWARD][0] == "plane"
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
