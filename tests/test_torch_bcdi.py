"""Bragg CDI phase retrieval through portfft_tpu_torch's multi-dim C2C plans,
on the CPU (the kernels' plain versions).

The reconstruction is the benchmark configuration's plain one
(``port_bench/configs/pynx_bcdi.py``: PyNX's error reduction, ER, with
L2-preserving 3D transforms), run at ``SMALL`` = 8 × 128 × 128, which takes
the route the cell takes at 512^3 (K11 over the trailing planes, then K10
down axis 0), once with the port's ``compute_forward`` /
``compute_backward`` as its FT / IFT and once with ``torch.fft`` in
complex128.  The cycles agree within the fp32 oracle bound
2·eps·N·log2N (absolute or relative, ``tests/oracle.py``) and, tighter,
within ``TOL`` of the reference's root mean square; ER's error never rises
from one cycle to the next.  The route, its ``portfft.axis`` notes under a
profiler, and K11's path rule (``cuda_multidim.md2_path``) are pinned.
"""

import math
import pathlib
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import portfft_tpu_torch as pt
from oracle import tolerance
from portfft_tpu_torch import config, fastpath
from portfft_tpu_torch.ops import cuda_multidim
from portfft_tpu_torch.utils import tracing
from port_bench import run
from port_bench.tests.conftest import ROOT

SMALL = [8, 128, 128]
FULL = [512, 512, 512]
CYCLES = 5
#: The widest |error| of the port's cycles as a share of the reference's
#: root mean square: the port reads 5.3e-6 (fp32 radix stages, eps = 6e-8,
#: through five cycles of two transforms); a TF32 pipeline (10-bit
#: mantissa) reads 1.3e-3 after one transform.
TOL = 2e-5
SRC = pathlib.Path(ROOT) / "portfft_tpu_torch" / "csrc" / "fft_md2.cu"


@pytest.fixture(scope="module")
def bcdi():
    return run.Bench(ROOT).config("pynx_bcdi")


def _scale(lengths) -> float:
    return 1 / math.sqrt(math.prod(lengths))


def _plan(lengths):
    s = _scale(lengths)
    return pt.Descriptor(lengths=lengths, forward_scale=s,
                         backward_scale=s).commit(device="cpu")


def _port(plan):
    """``(fft, ifft)`` of one object through the plan, counting the calls."""
    calls = []
    shape = plan.descriptor.lengths

    def fft(rho):
        calls.append("forward")
        y = plan.compute_forward(rho.reshape(-1))
        assert y.dtype == torch.complex64
        return y.view(*shape)

    def ifft(psi):
        calls.append("backward")
        y = plan.compute_backward(psi.reshape(-1))
        assert y.dtype == torch.complex64
        return y.view(*shape)

    return fft, ifft, calls


def _torch():
    dims = (0, 1, 2)
    return (lambda rho: torch.fft.fftn(rho, dim=dims, norm="ortho"),
            lambda psi: torch.fft.ifftn(psi, dim=dims, norm="ortho"))


def _problem(seed: int = 26):
    """A seeded object inside a box support, its measured amplitudes, and a
    random start inside the support, as a reconstruction begins."""
    gen = torch.Generator().manual_seed(seed)
    support = torch.zeros(SMALL, dtype=torch.bool)
    support[2:6, 32:96, 40:88] = True

    def uniform():
        raw = torch.empty(*SMALL, 2).uniform_(-1.0, 1.0, generator=gen)
        return torch.view_as_complex(raw) * support

    truth = uniform()
    amp = torch.fft.fftn(truth.to(torch.complex128), norm="ortho").abs()
    return uniform(), amp, support


def _rms_error(got, want) -> float:
    return float((got - want).abs().max() / want.abs().square().mean().sqrt())


def test_the_configuration_is_orthonormal_at_512_cubed(bcdi):
    desc = bcdi[0]["descriptor"]
    assert desc["forward_scale"] == desc["backward_scale"] == 512**-1.5
    assert 512**-1.5 == pytest.approx(_scale(FULL), rel=1e-15)
    assert desc["domain"] == "COMPLEX" and desc["precision"] == "fp32"


def test_the_reference_is_plain_torch_with_tf32_off(bcdi):
    _, ref = bcdi
    text = pathlib.Path(ref.__file__).read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|portfft_tpu)", text, re.M)
    torch.backends.cuda.matmul.allow_tf32 = True
    spec = {"lengths": SMALL, "batch": 1, "direction": "forward"}
    x = torch.zeros(1, math.prod(SMALL), dtype=torch.complex64)
    ref.reference(x, spec)
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.mark.parametrize("lengths", [SMALL, FULL])
def test_the_plan_takes_k11_then_k10(lengths):
    """Both directions: K11 over the ∏outer trailing planes with scale 1,
    then K10 down axis 0 with the orthonormal scale, the notes ``1,2 K11``
    and ``0 K10``."""
    plan = _plan(lengths)
    for direction, sign in ((pt.Direction.FORWARD, -1), (pt.Direction.BACKWARD, 1)):
        entry = plan._raw_fast[direction]
        assert isinstance(entry, fastpath.MultiDim)
        md2, col = entry.steps
        assert isinstance(md2, fastpath.Md2) and isinstance(col, fastpath.Col)
        assert (md2.batch, md2.plan1.n, md2.plan2.n, md2.sign, md2.scale) == (
            lengths[0], lengths[1], lengths[2], sign, 1.0)
        assert (col.kernel, col.bpre, col.plan.n, col.rest, col.sign) == (
            "col", 1, lengths[0], lengths[1] * lengths[2], sign)
        assert col.scale == pytest.approx(_scale(lengths), rel=1e-15)
        assert fastpath.step_notes(plan, entry) == ["1,2 K11", "0 K10"]


def test_each_step_is_an_axis_span_under_a_profiler():
    plan = _plan(SMALL)
    rho, _, _ = _problem()
    x = rho.reshape(-1)
    for fn in (plan.compute_forward, plan.compute_backward):
        with profile(activities=[ProfilerActivity.CPU]):
            fn(x)
        (call,) = tracing.calls(1)
        axes = sorted(call.named("portfft.axis"), key=lambda s: s.start_ns)
        assert [s.note for s in axes] == ["1,2 K11", "0 K10"]
        for axis, kernel in zip(axes, ("K11", "K10")):
            assert [c.name for c in call.children(axis)] == [f"portfft.{kernel}"]


def test_er_cycles_through_the_port_match_torch_fft(bcdi):
    _, ref = bcdi
    plan = _plan(SMALL)
    fft, ifft, calls = _port(plan)
    start, amp, support = _problem()
    got, want = start, start.to(torch.complex128)
    errors = []
    for _ in range(CYCLES):
        got, err = ref.er_cycle(got, amp.float(), support, fft, ifft)
        want, err_want = ref.er_cycle(want, amp, support, *_torch())
        errors.append(err)
        assert err == pytest.approx(err_want, rel=1e-4)
    assert calls == ["forward", "backward"] * CYCLES
    tol = tolerance(plan.descriptor)
    assert tol == pytest.approx(2 * np.finfo(np.float32).eps * math.prod(SMALL)
                                * math.log2(math.prod(SMALL)))
    diff = (got - want).abs().numpy()
    assert np.all((diff <= tol) | (diff <= tol * want.abs().numpy())), diff.max()
    assert _rms_error(got, want) <= TOL
    # ER never raises the Fourier-space error, and here it falls
    assert all(b <= a for a, b in zip(errors, errors[1:])), errors
    assert errors[-1] < errors[0]
    # the support projection holds: nothing outside the support
    assert got[~support].abs().max() == 0


def test_md2_path_spills_past_the_l2():
    """``spill`` where two blocks an SM on 132 SMs hold more intermediate
    planes (8 bytes an element) than the 50 MB L2: at 512 × 512 and 256 ×
    256; ``resident`` at 128 × 128 (34.6 MB)."""
    assert (config.H100_SM_COUNT, config.H100_L2_BYTES) == (132, 50 * 10**6)
    assert cuda_multidim.md2_path(512, 512) == "spill"
    assert cuda_multidim.md2_path(256, 256) == "spill"
    assert cuda_multidim.md2_path(128, 128) == "resident"
    assert cuda_multidim.md2_path(128, 256) == "spill"
    assert 2 * 132 * 128 * 128 * 8 <= config.H100_L2_BYTES < 2 * 132 * 128 * 256 * 8


def test_md2_path_reads_the_kernels_blocks_an_sm():
    """The rule's two blocks an SM are the kernel's launch bounds."""
    src = SRC.read_text()
    assert re.search(r"constexpr int kBlock = 256;", src)
    bounds = re.search(r"__launch_bounds__\(kBlock, (\d+)\)\s*\n\s*md2_kernel", src)
    assert bounds and int(bounds.group(1)) == cuda_multidim.MD2_BLOCKS_PER_SM


def test_a_cpu_call_counts_no_k11_path():
    """The plain version runs on the CPU: no launch, no path."""
    plan = _plan(SMALL)
    rho, _, _ = _problem()
    launches, paths = tracing.launches("K11"), tracing.paths("K11")
    plan.compute_forward(rho.reshape(-1))
    assert tracing.launches("K11") == launches and tracing.paths("K11") == paths
