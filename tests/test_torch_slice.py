"""The whole slice — Descriptor → commit(device="cpu") → compute — of
portfft_tpu_torch against portfft_tpu (``commit(use_pallas=True)``, Pallas
kernels in interpret mode) and ``np.fft``.

Tolerance: both within the oracle's per-element 2·eps·N·log2N of
``np.fft``; port against reference max|Δ| ≤ 5e-5·max|y_ref|.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import oracle
import portfft_tpu as ref
import portfft_tpu_torch as pt
from portfft_tpu_torch import fastpath
from portfft_tpu_torch.planner import plan_1d

# (n, batch): one row per kernel and plan shape of the slice; batches where
# the reference's raw kernel accepts the shape.
SLICE = [(16, 64), (256, 8), (4096, 4), (65536, 2), (1 << 19, 1)]
KERNEL_OF = {16: "direct", 256: "direct", 4096: "fused2", 65536: "global2",
             1 << 19: "global2"}


def _desc(mod, n, batch, **kw):
    if "placement" in kw:
        kw["placement"] = mod.Placement[kw["placement"]]
    return mod.Descriptor(lengths=[n], number_of_transforms=batch,
                          forward_scale=0.5, backward_scale=1.0 / n, **kw)


def _assert_close(got, want_ref, desc, x, direction):
    """``got`` and ``want_ref`` (flat complex) against np.fft, and each
    other."""
    canon = x.reshape(desc.number_of_transforms, *desc.lengths)
    expect = oracle.reference_output(desc, canon, direction)
    oracle.verify(desc, np.asarray(want_ref), expect, direction)
    oracle.verify(desc, np.asarray(got), expect, direction)
    delta = np.abs(np.asarray(got) - np.asarray(want_ref)).max()
    assert delta <= 5e-5 * np.abs(want_ref).max(), delta


@pytest.mark.parametrize("n,batch", SLICE)
def test_slice_out_of_place_numpy_complex(n, batch):
    rdesc = _desc(ref, n, batch)
    rplan = rdesc.commit(use_pallas=True)
    plan = _desc(pt, n, batch).commit(device="cpu")
    assert plan.plan_description() == rplan.plan_description()
    assert plan._raw_fast[pt.Direction.FORWARD].engine.kind == KERNEL_OF[n]
    rroute = rplan._raw_fast[ref.Direction.FORWARD]
    assert rroute[0] == KERNEL_OF[n]
    x = oracle.gen_input(rdesc, seed=n).reshape(-1)
    for rdir, pdir in zip(ref.Direction, pt.Direction):
        rfn = rplan.compute_forward if rdir == ref.Direction.FORWARD else (
            rplan.compute_backward)
        pfn = plan.compute_forward if pdir == pt.Direction.FORWARD else (
            plan.compute_backward)
        want = rfn(x)
        got = pfn(x)
        assert isinstance(got, np.ndarray) and got.dtype == np.complex64
        assert got.shape == want.shape == (batch * n,)
        _assert_close(got, want, rdesc, x, rdir)


@pytest.mark.parametrize("n,batch", SLICE[:4])
def test_slice_in_place_tensor_raw(n, batch):
    """IN_PLACE on a raw float32 tensor: the result lands in the caller's
    tensor, and equals the reference's in-place result."""
    rdesc = _desc(ref, n, batch, placement="IN_PLACE")
    rplan = rdesc.commit(use_pallas=True)
    plan = _desc(pt, n, batch, placement="IN_PLACE").commit(device="cpu")
    x = oracle.gen_input(rdesc, seed=n + 1).reshape(-1)
    raw = x.view(np.float32).copy()
    want = np.asarray(rplan.compute_forward(raw.copy())).view(np.complex64)
    t = torch.from_numpy(raw.copy())
    got = plan.compute_forward(t)
    assert got is t
    _assert_close(t.numpy().view(np.complex64), want, rdesc, x,
                  ref.Direction.FORWARD)
    back = plan.compute_backward(t)  # scales 0.5 and 1/n: the round trip is x/2
    assert back is t
    assert np.abs(t.numpy().view(np.complex64) - 0.5 * x).max() <= 1e-5


def test_slice_input_kinds():
    """numpy complex -> numpy complex; numpy raw -> numpy raw; tensor
    complex -> tensor complex; tensor raw -> tensor raw; all equal."""
    n, batch = 4096, 2
    plan = pt.Descriptor(lengths=[n], number_of_transforms=batch).commit(
        device="cpu"
    )
    x = oracle.gen_input(ref.Descriptor(lengths=[n], number_of_transforms=batch))
    x = x.reshape(-1)
    y_np = plan.compute_forward(x)
    y_raw = plan.compute_forward(x.view(np.float32))
    y_t = plan.compute_forward(torch.from_numpy(x.copy()))
    y_traw = plan.compute_forward(torch.from_numpy(x.view(np.float32).copy()))
    assert y_np.dtype == np.complex64
    assert y_raw.dtype == np.float32 and y_raw.shape == (2 * batch * n,)
    assert y_t.dtype == torch.complex64 and y_t.device.type == "cpu"
    assert y_traw.dtype == torch.float32
    for other in (y_raw.view(np.complex64), y_t.numpy(),
                  y_traw.numpy().view(np.complex64)):
        assert np.array_equal(other, y_np)
    ref_y = np.fft.fft(x.reshape(batch, n).astype(np.complex128)).reshape(-1)
    assert np.abs(y_np - ref_y).max() <= 1e-4 * np.abs(ref_y).max()


def test_slice_longer_buffer_and_in_place_numpy():
    """Scalars past the input count are ignored out-of-place (the result
    has the output count) and left alone in-place; a numpy buffer is
    written in place."""
    n, batch = 256, 3
    x = oracle.gen_input(ref.Descriptor(lengths=[n], number_of_transforms=batch))
    x = x.reshape(-1)
    long = np.concatenate([x, np.full(5, 7 + 7j, np.complex64)])
    plan = pt.Descriptor(lengths=[n], number_of_transforms=batch).commit(
        device="cpu"
    )
    y = plan.compute_forward(long)
    assert y.shape == (batch * n,)
    assert np.array_equal(y, plan.compute_forward(x))
    ip = pt.Descriptor(lengths=[n], number_of_transforms=batch,
                       placement=pt.Placement.IN_PLACE).commit(device="cpu")
    buf = long.copy()
    assert ip.compute_forward(buf) is buf
    assert np.array_equal(buf[: batch * n], y)
    assert np.all(buf[batch * n:] == 7 + 7j)


def test_slice_buffer_errors():
    plan = pt.Descriptor(lengths=[16], number_of_transforms=4).commit(
        device="cpu"
    )
    with pytest.raises(pt.InvalidConfiguration, match="needs 64"):
        plan.compute_forward(np.zeros(63, np.complex64))
    with pytest.raises(pt.InvalidConfiguration, match="even number"):
        plan.compute_forward(np.zeros(127, np.float32))
    with pytest.raises(pt.InvalidConfiguration, match="single complex"):
        plan.compute_forward(np.zeros(64, np.complex64), np.zeros(64))
    # an out= buffer gets the result in place (tests/test_torch_layout.py
    # holds out= layouts to the JAX package)
    x = oracle.gen_input(ref.Descriptor(lengths=[16], number_of_transforms=4))
    out = np.zeros(64, np.complex64)
    assert plan.compute_forward(x.reshape(-1), out=out) is out
    assert np.array_equal(out, plan.compute_forward(x.reshape(-1)))
    with pytest.raises(pt.InvalidConfiguration, match="output buffer has 63"):
        plan.compute_forward(np.zeros(64, np.complex64),
                             out=np.zeros(63, np.complex64))
    ip = pt.Descriptor(lengths=[16], placement=pt.Placement.IN_PLACE).commit(
        device="cpu"
    )
    with pytest.raises(pt.InvalidConfiguration, match="IN_PLACE"):
        ip.compute_forward(np.zeros(16, np.complex64),
                           out=np.zeros(16, np.complex64))
    with pytest.raises(pt.InvalidConfiguration, match="given to a plan"):
        plan.compute_forward(torch.zeros(64, dtype=torch.complex64,
                                         device="meta"))


def test_commit_needs_cuda_unless_cpu_is_named(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda", torch.device("cuda")):
        with pytest.raises(pt.UnsupportedConfiguration, match="no CUDA"):
            pt.Descriptor(lengths=[16]).commit(device=device)
    with pytest.raises(pt.UnsupportedConfiguration, match="not supported"):
        pt.Descriptor(lengths=[16]).commit(device="meta")
    assert pt.Descriptor(lengths=[16]).commit(device="cpu").device.type == "cpu"


@pytest.mark.parametrize(
    "kw,item",
    [
        (dict(lengths=[16], domain="REAL", complex_storage="SPLIT_COMPLEX"),
         "item 9"),
        (dict(lengths=[4, 4], domain="REAL"), "multi-dim.*item 9"),  # multi-dim REAL
        # REAL layouts come with the REAL plane path; the C2C cases that
        # raised naming item 8 are parity cases of tests/test_torch_layout.py
        (dict(lengths=[16], domain="REAL", number_of_transforms=2,
              forward_strides=[2], backward_strides=[2], forward_distance=32,
              backward_distance=18), "item 9"),
        (dict(lengths=[16], domain="REAL", backward_offset=2), "item 9"),
        (dict(lengths=[16], precision="fp64"), "item 12"),
        # the REAL lengths whose half length needs the plane path commit on
        # the REAL plane path: tests/test_torch_real_plane.py
    ],
)
def test_outside_the_slice_raises_at_commit(kw, item):
    kw = dict(kw)
    for field, enum in (("domain", pt.Domain),
                        ("complex_storage", pt.ComplexStorage)):
        if field in kw:
            kw[field] = enum[kw[field]]
    with pytest.raises(pt.UnsupportedConfiguration, match=item):
        pt.Descriptor(**kw).commit(device="cpu")


@pytest.mark.parametrize(
    "lengths,routes",
    [
        ([2, 65537], {2: "direct", 65537: "bluestein"}),
        ([4, 600], {4: "direct", 600: "chain"}),
        ([4, 2 * 65537], {4: "direct", 2 * 65537: "generic", 2: "direct",
                          65537: "bluestein"}),
    ],
)
def test_plane_last_axes_commit_on_the_per_axis_walk(lengths, routes):
    """Multi-dim shapes whose last axis the raw route declines run the
    plane path's per-axis walk, every axis through the executor here (no
    outer axis of 2 or 4 is one the column kernel K12 takes)."""
    plan = pt.Descriptor(lengths=lengths).commit(device="cpu")
    entry = plan._raw_fast[pt.Direction.FORWARD]
    assert isinstance(entry, fastpath.Core)
    assert entry.split is False and entry.k12 == ()
    assert entry.routes == routes


def test_global_with_a_16384_sub_routes_to_k14():
    """GLOBAL FUSED [128, 128] x [64, 128] runs on the plane GLOBAL kernel
    K14 (its [128, 128] pass as two launches); routes only, since the
    committed bank of 2^27 points would hold a GiB-sized twiddle table."""
    cfg = pt.DeviceConfig()
    plan = plan_1d(1 << 27, cfg, 4)
    assert fastpath.plane_routes(plan, cfg) == {1 << 27: "global2"}


def test_distributed_commit_raises():
    with pytest.raises(pt.UnsupportedConfiguration, match="item 15"):
        pt.Descriptor(lengths=[16]).commit(device="cpu", mesh=object())


def test_port_never_imports_jax():
    """``import portfft_tpu_torch`` and CPU transforms (C2C, REAL, and the
    FUSED engines K2-v1, K2-v2, K2-v3) succeed with JAX and the JAX package
    made unimportable; no source file imports them."""
    code = r"""
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "portfft_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import numpy as np
import portfft_tpu_torch as pt
import portfft_tpu_torch.convert, portfft_tpu_torch.fastpath
plan = pt.Descriptor(lengths=[65536], number_of_transforms=1).commit(device="cpu")
y = plan.compute_forward(np.ones(65536, np.complex64))
assert abs(y[0] - 65536) < 1e-2 and abs(y[1:]).max() < 1e-2
real = pt.Descriptor(lengths=[1000], number_of_transforms=2,
                     domain=pt.Domain.REAL).commit(device="cpu")
r = real.compute_forward(np.ones(2000, np.float32))
assert abs(r[0] - 1000) < 1e-2 and abs(r[1:501]).max() < 1e-2
import torch
from portfft_tpu_torch import fastpath
for n, params in ((4096, {"eng": 2, "bt": 2}), (4096, {"eng": 3}), (640, {"eng": 2})):
    f = pt.Descriptor(lengths=[n], number_of_transforms=2).commit(device="cpu")
    e = fastpath.with_engine(f, f._raw_fast[pt.Direction.FORWARD], params)
    z = fastpath.build_fn(f, e)(torch.ones(4 * n))
    assert abs(z[0] - n) < 1e-2 and abs(z[2:2 * n]).max() < 1e-2
assert not any(m.split(".")[0] in ("jax", "portfft_tpu") for m in sys.modules)
print("ok")
"""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=root, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
    import re

    pkg = os.path.join(root, "portfft_tpu_torch")
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|portfft_tpu)(\s|\.|$)",
                     re.M)
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    assert not bad.search(fh.read()), f
