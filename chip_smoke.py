"""Smoke run of portfft_tpu_torch on one CUDA card.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit) and the torch and
   CUDA versions; exits non-zero when no CUDA device is available.
2. Builds the kernels from ``portfft_tpu_torch/csrc`` and prints the build
   time and the compiler's register report (on stderr).
3. Kernel phase: each C2C kernel (K1 direct, K2 fused2, K3 global2) at
   every plan shape of the bench rows and the ladder, and each REAL kernel
   (K8a untangle, K8b retangle, K9 small_real) at every shape of the REAL
   bench rows plus n = 1000 (h = 500), 4 and 100, forward and backward with
   scale != 1, held on the same inputs to
   - its plain PyTorch version: max|kernel - plain| <= 1e-5 · max|plain|;
   - ``torch.fft`` (``fft``/``ifft``, ``rfft``/``irfft``; oracle only) on a
     sample of rows: every element within the absolute
     2·eps·N·log2(N)·|scale|.  K8a's input is the C2C kernel's spectrum of
     the reals, and K8b's output goes through the backward C2C kernel
     before the comparison, so the oracle sees a whole R2C or C2R.
   Each case also plants two faults, the kernel run with one of its tables
   conjugated and an all-zero output, and fails unless both checks reject
   both.  The REAL kernels are timed alone here at the bench shapes.
   Then the multi-dim kernels the same way: K10 col at the (bpre, L, rest)
   views of ``MD_COL_CASES`` (oracle ``fft`` along L) and K11 md2 at the
   (batch, n1, n2) shapes of ``MD2_CASES`` (oracle ``fft2``), N being the
   transform's size; K10 timed alone at md_1024x1024's column pass and K11
   at md_512x512, beside their plain versions and one ``torch.fft`` call.
   Then the plane path's kernels: K6 (deinterleave and interleave with a
   scale) at the ``IO_CASES`` element counts against its plain version and
   the exact strided copy; K13 chain at ``CHAIN_CASES`` (DIRECT, [a, 128]
   in one and two launches, the general factor chain in one and two
   launches) and K15 bluestein at ``BLUESTEIN_CASES``, on planes, against
   their plain versions and ``fft``/``ifft``, with the same two planted
   faults (K6: a conjugated result; K13: its roots or inner twiddle
   conjugated; K15: its pass-1 chirp conjugated).  K6 and K15 are timed
   alone at large_1d_prime, K13 at the [24, 128] convolution of n = 1031
   and in its chain mode at n = 1000.
4. Main-path phases, C2C, REAL, multi-dim, then the plane path:
   ``Descriptor(...).commit(device="cuda")`` and
   ``compute_forward``/``compute_backward`` on a float32 tensor on the
   card, for the C2C bench rows, then for the four REAL bench rows and
   real_large backward, then for the three ``MULTIDIM_CONFIGS`` rows,
   md_1024x1024 backward and the BATCH_INTERLEAVED row bi_4096, then for
   ``PLANE_ROWS`` (large_1d_prime 65537x2048 both ways through K6, K15,
   K6; n = 1031, 1000 and 2062 at about 1 GiB through K6, K13 and the
   executor's glue, K6).  Each phase
   resets the launch counts just before and reads them just after; each
   row's kernels (for a REAL row, its K8 or K9 and the C2C kernel under it;
   for a multi-dim row, every kernel of its route) must have launched.  A
   sample of transforms is held to ``torch.fft`` at the absolute
   2·eps·N·log2(N) per element.  The kernel path, the plain path and one
   ``torch.fft`` call of the same function (the yardstick; the port never
   calls it) are timed with CUDA events (3 warm-up calls, median of 10).
5. Prints the kernel table as one JSON line (each kernel's launches on the
   main path, largest error against its plain version, ms, plain ms, bound
   ms and library ms), then, as the last line, ``{"ok": true, "device":
   {...}}``.  Any failure exits non-zero before that line.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import statistics
import subprocess
import sys
import time

import torch

EPS32 = float(torch.finfo(torch.float32).eps)
#: max|kernel - plain| <= KERNEL_TOL · max|plain|.  The largest ratio
#: measured on an H100 is under 3e-6; a wrong table or a lost tile gives O(1).
KERNEL_TOL = 1e-5

# Bench rows (bench.py CONFIGS, EXTRA_CONFIGS backward_medium, top of
# LADDER_CONFIGS): name, n, batch, direction.
ROWS = [
    ("small_1d", 16, 8 * 1024 * 1024, "forward"),
    ("medium_small_1d", 256, 512 * 1024, "forward"),
    ("medium_large_1d", 4096, 32 * 1024, "forward"),
    ("large_1d", 65536, 2048, "forward"),
    ("backward_medium", 4096, 32 * 1024, "backward"),
    ("ladder_2^20", 1 << 20, 128, "forward"),
]
# Kernel phase: (n, batch); the bench shapes, the whole ladder (2^17 and
# 2^18 run K3 with 512-point DIRECT subs, 2^19 and 2^20 with a FUSED
# [16, 128] sub) and other plan shapes (n = 100 odd DIRECT, 512 largest
# DIRECT, 32768 two-launch FUSED).
KERNEL_CASES = [
    (16, 8 * 1024 * 1024), (100, 1 << 17), (256, 512 * 1024), (512, 1 << 15),
    (4096, 32 * 1024), (32768, 1 << 10),
    (65536, 2048), (1 << 17, 1024), (1 << 18, 512), (1 << 19, 32),
    (1 << 20, 128),
]
# REAL bench rows (bench.py REAL_CONFIGS) and real_large backward: name,
# n, batch, direction.
REAL_ROWS = [
    ("real_small", 32, 2 * 1024 * 1024, "forward"),
    ("real_medium", 512, 256 * 1024, "forward"),
    ("real_large", 8192, 16 * 1024, "forward"),
    ("real_131072", 131072, 1024, "forward"),
    ("real_large_backward", 8192, 16 * 1024, "backward"),
]
# REAL kernel phase: (n, batch); the REAL bench shapes (K9 at 32 and 512,
# K8 at h = 4096 over K2 and h = 65536 over K3), h = 500 (K8 over K1, a
# half length that is no multiple of 128) and K9 at n = 4 and 100.
REAL_KERNEL_CASES = [
    (4, 1 << 16), (32, 2 * 1024 * 1024), (100, 1 << 15), (512, 256 * 1024),
    (1000, 1 << 12), (8192, 16 * 1024), (131072, 1024),
]
# Multi-dim rows (bench.py MULTIDIM_CONFIGS, md_1024x1024 backward) and the
# BATCH_INTERLEAVED row bi_4096 (strides [batch], distance 1): name, lengths,
# batch, direction, batch-interleaved.
MD_ROWS = [
    ("md_512x512", (512, 512), 256, "forward", False),
    ("md_1024x1024", (1024, 1024), 64, "forward", False),
    ("md_128^3", (128, 128, 128), 32, "forward", False),
    ("md_1024x1024_backward", (1024, 1024), 64, "backward", False),
    ("bi_4096", (4096,), 32768, "forward", True),
]
# Multi-dim kernel phase.  K10 at (bpre, L, rest): the column passes of
# md_1024x1024 (FUSED [8, 128]) and md_128^3 (DIRECT), bi_4096, an odd
# DIRECT length, the longest one-tile FUSED length and the two-launch
# [128, 128].  K11 at (batch, n1,
# n2): md_512x512, the trailing pair of md_128^3, and FUSED phases A and B.
MD_COL_CASES = [(64, 1024, 1024), (32, 128, 16384), (1, 4096, 32768),
                (4, 100, 4096), (1, 8192, 2048), (2, 16384, 512)]
MD2_CASES = [(256, 512, 512), (4096, 128, 128), (64, 1024, 128),
             (64, 128, 1024)]
# The cases timed alone: md_1024x1024's column pass and md_512x512.
MD_ALONE = {"col": (64, 1024, 1024), "md2": (256, 512, 512)}
# The transformed axes of each kernel's complex (b, ., .) view.
MD_DIMS = {"col": (1,), "md2": (1, 2)}
# Plane path rows (bench.py EXTRA_CONFIGS large_1d_prime, both directions,
# and one row per other route at about 1 GiB of input): name, n, batch,
# direction.  1031: generic Bluestein over K13 [24, 128]; 1000: K13's
# chain [125, 8]; 2062: GLOBAL 2 x Bluestein 1031.
PLANE_ROWS = [
    ("large_1d_prime", 65537, 2048, "forward"),
    ("large_1d_prime_backward", 65537, 2048, "backward"),
    ("bluestein_1031", 1031, 1 << 17, "forward"),
    ("chain_1000", 1000, 1 << 17, "forward"),
    ("global_2062", 2062, 1 << 16, "forward"),
]
# Plane kernel phase.  K6 at M complex elements (one M no multiple of 128,
# large_1d_prime's); K13 at (n, batch): DIRECT 3 and 100, [24, 128] and the
# two-launch [192, 128] (Bluestein convolutions), the chains [125, 8],
# [120, 5] and the two-launch [81, 81, 3]; K15 at (n, batch) over the
# convolutions 256 x 192, 384 x 384 and FUSED [16, 128] x 144.
IO_CASES = [1031 * 1000, 1 << 20, 65537 * 2048]
CHAIN_CASES = [(3, 1 << 20), (100, 1 << 17), (3072, 4096), (24576, 512),
               (1000, 8192), (600, 8192), (19683, 512)]
BLUESTEIN_CASES = [(20011, 512), (65537, 256), (131101, 64)]
# The shapes timed alone: K6 and K15 at large_1d_prime, K13 at the
# [24, 128] convolution of the bluestein_1031 row.
PLANE_ALONE = {"interleave": (65537 * 2048, 1), "chain": (3072, 1 << 17),
               "bluestein": (65537, 2048)}
# K13's general chain mode, timed alone beside the table's shape: the
# [125, 8] chain of the chain_1000 row.
CHAIN_MODE_ALONE = (1000, 1 << 17)
SOURCES = {
    "direct": ("portfft_tpu_torch/csrc/fft_direct.cu",
               "portfft_tpu/ops/pallas_fft.py:386"),
    "fused2": ("portfft_tpu_torch/csrc/fft_fused2.cu",
               "portfft_tpu/ops/pallas_fft.py:791"),
    "global2": ("portfft_tpu_torch/csrc/fft_global2.cu",
                "portfft_tpu/ops/pallas_global.py:1031"),
    "untangle": ("portfft_tpu_torch/csrc/fft_real.cu",
                 "portfft_tpu/ops/pallas_real.py:125"),
    "retangle": ("portfft_tpu_torch/csrc/fft_real.cu",
                 "portfft_tpu/ops/pallas_real.py:426"),
    "small_real": ("portfft_tpu_torch/csrc/fft_real.cu",
                   "portfft_tpu/ops/pallas_real.py:567"),
    "col": ("portfft_tpu_torch/csrc/fft_col.cu",
            "portfft_tpu/ops/pallas_multidim.py:264"),
    "md2": ("portfft_tpu_torch/csrc/fft_md2.cu",
            "portfft_tpu/ops/pallas_multidim.py:403"),
    "interleave": ("portfft_tpu_torch/csrc/fft_io.cu",
                   "portfft_tpu/ops/pallas_io.py:62"),
    "chain": ("portfft_tpu_torch/csrc/fft_chain.cu",
              "portfft_tpu/ops/pallas_fft.py:189"),
    "bluestein": ("portfft_tpu_torch/csrc/fft_bluestein.cu",
                  "portfft_tpu/ops/pallas_bluestein.py:177"),
}
C2C_KINDS = ("direct", "fused2", "global2")
REAL_KINDS = ("untangle", "retangle", "small_real")
MD_KINDS = ("col", "md2")
# K6 is one kernel of the table with two wrappers (deinterleave, interleave).
PLANE_KINDS = ("interleave", "chain", "bluestein")
# The bound's rates: NVIDIA H100 SXM data sheet (700 W), device memory and
# fp32 outside the tensor cores, per millisecond.
HBM_BYTES_PER_MS = 3.35e9
FP32_FLOPS_PER_MS = 67e9


class SmokeFailure(Exception):
    """A check of the smoke run failed."""


def oracle_tol(n: int) -> float:
    return 2.0 * EPS32 * n * max(math.log2(n), 1.0)


def work(kind: str, n: int, batch: int) -> tuple[int, float]:
    """(bytes, flops) of one call of a kernel or path over ``batch``
    transforms of size ``n`` (for the un/retangle, the REAL length 2h; for
    K11, n = n1·n2): each input byte read once, each output byte written
    once; flops the nominal 5·n·log2(n) of a complex transform,
    2.5·n·log2(n) of a real one, and 18 per bin for the un/retangle."""
    lg, h = max(math.log2(n), 1.0), n // 2
    if kind == "interleave":  # both K6 kernels, n the element count
        return 32 * batch * n, 2.0 * batch * n
    if kind in C2C_KINDS or kind in MD_KINDS or kind in PLANE_KINDS:
        return 16 * batch * n, 5 * n * lg * batch
    if kind in ("untangle", "retangle"):
        return 8 * batch * h + 8 * batch * (h + 1), 18.0 * batch * h
    return 4 * batch * n + 8 * batch * (h + 1), 2.5 * n * lg * batch


def bound_of(kind: str, n: int, batch: int) -> tuple[float, str]:
    """``(bound_ms, bound_by)``: the least time the card could take for the
    work, the larger of its bytes over the memory rate and its flops over
    the fp32 peak, and which of the two it is."""
    nbytes, flops = work(kind, n, batch)
    by_bytes, by_flops = nbytes / HBM_BYTES_PER_MS, flops / FP32_FLOPS_PER_MS
    return max(by_bytes, by_flops), "bytes" if by_bytes >= by_flops else "operations"


def time_ms(fn, iters: int = 10, warmup: int = 3) -> float:
    """Median device time of one call, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_and_args(plan, direction):
    """(kind, kernel wrapper, its arguments after the raw buffer) of a
    committed plan's direction."""
    from portfft_tpu_torch import fastpath

    entry = plan._raw_fast[direction]
    kernel, args = fastpath.kernel_args(plan, entry)
    return entry[0], kernel, args


def random_raw(numel: int, seed: int, device: str = "cuda") -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.rand(numel, generator=gen, device=device) * 2 - 1


def sample_rows(batch: int) -> list[int]:
    return sorted({0, min(1, batch - 1), batch // 2, batch - 1})


def oracle_excess(y, x, n: int, batch: int, sign: int, scale: float) -> float:
    """Largest |y - ref| over a sample of rows, in units of the absolute
    bound 2·eps·N·log2(N)·|scale|; ref is ``torch.fft`` in complex128 (the
    oracle only).  At most 1 passes."""
    return nd_oracle_excess(y, x, (batch, n), (1,), sign, scale)


def nd_oracle_excess(y, x, shape, dims, sign: int, scale: float) -> float:
    """``oracle_excess`` of the transform over ``dims`` of the complex
    ``shape`` view of ``x`` and ``y``, on a sample of the first index; N is
    the transform's size.  ref is ``torch.fft.fftn``/``ifftn`` in
    complex128 (the oracle only)."""
    rows = sample_rows(shape[0])

    def pick(t):
        return torch.view_as_complex(t.view(*shape, 2)[rows]).to(torch.complex128)

    xs = pick(x)
    ref = (torch.fft.fftn(xs, dim=dims) if sign < 0
           else torch.fft.ifftn(xs, dim=dims, norm="forward")) * scale
    n = math.prod(shape[d] for d in dims)
    return (pick(y) - ref).abs().max().item() / (oracle_tol(n) * abs(scale))


def real_oracle_excess(y, src, n: int, batch: int, sign: int,
                       scale: float) -> float:
    """``oracle_excess`` of a REAL transform: forward, ``y`` holds the
    interleaved half spectra of the reals ``src``; backward, ``y`` holds the
    reals of the half spectra ``src`` (unnormalized).  ref is
    ``torch.fft.rfft``/``irfft`` in complex128 (the oracle only)."""
    rows, h = sample_rows(batch), n // 2
    if sign < 0:
        ref = torch.fft.rfft(src.view(batch, n)[rows].double()) * scale
        got = torch.view_as_complex(y.view(batch, h + 1, 2)[rows])
    else:
        spec = torch.view_as_complex(src.view(batch, h + 1, 2)[rows])
        ref = torch.fft.irfft(spec.to(torch.complex128), n, norm="forward") * scale
        got = y.view(batch, n)[rows]
    return (got.to(ref.dtype) - ref).abs().max().item() / (oracle_tol(n) * abs(scale))


def half_spectra(batch: int, n: int, seed: int, device: str = "cuda") -> torch.Tensor:
    """Random half spectra of real signals (Im X[0] = Im X[n/2] = 0) as raw
    float32 pairs."""
    raw = random_raw(batch * (n + 2), seed, device)
    bins = raw.view(batch, n // 2 + 1, 2)
    bins[:, 0, 1] = 0.0
    bins[:, -1, 1] = 0.0
    return raw


def conjugated(sub):
    """Sub-tables with the roots (DIRECT) or the inner twiddle (FUSED)
    conjugated."""
    field = "ui" if sub.a else "wi"
    return dataclasses.replace(sub, **{field: -getattr(sub, field)})


def planted(kind: str, args: tuple) -> tuple:
    """A kernel's arguments with one table conjugated: the roots (K1, K9,
    a DIRECT K10 or K11 axis), the inner twiddle (K2, a FUSED K10 or K11
    axis; K11's second axis), the inter-pass twiddle (K3) or the REAL
    post-twiddle (K8).  K9's plain version reads the matrix, whose
    conjugate negates the imaginary outputs (forward) or inputs
    (backward)."""
    if kind in ("untangle", "retangle"):
        batch, h, wr, wi, scale = args
        return (batch, h, wr, -wi, scale)
    if kind == "small_real":
        batch, tabs = args
        mat = tabs.mat.clone()
        (mat[:, 1::2] if tabs.sign < 0 else mat[1::2]).neg_()
        return (batch, dataclasses.replace(tabs, wi=-tabs.wi, mat=mat))
    if kind == "global2":
        batch, sub1, sub2, tr, ti, scale = args
        return (batch, sub1, sub2, tr, -ti, scale)
    if kind == "col":
        bpre, rest, sub, scale = args
        return (bpre, rest, conjugated(sub), scale)
    if kind == "md2":
        batch, sub1, sub2, scale = args
        return (batch, sub1, conjugated(sub2), scale)
    if kind == "chain":  # the first stage's roots, or as K1/K2
        (tabs,) = args
        if tabs.mode != "chain":
            return (dataclasses.replace(tabs, sub=conjugated(tabs.sub)),)
        (wr, wi, tr, ti), *rest = tabs.stages
        return (dataclasses.replace(tabs, stages=((wr, -wi, tr, ti), *rest)),)
    if kind == "bluestein":  # the pass-1 chirp
        (tabs,) = args
        return (dataclasses.replace(tabs, pre=(tabs.pre[0], -tabs.pre[1])),)
    batch, sub, scale = args
    return (batch, conjugated(sub), scale)


def check_kernel(kind: str, kernel, args: tuple, x, n: int, sign: int) -> dict:
    """Hold one call of a C2C ``kernel`` to its plain version and to the
    oracle, and check that both checks reject two planted faults.  Returns
    the measured numbers; raises :class:`SmokeFailure`."""
    batch, scale = args[0], args[-1]
    return check_against(
        f"{kind} n={n} sign={sign:+d}", kind, kernel, args, x,
        lambda y: oracle_excess(y, x, n, batch, sign, scale),
    )


def real_case(plan, direction, x, spec) -> tuple:
    """``(kind, kernel, args, input, finish)`` of the REAL kernel of one
    direction of ``plan``, given the reals ``x`` and the half spectra
    ``spec``: K9 takes them as they are; K8a takes the spectrum the C2C
    kernel makes of ``x``; K8b's output goes through the backward C2C
    kernel (``finish``) to become the reals."""
    from portfft_tpu_torch import fastpath

    entry = plan._raw_fast[direction]
    kernel, args = fastpath.kernel_args(plan, entry)
    forward = entry[0] in ("realf", "realsf")
    if entry[0] in ("realsf", "realsb"):
        return "small_real", kernel, args, x if forward else spec, None
    c2c, c2c_args = fastpath.kernel_args(plan, entry[1])
    if forward:
        return "untangle", kernel, args, c2c(x, *c2c_args), None
    return "retangle", kernel, args, spec, lambda z: c2c(z, *c2c_args)


def check_real(kind: str, kernel, args: tuple, inp, finish, src, n: int,
               sign: int, scale: float) -> dict:
    """``check_kernel`` for a REAL kernel: ``inp`` is its input, ``finish``
    (or None) turns its output into the transform's, and ``src`` is the
    transform's input for the oracle."""
    batch = args[0]
    finish = finish or (lambda y: y)
    return check_against(
        f"{kind} n={n} sign={sign:+d}", kind, kernel, args, inp,
        lambda y: real_oracle_excess(finish(y), src, n, batch, sign, scale),
    )


def check_against(what: str, kind: str, kernel, args: tuple, x, oracle) -> dict:
    """Hold one call of ``kernel`` on ``x`` to its plain version and, through
    ``oracle`` (output -> multiples of the oracle bound), to the oracle;
    check that both checks reject two planted faults."""
    got = kernel(x, *args)
    want = kernel.plain(x, *args)
    peak = want.abs().max().item()

    def judged(y):
        err = (y - want).abs().max().item()
        return err, err / peak, oracle(y)

    if not torch.isfinite(got).all():
        raise SmokeFailure(f"{what}: non-finite output")
    err, rel, excess = judged(got)
    if not rel <= KERNEL_TOL:
        raise SmokeFailure(f"{what}: max|kernel - plain| = {rel:.3e}·max|plain| "
                           f"> {KERNEL_TOL:g}·max|plain|")
    if not excess <= 1.0:
        raise SmokeFailure(f"{what}: {excess:.3e} times the oracle bound")
    faults = {"conjugated table": kernel(x, *planted(kind, args)),
              "zeros": torch.zeros_like(got)}
    caught = {}
    for name, y in faults.items():
        _, f_rel, f_excess = judged(y)
        if f_rel <= KERNEL_TOL or f_excess <= 1.0:
            raise SmokeFailure(
                f"{what}: planted fault ({name}) passed a check: "
                f"{f_rel:.3e}·max|plain|, {f_excess:.3e} times the oracle bound")
        caught[name] = (f_rel, f_excess)
    return {"err": err, "rel": rel, "excess": excess, "caught": caught}


def plain_path(plan, entry):
    """The plain versions of an entry's kernels, chained as the path chains
    the kernels: ``fn(x) -> y``."""
    from portfft_tpu_torch import fastpath

    if entry[0] == "plane":
        return fastpath.plane_fn(plan, entry, plain=True)
    if entry[0] == "multidim":
        steps = [fastpath.kernel_args(plan, s) for s in entry[2]]

        def chain(x):
            for kernel, args in steps:
                x = kernel.plain(x, *args)
            return x

        return chain
    kernel, args = fastpath.kernel_args(plan, entry)
    if entry[0] in ("realf", "realb"):
        c2c, c2c_args = fastpath.kernel_args(plan, entry[1])
        if entry[0] == "realf":
            return lambda x: kernel.plain(c2c.plain(x, *c2c_args), *args)
        return lambda x: c2c.plain(kernel.plain(x, *args), *c2c_args)
    return lambda x: kernel.plain(x, *args)


def library_call(x, n: int, batch: int, real: bool, forward: bool):
    """One ``torch.fft`` call that computes the same function as the path
    (unnormalized backward, scale 1): the yardstick, timed only."""
    if real and forward:
        return lambda: torch.fft.rfft(x.view(batch, n))
    if real:
        spec = torch.view_as_complex(x.view(batch, n // 2 + 1, 2))
        return lambda: torch.fft.irfft(spec, n, norm="forward")
    xc = torch.view_as_complex(x.view(batch, n, 2))
    if forward:
        return lambda: torch.fft.fft(xc)
    return lambda: torch.fft.ifft(xc, norm="forward")


def c2c_kernel_phase(pf, max_err: dict) -> None:
    for n, batch in KERNEL_CASES:
        desc = pf.Descriptor(lengths=[n], number_of_transforms=batch,
                             forward_scale=0.5, backward_scale=2.0 / n)
        plan = desc.commit(device="cuda")
        x = random_raw(2 * batch * n, seed=n)
        for direction, sign in ((pf.Direction.FORWARD, -1),
                                (pf.Direction.BACKWARD, +1)):
            kind, kernel, args = kernel_and_args(plan, direction)
            before = kernel.launches
            r = check_kernel(kind, kernel, args, x, n, sign)
            torch.cuda.synchronize()
            if kernel.launches != before + 2:  # the call and the planted fault
                raise SmokeFailure(f"{kind} n={n}: launch counter did not rise")
            report(kind, f"n={n:<8d} batch={batch:<8d} {direction.value:8s}", r)
            max_err[kind] = max(max_err.get(kind, 0.0), r["err"])
        del plan, x
        torch.cuda.empty_cache()


def report(kind: str, where: str, r: dict) -> None:
    caught = " ".join(f"{name}: {rel:.2e}·max|plain|, {exc:.2e}×oracle;"
                      for name, (rel, exc) in r["caught"].items())
    print(f"kernel {kind:10s} {where} max|k-plain|={r['err']:.3e} "
          f"={r['rel']:.2e}·max|plain| (tol {KERNEL_TOL:g}) "
          f"oracle {r['excess']:.2e}×bound | planted faults rejected: "
          f"{caught}")


def real_kernel_phase(pf, max_err: dict, card: str) -> dict:
    """Checks K8a, K8b and K9 at ``REAL_KERNEL_CASES``; returns
    ``{(kind, n, batch): (ms, plain_ms)}`` of each timed alone at the REAL
    bench shapes."""
    bench = {(n, batch) for _, n, batch, _ in REAL_ROWS}
    alone = {}
    for n, batch in REAL_KERNEL_CASES:
        scales = {pf.Direction.FORWARD: 0.5, pf.Direction.BACKWARD: 2.0 / n}
        plan = pf.Descriptor(
            lengths=[n], number_of_transforms=batch, domain=pf.Domain.REAL,
            forward_scale=scales[pf.Direction.FORWARD],
            backward_scale=scales[pf.Direction.BACKWARD],
        ).commit(device="cuda")
        x = random_raw(batch * n, seed=n)
        spec = half_spectra(batch, n, seed=n + 1)
        for direction, sign in ((pf.Direction.FORWARD, -1),
                                (pf.Direction.BACKWARD, +1)):
            kind, kernel, args, inp, finish = real_case(plan, direction, x, spec)
            before = kernel.launches
            r = check_real(kind, kernel, args, inp, finish,
                           x if sign < 0 else spec, n, sign, scales[direction])
            torch.cuda.synchronize()
            if kernel.launches != before + 2:  # the call and the planted fault
                raise SmokeFailure(f"{kind} n={n}: launch counter did not rise")
            report(kind, f"n={n:<8d} batch={batch:<8d} {direction.value:8s}", r)
            max_err[kind] = max(max_err.get(kind, 0.0), r["err"])
            if (n, batch) in bench:
                ms = time_ms(lambda: kernel(inp, *args))
                plain_ms = time_ms(lambda: kernel.plain(inp, *args))
                bound, by = bound_of(kind, n, batch)
                alone[(kind, n, batch)] = (ms, plain_ms)
                print(f"alone  {kind:10s} n={n:<8d} batch={batch:<8d} "
                      f"{direction.value:8s} kernel {ms:.3f} ms | plain "
                      f"{plain_ms:.3f} ms | bound {bound:.3f} ms ({by}) | {card}")
            del inp
        del plan, x, spec
        torch.cuda.empty_cache()
    return alone


def c2c_main_path(pf, counters: dict, card: str) -> tuple[list, dict]:
    results = []
    for c in counters.values():
        c.launches = 0
    for name, n, batch, dname in ROWS:
        direction = pf.Direction(dname)
        forward = direction == pf.Direction.FORWARD
        sign = -1 if forward else +1
        plan = pf.Descriptor(lengths=[n], number_of_transforms=batch).commit(
            device="cuda"
        )
        kind, kernel, args = kernel_and_args(plan, direction)
        before = counters[kind].launches
        x = random_raw(2 * batch * n, seed=0)
        compute = plan.compute_forward if forward else plan.compute_backward
        y = compute(x)
        torch.cuda.synchronize()
        rose = counters[kind].launches - before
        if rose <= 0:
            raise SmokeFailure(f"{name}: the {kind} kernel was not launched")
        if y.shape != x.shape or not torch.isfinite(y).all():
            raise SmokeFailure(f"{name}: output of shape {tuple(y.shape)} "
                               "or not finite")
        excess = oracle_excess(y, x, n, batch, sign, 1.0)
        if not excess <= 1.0:
            raise SmokeFailure(f"{name}: {excess:.3e} times the oracle bound "
                               f"{oracle_tol(n):.3e}")
        del y
        ms = time_ms(lambda: compute(x))
        plain_ms = time_ms(functools.partial(
            plain_path(plan, plan._raw_fast[direction]), x))
        library_ms = time_ms(library_call(x, n, batch, False, forward))
        nbytes, flops = work(kind, n, batch)
        bound, by = bound_of(kind, n, batch)
        print(f"row {name:16s} n={n:<8d} batch={batch:<8d} {kind:8s} "
              f"launches +{rose} oracle max|diff|={excess * oracle_tol(n):.3e} "
              f"tol={oracle_tol(n):.3e} | "
              f"kernel {ms:.3f} ms {nbytes / ms / 1e6:.1f} GB/s "
              f"{flops / ms / 1e6:.1f} GFLOP/s | plain {plain_ms:.3f} ms "
              f"{nbytes / plain_ms / 1e6:.1f} GB/s "
              f"{flops / plain_ms / 1e6:.1f} GFLOP/s | torch.fft {library_ms:.3f} ms "
              f"| bound {bound:.3f} ms ({by}) | {card}")
        results.append((name, kind, n, batch, ms, plain_ms, library_ms))
        del plan, x
        torch.cuda.empty_cache()
    launches = {k: counters[k].launches for k in C2C_KINDS}
    print(f"main-path launches: {launches}")
    for kind, count in launches.items():
        if count == 0:
            raise SmokeFailure(f"kernel {kind} was never launched on the main path")
    return results, launches


REAL_KIND_OF = {"realsf": "small_real", "realsb": "small_real",
                "realf": "untangle", "realb": "retangle"}


def real_main_path(pf, counters: dict, card: str) -> tuple[list, dict]:
    results = []
    for c in counters.values():
        c.launches = 0
    for name, n, batch, dname in REAL_ROWS:
        direction = pf.Direction(dname)
        forward = direction == pf.Direction.FORWARD
        sign = -1 if forward else +1
        plan = pf.Descriptor(lengths=[n], number_of_transforms=batch,
                             domain=pf.Domain.REAL).commit(device="cuda")
        entry = plan._raw_fast[direction]
        kinds = [REAL_KIND_OF[entry[0]]]
        if entry[0] in ("realf", "realb"):
            kinds.append(entry[1][0])  # the C2C kernel under it
        x = random_raw(batch * n, seed=0) if forward else half_spectra(batch, n, 0)
        compute = plan.compute_forward if forward else plan.compute_backward
        before = {k: counters[k].launches for k in kinds}
        y = compute(x)
        torch.cuda.synchronize()
        rose = {k: counters[k].launches - before[k] for k in kinds}
        if min(rose.values()) <= 0:
            raise SmokeFailure(f"{name}: a kernel of the path was not launched: {rose}")
        numel = batch * (n + 2) if forward else batch * n
        if y.shape != (numel,) or not torch.isfinite(y).all():
            raise SmokeFailure(f"{name}: output of shape {tuple(y.shape)} "
                               f"(expected ({numel},)) or not finite")
        excess = real_oracle_excess(y, x, n, batch, sign, 1.0)
        if not excess <= 1.0:
            raise SmokeFailure(f"{name}: {excess:.3e} times the oracle bound "
                               f"{oracle_tol(n):.3e}")
        del y
        ms = time_ms(lambda: compute(x))
        plain_ms = time_ms(functools.partial(plain_path(plan, entry), x))
        library_ms = time_ms(library_call(x, n, batch, True, forward))
        nbytes, _ = work("small_real", n, batch)  # the same bytes for every REAL path
        bound, by = bound_of("small_real", n, batch)
        print(f"row {name:20s} n={n:<8d} batch={batch:<8d} "
              f"{'+'.join(kinds):18s} launches {rose} oracle max|diff|="
              f"{excess * oracle_tol(n):.3e} tol={oracle_tol(n):.3e} | path "
              f"{ms:.3f} ms {nbytes / ms / 1e6:.1f} GB/s | plain {plain_ms:.3f} ms "
              f"| torch.fft {library_ms:.3f} ms | bound {bound:.3f} ms ({by}) "
              f"| {card}")
        results.append((name, kinds, n, batch, ms, plain_ms, library_ms))
        del plan, x
        torch.cuda.empty_cache()
    launches = {k: c.launches for k, c in counters.items()}
    print(f"REAL main-path launches: {launches}")
    for kind in REAL_KINDS:
        if launches[kind] == 0:
            raise SmokeFailure(f"kernel {kind} was never launched on the REAL path")
    return results, launches


def sub_tables_of(pf, n: int, sign: int, device: str = "cuda"):
    """The device tables of the length-``n`` plan for one direction, from a
    1D commit of that length."""
    from portfft_tpu_torch.ops import cuda_fft

    plan = pf.Descriptor(lengths=[n]).commit(device=device)
    return cuda_fft.sub_tables(plan.plans[n], sign, plan._bank_keys,
                               plan._bank_arrays)


def md_kernel_case(pf, kind: str, shape: tuple, sign: int, scale: float,
                   device: str = "cuda") -> tuple:
    """``(kernel, args)`` of a K10 case, ``shape`` = (bpre, L, rest), or a
    K11 case, (batch, n1, n2)."""
    from portfft_tpu_torch.ops import cuda_multidim

    if kind == "col":
        bpre, length, rest = shape
        sub = sub_tables_of(pf, length, sign, device)
        return cuda_multidim.col, (bpre, rest, sub, scale)
    batch, n1, n2 = shape
    return cuda_multidim.md2, (batch, sub_tables_of(pf, n1, sign, device),
                               sub_tables_of(pf, n2, sign, device), scale)


def check_md(kind: str, kernel, args: tuple, x, shape: tuple, sign: int) -> dict:
    """``check_kernel`` for K10 or K11 on the complex ``shape`` view."""
    return check_against(
        f"{kind} {shape} sign={sign:+d}", kind, kernel, args, x,
        lambda y: nd_oracle_excess(y, x, shape, MD_DIMS[kind], sign, args[-1]),
    )


def fftn_call(x, shape: tuple, dims: tuple, forward: bool):
    """One ``torch.fft`` call of the unscaled transform over ``dims`` of the
    complex ``shape`` view of ``x`` (the yardstick, timed only)."""
    xc = torch.view_as_complex(x.view(*shape, 2))
    if forward:
        return lambda: torch.fft.fftn(xc, dim=dims)
    return lambda: torch.fft.ifftn(xc, dim=dims, norm="forward")


def md_kernel_phase(pf, max_err: dict, card: str) -> dict:
    """Checks K10 at ``MD_COL_CASES`` and K11 at ``MD2_CASES``, forward
    (scale 0.5) and backward (scale 2/N); returns ``{kind: (ms, plain_ms,
    library_ms)}`` of each timed alone forward at its ``MD_ALONE`` shape."""
    alone = {}
    cases = [("col", s) for s in MD_COL_CASES] + [("md2", s) for s in MD2_CASES]
    for kind, shape in cases:
        x = random_raw(2 * math.prod(shape), seed=sum(shape))
        dims = MD_DIMS[kind]
        n = math.prod(shape[d] for d in dims)  # the transform's size
        for sign in (-1, +1):
            scale = 0.5 if sign < 0 else 2.0 / n
            kernel, args = md_kernel_case(pf, kind, shape, sign, scale)
            before = kernel.launches
            r = check_md(kind, kernel, args, x, shape, sign)
            torch.cuda.synchronize()
            if kernel.launches != before + 2:  # the call and the planted fault
                raise SmokeFailure(f"{kind} {shape}: launch counter did not rise")
            report(kind, f"{str(shape):18s} sign={sign:+d}", r)
            max_err[kind] = max(max_err.get(kind, 0.0), r["err"])
            if sign < 0 and MD_ALONE[kind] == shape:
                ms = time_ms(lambda: kernel(x, *args))
                plain_ms = time_ms(lambda: kernel.plain(x, *args))
                library_ms = time_ms(fftn_call(x, shape, dims, True))
                bound, by = bound_of(kind, n, math.prod(shape) // n)
                alone[kind] = (ms, plain_ms, library_ms)
                print(f"alone  {kind:10s} {str(shape):18s} kernel {ms:.3f} ms | "
                      f"plain {plain_ms:.3f} ms | torch.fft {library_ms:.3f} ms | "
                      f"bound {bound:.3f} ms ({by}) | {card}")
            del kernel, args
        del x
        torch.cuda.empty_cache()
    return alone


def md_main_path(pf, counters: dict, card: str) -> tuple[list, dict]:
    """The multi-dim and BATCH_INTERLEAVED rows through the committed
    plan; every kernel of each row's route must launch."""
    results = []
    for c in counters.values():
        c.launches = 0
    for name, lengths, batch, dname, bi in MD_ROWS:
        direction = pf.Direction(dname)
        forward = direction == pf.Direction.FORWARD
        sign = -1 if forward else +1
        kw = dict(forward_strides=[batch], backward_strides=[batch],
                  forward_distance=1, backward_distance=1) if bi else {}
        plan = pf.Descriptor(lengths=list(lengths), number_of_transforms=batch,
                             **kw).commit(device="cuda")
        entry = plan._raw_fast[direction]
        steps = entry[2] if entry[0] == "multidim" else (entry,)
        kinds = ["col" if s[0] in ("col", "bi_col") else s[0] for s in steps]
        n = math.prod(lengths)
        x = random_raw(2 * batch * n, seed=0)
        compute = plan.compute_forward if forward else plan.compute_backward
        before = {k: counters[k].launches for k in kinds}
        y = compute(x)
        torch.cuda.synchronize()
        rose = {k: counters[k].launches - before[k] for k in kinds}
        if min(rose.values()) <= 0:
            raise SmokeFailure(f"{name}: a kernel of the path was not launched: {rose}")
        if y.shape != x.shape or not torch.isfinite(y).all():
            raise SmokeFailure(f"{name}: output of shape {tuple(y.shape)} "
                               "or not finite")
        # BATCH_INTERLEAVED: one transform down each column of (n, batch)
        shape = (1, n, batch) if bi else (batch, *lengths)
        dims = (1,) if bi else tuple(range(1, len(shape)))
        excess = nd_oracle_excess(y, x, shape, dims, sign, 1.0)
        if not excess <= 1.0:
            raise SmokeFailure(f"{name}: {excess:.3e} times the oracle bound "
                               f"{oracle_tol(n):.3e}")
        del y
        ms = time_ms(lambda: compute(x))
        plain_ms = time_ms(functools.partial(plain_path(plan, entry), x))
        library_ms = time_ms(fftn_call(x, shape, dims, forward))
        nbytes, flops = work("md2", n, batch)
        bound, by = bound_of("md2", n, batch)
        print(f"row {name:22s} {'x'.join(map(str, lengths)):12s} batch={batch:<6d} "
              f"{'+'.join(kinds):12s} launches {rose} oracle max|diff|="
              f"{excess * oracle_tol(n):.3e} tol={oracle_tol(n):.3e} | path "
              f"{ms:.3f} ms {nbytes / ms / 1e6:.1f} GB/s | plain {plain_ms:.3f} ms "
              f"| torch.fft {library_ms:.3f} ms | bound {bound:.3f} ms ({by}), "
              f"{len(kinds)} pass floor {len(kinds) * nbytes / HBM_BYTES_PER_MS:.3f} ms "
              f"| {card}")
        results.append((name, kinds, n, batch, ms, plain_ms, library_ms))
        del plan, x
        torch.cuda.empty_cache()
    launches = {k: c.launches for k, c in counters.items()}
    print(f"multi-dim main-path launches: {launches}")
    for kind in MD_KINDS:
        if launches[kind] == 0:
            raise SmokeFailure(f"kernel {kind} was never launched on the multi-dim path")
    return results, launches


def on_raw(kernel, n: int):
    """A plane kernel (K13, K15) as a function of the raw interleaved
    buffer of rows of ``n``, with its plain version, for
    :func:`check_against`."""
    def over(k):
        def fn(x, *args):
            xr, xi = x.view(-1, n, 2).unbind(-1)
            yr, yi = k(xr.contiguous(), xi.contiguous(), *args)
            return torch.stack((yr, yi), dim=-1).reshape(-1)
        return fn

    fn = over(kernel)
    fn.plain = over(kernel.plain)
    return fn


def plane_case(pf, kind: str, n: int, sign: int, device: str = "cuda"):
    """``(kernel, args)`` of a K13 (``kind`` "chain") or K15 case: the
    length-n plan's tables for one direction, from a 1D commit."""
    from portfft_tpu_torch.ops import cuda_bluestein, cuda_chain

    plan = pf.Descriptor(lengths=[n]).commit(device=device)
    keys, arrays = plan._bank_keys, plan._bank_arrays
    if kind == "chain":
        return cuda_chain.chain, (
            cuda_chain.chain_tables(plan.plans[n], sign, keys, arrays),)
    return cuda_bluestein.bluestein, (
        cuda_bluestein.bluestein_tables(plan.plans[n], sign, keys, arrays),)


def check_plane(kind: str, kernel, args: tuple, x, n: int, batch: int,
                sign: int) -> dict:
    """``check_kernel`` for K13 or K15 on rows of ``n``."""
    return check_against(
        f"{kind} n={n} sign={sign:+d}", kind, on_raw(kernel, n), args, x,
        lambda y: oracle_excess(y, x, n, batch, sign, 1.0),
    )


def check_io(m: int, x, scale: float) -> dict:
    """K6 on ``m`` elements: the deinterleave against its plain version and
    against the strided views of ``x``, the interleave of its planes (times
    ``scale``) against its plain version and ``x·scale``; every check must
    reject two planted faults, a conjugated result and zeros.  The
    largest relative error of the two kernels is returned as ``rel`` and
    their largest absolute error as ``err``."""
    from portfft_tpu_torch.ops import cuda_io

    pairs = x.view(m, 2)
    re, im = cuda_io.deinterleave(x)
    want_re, want_im = cuda_io.deinterleave.plain(x)
    y = cuda_io.interleave(re, im, scale)
    want_y = cuda_io.interleave.plain(want_re, want_im, scale)
    exact = (torch.cat((pairs[:, 0], pairs[:, 1])), x * scale)
    got = (torch.cat((re, im)), y)
    plain = (torch.cat((want_re, want_im)), want_y)
    faults = {"conjugated": (torch.cat((re, -im)), torch.stack(
        (pairs[:, 0], -pairs[:, 1]), dim=-1).reshape(-1) * scale)}
    faults["zeros"] = tuple(torch.zeros_like(g) for g in got)
    r = {"err": 0.0, "rel": 0.0, "excess": 0.0, "caught": {}}
    for i, what in enumerate(("deinterleave", "interleave")):
        peak = plain[i].abs().max().item()
        err = (got[i] - plain[i]).abs().max().item()
        excess = (got[i] - exact[i]).abs().max().item() / peak
        if not err <= KERNEL_TOL * peak or excess > 0.0:
            raise SmokeFailure(f"{what} m={m}: max|kernel - plain| = {err:.3e}, "
                               f"max|kernel - exact| = {excess:.3e}·max")
        for name, fault in faults.items():
            f_rel = (fault[i] - plain[i]).abs().max().item() / peak
            f_exc = (fault[i] - exact[i]).abs().max().item() / peak
            if f_rel <= KERNEL_TOL or f_exc <= KERNEL_TOL:
                raise SmokeFailure(f"{what} m={m}: planted fault ({name}) passed")
            r["caught"][f"{what} {name}"] = (f_rel, f_exc)
        r["err"], r["rel"] = max(r["err"], err), max(r["rel"], err / peak)
    return r


def io_library_calls(x, re, im) -> tuple:
    """K6's one-call PyTorch counterparts, at scale 1 (neither folds a
    scale in): the deinterleave of ``x`` as one copy of its transposed
    (m, 2) view, which writes the re plane and then the im plane, and the
    interleave of ``re``, ``im`` as ``torch.complex``."""
    m = x.numel() // 2
    return (lambda: x.view(m, 2).t().contiguous(),
            lambda: torch.complex(re, im))


def plane_kernel_phase(pf, max_err: dict, card: str) -> dict:
    """Checks K6 at ``IO_CASES``, K13 at ``CHAIN_CASES`` and K15 at
    ``BLUESTEIN_CASES`` (both directions); returns ``{kind: (ms, plain_ms,
    library_ms)}`` of each timed alone at its ``PLANE_ALONE`` shape."""
    from portfft_tpu_torch.ops import cuda_bluestein, cuda_chain, cuda_io

    alone = {}
    for m in IO_CASES:
        x = random_raw(2 * m, seed=m)
        before = cuda_io.deinterleave.launches + cuda_io.interleave.launches
        r = check_io(m, x, 0.5)
        if cuda_io.deinterleave.launches + cuda_io.interleave.launches != before + 2:
            raise SmokeFailure(f"interleave m={m}: launch counters did not rise")
        print(f"kernel interleave  m={m:<10d} max|k-plain|={r['err']:.3e} "
              f"={r['rel']:.2e}·max|plain| (tol {KERNEL_TOL:g}), exact | planted "
              f"faults rejected: {sorted(r['caught'])}")
        max_err["interleave"] = max(max_err.get("interleave", 0.0), r["err"])
        if (m, 1) == PLANE_ALONE["interleave"]:
            re, im = cuda_io.deinterleave(x)
            ms = (time_ms(lambda: cuda_io.deinterleave(x))
                  + time_ms(lambda: cuda_io.interleave(re, im, 0.5)))
            plain_ms = (time_ms(lambda: cuda_io.deinterleave.plain(x))
                        + time_ms(lambda: cuda_io.interleave.plain(re, im, 0.5)))
            library_ms = sum(time_ms(f) for f in io_library_calls(x, re, im))
            bound, by = bound_of("interleave", m, 1)
            alone["interleave"] = (ms, plain_ms, library_ms)
            print(f"alone  interleave  m={m:<10d} deinterleave + interleave "
                  f"{ms:.3f} ms | plain {plain_ms:.3f} ms | library (scale 1) "
                  f"{library_ms:.3f} ms | bound {bound:.3f} ms ({by}) | {card}")
            del re, im
        del x
        torch.cuda.empty_cache()
    cases = ([("chain", c) for c in CHAIN_CASES]
             + [("bluestein", c) for c in BLUESTEIN_CASES])
    for kind, (n, batch) in cases:
        x = random_raw(2 * batch * n, seed=n)
        for sign in (-1, +1):
            kernel, args = plane_case(pf, kind, n, sign)
            before = kernel.launches
            r = check_plane(kind, kernel, args, x, n, batch, sign)
            torch.cuda.synchronize()
            if kernel.launches != before + 2:  # the call and the planted fault
                raise SmokeFailure(f"{kind} n={n}: launch counter did not rise")
            mode = args[0].mode if kind == "chain" else (
                f"{args[0].g1}x{args[0].g2}")
            report(kind, f"n={n:<8d} batch={batch:<8d} {mode:9s} sign={sign:+d}", r)
            max_err[kind] = max(max_err.get(kind, 0.0), r["err"])
        del x
        torch.cuda.empty_cache()
    for kind, (n, batch) in (("chain", PLANE_ALONE["chain"]),
                             ("chain", CHAIN_MODE_ALONE),
                             ("bluestein", PLANE_ALONE["bluestein"])):
        kernel, args = plane_case(pf, kind, n, -1)
        xr, xi = random_raw(2 * batch * n, seed=1).view(batch, n, 2).unbind(-1)
        xr, xi = xr.contiguous(), xi.contiguous()
        xc = torch.complex(xr, xi)
        ms = time_ms(lambda: kernel(xr, xi, *args))
        plain_ms = time_ms(lambda: kernel.plain(xr, xi, *args))
        library_ms = time_ms(lambda: torch.fft.fft(xc))
        bound, by = bound_of(kind, n, batch)
        if (n, batch) == PLANE_ALONE[kind]:
            alone[kind] = (ms, plain_ms, library_ms)
        print(f"alone  {kind:10s} n={n:<8d} batch={batch:<8d} kernel {ms:.3f} ms "
              f"| plain {plain_ms:.3f} ms | torch.fft {library_ms:.3f} ms | "
              f"bound {bound:.3f} ms ({by}) | {card}")
        del xr, xi, xc, kernel, args
        torch.cuda.empty_cache()
    return alone


def plane_main_path(pf, counters: dict, card: str) -> tuple[list, dict]:
    """The ``PLANE_ROWS`` through the committed plan: K6 around the
    executor and every K13 or K15 kernel of each row's route must
    launch."""
    results = []
    for c in counters.values():
        c.launches = 0
    for name, n, batch, dname in PLANE_ROWS:
        direction = pf.Direction(dname)
        forward = direction == pf.Direction.FORWARD
        sign = -1 if forward else +1
        plan = pf.Descriptor(lengths=[n], number_of_transforms=batch).commit(
            device="cuda")
        entry = plan._raw_fast[direction]
        if entry[0] != "plane":
            raise SmokeFailure(f"{name}: entry {entry[0]}, not the plane path")
        routes = set(entry[-1].values())
        kinds = ["deinterleave", "interleave"]
        kinds += ["chain"] if routes & {"direct", "two_stage", "chain"} else []
        kinds += ["bluestein"] if "bluestein" in routes else []
        x = random_raw(2 * batch * n, seed=0)
        compute = plan.compute_forward if forward else plan.compute_backward
        before = {k: counters[k].launches for k in kinds}
        y = compute(x)
        torch.cuda.synchronize()
        rose = {k: counters[k].launches - before[k] for k in kinds}
        if min(rose.values()) <= 0:
            raise SmokeFailure(f"{name}: a kernel of the path was not launched: {rose}")
        if y.shape != x.shape or not torch.isfinite(y).all():
            raise SmokeFailure(f"{name}: output of shape {tuple(y.shape)} "
                               "or not finite")
        excess = oracle_excess(y, x, n, batch, sign, 1.0)
        if not excess <= 1.0:
            raise SmokeFailure(f"{name}: {excess:.3e} times the oracle bound "
                               f"{oracle_tol(n):.3e}")
        del y
        ms = time_ms(lambda: compute(x))
        plain_ms = time_ms(functools.partial(plain_path(plan, entry), x))
        library_ms = time_ms(library_call(x, n, batch, False, forward))
        nbytes, flops = work("bluestein", n, batch)
        bound, by = bound_of("bluestein", n, batch)
        print(f"row {name:24s} n={n:<6d} batch={batch:<7d} "
              f"{'+'.join(kinds):36s} launches {rose} route {entry[-1]} oracle "
              f"max|diff|={excess * oracle_tol(n):.3e} tol={oracle_tol(n):.3e} | "
              f"path {ms:.3f} ms {nbytes / ms / 1e6:.1f} GB/s | plain "
              f"{plain_ms:.3f} ms | torch.fft {library_ms:.3f} ms | bound "
              f"{bound:.3f} ms ({by}) | {card}")
        results.append((name, kinds, n, batch, ms, plain_ms, library_ms))
        del plan, x
        torch.cuda.empty_cache()
    launches = {k: c.launches for k, c in counters.items()}
    print(f"plane main-path launches: {launches}")
    for kind in ("deinterleave", "interleave", "chain", "bluestein"):
        if launches[kind] == 0:
            raise SmokeFailure(f"kernel {kind} was never launched on the plane path")
    return results, launches


def kernel_table(max_err, c2c_rows, c2c_launches, real_rows, real_launches,
                 alone, md_launches, md_alone, plane_launches,
                 plane_alone) -> list[dict]:
    """One entry per kernel.  K1-K3 and K9 take their numbers from the first
    main-path row that runs them (the path is that one kernel); K8a and K8b
    from their timing alone at real_large, where no single ``torch.fft``
    call computes the same function; K10 and K11 from their timing alone at
    ``MD_ALONE``, with the launches of the multi-dim main path."""
    def entry(kind, launches, ms, plain_ms, library_ms, n, batch):
        source, replaces = SOURCES[kind]
        bound, by = bound_of(kind, n, batch)
        return {"name": kind, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": max_err[kind], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": by, "library_ms": library_ms}

    kernels = []
    for kind in C2C_KINDS:
        _, _, n, batch, ms, plain_ms, library_ms = next(
            r for r in c2c_rows if r[1] == kind)
        kernels.append(entry(kind, c2c_launches[kind], ms, plain_ms,
                             library_ms, n, batch))
    _, n, batch, _ = next(r for r in REAL_ROWS if r[0] == "real_large")
    for kind in ("untangle", "retangle"):
        ms, plain_ms = alone[(kind, n, batch)]
        kernels.append(entry(kind, real_launches[kind], ms, plain_ms, None,
                             n, batch))
    _, _, n, batch, ms, plain_ms, library_ms = next(
        r for r in real_rows if r[1] == ["small_real"])
    kernels.append(entry("small_real", real_launches["small_real"], ms,
                         plain_ms, library_ms, n, batch))
    for kind in MD_KINDS:
        shape = MD_ALONE[kind]
        n = shape[1] if kind == "col" else shape[1] * shape[2]
        kernels.append(entry(kind, md_launches[kind], *md_alone[kind], n,
                             math.prod(shape) // n))
    for kind in PLANE_KINDS:
        launches = (plane_launches["deinterleave"] + plane_launches["interleave"]
                    if kind == "interleave" else plane_launches[kind])
        kernels.append(entry(kind, launches, *plane_alone[kind],
                             *PLANE_ALONE[kind]))
    return kernels


def run() -> None:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        raise SmokeFailure(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)  # name and power limit, as nvidia-smi gives them
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    import portfft_tpu_torch as pf
    from portfft_tpu_torch.ops import (
        _build,
        cuda_bluestein,
        cuda_chain,
        cuda_fft,
        cuda_global,
        cuda_io,
        cuda_multidim,
        cuda_real,
    )

    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s ({_build.library_path().name})")
    print(_build.build_log(), file=sys.stderr)

    counters = {"direct": cuda_fft.direct, "fused2": cuda_fft.fused2,
                "global2": cuda_global.global2, "untangle": cuda_real.untangle,
                "retangle": cuda_real.retangle, "small_real": cuda_real.small_real,
                "col": cuda_multidim.col, "md2": cuda_multidim.md2,
                "deinterleave": cuda_io.deinterleave,
                "interleave": cuda_io.interleave, "chain": cuda_chain.chain,
                "bluestein": cuda_bluestein.bluestein}
    max_err: dict[str, float] = {}
    phases = []

    def phase(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        phases.append(f"{name} {time.perf_counter() - t:.1f} s")
        return out

    phase("C2C kernels", c2c_kernel_phase, pf, max_err)
    alone = phase("REAL kernels", real_kernel_phase, pf, max_err, card)
    md_alone = phase("multi-dim kernels", md_kernel_phase, pf, max_err, card)
    plane_alone = phase("plane kernels", plane_kernel_phase, pf, max_err, card)
    c2c_rows, c2c_launches = phase("C2C main path", c2c_main_path, pf, counters, card)
    real_rows, real_launches = phase("REAL main path", real_main_path, pf,
                                     counters, card)
    _, md_launches = phase("multi-dim main path", md_main_path, pf, counters, card)
    _, plane_launches = phase("plane main path", plane_main_path, pf, counters,
                              card)
    print(f"phases: {'; '.join(phases)}; total {time.perf_counter() - t_start:.1f} s")
    kernels = kernel_table(max_err, c2c_rows, c2c_launches, real_rows,
                           real_launches, alone, md_launches, md_alone,
                           plane_launches, plane_alone)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def main() -> None:
    try:
        run()
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr, flush=True)
        sys.exit(1)


if __name__ == "__main__":
    main()
