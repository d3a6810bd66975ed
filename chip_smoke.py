"""Smoke run of portfft_tpu_torch on one CUDA card.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit) and the torch and
   CUDA versions; exits non-zero when no CUDA device is available.
2. Builds the kernels from ``portfft_tpu_torch/csrc`` and prints the build
   time and the compiler's register report (on stderr).
3. Kernel phase: each kernel (K1 direct, K2 fused2, K3 global2) at every
   plan shape of the bench rows and the ladder, forward and backward with
   scale != 1, held on the same inputs to
   - its plain PyTorch version: max|kernel - plain| <= 1e-5 · max|plain|;
   - ``torch.fft`` (oracle only) on a sample of rows: every element within
     the absolute 2·eps·N·log2(N)·|scale|.
   Each case also plants two faults, the kernel run with one of its tables
   conjugated and an all-zero output, and fails unless both checks reject
   both.
4. Main-path phase: ``Descriptor(...).commit(device="cuda")`` and
   ``compute_forward``/``compute_backward`` on a raw float32 tensor on the
   card, for the bench rows.  Launch counts are reset just before and read
   just after; each row's kernel must have launched.  A sample of rows is
   held to ``torch.fft`` at the absolute 2·eps·N·log2(N) per element.
   Kernel path and plain path are timed with CUDA events (3 warm-up calls,
   median of 10).
5. Prints the kernel table as one JSON line, then, as the last line,
   ``{"ok": true, "device": {...}}``.  Any failure exits non-zero before
   that line.
"""

from __future__ import annotations

import dataclasses
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
SOURCES = {
    "direct": ("portfft_tpu_torch/csrc/fft_direct.cu",
               "portfft_tpu/ops/pallas_fft.py:386"),
    "fused2": ("portfft_tpu_torch/csrc/fft_fused2.cu",
               "portfft_tpu/ops/pallas_fft.py:791"),
    "global2": ("portfft_tpu_torch/csrc/fft_global2.cu",
                "portfft_tpu/ops/pallas_global.py:1031"),
}


class SmokeFailure(Exception):
    """A check of the smoke run failed."""


def oracle_tol(n: int) -> float:
    return 2.0 * EPS32 * n * max(math.log2(n), 1.0)


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


def random_raw(numel: int, seed: int) -> torch.Tensor:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.rand(numel, generator=gen, device="cuda") * 2 - 1


def oracle_excess(y, x, n: int, batch: int, sign: int, scale: float) -> float:
    """Largest |y - ref| over a sample of rows, in units of the absolute
    bound 2·eps·N·log2(N)·|scale|; ref is ``torch.fft`` in complex128 (the
    oracle only).  At most 1 passes."""
    rows = sorted({0, min(1, batch - 1), batch // 2, batch - 1})
    xs = torch.view_as_complex(x.view(batch, n, 2)[rows]).to(torch.complex128)
    ys = torch.view_as_complex(y.view(batch, n, 2)[rows]).to(torch.complex128)
    ref = (torch.fft.fft(xs) if sign < 0 else torch.fft.ifft(xs) * n) * scale
    return (ys - ref).abs().max().item() / (oracle_tol(n) * abs(scale))


def planted(kind: str, args: tuple) -> tuple:
    """A kernel's arguments with one table conjugated: the roots (K1), the
    inner twiddle (K2) or the inter-pass twiddle (K3)."""
    if kind == "global2":
        batch, sub1, sub2, tr, ti, scale = args
        return (batch, sub1, sub2, tr, -ti, scale)
    batch, sub, scale = args
    field = "ui" if kind == "fused2" else "wi"
    return (batch, dataclasses.replace(sub, **{field: -getattr(sub, field)}),
            scale)


def check_kernel(kind: str, kernel, args: tuple, x, n: int, sign: int) -> dict:
    """Hold one call of ``kernel`` to its plain version and to the oracle,
    and check that both checks reject two planted faults.  Returns the
    measured numbers; raises :class:`SmokeFailure`."""
    batch, scale = args[0], args[-1]
    what = f"{kind} n={n} sign={sign:+d}"
    got = kernel(x, *args)
    want = kernel.plain(x, *args)
    peak = want.abs().max().item()

    def judged(y):
        err = (y - want).abs().max().item()
        return err, err / peak, oracle_excess(y, x, n, batch, sign, scale)

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


def run() -> None:
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
    from portfft_tpu_torch.ops import _build, cuda_fft, cuda_global

    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s ({_build.library_path().name})")
    print(_build.build_log(), file=sys.stderr)
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions: full fp32

    counters = {"direct": cuda_fft.direct, "fused2": cuda_fft.fused2,
                "global2": cuda_global.global2}

    # -- kernel phase ------------------------------------------------------
    max_err: dict[str, float] = {}
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
            caught = " ".join(f"{name}: {rel:.2e}·max|plain|, {exc:.2e}×oracle;"
                              for name, (rel, exc) in r["caught"].items())
            print(f"kernel {kind:8s} n={n:<8d} batch={batch:<8d} "
                  f"{direction.value:8s} max|k-plain|={r['err']:.3e} "
                  f"={r['rel']:.2e}·max|plain| (tol {KERNEL_TOL:g}) "
                  f"oracle {r['excess']:.2e}×bound | planted faults rejected: "
                  f"{caught}")
            max_err[kind] = max(max_err.get(kind, 0.0), r["err"])
        del plan, x
        torch.cuda.empty_cache()

    # -- main-path phase ---------------------------------------------------
    results = []
    for c in counters.values():
        c.launches = 0
    for name, n, batch, dname in ROWS:
        direction = pf.Direction(dname)
        sign = -1 if direction == pf.Direction.FORWARD else +1
        plan = pf.Descriptor(lengths=[n], number_of_transforms=batch).commit(
            device="cuda"
        )
        kind, kernel, args = kernel_and_args(plan, direction)
        before = counters[kind].launches
        x = random_raw(2 * batch * n, seed=0)
        compute = (plan.compute_forward if direction == pf.Direction.FORWARD
                   else plan.compute_backward)
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
        plain_ms = time_ms(lambda: kernel.plain(x, *args))
        nbytes = 16 * batch * n
        flops = 5 * n * math.log2(n) * batch
        print(f"row {name:16s} n={n:<8d} batch={batch:<8d} {kind:8s} "
              f"launches +{rose} oracle max|diff|={excess * oracle_tol(n):.3e} "
              f"tol={oracle_tol(n):.3e} | "
              f"kernel {ms:.3f} ms {nbytes / ms / 1e6:.1f} GB/s "
              f"{flops / ms / 1e6:.1f} GFLOP/s | plain {plain_ms:.3f} ms "
              f"{nbytes / plain_ms / 1e6:.1f} GB/s "
              f"{flops / plain_ms / 1e6:.1f} GFLOP/s | {card}")
        results.append((name, kind, ms, plain_ms))
        del plan, x
        torch.cuda.empty_cache()
    launches = {k: c.launches for k, c in counters.items()}
    print(f"main-path launches: {launches}")
    for kind, count in launches.items():
        if count == 0:
            raise SmokeFailure(f"kernel {kind} was never launched on the main path")

    kernels = []
    for kind, (source, replaces) in SOURCES.items():
        name, _, ms, plain_ms = next(r for r in results if r[1] == kind)
        kernels.append({
            "name": kind, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[kind],
            "max_abs_err": max_err[kind], "ms": ms, "plain_ms": plain_ms,
        })
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
