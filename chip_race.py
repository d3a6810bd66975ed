"""Kernels of one tree timed at the shapes ``chip_smoke.py`` gives them, so
that two trees can be compared on one card.

    python3 chip_race.py [--batch B ...] [ROOT [KERNEL ...]]

Imports ``portfft_tpu_torch`` from ROOT (a checkout of another commit, for
instance a ``git archive`` unpacked under ``_checkout/``; default: this
script's own directory), builds its kernels there, and times each KERNEL
(a name of ``chip_smoke.SOURCES``, or ``restride`` or ``global_fused_ftw``,
the factored-twiddle mode of K17; default: every one) at every shape of its
case table in ``chip_smoke`` (``CASES``; K15 and K15-bf also at the shape
``chip_smoke`` times them alone, 65537 x 2048, K9 at ``K9_ALONE`` and K10
at ``K10_ALONE``): one
forward call out of place, the median of 10 CUDA-event timed calls after 3
warm-up calls (``chip_smoke.time_ms``).  ``--batch B`` (repeatable) runs every case whose
table gives a number of transforms, (n, batch) of a 1D kernel, (batch, n1,
n2) of K11 and (g1, g2, batch, post) of K14, at each B instead; the other
cases keep their shapes.  Each case is first held to its plain version
(max|kernel − plain| ≤ ``chip_smoke.KERNEL_TOL``·max|plain|), and the
script exits non-zero where one is not, or where a KERNEL has no case.
The first line is the card's name and power limit as ``nvidia-smi`` gives
them; then one line per case; the last line is one JSON object
``{"root": ..., "card": ..., "ms": {"<kernel> <shape>": ms, ...}}``.  Run
it for two roots in turns (A, B, B, A) in one command to compare them.
Needs one CUDA device and exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile

import torch

import chip_smoke as cs


def commit(pf, n: int, batch: int, device: str, **kw):
    return pf.Descriptor(lengths=[n], number_of_transforms=batch, **kw
                         ).commit(device=device)


def at(table, batches, pos: int = 1) -> list[tuple]:
    """The cases of ``table`` with the entry at ``pos`` (the batch) set to
    each of ``batches``, or as they are."""
    if not batches:
        return list(table)
    return [(*c[:pos], b, *c[pos + 1:]) for c in table for b in batches]


# Each family yields (label, kernel, args, x) of its forward cases on
# ``device``: the kernel called as kernel(x, *args), its plain version as
# kernel.plain(x, *args).

def c2c_cases(pf, kind, batches, device):
    for n, batch in at(cs.KERNEL_CASES, batches):
        plan = commit(pf, n, batch, device)
        got, kernel, args = cs.kernel_and_args(plan, pf.Direction.FORWARD)
        if got == kind:
            yield (f"n={n} batch={batch}", kernel, args,
                   cs.random_raw(2 * batch * n, n, device))


def fused_cases(pf, kind, batches, device):
    table = [(n, b) for k, n, b in cs.FUSED_KERNEL_CASES if k == kind]
    for n, batch in at(table, batches):
        kernel, args = cs.fused_kernel(commit(pf, n, batch, device), kind,
                                       pf.Direction.FORWARD)
        yield (f"n={n} batch={batch}", kernel, args,
               cs.random_raw(2 * batch * n, n, device))


def tuned_cases(pf, kind, batches, device):
    table = ([(n, b) for _, n, b in cs.tuned_cases(pf, (kind,))]
             if kind != "global3" else cs.MMA_GLOBAL_CASES)
    for n, batch in at(table, batches):
        plan = commit(pf, n, batch, device)
        g1, g2 = (s.n for s in plan.plans[n].sub)
        kernel, args = cs.tuned_kernel(plan, kind, pf.Direction.FORWARD)
        yield (f"{g1}x{g2}x{batch}", kernel, args,
               cs.random_raw(2 * batch * n, n, device))


def md_cases(pf, kind, batches, device):
    table = {"col": cs.MD_COL_CASES, "col_mm": cs.MMA_COL_CASES,
             "md2": at(cs.MD2_CASES, batches, 0)}[kind]
    for shape in table:
        kernel, args = cs.md_kernel_case(pf, kind, shape, -1, 1.0, device)
        yield ("x".join(map(str, shape)), kernel, args,
               cs.random_raw(2 * math.prod(shape), sum(shape), device))
    if kind == "col":  # also where chip_smoke times K10 alone
        for shape, dtype in cs.K10_ALONE:
            kernel, args = cs.k10_case(pf, shape, dtype, -1, 1.0, device)
            yield (f"{'x'.join(map(str, shape))} {str(dtype).split('.')[-1]}",
                   kernel, args,
                   cs.hashed_uniform(2 * math.prod(shape), shape[1], dtype, device))


def plane_cases(pf, kind, batches, device):
    # K15 and K15-bf also at the shape chip_smoke times them alone
    table = {"chain": cs.CHAIN_CASES,
             "bluestein": cs.BLUESTEIN_CASES + [cs.PLANE_ALONE["bluestein"]],
             "bluestein_bf": (cs.BLUESTEIN_BF_CASES
                              + [cs.REAL_PLANE_ALONE["bluestein_bf"]])}[kind]
    for n, batch in at(table, batches):
        kernel, args = cs.plane_case(pf, kind, n, -1, device)
        yield (f"n={n} batch={batch}", cs.on_raw(kernel, n), args,
               cs.random_raw(2 * batch * n, n, device))


def split_cases(pf, kind, batches, device):
    table = (at(cs.GLOBAL_PLANES_CASES, batches, 2) if kind == "global2_planes"
             else cs.AXIS_CASES)
    for case in table:
        shape = cs.split_shape(kind, case)
        kernel, args = cs.split_case(pf, kind, case, -1, device)
        yield (str(case), cs.on_raw(kernel, math.prod(shape)), args,
               cs.random_raw(2 * math.prod(shape), shape[1], device))


def real_cases(pf, kind, batches, device):
    from portfft_tpu_torch.ops import cuda_real

    wide = kind == "untangle_wide"
    table = cs.WIDE_CASES if wide else cs.REAL_KERNEL_CASES
    if kind == "small_real":  # also where chip_smoke times K9 alone
        table = table + [c for c in cs.K9_ALONE if c not in table]
    for n, batch in at(table, batches):
        plan = commit(pf, n, batch, device, domain=pf.Domain.REAL)
        x = cs.random_raw(batch * n, n, device)
        spec = cs.half_spectra(batch, n, n + 1, device)
        for direction in ((pf.Direction.FORWARD,) if wide else pf.Direction):
            got, kernel, args, inp, _ = cs.real_case(plan, direction, x, spec)
            if wide:  # also a shape the gate declines (the kernel takes it)
                got, kernel = kind, cuda_real.untangle_wide
            if got == kind:
                yield f"n={n} batch={batch} {direction.value}", kernel, args, inp


def io_cases(pf, kind, batches, device):
    from portfft_tpu_torch.ops import cuda_io

    def both(k_de, k_in):
        return lambda x, scale: k_in(*k_de(x), scale)

    kernel = both(cuda_io.deinterleave, cuda_io.interleave)
    kernel.plain = both(cuda_io.deinterleave.plain, cuda_io.interleave.plain)
    for m in cs.IO_CASES:  # deinterleave, then interleave with a scale
        yield f"m={m}", kernel, (0.5,), cs.random_raw(2 * m, m, device)


def stride_cases(pf, kind, batches, device):
    from portfft_tpu_torch.ops import cuda_stride

    for name, m, split in cs.STRIDE_CASES:
        o, s, dist, n, batch = m
        count = o + (batch - 1) * dist + (n - 1) * s + 1
        label = f"{name} {'planes' if split else 'interleaved'}"
        if kind == "destride":
            yield (label, cuda_stride.destride, m,
                   cs.stride_buffer(count, split, 1, device))
        else:  # restride with fill_gaps into a buffer of the strided side
            out = cs.stride_buffer(count, split, 0, device, cs.SENTINEL)
            yield (label, cuda_stride.restride, (*m, out, True),
                   cs.stride_buffer(batch * n, split, 2, device))


FAMILIES = [
    (c2c_cases, cs.C2C_KINDS),
    (fused_cases, cs.FUSED_KINDS),
    (tuned_cases, cs.TUNED_ENGINES + ("global3",)),
    (md_cases, ("col", "col_mm", "md2")),
    (plane_cases, ("chain", "bluestein", "bluestein_bf")),
    (split_cases, cs.SPLIT_KINDS),
    (real_cases, cs.REAL_KINDS + ("untangle_wide",)),
    (io_cases, ("interleave",)),
    (stride_cases, cs.STRIDE_KINDS),
]
#: kernel name -> its case family.
CASES = {kind: family for family, kinds in FAMILIES for kind in kinds}


def planes(y) -> tuple:
    return y if isinstance(y, tuple) else (y,)


def race(pf, kinds, batches, card: str, device: str = "cuda") -> dict:
    """``{"<kernel> <shape>": ms}`` of every case of ``kinds``; raises
    :class:`chip_smoke.SmokeFailure` where a kernel disagrees with its
    plain version or has no case."""
    ms = {}
    for kind in kinds:
        seen = 0
        for label, kernel, args, x in CASES[kind](pf, kind, batches, device):
            seen += 1
            key = f"{kind} {label}"
            # a copy: an out= argument (K7's restride) is written by both
            got = tuple(y.clone() for y in planes(kernel(x, *args)))
            want = planes(kernel.plain(x, *args))
            err = max((g - w).abs().max().item() for g, w in zip(got, want))
            top = max(w.abs().max().item() for w in want)
            if not err <= cs.KERNEL_TOL * top:
                raise cs.SmokeFailure(f"{key}: max|kernel - plain| = {err:.3e} > "
                                      f"{cs.KERNEL_TOL:g}·{top:.3e}")
            del got, want
            ms[key] = cs.time_ms(lambda: kernel(x, *args))
            print(f"{key:48s} {ms[key]:.3f} ms | {card}", flush=True)
            del kernel, args, x
            torch.cuda.empty_cache()
        if not seen:
            raise cs.SmokeFailure(f"no case of {kind} at batch {batches or 'as listed'}")
    return ms


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch", type=int, action="append", default=[])
    parser.add_argument("root", nargs="?",
                        default=os.path.dirname(os.path.abspath(__file__)))
    parser.add_argument("kernels", nargs="*", default=list(CASES))
    a = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_race.py: torch.cuda.is_available() is False")
    unknown = sorted(set(a.kernels) - set(CASES))
    if unknown:
        sys.exit(f"chip_race.py: no case table for {unknown}; one of {sorted(CASES)}")
    root = os.path.abspath(a.root)
    sys.path.insert(0, root)
    os.environ["PORTFFT_NO_TUNING"] = "1"
    os.environ["PORTFFT_TUNING_CACHE"] = os.path.join(tempfile.gettempdir(),
                                                      "portfft_race_tuning.json")
    import portfft_tpu_torch as pf
    from portfft_tpu_torch.ops import _build

    if not pf.__file__.startswith(root):
        sys.exit(f"chip_race.py: imported {pf.__file__}, not from {root}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    _build.load()
    try:
        ms = race(pf, a.kernels, a.batch, card)
    except cs.SmokeFailure as e:
        sys.exit(f"chip_race.py: {e}")
    print(json.dumps({"root": root, "card": card, "ms": ms}))


if __name__ == "__main__":
    main()
