"""The checks of ``chip_smoke.py`` for the tensor-core kernels (K10-mm, K16)
and the tuned multi-dim rows, run on the CPU at every shape of its phase:
they pass a correct result, and they reject a faulty kernel and the faults
the smoke run plants itself.

On the CPU a wrapper runs its plain version, so the correct "kernel" here
is the plain path.  A faulty kernel is a wrapper that runs the plain
version on a conjugated table (``chip_smoke.planted``) or returns zeros.
The batch is cut to 1 or 2 rows.
"""

import math

import pytest
import torch

import chip_smoke
import portfft_tpu_torch as pf

DIRECTIONS = [(pf.Direction.FORWARD, -1), (pf.Direction.BACKWARD, +1)]


# The tensor-core kernel phase, cut on the CPU: K10-mm to bpre <= 2 and
# rest <= 8, K16 to one transform; L and n as on the card.
MMA_CPU = ([("col_mm", (min(b, 2), L, min(r, 8))) for b, L, r in chip_smoke.MMA_COL_CASES]
           + [("global3", (n, 1)) for n, _ in chip_smoke.MMA_GLOBAL_CASES])


def _mma_check(kind, case, direction, kernel=None):
    """Run the phase's check of one case, with ``kernel`` standing in for the
    wrapper where given."""
    sign = -1 if direction == pf.Direction.FORWARD else +1
    if kind == "col_mm":
        n = case[1]
        scale = 0.5 if sign < 0 else 2.0 / n
        wrapper, args = chip_smoke.md_kernel_case(pf, kind, case, sign, scale, "cpu")
        x = chip_smoke.random_raw(2 * math.prod(case), seed=sum(case), device="cpu")
        return chip_smoke.check_md(kind, kernel or wrapper, args, x, case, sign)
    n, batch = case
    plan = pf.Descriptor(lengths=[n], number_of_transforms=batch, forward_scale=0.5,
                         backward_scale=2.0 / n).commit(device="cpu")
    wrapper, args = chip_smoke.tuned_kernel(plan, kind, direction)
    assert wrapper.__name__ == kind
    x = chip_smoke.random_raw(2 * batch * n, seed=n, device="cpu")
    return chip_smoke.check_kernel(kind, kernel or wrapper, args, x, n, sign)


@pytest.mark.parametrize("kind,case", MMA_CPU)
def test_mma_checks_pass_and_reject_faults(kind, case):
    """The check passes the plain version with both planted faults (K10-mm:
    its roots or inner twiddle conjugated; K16: its twiddle factor B2
    conjugated; zeros) rejected by both checks, and fails a kernel run on
    the planted table or returning zeros."""
    from portfft_tpu_torch.ops import cuda_global, cuda_multidim

    for direction, _ in DIRECTIONS:
        r = _mma_check(kind, case, direction)
        assert r["rel"] == 0.0 and r["excess"] <= 1.0
        for rel, excess in r["caught"].values():
            assert rel > 100 * chip_smoke.KERNEL_TOL and excess > 100.0
    wrapper = getattr(cuda_multidim if kind == "col_mm" else cuda_global, kind)
    for fault in ("conjugated table", "zeros"):
        def faulty(raw, *a, fault=fault):
            if fault == "zeros":
                return torch.zeros_like(raw)
            return wrapper.plain(raw, *chip_smoke.planted(kind, a))

        faulty.plain = wrapper.plain
        with pytest.raises(chip_smoke.SmokeFailure, match=r"max\|kernel - plain\|"):
            _mma_check(kind, case, pf.Direction.FORWARD, faulty)


def test_bounds_of_the_mma_kernels():
    """The tensor-core kernels are bound as every C2C kernel is, by the
    function's work and not by their dense products: 16 bytes and
    5·log2(N) flops a point at the fp32 peak, bound by bytes (0.321 ms for
    K10-mm at (64, 1024, 1024), 0.641 for K16 at 65536 x 2048)."""
    for kind, want in (("col_mm", 0.321), ("global3", 0.641)):
        shape = chip_smoke.MMA_ALONE[kind]
        n, batch = (shape[1], shape[0] * shape[2]) if kind == "col_mm" else shape
        assert chip_smoke.work(kind, n, batch) == chip_smoke.work("global2", n, batch)
        bound, by = chip_smoke.bound_of(kind, n, batch)
        assert by == "bytes" and bound == pytest.approx(16 * n * batch / 3.35e9)
        assert bound == pytest.approx(want, abs=1e-3)


def test_mma_cases_hold_the_main_path_shapes():
    """The tensor-core kernel phase checks K10-mm at every column step a
    ``multidim`` or ``bi_col`` variant of an ``MD_ROWS`` row gives it
    (md_128^3's axis-1 step (4096, 128, 128) where K11 is off among them),
    and K16 at every tuned row its gate takes (``tuned_cases``)."""
    from portfft_tpu_torch import fastpath, race

    steps = set()
    for _, lengths, batch, dname, bi in chip_smoke.MD_ROWS:
        kw = dict(forward_strides=[batch], backward_strides=[batch],
                  forward_distance=1, backward_distance=1) if bi else {}
        plan = pf.Descriptor(lengths=list(lengths), number_of_transforms=batch,
                             **kw).commit(device="cpu")
        entry = plan._raw_fast[pf.Direction(dname)]
        for params in race._variants_for_entry(plan, entry):
            tuned = fastpath.with_engine(plan, entry, params)
            inner = getattr(tuned, "inner", tuned)
            cols = inner.steps if isinstance(inner, fastpath.MultiDim) else (inner,)
            steps |= {(s.bpre, s.plan.n, s.rest) for s in cols
                      if isinstance(s, fastpath.Col) and s.kernel == "col_mm"}
    assert (4096, 128, 128) in steps and (1, 4096, 32768) in steps
    assert steps <= set(chip_smoke.MMA_COL_CASES)
    tuned = {(n, batch) for _, n, batch in chip_smoke.tuned_cases(pf, ("global3",))}
    assert len(tuned) == len(chip_smoke.TUNED_ROWS)
    assert tuned <= set(chip_smoke.MMA_GLOBAL_CASES)


def test_col_mm_declines_only_direct_lengths_off_128():
    """Among the lengths K10 takes, K10-mm's gate declines exactly the
    DIRECT ones that are no multiple of 128 (the phase prints them)."""
    assert chip_smoke.col_mm_declines(pf) == [n for n in range(2, 513) if n % 128]


def test_md_kinds_of_the_tuned_routes():
    """``md_kinds`` names every kernel of a multi-dim or column route:
    K10-mm where ``{"cm": 1}`` selects it."""
    from portfft_tpu_torch import fastpath

    plan = pf.Descriptor(lengths=[128, 128, 128]).commit(device="cpu")
    entry = plan._raw_fast[pf.Direction.FORWARD]
    assert chip_smoke.md_kinds(entry) == ["md2", "col"]
    assert chip_smoke.md_kinds(fastpath.with_engine(plan, entry, {"m2": 0, "cm": 1})) \
        == ["direct", "col_mm", "col_mm"]
    bi = pf.Descriptor(lengths=[4096], number_of_transforms=4, forward_strides=[4],
                       backward_strides=[4], forward_distance=1,
                       backward_distance=1).commit(device="cpu")
    entry = bi._raw_fast[pf.Direction.FORWARD]
    assert chip_smoke.md_kinds(entry) == ["col"]
    assert chip_smoke.md_kinds(fastpath.with_engine(bi, entry, {"cm": 1})) == ["col_mm"]
    assert chip_smoke.layout_kinds(fastpath.with_engine(bi, entry, {"cm": 1})) == ["col_mm"]
