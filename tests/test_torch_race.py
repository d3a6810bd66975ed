"""``chip_race.py``'s case families, run on the CPU: every kernel of
``chip_smoke.SOURCES`` (and K7's restride and K17's factored mode) has a
case table, and each family builds its cases, holds the kernel to its plain
version and reports a time per case.

On the CPU a wrapper runs its plain version, so the race holds the plain
path to itself; the timer is replaced by a stub.  The case tables are cut
to one small shape of each kernel.
"""

import pytest
import torch

import chip_race
import chip_smoke as cs
import portfft_tpu_torch as pf

# One small case of each table, on the CPU.
SMALL = {
    "KERNEL_CASES": [(16, 4), (4096, 2), (65536, 1)],
    "FUSED_KERNEL_CASES": [(k, 1024, 2) for k in cs.FUSED_KINDS],
    "TUNED_ROWS": [("large_1d", 65536, 1)],
    "MMA_GLOBAL_CASES": [(65536, 1)],
    "MD_COL_CASES": [(2, 128, 4)],
    "MMA_COL_CASES": [(2, 128, 4)],
    "MD2_CASES": [(1, 128, 128)],
    "CHAIN_CASES": [(100, 2)],
    "BLUESTEIN_CASES": [(20011, 1)],
    "BLUESTEIN_BF_CASES": [(24977, 1)],
    "PLANE_ALONE": {**cs.PLANE_ALONE, "bluestein": (16411, 1)},
    "REAL_PLANE_ALONE": {**cs.REAL_PLANE_ALONE, "bluestein_bf": (37951, 1)},
    "GLOBAL_PLANES_CASES": [(256, 256, 1, None)],
    "AXIS_CASES": [(2, 128, 4)],
    "REAL_KERNEL_CASES": [(32, 4), (1000, 2)],
    "K9_ALONE": [(180, 3), (32, 4)],
    "K10_ALONE": [((2, 90, 5), torch.float32), ((1, 16, 3), torch.float64)],
    "WIDE_CASES": [(16384, 2)],
    "IO_CASES": [1000],
    "STRIDE_CASES": [("strided", (0, 2, 128, 64, 4), False),
                     ("split_strided", (1, 2, 130, 64, 3), True)],
}


@pytest.fixture
def small(monkeypatch):
    for name, table in SMALL.items():
        monkeypatch.setattr(cs, name, table)
    monkeypatch.setattr(cs, "time_ms", lambda fn: (fn(), 0.0)[1])


def test_every_kernel_has_a_case_table():
    assert set(cs.SOURCES) | {"restride", "global_fused_ftw"} == set(chip_race.CASES)


@pytest.mark.parametrize("kind", sorted(chip_race.CASES))
def test_each_family_races_its_kernel(small, kind):
    ms = chip_race.race(pf, [kind], [], "cpu", device="cpu")
    assert ms and all(key.startswith(f"{kind} ") and t == 0.0 for key, t in ms.items())


def test_batch_replaces_the_tables_batch(small):
    ms = chip_race.race(pf, ["global_fused", "md2", "global2_planes"], [2, 3],
                        "cpu", device="cpu")
    assert sorted(ms) == ["global2_planes (256, 256, 2, None)",
                          "global2_planes (256, 256, 3, None)",
                          "global_fused 256x256x2", "global_fused 256x256x3",
                          "md2 2x128x128", "md2 3x128x128"]


def test_a_kernel_without_a_case_fails(small, monkeypatch):
    monkeypatch.setattr(cs, "KERNEL_CASES", [(16, 4)])
    with pytest.raises(cs.SmokeFailure, match="no case of global2"):
        chip_race.race(pf, ["global2"], [], "cpu", device="cpu")


def test_a_kernel_that_disagrees_fails(small, monkeypatch):
    tuned_kernel = cs.tuned_kernel

    def off(plan, kind, direction):
        kernel, args = tuned_kernel(plan, kind, direction)

        def wrong(raw, *a):
            return kernel.plain(raw, *a) * 1.001

        wrong.plain = kernel.plain
        return wrong, args

    monkeypatch.setattr(cs, "tuned_kernel", off)
    with pytest.raises(cs.SmokeFailure, match=r"max\|kernel - plain\|"):
        chip_race.race(pf, ["global_fused"], [], "cpu", device="cpu")
