"""The checks of ``chip_smoke.py`` for K7 and the layout rows, run on the
CPU at every shape of its phase: they pass a correct result, and they reject
a faulty kernel and the faults the smoke run plants itself.

On the CPU a wrapper runs its plain version, so the correct "kernel" here
is the plain path.  A faulty kernel is a wrapper that runs the plain
version on a conjugated table (``chip_smoke.planted``) or returns zeros.
The batch is cut to 1 or 2 rows.
"""

import json

import pytest

import chip_smoke
import portfft_tpu_torch as pf


def _cut(m):
    """A K7 case cut for the CPU: n <= 256 and batch <= 4, the gap past a
    row's span (row-major) or the batch-innermost stride kept."""
    o, s, dist, n, batch = m
    n2, b2 = min(n, 256), min(batch, 4)
    if dist < s:
        return (o, b2 if s == batch else s, dist, n2, b2)
    return (o, s, dist - s * (n - n2), n2, b2)


@pytest.mark.parametrize("name,m,split", chip_smoke.STRIDE_CASES,
                         ids=[c[0] for c in chip_smoke.STRIDE_CASES])
def test_stride_checks_pass_and_reject_faults(name, m, split, monkeypatch):
    """K7's check passes the plain versions (exact) with both planted
    faults rejected, and fails a destride that reads one element late and
    a restride that drops its fill_gaps zeros."""
    from portfft_tpu_torch.ops import cuda_stride

    m = _cut(m)
    r = chip_smoke.check_stride(name, m, split, device="cpu")
    assert r["err"] == 0.0 and len(r["caught"]) == 6
    assert all(v > 0.0 for v in r["caught"].values())
    late = lambda x, o, *rest: cuda_stride.destride_plain(x, o + 1, *rest)  # noqa: E731
    late.plain = cuda_stride.destride.plain
    monkeypatch.setattr(cuda_stride, "destride", late)
    with pytest.raises(chip_smoke.SmokeFailure, match="destride"):
        chip_smoke.check_stride(name, m, split, device="cpu")
    monkeypatch.undo()
    unfilled = lambda y, *a: cuda_stride.restride_plain(y, *a[:-1], False)  # noqa: E731
    unfilled.plain = cuda_stride.restride.plain
    monkeypatch.setattr(cuda_stride, "restride", unfilled)
    with pytest.raises(chip_smoke.SmokeFailure, match="restride fill_gaps=True"):
        chip_smoke.check_stride(name, m, split, device="cpu")


def test_layout_rows_route_through_k7():
    """Each layout row commits to the route its name promises, and the K7
    phase checks K7 at every layout those rows give it."""
    from portfft_tpu_torch.utils.layout import Rows, rows_1d

    want = {
        "strided_large": ["destride", "global2"],
        "strided_out_large": ["global2", "restride"],
        "bi_in_4096": ["destride", "fused2"],
        "bi_65536": ["destride", "global2", "restride"],
        "offset_out_large_1d": ["global2"],
        "split_strided_4096": ["destride", "chain", "restride"],
    }
    cases = {(m, split) for _, m, split in chip_smoke.STRIDE_CASES}
    for name, n, batch, split, fields, _ in chip_smoke.LAYOUT_ROWS:
        desc = pf.Descriptor(lengths=[n], number_of_transforms=batch,
                             complex_storage=(pf.ComplexStorage.SPLIT_COMPLEX if split
                                              else pf.ComplexStorage.INTERLEAVED_COMPLEX),
                             **fields)
        entry = desc.commit(device="cpu")._raw_fast[pf.Direction.FORWARD]
        assert chip_smoke.layout_kinds(entry) == want[name]
        for side in entry[2:]:
            if isinstance(side, Rows):
                assert (tuple(vars(side).values()), split) in cases, (name, side)
        for direction in pf.Direction:
            rows = rows_1d(desc, direction)
            assert rows.contiguous or (tuple(vars(rows).values()), split) in cases


def test_tuned_layout_rows_take_the_shipped_engine():
    """Each tuned layout row is a layout row whose GLOBAL plan the shipped
    ``cuda_h100`` table names an engine for, and with that engine its route
    is K7 around K17 (the table's 65536 winner)."""
    from portfft_tpu_torch import fastpath, tuning

    with open(tuning._DEFAULTS_PATH) as f:
        table = json.load(f)["cuda_h100"]["global2"]
    want = {
        "strided_large": ["destride", "global_fused"],
        "strided_out_large": ["global_fused", "restride"],
        "bi_65536": ["destride", "global_fused", "restride"],
        "offset_out_large_1d": ["global_fused"],
    }
    assert set(chip_smoke.TUNED_LAYOUT) == set(want)
    for name, n, batch, split, fields, _ in chip_smoke.LAYOUT_ROWS:
        if name not in want:
            continue
        plan = pf.Descriptor(lengths=[n], number_of_transforms=batch,
                             **fields).commit(device="cpu")
        params = table[tuning._entry_key(plan, "global2")]
        entry = fastpath.with_engine(plan, plan._raw_fast[pf.Direction.FORWARD],
                                     params)
        assert chip_smoke.layout_kinds(entry) == want[name]


def test_bounds_of_k7_and_the_layout_rows():
    """K7 at strided_large reads 512 rows of a stride-2 span (16 bytes a
    used element, in sectors) and writes 256 MiB: 805 MB, 0.240 ms at
    3.35 TB/s; a BATCH_INTERLEAVED side costs 8 bytes an element, a
    stride-3 side 24, one past 4 elements a whole sector."""
    from portfft_tpu_torch.utils.layout import Rows

    m = dict((name, m) for name, m, _ in chip_smoke.STRIDE_CASES)["strided_large"]
    bound, by = chip_smoke.stride_bound(m, False)
    assert by == "bytes" and bound == pytest.approx(
        (16 + 8) * 65536 * 512 / 3.35e9) == pytest.approx(0.2404, abs=1e-4)
    assert chip_smoke.side_bytes(Rows(0, 512, 1, 64, 512), 8) == 8 * 64 * 512
    assert chip_smoke.side_bytes(Rows(5, 3, 400, 64, 4), 8) == 24 * 64 * 4
    assert chip_smoke.side_bytes(Rows(0, 5, 400, 64, 4), 8) == 32 * 64 * 4
    assert chip_smoke.side_bytes(Rows(0, 2, 400, 64, 4), 4, 2) == 2 * 8 * 64 * 4
