"""The checks of ``chip_smoke.py`` for the multi-dimensional kernel phase
(K10, K11) and rows, run on the CPU at every shape of its phase: they pass a
correct result, and they reject a faulty kernel and the faults the smoke run
plants itself.

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


# Multi-dim kernel phase, cut on the CPU: K10 to bpre <= 2 and rest <= 8,
# K11 to one transform; L, n1 and n2 as on the card.
MD_CASES = ([("col", (min(b, 2), L, min(r, 8))) for b, L, r in chip_smoke.MD_COL_CASES]
            + [("md2", (1, n1, n2)) for _, n1, n2 in chip_smoke.MD2_CASES])


def _md_case(kind, shape, sign):
    n = math.prod(shape[d] for d in chip_smoke.MD_DIMS[kind])
    scale = 0.5 if sign < 0 else 2.0 / n
    kernel, args = chip_smoke.md_kernel_case(pf, kind, shape, sign, scale, "cpu")
    x = chip_smoke.random_raw(2 * math.prod(shape), seed=sum(shape), device="cpu")
    return kernel, args, x


@pytest.mark.parametrize("kind,shape", MD_CASES)
def test_md_checks_pass_a_correct_result(kind, shape):
    for _, sign in DIRECTIONS:
        kernel, args, x = _md_case(kind, shape, sign)
        r = chip_smoke.check_md(kind, kernel, args, x, shape, sign)
        assert r["rel"] == 0.0 and r["excess"] <= 1.0
        for rel, excess in r["caught"].values():
            assert rel > 100 * chip_smoke.KERNEL_TOL and excess > 100.0


@pytest.mark.parametrize("fault", ["conjugated table", "zeros"])
@pytest.mark.parametrize("kind,shape", MD_CASES)
def test_md_checks_reject_a_faulty_kernel(kind, shape, fault):
    for _, sign in DIRECTIONS:
        kernel, args, x = _md_case(kind, shape, sign)

        def faulty(raw, *a):
            if fault == "zeros":
                return torch.zeros_like(raw)
            return kernel.plain(raw, *chip_smoke.planted(kind, a))

        faulty.plain = kernel.plain
        with pytest.raises(chip_smoke.SmokeFailure, match=r"max\|kernel - plain\|"):
            chip_smoke.check_md(kind, faulty, args, x, shape, sign)
        excess = chip_smoke.nd_oracle_excess(faulty(x, *args), x, shape,
                                             chip_smoke.MD_DIMS[kind], sign,
                                             args[-1])
        assert excess > 100.0


def test_bounds_of_the_multidim_rows():
    """Each multi-dim row moves 2^30 bytes (0.321 ms at 3.35 TB/s) and
    bi_4096 2^31 (0.641 ms), bound by bytes at the nominal flops; K10 and
    K11 alone move 2^30."""
    for name, lengths, batch, _, _ in chip_smoke.MD_ROWS:
        bound, by = chip_smoke.bound_of("md2", math.prod(lengths), batch)
        nbytes = 2**31 if name == "bi_4096" else 2**30
        assert by == "bytes" and bound == pytest.approx(nbytes / 3.35e9)
    for kind, shape in chip_smoke.MD_ALONE.items():
        n = math.prod(shape[d] for d in chip_smoke.MD_DIMS[kind])
        bound, by = chip_smoke.bound_of(kind, n, math.prod(shape) // n)
        assert by == "bytes" and bound == pytest.approx(2**30 / 3.35e9)


@pytest.mark.parametrize("lengths,batch,bi", [((16, 64), 2, False),
                                              ((4, 8, 32), 1, False),
                                              ((1024,), 4, True)])
def test_fftn_call_computes_the_multidim_path_function(lengths, batch, bi):
    """The ``torch.fft`` yardstick of a multi-dim or BATCH_INTERLEAVED row
    computes what the row's plain path computes, both directions."""
    kw = dict(forward_strides=[batch], backward_strides=[batch],
              forward_distance=1, backward_distance=1) if bi else {}
    plan = pf.Descriptor(lengths=list(lengths), number_of_transforms=batch,
                         **kw).commit(device="cpu")
    n = math.prod(lengths)
    shape = (1, n, batch) if bi else (batch, *lengths)
    dims = (1,) if bi else tuple(range(1, len(shape)))
    x = chip_smoke.random_raw(2 * batch * n, 7, device="cpu")
    for direction, sign in DIRECTIONS:
        want = chip_smoke.plain_path(plan, plan._raw_fast[direction])(x)
        got = torch.view_as_real(chip_smoke.fftn_call(x, shape, dims, sign < 0)())
        assert torch.allclose(got.reshape(-1), want, atol=1e-3 * want.abs().max().item())


def test_shipped_rows_stay_on_k11():
    """``MD_SHIPPED`` rows: the shipped table names no ``multidim`` entry for
    their shape, and their static route is K11 alone, so the smoke run's
    commit with tuning on takes K11; their bound is the other rows'."""
    from portfft_tpu_torch import tuning

    for name, lengths, batch, dname, _ in chip_smoke.MD_SHIPPED:
        key = "n" + "x".join(map(str, lengths))
        assert tuning.lookup("cuda_h100", "multidim", key) is None, name
        plan = pf.Descriptor(lengths=list(lengths),
                             number_of_transforms=batch).commit(device="cpu")
        assert chip_smoke.md_kinds(plan._raw_fast[pf.Direction(dname)]) == ["md2"]
        assert (batch, *lengths) in chip_smoke.MD2_CASES
        bound, by = chip_smoke.bound_of("md2", math.prod(lengths), batch)
        assert by == "bytes" and bound == pytest.approx(2**30 / 3.35e9)


def test_afno_phase_checks_and_times_each_step(monkeypatch, capsys):
    """The AFNO phase on the CPU at the published lengths, cut to two
    transforms (timer stubbed): its checks pass the plain path, every timed
    function runs, and one line a direction is printed."""
    calls = []
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn: (calls.append(fn()), 1.0)[1])
    lengths, _, scale = chip_smoke.AFNO
    out = chip_smoke.afno_phase(pf, "cpu", (lengths, 2, scale), device="cpu")
    assert set(out) == {"forward", "backward"}
    assert all(set(ms) == {"call", "K9", "K10", "K13col+K6", "torch.fft"}
               for ms in out.values())
    assert len(calls) == 10
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("afno")]
    assert len(lines) == 2


def test_afno_phase_rejects_a_faulty_column_step(monkeypatch):
    from portfft_tpu_torch.ops import cuda_multidim

    plain = cuda_multidim.col.plain

    def faulty(raw, *a, out=None):
        return torch.zeros_like(raw)

    faulty.plain = plain
    faulty.kernel = "K10"
    monkeypatch.setattr(cuda_multidim, "col", faulty)
    lengths, _, scale = chip_smoke.AFNO
    with pytest.raises(chip_smoke.SmokeFailure, match="afno K10"):
        chip_smoke.afno_phase(pf, "cpu", (lengths, 2, scale), device="cpu")


def test_k9_phase_checks_and_times_each_case(monkeypatch, capsys):
    """The K9 phase on the CPU at small batches of its lengths (timer
    stubbed): every case runs K9 both ways against its plain version and
    prints one line a direction with its multiple of the byte bound."""
    calls = []
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn: (calls.append(fn()), 1.0)[1])
    cases = [(n, 3) for n, _ in chip_smoke.K9_ALONE]
    out = chip_smoke.k9_phase(pf, "cpu", cases, device="cpu")
    assert set(out) == {(n, 3, d) for n, _ in cases for d in ("forward", "backward")}
    assert len(calls) == 2 * len(cases)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("alone  K9")]
    assert len(lines) == 2 * len(cases) and all("x bound" in ln for ln in lines)


def test_dns_phase_checks_and_times_each_step(monkeypatch, capsys):
    """The fp64 DNS phase on the CPU at 8 x 12 x 16, two transforms (timer
    stubbed): each step runs in double and passes its plain version, the
    call passes ``torch.fft`` in complex128 far inside ``DNS_TOL``, and
    one line a direction is printed."""
    calls = []
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn: (calls.append(fn()), 1.0)[1])
    out = chip_smoke.dns_phase(pf, "cpu", ((8, 12, 16), 2, 1 / 1536), device="cpu")
    assert set(out) == {"forward", "backward"}
    for ms in out.values():
        assert set(ms) == {"K9 rows", "K10 9", "K10 108", "call", "torch_fft", "err"}
        assert ms["err"] < 1e-2 * chip_smoke.DNS_TOL
    assert len(calls) == 10
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("dns")]
    assert len(lines) == 2 and all("fp64" in ln for ln in lines)
    lengths, batch, scale = chip_smoke.DNS
    assert lengths == (512, 512, 512) and batch == 1 and scale == 2.0**-27


def test_dns_phase_rejects_a_float32_step(monkeypatch):
    """A K10 that runs in float32 under double data fails its plain check."""
    from portfft_tpu_torch.ops import cuda_multidim

    plain = cuda_multidim.col.plain

    def narrow(raw, bpre, rest, sub, scale, out=None):
        y = plain(raw.float(), bpre, rest, type(sub)(*(
            t.float() if isinstance(t, torch.Tensor) else t for t in vars(sub).values())),
            scale).double()
        return y if out is None else out.copy_(y)

    narrow.plain = plain
    narrow.kernel = "K10"
    monkeypatch.setattr(cuda_multidim, "col", narrow)
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn: (fn(), 1.0)[1])
    with pytest.raises(chip_smoke.SmokeFailure, match="dns K10"):
        chip_smoke.dns_phase(pf, "cpu", ((8, 12, 16), 2, 1 / 1536), device="cpu")


def test_fp32_digests_are_bit_for_bit():
    """The digests hash the kernels' outputs: the same tree gives the same
    digests, a table off by one float32 ulp another; the inputs depend on no
    random generator."""
    cases = [("K9", 180, 6), ("K9", 512, 3), ("K10", 90, (2, 91))]
    first = chip_smoke.fp32_digests(pf, "cpu", cases)
    assert set(first) == {f"{k} n={n} {d}" for k, n, _ in cases
                          for d in ("forward", "backward")}
    assert chip_smoke.fp32_digests(pf, "cpu", cases) == first
    x = chip_smoke.hashed_uniform(1000, 3, device="cpu")
    assert torch.equal(x, chip_smoke.hashed_uniform(1000, 3, device="cpu"))
    assert x.min() >= -1 and x.max() < 1 and x.std() > 0.5
    assert not torch.equal(x, chip_smoke.hashed_uniform(1000, 4, device="cpu"))
    assert len({tuple(k for k, n, _ in chip_smoke.FP32_DIGEST_CASES)}) == 1


def test_k10_phase_checks_and_times_each_case(monkeypatch, capsys):
    """The K10 phase on the CPU at its lengths and precisions, cut to two
    batches of 5 to 7 columns (timer stubbed): every case passes its plain
    version, ``torch.fft`` and the in-place check both ways, and prints one
    line a direction with its multiple of the byte bound; the phase's
    shapes are the AFNO and DNS cells' column steps."""
    calls = []
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn: (calls.append(fn()), 1.0)[1])
    cases = [((2, L, 5 + i), dtype)
             for i, ((_, L, _), dtype) in enumerate(chip_smoke.K10_ALONE)]
    out = chip_smoke.k10_phase(pf, "cpu", cases, device="cpu")
    assert len(out) == 2 * len(cases)
    assert all(set(ms) == {"kernel", "plain", "torch.fft"} for ms in out.values())
    assert len(calls) == 6 * len(cases)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("alone  K10")]
    assert len(lines) == 2 * len(cases) and all("x bound" in ln for ln in lines)
    assert chip_smoke.K10_ALONE == [((12288, 90, 91), torch.float32),
                                    ((512, 512, 257), torch.float64),
                                    ((1, 512, 131584), torch.float64)]


@pytest.mark.parametrize("fault,match", [("zeros", r"max\|kernel - plain\|"),
                                         ("in place", "in place differs")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k10_phase_rejects_a_faulty_kernel(monkeypatch, fault, match, dtype):
    from portfft_tpu_torch.ops import cuda_multidim

    col = cuda_multidim.col

    def faulty(raw, *a, out=None):
        if fault == "zeros" or out is raw:
            return torch.zeros_like(raw) if out is None else out.zero_()
        return col(raw, *a, out=out)

    faulty.plain = col.plain
    faulty.kernel = "K10"
    monkeypatch.setattr(cuda_multidim, "col", faulty)
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn: (fn(), 1.0)[1])
    with pytest.raises(chip_smoke.SmokeFailure, match=match):
        chip_smoke.k10_phase(pf, "cpu", [((2, 90, 5), dtype)], device="cpu")


def test_md2_phase_checks_and_times_each_case(monkeypatch, capsys):
    """The K11 phase on the CPU at its planes, cut to one or two transforms (timer
    stubbed): every case passes its plain version, ``torch.fft.fft2`` and
    the in-place check both ways, and prints one line a direction with its
    path and multiple of the byte bound; the phase's first shape is the BCDI
    cell's K11 step."""
    calls = []
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn: (calls.append(fn()), 1.0)[1])
    cases = ([(1 + i, n1, n2) for i, (_, n1, n2) in enumerate(chip_smoke.MD2_ALONE)]
             + [(2, 128, 128)])
    out = chip_smoke.md2_phase(pf, "cpu", cases, device="cpu")
    assert len(out) == 2 * len(cases)
    assert all(set(ms) == {"kernel", "plain", "torch.fft"} for ms in out.values())
    assert len(calls) == 6 * len(cases)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("alone  K11")]
    assert len(lines) == 2 * len(cases) and all("x bound" in ln for ln in lines)
    assert sum(" spill " in ln for ln in lines) == 4
    assert sum(" resident " in ln for ln in lines) == 2
    assert chip_smoke.MD2_ALONE == [(512, 512, 512), (256, 512, 512)]


@pytest.mark.parametrize("fault,match", [("zeros", r"max\|kernel - plain\|"),
                                         ("in place", "in place differs"),
                                         ("conjugate", "eps of max")])
def test_md2_phase_rejects_a_faulty_kernel(monkeypatch, fault, match):
    from portfft_tpu_torch.ops import cuda_multidim

    md2 = cuda_multidim.md2

    def faulty(raw, *a, out=None):
        if fault == "zeros" or (fault == "in place" and out is raw):
            return torch.zeros_like(raw) if out is None else out.zero_()
        return md2(raw, *a, out=out)

    # a plain version that agrees with the faulty kernel: only torch.fft
    # can catch a table of the other direction
    if fault == "conjugate":
        def faulty(raw, batch, s1, s2, scale, out=None):  # noqa: F811
            return md2(raw, batch, chip_smoke.conjugated(s1), s2, scale, out=out)
        faulty.plain = lambda raw, batch, s1, s2, scale: md2.plain(
            raw, batch, chip_smoke.conjugated(s1), s2, scale)
    else:
        faulty.plain = md2.plain
    faulty.kernel = "K11"
    monkeypatch.setattr(cuda_multidim, "md2", faulty)
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn: (fn(), 1.0)[1])
    with pytest.raises(chip_smoke.SmokeFailure, match=match):
        chip_smoke.md2_phase(pf, "cpu", [(1, 128, 128)], device="cpu")
