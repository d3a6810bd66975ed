"""The route of every entry kind, pinned kernel by kernel on the CPU.

Each case commits a descriptor on the CPU (with tuning entries recorded in a
temporary cache where the case names them), runs both directions once, and
records every kernel wrapper that runs, in the order it runs, with the
arguments that choose the route: the wrapper's K-number (so the engine),
its scalar arguments (a batch tile, K8b's ``drop``, the scale) and the
class of each table it takes, with that table's float fields (K9 folds its
scale in) and the names of its non-empty tuple fields (K17's dense ``tw``
or factored ``q`` twiddle).  Every descriptor has a forward and a backward
scale of its own, so the step that carries each shows.  The tuning table's
outcomes at commit (``tracing.tuning_outcomes``) are pinned too.

The wrappers are observed through the span hook every wrapper calls while a
profiler records (``utils.tracing.run``): the test turns that hook on and
records instead of timing.  Nothing here reads a committed entry, so the
literals below hold whatever form the registry gives its routes.
"""

import dataclasses
import math
import types

import pytest
import torch

import portfft_tpu_torch as pf
from portfft_tpu_torch import tuning
from portfft_tpu_torch.utils import tracing

F, B = 0.5, 0.25  # the forward and backward scales of every case but fastMRI
ORTHO = 1.0 / math.sqrt(640 * 368)
BI = dict(forward_strides=[8], backward_strides=[8], forward_distance=1,
          backward_distance=1)


@pytest.fixture
def tmp_cache(tmp_path, monkeypatch):
    monkeypatch.delenv("PORTFFT_NO_TUNING", raising=False)
    monkeypatch.delenv("PORTFFT_BLUESTEIN_BF", raising=False)
    monkeypatch.setattr(tuning, "_USER_PATH", str(tmp_path / "port.json"))
    tuning._reset_for_tests()
    yield
    tuning._reset_for_tests()


def _summary(v):
    """A route-choosing view of one wrapper argument, or None for data."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if dataclasses.is_dataclass(v):
        fields = [(f.name, getattr(v, f.name)) for f in dataclasses.fields(v)]
        return (type(v).__name__,
                *(x for _, x in fields if type(x) is float),
                *(name for name, x in fields if isinstance(x, tuple) and x))
    return None


def _record(monkeypatch) -> list:
    """Turn the wrappers' span hook on and record ``(K, *args)`` of every
    wrapper call in order."""
    seen = []

    def run(name, fn, *args, note="", **kwargs):
        kernel = name[len(tracing.PREFIX):]
        if kernel in tracing.KERNELS:
            shown = [_summary(a) for a in args[1:]]
            shown += [f"{k}={_summary(v) if _summary(v) is not None else 'set'}"
                      for k, v in sorted(kwargs.items())
                      if k != "out" and v is not None]
            seen.append((kernel, *(s for s in shown if s is not None)))
        return fn(*args, **kwargs)

    monkeypatch.setattr(tracing, "PROFILER",
                        types.SimpleNamespace(_is_profiler_enabled=True))
    monkeypatch.setattr(tracing, "run", run)
    return seen


def _inputs(desc, direction):
    """One direction's input, made from a seed: raw (re, im) pairs, a SPLIT
    (re, im) pair, or REAL forward's real rows."""
    count = desc.get_input_count(direction)
    gen = torch.Generator().manual_seed(7)
    if desc.complex_storage == pf.ComplexStorage.SPLIT_COMPLEX:
        return (torch.empty(count).uniform_(-1, 1, generator=gen),
                torch.empty(count).uniform_(-1, 1, generator=gen))
    real = desc.domain == pf.Domain.REAL and direction == pf.Direction.FORWARD
    return (torch.empty(count * (1 if real else 2)).uniform_(-1, 1, generator=gen),)


# (id, descriptor fields, tuning entries recorded before the commit)
ROUTES = [
    # 1D DIRECT: K1
    ("direct_256", dict(lengths=[256], number_of_transforms=2), []),
    # 1D FUSED [32, 128]: K2 static; K2-v2 at a tuned tile; K2-v3 whose
    # tuned tile the batch cannot take (the kernel picks); K2-v1 where a
    # has no fold
    ("fused_4096", dict(lengths=[4096], number_of_transforms=2), []),
    ("fused_4096_v2", dict(lengths=[4096], number_of_transforms=4),
     [("fused2", "n4096", {"eng": 2, "bt": 2})]),
    ("fused_4096_v3_tile_dropped", dict(lengths=[4096], number_of_transforms=2),
     [("fused2", "n4096", {"eng": 3, "bt": 32})]),
    ("fused_640_v1", dict(lengths=[640], number_of_transforms=2),
     [("fused2", "n640", {"eng": 2})]),
    # 1D GLOBAL 256 x 256: K3 static; K5-ov, K17 factored and K4 tuned; a
    # stale K4 past its cluster at 2^18 (K3 runs)
    ("global_65536", dict(lengths=[65536]), []),
    ("global_65536_k5ov", dict(lengths=[65536]),
     [("global2", "n65536_g256x256", {"eng": 7, "ov": 1})]),
    ("global_65536_k17ftw", dict(lengths=[65536]),
     [("global2", "n65536_g256x256", {"eng": 6, "ftw": 1})]),
    ("global_65536_k17", dict(lengths=[65536]),
     [("global2", "n65536_g256x256", {"eng": 6})]),
    ("global_262144_stale_k4", dict(lengths=[1 << 18]),
     [("global2", "n262144_g512x512", {"eng": 5})]),
    # the plane path: a Bluestein prime on K15, a FUSED [125, 8] chain on
    # K13, and a GLOBAL whose Bluestein sub runs in the executor's glue
    ("plane_65537", dict(lengths=[65537]), []),
    ("plane_1000", dict(lengths=[1000], number_of_transforms=2), []),
    ("plane_2062_nested", dict(lengths=[2062], number_of_transforms=2), []),
    # the per-axis walk: fastMRI's slice at the orthonormal scale (its 640
    # axis on K13's column form), a SPLIT transform whose outer axis runs on
    # K12, one whose outer DIRECT 100 K12 declines (K13's column form, the
    # scale in it), and one whose outer Bluestein axis stays on movedim
    ("core_fastmri", dict(lengths=[640, 368], forward_scale=ORTHO,
                          backward_scale=ORTHO), []),
    ("core_split_k12", dict(lengths=[128, 256], number_of_transforms=2,
                            complex_storage=pf.ComplexStorage.SPLIT_COMPLEX), []),
    ("core_split_k13col", dict(lengths=[100, 256], number_of_transforms=2,
                               complex_storage=pf.ComplexStorage.SPLIT_COMPLEX), []),
    ("core_split_movedim", dict(lengths=[1031, 16],
                                complex_storage=pf.ComplexStorage.SPLIT_COMPLEX), []),
    # multi-dim: K11 and K10; the last axis's kernel and K10 (no md2);
    # K11 turned off and K10-mm on by a tuned entry
    ("multidim_md2", dict(lengths=[2, 128, 128], number_of_transforms=2), []),
    ("multidim_per_axis", dict(lengths=[100, 256], number_of_transforms=2), []),
    ("multidim_cm", dict(lengths=[512, 512]),
     [("multidim", "n512x512", {"m2": 0, "cm": 1})]),
    # BATCH_INTERLEAVED: one K10 call; a strided layout (K7 around K1); an
    # offset layout (views around K2)
    ("bi_col_256", dict(lengths=[256], number_of_transforms=8, **BI), []),
    ("bi_col_256_cm", dict(lengths=[256], number_of_transforms=8, **BI),
     [("bi_col", "n256", {"cm": 1})]),
    ("layout_strided", dict(lengths=[256], number_of_transforms=2,
                            forward_strides=[2], forward_distance=512), []),
    ("layout_offset", dict(lengths=[4096], number_of_transforms=2,
                           forward_offset=3, backward_offset=5), []),
    # REAL: K9; the half length on K1 with K8b dropping the two bins; on
    # K2; on the plane path (K15); on the plane path with K8a-w
    ("real_32", dict(lengths=[32], number_of_transforms=2, domain=pf.Domain.REAL), []),
    ("real_768_drop", dict(lengths=[768], number_of_transforms=2,
                           domain=pf.Domain.REAL), []),
    ("real_8192", dict(lengths=[8192], number_of_transforms=2, domain=pf.Domain.REAL),
     []),
    ("real_8192_v2", dict(lengths=[8192], number_of_transforms=4,
                          domain=pf.Domain.REAL),
     [("fused2", "n4096", {"eng": 2, "bt": 2})]),
    ("real_131074_plane", dict(lengths=[2 * 65537], domain=pf.Domain.REAL), []),
    ("real_wide", dict(lengths=[2 * 2048 * 521], number_of_transforms=8,
                       domain=pf.Domain.REAL), []),
]


# What each case ran on the CPU, recorded once: (the tuning outcomes at
# commit, the forward kernels, the backward kernels).
PINNED = {'bi_col_256': ({'miss': 1},
                [('K10', 1, 8, ('SubTables',), 0.5)],
                [('K10', 1, 8, ('SubTables',), 0.25)]),
 'bi_col_256_cm': ({'hit': 1},
                   [('K10-mm', 1, 8, ('SubTables',), 0.5)],
                   [('K10-mm', 1, 8, ('SubTables',), 0.25)]),
 'core_fastmri': ({},
                  [('K6-de',),
                   ('K13', ('ChainTables',)),
                   ('K13', 1, 368, ('ChainTables', 'factors', 'stages'), 1.0),
                   ('K6-in', 0.0020605639793618343)],
                  [('K6-de',),
                   ('K13', ('ChainTables',)),
                   ('K13', 1, 368, ('ChainTables', 'factors', 'stages'), 1.0),
                   ('K6-in', 0.0020605639793618343)]),
 'core_split_k12': ({},
                    [('K13', ('ChainTables',)), ('K12', 2, 256, ('SubTables',), 0.5)],
                    [('K13', ('ChainTables',)), ('K12', 2, 256, ('SubTables',), 0.25)]),
 'core_split_k13col': ({},
                       [('K13', ('ChainTables',)), ('K13', 2, 256, ('ChainTables',), 0.5)],
                       [('K13', ('ChainTables',)), ('K13', 2, 256, ('ChainTables',), 0.25)]),
 'core_split_movedim': ({},
                        [('K13', ('ChainTables',)),
                         ('K13', ('ChainTables',)),
                         ('K13', ('ChainTables',))],
                        [('K13', ('ChainTables',)),
                         ('K13', ('ChainTables',)),
                         ('K13', ('ChainTables',))]),
 'direct_256': ({}, [('K1', 2, ('SubTables',), 0.5)], [('K1', 2, ('SubTables',), 0.25)]),
 'fused_4096': ({'miss': 1}, [('K2', 2, ('SubTables',), 0.5)], [('K2', 2, ('SubTables',), 0.25)]),
 'fused_4096_v2': ({'hit': 1},
                   [('K2-v2', 4, ('SubTables',), 2, 0.5)],
                   [('K2-v2', 4, ('SubTables',), 2, 0.25)]),
 'fused_4096_v3_tile_dropped': ({'hit': 1},
                                [('K2-v3', 2, ('SubTables',), 2, 0.5)],
                                [('K2-v3', 2, ('SubTables',), 2, 0.25)]),
 'fused_640_v1': ({'hit': 1},
                  [('K2-v1', 2, ('SubTables',), 0.5)],
                  [('K2-v1', 2, ('SubTables',), 0.25)]),
 'global_262144_stale_k4': ({'declined': 1},
                            [('K3', 1, ('SubTables',), ('SubTables',), 0.5)],
                            [('K3', 1, ('SubTables',), ('SubTables',), 0.25)]),
 'global_65536': ({'miss': 1},
                  [('K3', 1, ('SubTables',), ('SubTables',), 0.5)],
                  [('K3', 1, ('SubTables',), ('SubTables',), 0.25)]),
 'global_65536_k17': ({'hit': 1},
                      [('K17', 1, ('GlobalFusedTables', 'tw'), 0.5)],
                      [('K17', 1, ('GlobalFusedTables', 'tw'), 0.25)]),
 'global_65536_k17ftw': ({'hit': 1},
                         [('K17', 1, ('GlobalFusedTables', 'q', 'factors'), 0.5)],
                         [('K17', 1, ('GlobalFusedTables', 'q', 'factors'), 0.25)]),
 'global_65536_k5ov': ({'hit': 1},
                       [('K5-ov', 1, ('BfTables', 'w128', 'u1', 'u2', 'ga', 'gb'), 0.5)],
                       [('K5-ov', 1, ('BfTables', 'w128', 'u1', 'u2', 'ga', 'gb'), 0.25)]),
 'layout_offset': ({'miss': 1},
                   [('K2', 2, ('SubTables',), 0.5)],
                   [('K2', 2, ('SubTables',), 0.25)]),
 'layout_strided': ({},
                    [('K7-de', 0, 2, 512, 256, 2), ('K1', 2, ('SubTables',), 0.5)],
                    [('K1', 2, ('SubTables',), 0.25),
                     ('K7-re', 0, 2, 512, 256, 2, 'fill_gaps=True')]),
 'multidim_cm': ({'hit': 1},
                 [('K1', 512, ('SubTables',), 1.0), ('K10-mm', 1, 512, ('SubTables',), 0.5)],
                 [('K1', 512, ('SubTables',), 1.0), ('K10-mm', 1, 512, ('SubTables',), 0.25)]),
 'multidim_md2': ({'miss': 1},
                  [('K11', 4, ('SubTables',), ('SubTables',), 1.0),
                   ('K10', 2, 16384, ('SubTables',), 0.5)],
                  [('K11', 4, ('SubTables',), ('SubTables',), 1.0),
                   ('K10', 2, 16384, ('SubTables',), 0.25)]),
 'multidim_per_axis': ({'miss': 1},
                       [('K1', 200, ('SubTables',), 1.0), ('K10', 2, 256, ('SubTables',), 0.5)],
                       [('K1', 200, ('SubTables',), 1.0), ('K10', 2, 256, ('SubTables',), 0.25)]),
 'plane_1000': ({},
                [('K6-de',), ('K13', ('ChainTables', 'factors', 'stages')), ('K6-in', 0.5)],
                [('K6-de',), ('K13', ('ChainTables', 'factors', 'stages')), ('K6-in', 0.25)]),
 'plane_2062_nested': ({},
                       [('K6-de',),
                        ('K13', ('ChainTables',)),
                        ('K13', ('ChainTables',)),
                        ('K13', ('ChainTables',)),
                        ('K6-in', 0.5)],
                       [('K6-de',),
                        ('K13', ('ChainTables',)),
                        ('K13', ('ChainTables',)),
                        ('K13', ('ChainTables',)),
                        ('K6-in', 0.25)]),
 'plane_65537': ({},
                 [('K6-de',),
                  ('K15', ('BluesteinTables', 'pre', 'twf', 'hat', 'twb', 'fin'), 'scale=1.0'),
                  ('K6-in', 0.5)],
                 [('K6-de',),
                  ('K15', ('BluesteinTables', 'pre', 'twf', 'hat', 'twb', 'fin'), 'scale=1.0'),
                  ('K6-in', 0.25)]),
 'real_131074_plane': ({},
                       [('K6-de',),
                        ('K15',
                         ('BluesteinTables', 'pre', 'twf', 'hat', 'twb', 'fin'),
                         'scale=1.0'),
                        ('K6-in', 1.0),
                        ('K8a', 1, 65537, 0.5)],
                       [('K8b', 1, 65537, 0.25, False),
                        ('K6-de',),
                        ('K15',
                         ('BluesteinTables', 'pre', 'twf', 'hat', 'twb', 'fin'),
                         'scale=1.0'),
                        ('K6-in', 1.0)]),
 'real_32': ({}, [('K9', 2, ('SmallRealTables', 0.5))], [('K9', 2, ('SmallRealTables', 0.25))]),
 'real_768_drop': ({},
                   [('K1', 2, ('SubTables',), 1.0), ('K8a', 2, 384, 0.5)],
                   [('K8b', 2, 384, 0.25, True), ('K1', 2, ('SubTables',), 1.0)]),
 'real_8192': ({'miss': 1},
               [('K2', 2, ('SubTables',), 1.0), ('K8a', 2, 4096, 0.5)],
               [('K8b', 2, 4096, 0.25, False), ('K2', 2, ('SubTables',), 1.0)]),
 'real_8192_v2': ({'hit': 1},
                  [('K2-v2', 4, ('SubTables',), 2, 1.0), ('K8a', 4, 4096, 0.5)],
                  [('K8b', 4, 4096, 0.25, False), ('K2-v2', 4, ('SubTables',), 2, 1.0)]),
 'real_wide': ({},
               [('K6-de',),
                ('K13', ('ChainTables',)),
                ('K13', ('ChainTables',)),
                ('K13', ('ChainTables',)),
                ('K6-in', 1.0),
                ('K8a-w', 8, 1067008, 0.5)],
               [('K8b', 8, 1067008, 0.25, False),
                ('K6-de',),
                ('K13', ('ChainTables',)),
                ('K13', ('ChainTables',)),
                ('K13', ('ChainTables',)),
                ('K6-in', 1.0)])}


def _route(monkeypatch, fields, tuned):
    """``(tuning outcomes at commit, forward calls, backward calls)``."""
    for kind, key, params in tuned:
        tuning.record("cpu", kind, key, params)
    fields = {"forward_scale": F, "backward_scale": B, **fields}
    desc = pf.Descriptor(**fields)
    before = tracing.tuning_outcomes()
    plan = desc.commit(device="cpu")
    after = tracing.tuning_outcomes()
    outcomes = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    calls = []
    with monkeypatch.context() as patched:
        seen = _record(patched)
        for direction in pf.Direction:
            del seen[:]
            compute = (plan.compute_forward if direction == pf.Direction.FORWARD
                       else plan.compute_backward)
            compute(*_inputs(desc, direction))
            calls.append(list(seen))
    return outcomes, calls[0], calls[1]


@pytest.mark.parametrize("name,fields,tuned", ROUTES, ids=[r[0] for r in ROUTES])
def test_route_of_every_entry_kind(tmp_cache, monkeypatch, name, fields, tuned):
    assert _route(monkeypatch, fields, tuned) == PINNED[name]
