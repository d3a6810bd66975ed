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
   and in its chain mode at n = 1000.  K13's column form at
   ``CHAIN_COLS_CASES`` (down axis 1 of (bpre, n, trailing) planes, a scale
   of 0.5) against its plain version and ``fft`` over that axis, with the
   same planted faults, each call counted on the ``radix_col`` path; timed
   alone at fastMRI's 525 x 640 x 368 beside the row form on the moved
   planes and the four copies of the move.  Then K7 (destride, and restride
   with fill_gaps on and off) at the layouts of ``STRIDE_CASES``, held to
   its plain version exactly (max|kernel - plain| = 0), each check
   rejecting a run at the offset plus one and an all-zero output; K7's
   destride is timed alone at strided_large's input beside one
   ``as_strided(...).contiguous()`` of the same view.
4. Main-path phases, C2C, REAL, multi-dim, then the plane path:
   ``Descriptor(...).commit(device="cuda")`` and
   ``compute_forward``/``compute_backward`` on a float32 tensor on the
   card, for the C2C bench rows, then for the four REAL bench rows and
   real_large backward, then for the three ``MULTIDIM_CONFIGS`` rows,
   md_1024x1024 backward, the BATCH_INTERLEAVED row bi_4096 and, with
   tuning on, md_256x256 (``MD_SHIPPED``: the shipped table leaves it on
   K11, which must launch), then for
   ``PLANE_ROWS`` (large_1d_prime 65537x2048 both ways through K6, K15,
   K6; n = 1031, 1000 and 2062 at about 1 GiB through K6, K13 and the
   executor's glue, K6), then for ``SPLIT_ROWS`` (SPLIT_COMPLEX planes in
   and out: K14, K13, K15 and K12 under the per-axis walk) and
   ``PLANE_MORE_ROWS`` (interleaved rows the raw kernels decline: a
   multi-dim shape through K12, the nested GLOBAL 12232320 and the
   Bluestein length 50431897 through K14), each with its peak device
   memory.  Each phase
   resets the launch counts just before and reads them just after; each
   row's kernels (for a REAL row, its K8 or K9 and the C2C kernel under it;
   for a multi-dim row, every kernel of its route) must have launched.  A
   sample of transforms is held to ``torch.fft`` at the absolute
   2·eps·N·log2(N) per element.  The kernel path, the plain path and one
   ``torch.fft`` call of the same function (the yardstick; the port never
   calls it) are timed with CUDA events (3 warm-up calls, median of 10).
5. K14/K12 kernel phase, after the rows (its K14 post case at 16384 x 8192
   reads the tables of bluestein_50431897's plan): K14 at
   ``GLOBAL_PLANES_CASES`` and K12 at ``AXIS_CASES``, both directions,
   against their plain versions and ``torch.fft`` (K14 with post: ``fft``
   times the post table), with the two planted faults; K14 timed alone at
   split_large_1d's shape, K12 at split_md_1024x1024's column pass.  Then
   the layout main path, ``LAYOUT_ROWS``: strided input (K7 → K3), strided
   output (K3 → K7 with fill_gaps), BATCH_INTERLEAVED input only (K7's
   tile mapping → K2), BATCH_INTERLEAVED at 65536, which K10 declines
   (K7 → K3 → K7), offsets with a sentinel-filled out= tensor (K3 on the
   views) and SPLIT strided planes (K7 → K13 → K7), each held to
   ``torch.fft`` on a sample of rows, with every element outside the
   output layout 0 (no out=) or the sentinel (out=), its launches and its
   peak device memory.
6. The tuned GLOBAL engines.  Every phase above runs with
   ``PORTFFT_NO_TUNING=1`` (the static routes: K3 for GLOBAL plans), and
   ``PORTFFT_TUNING_CACHE`` points at a temporary file removed at the end.
   Kernel phase: K4 ``global_sq``, K5 ``global_bf`` and K5-ov
   ``global_bf_ov`` at every (G1, G2) the tuned rows give them
   (``tuned_cases``), both directions with a folded scale, against their
   plain versions and ``torch.fft`` with two planted faults (K5: its low
   twiddle factor GB conjugated); each timed alone at ``TUNED_ALONE``
   (2^27 points).  Tuned layout rows, ``TUNED_LAYOUT``: the layout rows
   at 65536 with tuning on and only the shipped table, each held to the
   engine that table names for its plan (K17) and then run as on the
   layout main path (launches, oracle, gaps, times).  Main path,
   ``TUNED_ROWS`` (large_1d and the ladder
   2^17–2^20 at about 1 GiB), with tuning on: each engine whose gate takes
   the row's plan is forced by a recorded tuning entry and the committed
   plan held to ``torch.fft`` and timed, with its peak device memory; then
   ``plan.autotune()`` races the engines, every variant's ms and the
   winner are printed, and the tuned plan is held and timed again.  The
   last of these lines gives every row's winner as the JSON that
   ``portfft_tpu_torch/tuning_defaults.json`` holds.
7. The FUSED engines.  Kernel phase: K2-v1 ``fused2_v1``, K2-v2
   ``fused2_v2`` and K2-v3 ``fused2_v3`` at ``FUSED_KERNEL_CASES`` (K2-v2
   and K2-v3 at a = 8, 32, 64, 128; K2-v1 at a = 5, 24, 96 and 32), both
   directions with a scale, each at the tile it picks, against its plain
   version and ``torch.fft`` with the two planted faults (its inner twiddle
   conjugated, zeros); each timed alone at ``FUSED_ALONE`` (K2-v2 and
   K2-v3 at 4096 x 32Ki, K2-v1 at 3072 x 32768).  Shipped rows,
   ``FUSED_SHIPPED``: real_large and bi_in_4096 with tuning on and only
   the shipped table, each held to the engine that table names for n4096,
   then to ``torch.fft``.  Tuned FUSED main path, ``TUNED_FUSED_ROWS``
   (a = 8 … 256 and the no-fold 3072, 12288 at 0.75–1 GiB): each engine
   the row's ``fused2`` entry can reach is forced by a recorded entry,
   held and timed; ``plan.autotune()`` races K2 and every engine at every
   tile its gate takes (a variant its parity gate drops fails the run)
   and prints each variant's ms and the winner; the line "autotune winners
   (fused2, ...)" is the JSON of ``tuning_defaults.json``'s
   ``cuda_h100.fused2`` (rows K2 won are left out).
8. The tensor-core kernels.  Kernel phase: K10-mm ``col_mm`` at the
   (bpre, L, rest) views of ``MMA_COL_CASES`` and K16 ``global3`` at the
   (n, batch) of ``MMA_GLOBAL_CASES``, both directions with a scale,
   against their plain versions (which emulate the TF32 hi/lo rounding) and
   ``torch.fft`` with the two planted faults (K10-mm: its roots or inner
   twiddle conjugated; K16: its high twiddle factor B2); the lengths
   K10-mm's gate declines among K10's are printed.  K10-mm is timed beside
   K10 at every case, and each kernel alone at ``MMA_ALONE`` beside the
   kernel it stands in for (K10; K3 and K5-ov).  Their bound is every C2C
   kernel's: the function's bytes and 5·N·log2 N flops at fp32.  Tuned
   multi-dim main path, ``MD_ROWS`` with tuning on: each variant of the
   row's ``multidim`` or ``bi_col`` entry (``{}``, ``{"cm": 1}``,
   ``{"m2": 0}``, ``{"m2": 0, "cm": 1}`` where they change a kernel) is
   forced by a recorded entry, must launch its kernels, is held to
   ``torch.fft`` and timed; then ``plan.autotune()`` races them and the
   line "autotune winners (multidim/bi_col, ...)" gives the winners.  The
   tuned GLOBAL main path (6.) forces and races K16 (``{"eng": 3}``) beside
   K3, K4, K5 and K5-ov.
9. The last GLOBAL engines, K17 ``global_fused`` (dense twiddle, and
   factored: ``{"eng": 6, "ftw": 1}``), K18 ``global_ilv`` (mixed radix)
   and K19 ``global_bf2``, run in the phases of 6.: the kernel phase holds
   each at every (G1, G2) of ``TUNED_ROWS`` its gate takes, both
   directions, against its plain version and ``torch.fft`` with the two
   planted faults (K17: its twiddle, or the factored mode's per-tile
   factors, conjugated; K18: GB; K19: its factor B1ᵀ), and times each
   alone at 2^17 x 1024 beside K3, K5-ov and K16; the tuned main path
   forces each (K17 in both modes) on every row its gate takes and races
   them, ``TUNED_ROWS`` now with the mixed-radix rows mixed_147456
   (384 x 384) and mixed_196608 (512 x 384), where K3, K16, K17 and K18
   race.  Then the wrappers, ``WRAPPER_ROWS``: real_131072 and
   strided_large with each of K17, K18 and K19 forced on their 65536
   entry, run as on the REAL and layout main paths (the engine launched
   under K8a and K7).
10. The REAL plane path (the REAL lengths whose half length h needs the
   plane path) and the last three Pallas pieces.  K3-ftw ``global2_ftw``
   (K3 with its twiddle formed from the factored tables, ``{"eng": 2,
   "ftw": 1}``) runs in the phases of 6.: checked at every ``TUNED_ROWS``
   split, timed alone at 2^17 x 1024 beside K3, forced and raced on the
   tuned main path.  After the layout rows, the REAL plane kernel phase:
   K8a-w ``untangle_wide`` at ``WIDE_CASES``, K8b with its flag at
   ``DROP_CASES`` (spectra whose Im X[0] and Im X[n/2] are not 0: dropped
   below n = 1024, kept from there on, ``c2r_reference``) and K15-bf
   ``bluestein_bf`` at ``BLUESTEIN_BF_CASES`` (slab factors 3·3, 2·2,
   16·2, 16·16), each against its plain version and the oracle with the two
   planted faults (K8a-w: the post-twiddle; K15-bf: its pass-1 chirp),
   K8a-w timed alone beside K8a and K15-bf beside K15.  Then the REAL plane
   main path, ``REAL_PLANE_ROWS`` at about 1 GiB in (h = 600 on K13's chain
   mode both ways; 2·65537 both ways on K15 and, with
   ``PORTFFT_BLUESTEIN_BF`` set at commit, on K15-bf; 4·65537 on the
   generic glue around K15; 2^28 on K14; 4222976 x 64 with K8a-w), backward
   on spectra whose two bins are not 0, with its peak memory and its host
   commit time.
11. Multi-dim REAL: FourCastNet's AFNO call (``AFNO``, 12288 x 90 x 180,
   both directions, ``afno_phase``): K9 at 180 and K10 at (12288, 90, 91),
   each held to its plain version and timed alone, and for the record K13's
   column form with K6 around it on the same half spectrum, held to K10's
   result; the whole call held to ``torch.fft`` on its first rows and timed
   beside one ``rfft2``/``irfft2`` call.  One ``afno`` line a direction.
   Then K9 alone (``k9_phase``) at ``K9_ALONE``: r2c's 32 x 2Mi and 512 x
   256Ki, AFNO's 180 over 1,105,920 rows and the prime h = 251 and 127,
   both directions, each held to its plain version and timed beside its
   byte bound (``python -c "import chip_smoke, portfft_tpu_torch as pf;
   chip_smoke.k9_phase(pf, 'card')"`` runs it alone).
   Then fp64 (``dns_phase``): the Taylor-Green DNS call (``DNS``, one 512^3
   component, ``rfftn``/``irfftn`` with the backward scale 1/N^3, the
   benchmark cell ``taylor_green_dns.stage``): its three steps, K9 at 512 in
   double over 262,144 rows and K10 in double down (512, 512, 257) and (1,
   512, 131584), each held to its plain version in float64 and timed alone;
   the whole call held to ``torch.fft`` in complex128 (the widest |error| as
   a share of the reference's root mean square, the benchmark's measure)
   with one K9 ``radix_f64`` and two K10 ``radix_f64`` launches and no
   float32 launch, timed beside one ``torch.fft`` call and the call's byte
   bound.  One ``dns`` line a direction (``python -c "import chip_smoke,
   portfft_tpu_torch as pf; chip_smoke.dns_phase(pf, 'card')"`` runs it
   alone).  Then K10 alone (``k10_phase``) at ``K10_ALONE``: AFNO's (12288,
   90, 91) in float32 and DNS's (512, 512, 257) and (1, 512, 131584) in
   float64, both directions, each held to its plain version and to
   ``torch.fft`` along the axis in complex128, in place once, and timed
   beside its byte bound, its plain version and one ``torch.fft`` call
   along the axis (``python -c "import chip_smoke, portfft_tpu_torch as pf;
   chip_smoke.k10_phase(pf, 'card')"`` runs it alone).  ``fp32_digests``
   gives the SHA-256 of K9's and K10's float32 outputs at AFNO's and r2c's
   shapes on inputs that depend on no random generator, so that two trees'
   kernels can be compared bit for bit.  Then K1 alone (``k1_phase``) at
   ``K1_ALONE``: c2c_1d.bulk's 16 x 8Mi and 256 x 512Ki, both directions,
   each held to its plain version and to ``torch.fft`` in complex128, in
   place once, one ``radix`` launch a call, and timed beside its byte bound,
   its plain version and one ``torch.fft`` call (``python -c "import
   chip_smoke, portfft_tpu_torch as pf; chip_smoke.k1_phase(pf, 'card')"``
   runs it alone).
12. Prints the kernel table as one JSON line (each kernel's launches on the
   main path, largest error against its plain version, ms, plain ms, bound
   ms and library ms; twenty-eight kernels), then, as the last line, ``{"ok":
   true, "device": {...}}``.  Any failure exits non-zero before that line.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
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
# n2): md_512x512, the trailing pair of md_128^3 (the whole transform in
# shared memory), FUSED phases A and B, and md_256x256 of ``MD_SHIPPED``.
MD_COL_CASES = [(64, 1024, 1024), (32, 128, 16384), (1, 4096, 32768),
                (4, 100, 4096), (1, 8192, 2048), (2, 16384, 512)]
MD2_CASES = [(256, 512, 512), (4096, 128, 128), (64, 1024, 128),
             (64, 128, 1024), (1024, 256, 256)]
# Multi-dim rows run with tuning on and only the shipped table, which names
# no entry for their shape, so they keep the static route: md_256x256 (2^26
# points, 0.5 GiB in) on K11, checked at its shape in ``MD2_CASES``.
MD_SHIPPED = [("md_256x256", (256, 256), 1024, "forward", False)]
# The cases timed alone: md_1024x1024's column pass and md_512x512.
MD_ALONE = {"col": (64, 1024, 1024), "md2": (256, 512, 512)}
# The transformed axes of each kernel's complex (b, ., .) view.
MD_DIMS = {"col": (1,), "col_mm": (1,), "md2": (1, 2)}
# FourCastNet's AFNO block (the benchmark cell ``fourcastnet_afno.ensemble``):
# 16 members x 768 channels of 90 x 180 a call, rfft2/irfft2 at the
# orthonormal scale; the multi-dim REAL route, K9 then K10.
AFNO = ((90, 180), 12288, 1 / math.sqrt(90 * 180))
# The Taylor-Green DNS call (the benchmark cell ``taylor_green_dns.stage``):
# one 512^3 velocity component a call in float64, rfftn forward at scale 1
# and irfftn backward at 1/N^3; K9 at 512 then K10 on axes 1 and 0.
DNS = ((512, 512, 512), 1, 2.0**-27)
# The fp32 kernel outputs ``fp32_digests`` hashes: K9 at AFNO's REAL step
# and r2c's 512 spec, K10 down AFNO's half spectrum, both directions each.
FP32_DIGEST_CASES = [("K9", 180, 12288 * 90), ("K9", 512, 256 * 1024),
                     ("K10", 90, (12288, 91))]
# K9 timed alone (``k9_phase``): (n, batch) of r2c_1d.bulk's two K9 specs,
# AFNO's REAL step (180 over 12288·90 rows) and the prime h = 251 and 127,
# which K9 runs as one stage of pair sums.
K9_ALONE = [(32, 2 * 1024 * 1024), (512, 256 * 1024), (180, 12288 * 90),
            (502, 256 * 1024), (254, 512 * 1024)]
# K1 timed alone (``k1_phase``): (n, batch) of c2c_1d.bulk's two K1 specs.
K1_ALONE = [(16, 8 * 1024 * 1024), (256, 512 * 1024)]
# K10 timed alone (``k10_phase``, and ``chip_race.py`` ``col``): (bpre, L,
# rest) and precision of AFNO's column step and DNS's two.
K10_ALONE = [((12288, 90, 91), torch.float32), ((512, 512, 257), torch.float64),
             ((1, 512, 131584), torch.float64)]
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
# [120, 5] and the two-launch [81, 81, 3], and fastmri_knee.volume's two
# axes: DIRECT 368 on 336000 rows, the chain [5, 128] on 193200; K15 at
# (n, batch) over the convolutions 256 x 192, 384 x 384 and FUSED [16, 128]
# x 144.
IO_CASES = [1031 * 1000, 1 << 20, 65537 * 2048]
CHAIN_CASES = [(3, 1 << 20), (100, 1 << 17), (3072, 4096), (24576, 512),
               (1000, 8192), (600, 8192), (19683, 512), (368, 336000),
               (640, 193200)]
BLUESTEIN_CASES = [(20011, 512), (65537, 256), (131101, 64)]
# K13's column form (``cuda_chain.chain_cols``) at (bpre, n, trailing): the
# 640 axis where it lies in fastmri_knee.volume (525 x 640 x 368, 8-column
# tiles) and in plane_md_128x640x128 (12 x 640 x 128), a DIRECT axis over 21
# columns (the last tile partial) and the chain over 4 columns (a tile of
# whole rows); scale CHAIN_COLS_SCALE both ways.  Timed alone at fastMRI's
# shape, beside the row form on the moved planes and the four plane copies
# of the move there and back that the column form saves.
CHAIN_COLS_CASES = [(525, 640, 368), (12, 640, 128), (4096, 100, 21),
                    (8192, 640, 4)]
CHAIN_COLS_ALONE = (525, 640, 368)
CHAIN_COLS_SCALE = 0.5
# The measurement behind the column form's gate (``cuda_chain.cols_supported``,
# its ``COLS_MIN_POINTS``): (n, trailing) around the break-even against the
# walk's move, row form and move back, each over fastMRI's number of points.
CHAIN_COLS_GATE = [(640, 1), (640, 2), (640, 4), (368, 2), (368, 4), (100, 8),
                   (100, 16)]
# The shapes timed alone: K6 and K15 at large_1d_prime, K13 at the
# [24, 128] convolution of the bluestein_1031 row.
PLANE_ALONE = {"interleave": (65537 * 2048, 1), "chain": (3072, 1 << 17),
               "bluestein": (65537, 2048)}
# K13's general chain mode, timed alone beside the table's shape: the
# [125, 8] chain of the chain_1000 row.
CHAIN_MODE_ALONE = (1000, 1 << 17)
# SPLIT_COMPLEX main path (bench.py large_1d, the top of the ladder,
# medium_large_1d, large_1d_prime and two MULTIDIM_CONFIGS rows, about 1 GiB
# of planes in): name, lengths, batch, direction.  K14 with DIRECT subs and
# with a FUSED [16, 128] sub, K13 [32, 128], K15 on planes, K13 then K12
# FUSED, K13 then K12 DIRECT twice.
SPLIT_ROWS = [
    ("split_large_1d", (65536,), 2048, "forward"),
    ("split_large_1d_backward", (65536,), 2048, "backward"),
    ("split_2^20", (1 << 20,), 128, "forward"),
    ("split_4096", (4096,), 32768, "forward"),
    ("split_large_1d_prime", (65537,), 2048, "forward"),
    ("split_md_1024x1024", (1024, 1024), 64, "forward"),
    ("split_md_128^3", (128, 128, 128), 32, "forward"),
]
# Interleaved plane rows the raw kernels decline, about 1 GiB in: a
# multi-dim shape with an outer axis K10 does not take (K6, K13, K13's chain
# [5, 128] in column geometry, K12, K6), the nested GLOBAL length (K6, K14 on its
# inner 240 x 184, K13, K6) and a Bluestein length whose convolution has a
# [128, 128] sub (K6, K14 with post both ways, K6).
PLANE_MORE_ROWS = [
    ("plane_md_128x640x128", (128, 640, 128), 12, "forward"),
    ("nested_global_12232320", (12232320,), 8, "forward"),
    ("bluestein_50431897", (50431897,), 1, "forward"),
]
# K14 kernel phase: (g1, g2, batch, post): DIRECT subs (65536 = 256 x 256,
# split_large_1d), a FUSED sub (2^20 = [16, 128] x 512), the inner node of
# nested_global_12232320 at its batch 8 x 277 (DIRECT subs, 184 no power of
# two), the post tables of the 384 x 384 convolution of 65537 (b̂ forward,
# the final chirp backward) and those of the 16384 x 8192 convolution of
# bluestein_50431897 (a [128, 128] sub in two launches), on the tables of
# that row's plan.
GLOBAL_PLANES_CASES = [(256, 256, 2048, None), (2048, 512, 128, None),
                       (240, 184, 8 * 277, None), (384, 384, 512, 65537),
                       (16384, 8192, 1, 50431897)]
# K12 kernel phase at (bpre, L, rest): DIRECT 128 (both column passes of
# split_md_128^3, and the axis-0 pass of plane_md_128x640x128) and 256,
# FUSED [8, 128] (split_md_1024x1024), [24, 128] (24 does not divide 128)
# and [128, 128] in two launches.
AXIS_CASES = [(32, 128, 16384), (4096, 128, 128), (12, 128, 640 * 128),
              (64, 256, 4096), (64, 1024, 1024), (16, 3072, 1024),
              (4, 16384, 1024)]
# The shapes timed alone: K14 at split_large_1d, K12 at the column pass of
# split_md_1024x1024.
GLOBAL_PLANES_ALONE = (256, 256, 2048)
AXIS_ALONE = (64, 1024, 1024)
# K7 kernel phase: (name, (o, s, dist, n, batch), SPLIT planes).
# strided_large's input layout (s = 2, dist = 2n; strided_out_large's
# output), the minimal span dist = (n-1)·s + 1, s = 3 with an offset, the
# BATCH_INTERLEAVED sides of bi_in_4096 and bi_65536 (dist = 1, s = batch:
# the tile mapping) and split_strided_4096's planes.
STRIDE_CASES = [
    ("strided_large", (0, 2, 2 * 65536, 65536, 512), False),
    ("minimal_span", (0, 2, 2 * 65535 + 1, 65536, 512), False),
    ("odd_stride_offset", (7, 3, 3 * 4096 + 5, 4096, 4096), False),
    ("bi_in_4096", (0, 32768, 1, 4096, 32768), False),
    ("bi_65536", (0, 2048, 1, 65536, 2048), False),
    ("split_strided_4096", (0, 2, 8192, 4096, 32768), True),
]
# K7 is timed alone at strided_large's input.
STRIDE_ALONE = "strided_large"
# Layout rows, forward, about 1 GiB in (bench.py strided_large and its
# output-side twin at 65536 x 512; the bench's medium_large_1d and large_1d
# shapes in the other layouts): name, n, batch, SPLIT, descriptor fields,
# whether an out= buffer (sentinel-filled, on the card) is given.
LAYOUT_ROWS = [
    ("strided_large", 65536, 512, False,
     dict(forward_strides=[2], forward_distance=2 * 65536), False),
    ("strided_out_large", 65536, 512, False,
     dict(backward_strides=[2], backward_distance=2 * 65536), False),
    ("bi_in_4096", 4096, 32768, False,
     dict(forward_strides=[32768], forward_distance=1), False),
    ("bi_65536", 65536, 2048, False,
     dict(forward_strides=[2048], forward_distance=1, backward_strides=[2048],
          backward_distance=1), False),
    ("offset_out_large_1d", 65536, 2048, False,
     dict(forward_offset=1000, backward_offset=3), True),
    ("split_strided_4096", 4096, 32768, True,
     dict(forward_strides=[2], backward_strides=[2], forward_distance=8192,
          backward_distance=8192), False),
]
#: The value of every element of an out= buffer the layout does not address.
SENTINEL = -5.0
# The layout rows whose GLOBAL plan (65536 = 256 x 256) the shipped tuning
# table reroutes: run again with tuning on, through the shipped engine.
TUNED_LAYOUT = ("strided_large", "strided_out_large", "bi_65536",
                "offset_out_large_1d")
# Tuned main path (bench.py large_1d and LADDER_CONFIGS at about 1 GiB in,
# and two lengths whose subs are 3·2^k, 147456 = 384 x 384 and 196608 =
# 512 x 384, at 1.21 and 0.81 GB in): name, n, batch.  Each row runs every
# tuned engine its plan takes, forced by a recorded tuning entry, then
# autotune.  The kernel phase checks the tuned engines at the same shapes
# (tuned_cases): K4 at 256 x 256 and 512 x 256; K5, K5-ov and K19 at the
# five power-of-two splits; K17 (both twiddle modes) and K18 at all seven.
TUNED_ROWS = [
    ("large_1d", 65536, 2048), ("ladder_2^17", 1 << 17, 1024),
    ("ladder_2^18", 1 << 18, 512), ("ladder_2^19", 1 << 19, 256),
    ("ladder_2^20", 1 << 20, 128), ("mixed_147456", 147456, 1024),
    ("mixed_196608", 196608, 512),
]
# Timed alone at 2^27 points: K4 at large_1d, the others at the 2^17 row
# (K17, K18, K19 and K3-ftw beside K3, K5-ov and K16 there).
TUNED_ALONE = {"global_sq": (65536, 2048), "global_bf": (1 << 17, 1024),
               "global2_ftw": (1 << 17, 1024),
               "global_bf_ov": (1 << 17, 1024), "global_fused": (1 << 17, 1024),
               "global_fused_ftw": (1 << 17, 1024), "global_ilv": (1 << 17, 1024),
               "global_bf2": (1 << 17, 1024)}
# The wrappers carry a tuned engine: real_131072 (its h = 65536 is a global2
# entry) and strided_large (K7 around the 65536 entry) on each of K17, K18
# and K19, forced by a recorded entry.
WRAPPER_ROWS = ("real_131072", "strided_large")
WRAPPER_ENGINES = ("global_fused", "global_ilv", "global_bf2")
# The FUSED engines K2-v1, K2-v2 and K2-v3 (K2 is "fused2").
FUSED_KINDS = ("fused2_v1", "fused2_v2", "fused2_v3")
# Tuned FUSED main path (about 1 GiB in): name, n, batch.  medium_large_1d is
# bench.py's row (run both ways); the others span a = 8 … 256 and two a with
# no fold (3072, 12288), where engines 2 and 3 reach K2-v1.  Each row forces
# every engine its plan's tuned entry can reach, then races them.
TUNED_FUSED_ROWS = [
    ("fused_1024", 1024, 131072), ("medium_large_1d", 4096, 32768),
    ("fused_8192", 8192, 16384), ("fused_16384", 16384, 8192),
    ("fused_32768", 32768, 4096), ("fused_3072", 3072, 32768),
    ("fused_12288", 12288, 8192),
]
# FUSED kernel phase: (kind, n, batch).  K2-v2 and K2-v3 at a = 8, 32, 64 and
# 128 (at a = 256 no transform fits a block of either), K2-v1 at the no-fold
# a = 5, 24 and 96 and at a = 32, which has a fold; the tuned rows' shapes,
# and 640 at about 1 GiB.
FUSED_KERNEL_CASES = [
    ("fused2_v1", 640, 204800), ("fused2_v1", 3072, 32768),
    ("fused2_v1", 12288, 8192), ("fused2_v1", 4096, 32768),
    *[(kind, n, batch) for kind in ("fused2_v2", "fused2_v3")
      for n, batch in ((1024, 131072), (4096, 32768), (8192, 16384),
                       (16384, 8192))],
]
# Timed alone: K2-v2 and K2-v3 at medium_large_1d, K2-v1 at fused_3072.
FUSED_ALONE = {"fused2_v1": (3072, 32768), "fused2_v2": (4096, 32768),
               "fused2_v3": (4096, 32768)}
# Rows run with tuning on and only the shipped table: their FUSED entry
# (n = 4096) must take the engine that table names for n4096.
FUSED_SHIPPED = ("real_large", "bi_in_4096")
# The tensor-core kernels.  K10-mm at (bpre, L, rest): every column step a
# variant of an ``MD_ROWS`` row gives it, md_1024x1024's (FUSED [8, 128]),
# md_128^3's two (DIRECT 128; the axis-1 step where K11 is off), bi_4096's
# (FUSED [32, 128]) and md_512x512's per-axis route (DIRECT 512).  K16 at
# (n, batch): every ``TUNED_ROWS`` shape, where the tuned GLOBAL path forces
# and races it (256 x 256 … FUSED [16, 128] x 512).
MMA_COL_CASES = [(64, 1024, 1024), (32, 128, 16384), (4096, 128, 128),
                 (1, 4096, 32768), (256, 512, 512)]
MMA_GLOBAL_CASES = [(n, batch) for _, n, batch in TUNED_ROWS]
MMA_KINDS = ("col_mm", "global3")
# Timed alone: K10-mm at md_1024x1024's column pass (beside K10), K16 at
# large_1d (beside K3 and K5-ov).
MMA_ALONE = {"col_mm": (64, 1024, 1024), "global3": (65536, 2048)}
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
    "global2_planes": ("portfft_tpu_torch/csrc/fft_global2_planes.cu",
                       "portfft_tpu/ops/pallas_global.py:394"),
    "axis_m2": ("portfft_tpu_torch/csrc/fft_axis.cu",
                "portfft_tpu/ops/pallas_global.py:519"),
    "destride": ("portfft_tpu_torch/csrc/fft_stride.cu",
                 "portfft_tpu/ops/pallas_io.py:173"),
    "global_sq": ("portfft_tpu_torch/csrc/fft_global_sq.cu",
                  "portfft_tpu/ops/pallas_global.py:770"),
    "global_bf": ("portfft_tpu_torch/csrc/fft_global_bf.cu",
                  "portfft_tpu/ops/pallas_global_bf.py:770"),
    "global_bf_ov": ("portfft_tpu_torch/csrc/fft_global_bf.cu",
                     "portfft_tpu/ops/pallas_global_bf.py:595"),
    "fused2_v1": ("portfft_tpu_torch/csrc/fft_fused2_v1.cu",
                  "portfft_tpu/ops/pallas_fft.py:473"),
    "fused2_v2": ("portfft_tpu_torch/csrc/fft_fused2_v2.cu",
                  "portfft_tpu/ops/pallas_fft.py:607"),
    "fused2_v3": ("portfft_tpu_torch/csrc/fft_fused2_v3.cu",
                  "portfft_tpu/ops/pallas_fft.py:910"),
    "col_mm": ("portfft_tpu_torch/csrc/fft_col_mm.cu",
               "portfft_tpu/ops/pallas_multidim.py:240"),
    "global3": ("portfft_tpu_torch/csrc/fft_global3.cu",
                "portfft_tpu/ops/pallas_global3.py:294"),
    "global_fused": ("portfft_tpu_torch/csrc/fft_global_fused.cu",
                     "portfft_tpu/ops/pallas_global.py:1004"),
    "global_ilv": ("portfft_tpu_torch/csrc/fft_global_ilv.cu",
                   "portfft_tpu/ops/pallas_global_ilv.py:371"),
    "global_bf2": ("portfft_tpu_torch/csrc/fft_global_bf.cu",
                   "portfft_tpu/ops/pallas_global_bf.py:390"),
    "untangle_wide": ("portfft_tpu_torch/csrc/fft_real.cu",
                      "portfft_tpu/ops/pallas_real.py:243"),
    "global2_ftw": ("portfft_tpu_torch/csrc/fft_global2.cu",
                    "portfft_tpu/ops/pallas_global.py:1085"),
    "bluestein_bf": ("portfft_tpu_torch/csrc/fft_bluestein.cu",
                     "portfft_tpu/ops/pallas_bluestein.py:201"),
}
# REAL plane path rows (the REAL lengths whose half length h needs the plane
# path), about 1 GiB in: name, n, batch, directions, PORTFFT_BLUESTEIN_BF.
# h = 600 FUSED [120, 5] on K13's chain mode; h = 65537 on K15, and with
# the flag on K15-bf (a 384 x 384 convolution); h = 2 x 65537, the generic
# GLOBAL glue around K15; h = 2^27 on K14; h = [16, 128] x Bluestein 1031,
# whose width K8a-w's gate takes at batch 64.
REAL_PLANE_ROWS = [
    ("real_plane_1200", 1200, 262144, ("forward", "backward"), False),
    ("real_plane_131074", 2 * 65537, 2048, ("forward", "backward"), False),
    ("real_plane_131074_bf", 2 * 65537, 2048, ("forward", "backward"), True),
    ("real_plane_262148", 4 * 65537, 1024, ("forward",), False),
    ("real_plane_2^28", 1 << 28, 1, ("forward",), False),
    ("real_plane_4222976", 4222976, 64, ("forward",), False),
]
# REAL plane kernel phase: K8a-w at (n, batch): real_plane_4222976's shape,
# the reference's test shape, and a batch its gate declines (the kernel
# takes it); K8b with its flag on spectra whose Im X[0] and Im X[n/2] are
# not 0, below (dropped) and from n = 1024 on (kept); K15-bf at (n, batch)
# over the convolutions 384 x 384 (A = 3, 3), 256 x 256, [16, 128] x 256
# (A = 16, 2) and [16, 128] x [16, 128].
WIDE_CASES = [(4222976, 64), (16384, 64), (1 << 17, 17)]
DROP_CASES = [(1000, 1 << 12), (1200, 1 << 12)]
BLUESTEIN_BF_CASES = [(65537, 256), (24977, 512), (200191, 32), (1586939, 2)]
# Timed alone: K8a-w at real_plane_4222976's untangle (beside K8a), K15-bf
# at real_plane_131074's convolution (beside K15).
REAL_PLANE_ALONE = {"untangle_wide": (4222976, 64), "bluestein_bf": (65537, 2048)}
C2C_KINDS = ("direct", "fused2", "global2")
REAL_KINDS = ("untangle", "retangle", "small_real")
MD_KINDS = ("col", "md2")
# K6 is one kernel of the table with two wrappers (deinterleave, interleave).
PLANE_KINDS = ("interleave", "chain", "bluestein")
# The REAL plane path's own kernels: K8a-w and K15-bf.
REAL_PLANE_KINDS = ("untangle_wide", "bluestein_bf")
SPLIT_KINDS = ("global2_planes", "axis_m2")
# K7 is one kernel of the table with two wrappers (destride, restride).
STRIDE_KINDS = ("destride", "restride")
# The tuned GLOBAL kernels K4, K5, K5-ov, K17, K18, K19 and K3-ftw (K3 is
# "global2", K16 "global3"), and their engines: K17 runs in two twiddle
# modes, "global_fused_ftw" its factored one.
TUNED_KINDS = ("global_sq", "global_bf", "global_bf_ov", "global_fused",
               "global_ilv", "global_bf2", "global2_ftw")
TUNED_ENGINES = TUNED_KINDS + ("global_fused_ftw",)
KERNEL_OF = {"global_fused_ftw": "global_fused"}
# The bound's rates: NVIDIA H100 SXM data sheet (700 W), device memory and
# fp32, per millisecond.
HBM_BYTES_PER_MS = 3.35e9
FP32_FLOPS_PER_MS = 67e9


class SmokeFailure(Exception):
    """A check of the smoke run failed."""


# The fp64 DNS phase's bound, on a step's largest difference from its plain
# version (as a share of the plain version's largest element) and on the
# call's widest |error| against ``torch.fft`` in complex128 (as a share of
# the reference's root mean square): about a hundred times the float64
# rounding of a 512^3 transform, and 1e-5 below what float32 gives.
DNS_TOL = 1e-12


def launched(kernel) -> int:
    """The launches of a kernel wrapper so far, from the program's launch
    registry (``portfft_tpu_torch.utils.tracing``)."""
    from portfft_tpu_torch.utils import tracing

    return tracing.launches(kernel.kernel)


def reset_launches() -> None:
    from portfft_tpu_torch.utils import tracing

    tracing.reset_launches()


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
    if kind in (C2C_KINDS + MD_KINDS + PLANE_KINDS + SPLIT_KINDS + TUNED_KINDS
                + FUSED_KINDS + MMA_KINDS + ("bluestein_bf",)):
        return 16 * batch * n, 5 * n * lg * batch
    if kind in ("untangle", "untangle_wide", "retangle"):
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
    """(engine, kernel wrapper, its arguments after the raw buffer) of a
    committed plan's direction, a raw route."""
    entry = plan._raw_fast[direction]
    kernel, args = entry.kernel_args(plan)
    return entry.engine.name, kernel, args


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
        ref = c2r_reference(spec.to(torch.complex128), n) * scale
        got = y.view(batch, n)[rows]
    return (got.to(ref.dtype) - ref).abs().max().item() / (oracle_tol(n) * abs(scale))


def c2r_reference(spec, n: int):
    """The port's unnormalized C2R of the (rows, n/2+1) half spectra
    ``spec`` (complex128): ``torch.fft.irfft`` (the oracle only), which
    drops Im X[0] and Im X[n/2], plus from ``REAL_KEEP_MIN_N`` on the two
    bins' known contribution where the retangle keeps them: Z[0] gains
    −(a + c) + i·(a − c) (a = Im X[0], c = Im X[n/2]), and the h-point
    backward transform adds that constant to every z[j] = x[2j] + i·x[2j+1]."""
    from portfft_tpu_torch.fastpath import REAL_KEEP_MIN_N

    ref = torch.fft.irfft(spec, n, norm="forward")
    if n >= REAL_KEEP_MIN_N:
        a, c = spec[:, :1].imag, spec[:, -1:].imag
        ref[:, 0::2] -= a + c
        ref[:, 1::2] += a - c
    return ref


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
    axis; K11's second axis), the inter-pass twiddle (K3, K4, K17; in K17's
    factored mode its table B1), the low factor GB of K5's and K18's
    twiddle (K19: its factor B1ᵀ) or the REAL post-twiddle (K8); K2-v1, K2-v2
    and K2-v3 the inner twiddle, as K2.  K9's plain
    version reads the matrix, whose
    conjugate negates the imaginary outputs (forward) or inputs
    (backward)."""
    if kind in ("untangle", "untangle_wide", "retangle"):  # K8b: and its flag
        batch, h, wr, wi, scale, *flag = args
        return (batch, h, wr, -wi, scale, *flag)
    if kind == "small_real":
        batch, tabs = args
        mat = tabs.mat.clone()
        (mat[:, 1::2] if tabs.sign < 0 else mat[1::2]).neg_()
        return (batch, dataclasses.replace(tabs, wi=-tabs.wi, mat=mat))
    if kind in ("global2", "global_sq"):
        batch, sub1, sub2, tr, ti, scale = args
        return (batch, sub1, sub2, tr, -ti, scale)
    if kind in ("global_bf", "global_bf_ov", "global_ilv"):  # the low twiddle factor
        batch, tabs, scale = args
        return (batch, dataclasses.replace(tabs, gb=(tabs.gb[0], -tabs.gb[1])),
                scale)
    if kind == "global_bf2":  # B1ᵀ, the first factor of the low twiddle
        batch, tabs, scale = args
        (b1r, b1i), b2 = tabs.lo
        return (batch, dataclasses.replace(tabs, lo=((b1r, -b1i), b2)), scale)
    if kind in ("global_fused", "global_fused_ftw", "global2_ftw"):  # twiddle, A1, A2
        batch, tabs, scale = args
        if tabs.tw:
            return (batch, dataclasses.replace(tabs, tw=(tabs.tw[0], -tabs.tw[1])),
                    scale)
        b1, b2, (a1r, a1i), (a2r, a2i) = tabs.q
        return (batch, dataclasses.replace(tabs, q=(b1, b2, (a1r, -a1i), (a2r, -a2i))),
                scale)
    if kind in ("col", "col_mm"):
        bpre, rest, sub, scale = args
        return (bpre, rest, conjugated(sub), scale)
    if kind == "global3":  # the high factor of the twiddle
        batch, tabs, scale = args
        return (batch, dataclasses.replace(tabs, b2=(tabs.b2[0], -tabs.b2[1])),
                scale)
    if kind == "md2":
        batch, sub1, sub2, scale = args
        return (batch, sub1, conjugated(sub2), scale)
    if kind == "chain_cols":  # as the row form
        bpre, trailing, tabs, scale = args
        return (bpre, trailing, *planted("chain", (tabs,)), scale)
    if kind == "chain":  # the first stage's roots, or as K1/K2
        (tabs,) = args
        if tabs.mode != "chain":
            return (dataclasses.replace(tabs, sub=conjugated(tabs.sub)),)
        (wr, wi, tr, ti), *rest = tabs.stages
        return (dataclasses.replace(tabs, stages=((wr, -wi, tr, ti), *rest)),)
    if kind in ("bluestein", "bluestein_bf"):  # the pass-1 chirp
        (tabs,) = args
        return (dataclasses.replace(tabs, pre=(tabs.pre[0], -tabs.pre[1])),)
    if kind == "global2_planes":  # the inter-pass twiddle, as K3
        tabs, *rest = args
        return (dataclasses.replace(tabs, tw=(tabs.tw[0], -tabs.tw[1])), *rest)
    if kind == "axis_m2":
        bpre, rest, sub, scale = args
        return (bpre, rest, conjugated(sub), scale)
    if kind in ("fused2_v2", "fused2_v3"):
        batch, sub, bt, scale = args
        return (batch, conjugated(sub), bt, scale)
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
    ``spec``: K9 takes them as they are; K8a or K8a-w takes the spectrum
    the C2C transform of h (its kernel, or the plane path) makes of ``x``;
    K8b's output goes through the backward C2C transform (``finish``) to
    become the reals."""
    from portfft_tpu_torch import fastpath

    entry = plan._raw_fast[direction]
    kernel, args = entry.kernel_args(plan)
    forward = entry.sign < 0
    if isinstance(entry, fastpath.SmallReal):
        return "small_real", kernel, args, x if forward else spec, None
    c2c = fastpath.half_c2c_fn(plan, entry.inner)  # a raw or a plane route
    if forward:
        return kernel.__name__, kernel, args, c2c(x), None
    return "retangle", kernel, args, spec, c2c


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
    the kernels: ``fn(x) -> y`` (a C2C entry's ``fn(x, out=None)`` of
    ``fastpath.build_fn``; SPLIT ``x`` an (re, im) pair)."""
    from portfft_tpu_torch import fastpath

    return fastpath.build_fn(plan, entry, plain=True)


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
            before = launched(kernel)
            r = check_kernel(kind, kernel, args, x, n, sign)
            torch.cuda.synchronize()
            if launched(kernel) != before + 2:  # the call and the planted fault
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
            before = launched(kernel)
            r = check_real(kind, kernel, args, inp, finish,
                           x if sign < 0 else spec, n, sign, scales[direction])
            torch.cuda.synchronize()
            if launched(kernel) != before + 2:  # the call and the planted fault
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
    reset_launches()
    for name, n, batch, dname in ROWS:
        direction = pf.Direction(dname)
        forward = direction == pf.Direction.FORWARD
        sign = -1 if forward else +1
        plan = pf.Descriptor(lengths=[n], number_of_transforms=batch).commit(
            device="cuda"
        )
        kind, kernel, args = kernel_and_args(plan, direction)
        before = launched(counters[kind])
        x = random_raw(2 * batch * n, seed=0)
        compute = plan.compute_forward if forward else plan.compute_backward
        y = compute(x)
        torch.cuda.synchronize()
        rose = launched(counters[kind]) - before
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
    launches = {k: launched(counters[k]) for k in C2C_KINDS}
    print(f"main-path launches: {launches}")
    for kind, count in launches.items():
        if count == 0:
            raise SmokeFailure(f"kernel {kind} was never launched on the main path")
    return results, launches


def real_main_path(pf, counters: dict, card: str, rows=REAL_ROWS,
                   required=REAL_KINDS) -> tuple[list, dict]:
    """``rows`` (``REAL_ROWS``) through the committed plan: each row's REAL
    kernel and the C2C kernel under it (the engine of its ``global2`` or
    ``fused2`` entry) must launch, a sample of transforms is held to
    ``rfft``/``irfft``, and the path, its plain version and one
    ``torch.fft`` call are timed; every kernel of ``required`` must have
    launched."""
    from portfft_tpu_torch import fastpath

    results = []
    reset_launches()
    for name, n, batch, dname in rows:
        direction = pf.Direction(dname)
        forward = direction == pf.Direction.FORWARD
        sign = -1 if forward else +1
        plan = pf.Descriptor(lengths=[n], number_of_transforms=batch,
                             domain=pf.Domain.REAL).commit(device="cuda")
        entry = plan._raw_fast[direction]
        if isinstance(entry, fastpath.SmallReal):
            kinds = ["small_real"]
        else:  # the un/retangle and the C2C kernel under it
            kinds = [entry.tangle, entry.inner.engine.name]
        x = random_raw(batch * n, seed=0) if forward else half_spectra(batch, n, 0)
        compute = plan.compute_forward if forward else plan.compute_backward
        before = {k: launched(counters[k]) for k in kinds}
        y = compute(x)
        torch.cuda.synchronize()
        rose = {k: launched(counters[k]) - before[k] for k in kinds}
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
    launches = {k: launched(c) for k, c in counters.items()}
    print(f"REAL main-path launches: {launches}")
    for kind in required:
        if launches[kind] == 0:
            raise SmokeFailure(f"kernel {kind} was never launched on the REAL path")
    return results, launches


def real_plane_kernel_phase(pf, max_err: dict, card: str) -> dict:
    """Checks K8a-w at ``WIDE_CASES`` (its input the C2C spectrum of reals
    through the REAL plane path of h, or for a shape its gate declines the
    kernel called alone), K8b with its flag at ``DROP_CASES`` (spectra with
    nonzero Im X[0] and Im X[n/2]; the oracle ``c2r_reference``) and
    K15-bf at ``BLUESTEIN_BF_CASES`` (both directions), each against its
    plain version and the oracle with the two planted faults.  Returns
    ``{kind: (ms, plain_ms, library_ms)}`` of K8a-w and K15-bf timed alone
    at ``REAL_PLANE_ALONE``, printed beside K8a and K15 on the same input;
    there K15-bf and K15 are also held to their plain versions."""
    from portfft_tpu_torch.ops import cuda_real

    alone = {}
    for n, batch in WIDE_CASES + DROP_CASES:
        plan = pf.Descriptor(lengths=[n], number_of_transforms=batch,
                             domain=pf.Domain.REAL, forward_scale=0.5,
                             backward_scale=2.0 / n).commit(device="cuda")
        x = random_raw(batch * n, seed=n)
        spec = random_raw(batch * (n + 2), seed=n + 1)  # the bins not 0
        wide = (n, batch) in WIDE_CASES
        direction = pf.Direction.FORWARD if wide else pf.Direction.BACKWARD
        kind, kernel, args, inp, finish = real_case(plan, direction, x, spec)
        if wide and kind != "untangle_wide":  # a shape the gate declines
            kind, kernel = "untangle_wide", cuda_real.untangle_wide
        sign, scale = (-1, 0.5) if wide else (+1, 2.0 / n)
        before = launched(kernel)
        r = check_real(kind, kernel, args, inp, finish, x if wide else spec, n,
                       sign, scale)
        torch.cuda.synchronize()
        if launched(kernel) != before + 2:  # the call and the planted fault
            raise SmokeFailure(f"{kind} n={n}: launch counter did not rise")
        flag = f"drop={args[-1]}" if not wide else "forward"
        report(kind, f"n={n:<8d} batch={batch:<8d} {flag:8s}", r)
        max_err[kind] = max(max_err.get(kind, 0.0), r["err"])
        if wide and (n, batch) == REAL_PLANE_ALONE["untangle_wide"]:
            ms = time_ms(lambda: kernel(inp, *args))
            plain_ms = time_ms(lambda: kernel.plain(inp, *args))
            narrow_ms = time_ms(lambda: cuda_real.untangle(inp, *args))
            bound, by = bound_of(kind, n, batch)
            alone[kind] = (ms, plain_ms, None)
            print(f"alone  {kind:13s} n={n:<8d} batch={batch:<6d} kernel {ms:.3f} "
                  f"ms | untangle {narrow_ms:.3f} ms | plain {plain_ms:.3f} ms | "
                  f"bound {bound:.3f} ms ({by}) | {card}")
        del plan, x, spec, inp, finish, args
        torch.cuda.empty_cache()
    for n, batch in BLUESTEIN_BF_CASES:
        x = random_raw(2 * batch * n, seed=n)
        for sign in (-1, +1):
            kernel, args = plane_case(pf, "bluestein_bf", n, sign)
            before = launched(kernel)
            r = check_plane("bluestein_bf", kernel, args, x, n, batch, sign)
            torch.cuda.synchronize()
            if launched(kernel) != before + 2:
                raise SmokeFailure(f"bluestein_bf n={n}: launch counter did not rise")
            t = args[0]
            report("bluestein_bf", f"n={n:<8d} batch={batch:<8d} "
                   f"{t.g1}x{t.g2} A={t.f1.a},{t.f2.a} sign={sign:+d}", r)
            max_err["bluestein_bf"] = max(max_err.get("bluestein_bf", 0.0), r["err"])
        del x
        torch.cuda.empty_cache()
    n, batch = REAL_PLANE_ALONE["bluestein_bf"]
    (kernel, args), (dense, dargs) = (plane_case(pf, k, n, -1)
                                      for k in ("bluestein_bf", "bluestein"))
    xr, xi = random_raw(2 * batch * n, seed=1).view(batch, n, 2).unbind(-1)
    xr, xi = xr.contiguous(), xi.contiguous()
    xc = torch.complex(xr, xi)
    rel = {}  # both kernels held to their plain versions at the row's shape
    for kind, k, a in (("bluestein_bf", kernel, args), ("bluestein", dense, dargs)):
        got, want = k(xr, xi, *a), k.plain(xr, xi, *a)
        rel[kind] = max(((g - w).abs().max() / w.abs().max()).item()
                        for g, w in zip(got, want))
        if not rel[kind] <= KERNEL_TOL:
            raise SmokeFailure(f"{kind} n={n} batch={batch}: max|kernel - plain| = "
                               f"{rel[kind]:.3e}·max|plain| > {KERNEL_TOL:g}·max|plain|")
        del got, want
    ms = time_ms(lambda: kernel(xr, xi, *args))
    dense_ms = time_ms(lambda: dense(xr, xi, *dargs))
    plain_ms = time_ms(lambda: kernel.plain(xr, xi, *args))
    library_ms = time_ms(lambda: torch.fft.fft(xc))
    bound, by = bound_of("bluestein_bf", n, batch)
    alone["bluestein_bf"] = (ms, plain_ms, library_ms)
    print(f"alone  bluestein_bf  n={n:<8d} batch={batch:<6d} kernel {ms:.3f} ms | "
          f"bluestein {dense_ms:.3f} ms | plain {plain_ms:.3f} ms | torch.fft "
          f"{library_ms:.3f} ms | bound {bound:.3f} ms ({by}) | max|kernel - plain| "
          f"{rel['bluestein_bf']:.2e} (K15 {rel['bluestein']:.2e})·max|plain| | {card}")
    return alone


def real_plane_path(pf, counters: dict, card: str) -> tuple[list, dict]:
    """``REAL_PLANE_ROWS`` through the committed plan (``PORTFFT_BLUESTEIN_BF``
    set at commit where the row asks): each row's entry must be the REAL
    plane path and every kernel of it (its un/retangle, K6, and K13, K14,
    K15 or K15-bf for the routes of h) must launch; a sample of transforms
    is held to ``rfft`` forward and to ``c2r_reference`` backward, on
    spectra whose Im X[0] and Im X[n/2] are not 0, and the whole output to
    the plain chain's within ``KERNEL_TOL``·max|plain| (every kernel of the
    row at the row's shape); the path, its plain chain and one
    ``torch.fft`` call are timed; the peak device memory of
    the first call is printed.  Every kernel of the path must launch."""
    from portfft_tpu_torch import fastpath

    results = []
    reset_launches()
    for name, n, batch, dnames, bf in REAL_PLANE_ROWS:
        if bf:
            os.environ["PORTFFT_BLUESTEIN_BF"] = "1"
        try:
            t0 = time.perf_counter()
            plan = pf.Descriptor(lengths=[n], number_of_transforms=batch,
                                 domain=pf.Domain.REAL).commit(device="cuda")
            commit_s = time.perf_counter() - t0
        finally:
            os.environ.pop("PORTFFT_BLUESTEIN_BF", None)
        for dname in dnames:
            direction = pf.Direction(dname)
            forward = direction == pf.Direction.FORWARD
            sign = -1 if forward else +1
            entry = plan._raw_fast[direction]
            if not isinstance(getattr(entry, "inner", None), fastpath.Plane):
                raise SmokeFailure(f"{name}: route {entry}, not the REAL plane path")
            kinds = [entry.tangle] + path_kinds(entry.inner)
            x = random_raw(batch * (n if forward else n + 2), seed=n)
            compute = plan.compute_forward if forward else plan.compute_backward
            before = {k: launched(counters[k]) for k in kinds}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            y = compute(x)
            torch.cuda.synchronize()
            peak_gib = torch.cuda.max_memory_allocated() / 2**30
            rose = {k: launched(counters[k]) - before[k] for k in kinds}
            if min(rose.values()) <= 0:
                raise SmokeFailure(f"{name}: a kernel of the path was not launched: {rose}")
            numel = batch * (n + 2) if forward else batch * n
            if y.shape != (numel,) or not torch.isfinite(y).all():
                raise SmokeFailure(f"{name}: output of shape {tuple(y.shape)} "
                                   f"(expected ({numel},)) or not finite")
            excess = real_oracle_excess(y, x, n, batch, sign, 1.0)
            if not excess <= 1.0:
                raise SmokeFailure(f"{name} {dname}: {excess:.3e} times the oracle "
                                   f"bound {oracle_tol(n):.3e}")
            plain = fastpath.build_fn(plan, entry, plain=True)
            want = plain(x)
            rel = ((y - want).abs().max() / want.abs().max()).item()
            if not rel <= KERNEL_TOL:
                raise SmokeFailure(f"{name} {dname}: max|path - plain| = {rel:.3e}"
                                   f"·max|plain| > {KERNEL_TOL:g}·max|plain|")
            del y, want
            ms = time_ms(lambda: compute(x))
            plain_ms = time_ms(lambda: plain(x))
            library_ms = time_ms(library_call(x, n, batch, True, forward))
            nbytes, _ = work("small_real", n, batch)
            bound, by = bound_of("small_real", n, batch)
            print(f"row {name:21s} n={n:<9d} batch={batch:<6d} {dname:8s} "
                  f"{'+'.join(kinds):45s} launches {rose} route {entry.inner.routes} "
                  f"oracle max|diff|={excess * oracle_tol(n):.3e} "
                  f"tol={oracle_tol(n):.3e} | max|path - plain|={rel:.2e}·max|plain| "
                  f"(tol {KERNEL_TOL:g}) | path {ms:.3f} ms "
                  f"{nbytes / ms / 1e6:.1f} GB/s | plain {plain_ms:.3f} ms | "
                  f"torch.fft {library_ms:.3f} ms | bound {bound:.3f} ms ({by}) | "
                  f"peak {peak_gib:.2f} GiB | commit {commit_s:.1f} s (host) | {card}")
            results.append((name, dname, kinds, n, batch, ms, plain_ms, library_ms))
            del x, plain
        del plan
        torch.cuda.empty_cache()
    launches = {k: launched(c) for k, c in counters.items()}
    print(f"REAL plane main-path launches: {launches}")
    for kind in ("untangle", "untangle_wide", "retangle", "deinterleave",
                 "interleave", "chain", "global2_planes", "bluestein",
                 "bluestein_bf"):
        if launches[kind] == 0:
            raise SmokeFailure(f"kernel {kind} was never launched on the REAL "
                               "plane path")
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
    """``(kernel, args)`` of a K10 or K10-mm case, ``shape`` = (bpre, L,
    rest), or a K11 case, (batch, n1, n2)."""
    from portfft_tpu_torch.ops import cuda_multidim

    if kind in ("col", "col_mm"):
        bpre, length, rest = shape
        sub = sub_tables_of(pf, length, sign, device)
        return getattr(cuda_multidim, kind), (bpre, rest, sub, scale)
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
            before = launched(kernel)
            r = check_md(kind, kernel, args, x, shape, sign)
            torch.cuda.synchronize()
            if launched(kernel) != before + 2:  # the call and the planted fault
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


def md_kinds(entry) -> list[str]:
    """The kernels of a multi-dim, column or raw route, in the order they
    run: a raw step's engine, a column step's kernel, ``md2``."""
    from portfft_tpu_torch import fastpath

    steps = entry.steps if isinstance(entry, fastpath.MultiDim) else (entry,)
    return [s.engine.name if isinstance(s, fastpath.Raw) else
            s.kernel if isinstance(s, fastpath.Col) else "md2" for s in steps]


def md_main_path(pf, counters: dict, card: str) -> tuple[list, dict]:
    """The multi-dim and BATCH_INTERLEAVED rows through the committed
    plan, then ``MD_SHIPPED`` committed with tuning on (the run's cache is
    still empty, so only the shipped table applies), each of which must
    take K11; every kernel of each row's route must launch."""
    results = []
    reset_launches()
    rows = [(r, False) for r in MD_ROWS] + [(r, True) for r in MD_SHIPPED]
    for (name, lengths, batch, dname, bi), shipped in rows:
        direction = pf.Direction(dname)
        forward = direction == pf.Direction.FORWARD
        sign = -1 if forward else +1
        kw = dict(forward_strides=[batch], backward_strides=[batch],
                  forward_distance=1, backward_distance=1) if bi else {}
        desc = pf.Descriptor(lengths=list(lengths), number_of_transforms=batch,
                             **kw)
        if shipped:
            os.environ.pop("PORTFFT_NO_TUNING", None)
        try:
            plan = desc.commit(device="cuda")
        finally:
            os.environ["PORTFFT_NO_TUNING"] = "1"
        entry = plan._raw_fast[direction]
        kinds = md_kinds(entry)
        if shipped and "md2" not in kinds:
            raise SmokeFailure(f"{name}: the shipped route is {kinds}, not K11")
        n = math.prod(lengths)
        x = random_raw(2 * batch * n, seed=0)
        compute = plan.compute_forward if forward else plan.compute_backward
        before = {k: launched(counters[k]) for k in kinds}
        y = compute(x)
        torch.cuda.synchronize()
        rose = {k: launched(counters[k]) - before[k] for k in kinds}
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
    launches = {k: launched(c) for k, c in counters.items()}
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
    """``(kernel, args)`` of a K13 (``kind`` "chain"), K15 ("bluestein") or
    K15-bf ("bluestein_bf") case: the length-n plan's tables for one
    direction, from a 1D commit."""
    from portfft_tpu_torch.ops import cuda_bluestein, cuda_chain

    plan = pf.Descriptor(lengths=[n]).commit(device=device)
    keys, arrays = plan._bank_keys, plan._bank_arrays
    if kind == "chain":
        return cuda_chain.chain, (
            cuda_chain.chain_tables(plan.plans[n], sign, keys, arrays),)
    return getattr(cuda_bluestein, kind), (cuda_bluestein.bluestein_tables(
        plan.plans[n], sign, keys, arrays, bf=kind == "bluestein_bf"),)


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
    ``BLUESTEIN_CASES`` (both directions), then K13's column form
    (``chain_cols_phase``); returns ``{kind: (ms, plain_ms, library_ms)}``
    of each timed alone at its ``PLANE_ALONE`` shape, and of the column
    form (``"chain_cols"``) at ``CHAIN_COLS_ALONE``."""
    from portfft_tpu_torch.ops import cuda_bluestein, cuda_chain, cuda_io

    alone = {}
    for m in IO_CASES:
        x = random_raw(2 * m, seed=m)
        before = launched(cuda_io.deinterleave) + launched(cuda_io.interleave)
        r = check_io(m, x, 0.5)
        if launched(cuda_io.deinterleave) + launched(cuda_io.interleave) != before + 2:
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
            before = launched(kernel)
            r = check_plane(kind, kernel, args, x, n, batch, sign)
            torch.cuda.synchronize()
            if launched(kernel) != before + 2:  # the call and the planted fault
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
    alone.update(chain_cols_phase(pf, max_err, card))
    return alone


def check_chain_cols(pf, shape: tuple, x, sign: int) -> dict:
    """``check_against`` for K13's column form on the (bpre, n, trailing)
    ``shape`` of ``x``, times ``CHAIN_COLS_SCALE``: the oracle is the
    transform over axis 1."""
    from portfft_tpu_torch.ops import cuda_chain

    bpre, n, trailing = shape
    (tabs,) = plane_case(pf, "chain", n, sign, x.device.type)[1]
    return check_against(
        f"chain_cols {bpre}x{n}x{trailing} sign={sign:+d}", "chain_cols",
        on_raw(cuda_chain.chain_cols, n), (bpre, trailing, tabs, CHAIN_COLS_SCALE),
        x, lambda y: nd_oracle_excess(y, x, shape, (1,), sign, CHAIN_COLS_SCALE))


def chain_cols_phase(pf, max_err: dict, card: str) -> dict:
    """Checks K13's column form at ``CHAIN_COLS_CASES`` (both directions):
    each call, and the planted fault's, is one K13 launch on the
    ``radix_col`` path.  Times it alone at ``CHAIN_COLS_ALONE`` beside its
    plain version, the row form on the moved planes, the four plane copies
    of the move there and back, one ``torch.fft`` call and its bound;
    returns ``{"chain_cols": (ms, plain_ms, library_ms)}``."""
    from portfft_tpu_torch.ops import cuda_chain
    from portfft_tpu_torch.utils import tracing

    def counts():
        return launched(cuda_chain.chain_cols), tracing.paths("K13").get("radix_col", 0)

    alone = {}
    for shape in CHAIN_COLS_CASES:
        bpre, n, trailing = shape
        x = random_raw(2 * math.prod(shape), seed=n + trailing)
        for sign in (-1, +1):
            before = counts()
            r = check_chain_cols(pf, shape, x, sign)
            torch.cuda.synchronize()
            if counts() != (before[0] + 2, before[1] + 2):  # call and planted fault
                raise SmokeFailure(f"chain_cols {shape}: launches {before} -> "
                                   f"{counts()}, not two more radix_col")
            report("chain_cols", f"{bpre}x{n}x{trailing} sign={sign:+d}", r)
            max_err["chain_cols"] = max(max_err.get("chain_cols", 0.0), r["err"])
        if shape == CHAIN_COLS_ALONE:
            alone["chain_cols"] = time_chain_cols(pf, shape, x, card)
        del x
        torch.cuda.empty_cache()
    for n, trailing in CHAIN_COLS_GATE:
        time_cols_gate(pf, n, trailing, card)
        torch.cuda.empty_cache()
    return alone


def time_cols_gate(pf, n: int, trailing: int, card: str,
                   points: int = math.prod(CHAIN_COLS_ALONE),
                   device: str = "cuda") -> tuple:
    """K13's column form against the walk's ``movedim`` path (the move of
    both planes, the row form, the move back) down axis 1 of (bpre, n,
    ``trailing``) planes of about ``points`` points, forward; prints both
    and whether ``cuda_chain.cols_supported`` takes the axis.  Returns
    ``(cols_ms, walk_ms)``."""
    from portfft_tpu_torch.ops import cuda_chain

    bpre = max(points // (n * trailing), 1)
    shape = (bpre, n, trailing)
    plan = pf.Descriptor(lengths=[n]).commit(device=device)
    (tabs,) = plane_case(pf, "chain", n, -1, device)[1]
    xr, xi = (t.contiguous() for t in random_raw(
        2 * math.prod(shape), n + trailing, device).view(-1, 2).unbind(-1))

    def walk():
        moved = (t.view(shape).movedim(1, -1).contiguous() for t in (xr, xi))
        return tuple(y.movedim(-1, 1).contiguous()
                     for y in cuda_chain.chain(*moved, tabs))

    cols_ms = time_ms(lambda: cuda_chain.chain_cols(xr, xi, bpre, trailing, tabs))
    walk_ms = time_ms(walk)
    takes = cuda_chain.cols_supported(plan.plans[n], trailing)
    print(f"gate   chain_cols n={n:<5d} trailing={trailing:<3d} bpre={bpre:<8d} "
          f"({n * trailing} points a tile at most) columns {cols_ms:.3f} ms | "
          f"walk {walk_ms:.3f} ms | ratio {cols_ms / walk_ms:.3f} | "
          f"gate takes it: {takes} | {card}")
    return cols_ms, walk_ms


def time_chain_cols(pf, shape: tuple, x, card: str) -> tuple:
    """K13's column form timed alone on the (bpre, n, trailing) ``shape`` of
    ``x`` (forward, ``CHAIN_COLS_SCALE``), with what it replaces: the row
    form on the planes with axis 1 moved last, and the four plane copies of
    that move there and back.  Returns ``(ms, plain_ms, library_ms)``."""
    from portfft_tpu_torch.ops import cuda_chain

    bpre, n, trailing = shape
    (tabs,) = plane_case(pf, "chain", n, -1, x.device.type)[1]
    xr, xi = (t.contiguous() for t in x.view(-1, 2).unbind(-1))
    args = (bpre, trailing, tabs, CHAIN_COLS_SCALE)
    ms = time_ms(lambda: cuda_chain.chain_cols(xr, xi, *args))
    plain_ms = time_ms(lambda: cuda_chain.chain_cols.plain(xr, xi, *args))
    mr, mi = (t.view(shape).movedim(1, -1).contiguous() for t in (xr, xi))
    rows_ms = time_ms(lambda: cuda_chain.chain(mr, mi, tabs))

    def move_there_and_back():
        for t in (xr, xi):
            t.view(shape).movedim(1, -1).contiguous().movedim(-1, 1).contiguous()

    copies_ms = time_ms(move_there_and_back)
    del mr, mi
    xc = torch.complex(xr, xi).view(shape)
    library_ms = time_ms(lambda: torch.fft.fft(xc, dim=1))
    bound, by = bound_of("chain", n, bpre * trailing)
    print(f"alone  chain_cols {bpre}x{n}x{trailing} {tabs.mode} kernel {ms:.3f} ms "
          f"| rows on the moved planes {rows_ms:.3f} ms + the four copies "
          f"{copies_ms:.3f} ms | plain {plain_ms:.3f} ms | torch.fft {library_ms:.3f} "
          f"ms | bound {bound:.3f} ms ({by}) | {card}")
    return ms, plain_ms, library_ms


def afno_phase(pf, card: str, case: tuple = AFNO, device: str = "cuda") -> dict:
    """FourCastNet's AFNO call (``AFNO``) through the committed plan, each
    direction: its two steps, K9 at n = 180 over batch·90 rows and K10 over
    90 down the (batch, 90, 91) half spectrum, each held to its plain version
    and timed alone; for the record, K13's column form with K6 around it on
    the same half spectrum (what the per-axis walk would run on that axis),
    held to K10's result; the whole call, held to ``torch.fft`` on its first
    rows at the oracle bound, beside one ``rfft2``/``irfft2`` call and the
    call's bound.  Prints one line a direction; returns ``{direction: {name:
    ms}}``."""
    from portfft_tpu_torch import fastpath
    from portfft_tpu_torch.ops import cuda_chain, cuda_io

    lengths, batch, scale = case
    n_out, n = lengths
    bins = n // 2 + 1
    plan = pf.Descriptor(lengths=list(lengths), number_of_transforms=batch,
                         domain=pf.Domain.REAL, forward_scale=scale,
                         backward_scale=scale).commit(device=device)
    reals = random_raw(batch * n_out * n, seed=n, device=device)
    half = random_raw(2 * batch * n_out * bins, seed=bins, device=device)
    rows = min(batch, 64)
    bound = 4 * n_out * n * batch + 8 * n_out * bins * batch
    out = {}

    def agree(what: str, got, want, tol: float = KERNEL_TOL) -> None:
        rel = (got - want).abs().max().item() / want.abs().max().item()
        if not rel <= tol:
            raise SmokeFailure(f"afno {what}: max|kernel - plain| = {rel:.2e}·max|plain|")

    for direction, sign in ((pf.Direction.FORWARD, -1), (pf.Direction.BACKWARD, +1)):
        forward = sign < 0
        entry = plan._raw_fast[direction]
        k9, k9_args = fastpath.real_step(entry).kernel_args(plan)
        col = next(s for s in entry.steps if isinstance(s, fastpath.Col))
        k10, k10_args = col.kernel_args(plan)
        (tabs,) = plane_case(pf, "chain", n_out, sign, device)[1]

        def k13_walk():
            xr, xi = cuda_io.deinterleave(half)
            yr, yi = cuda_chain.chain_cols(xr, xi, batch, bins, tabs, col.scale)
            return cuda_io.interleave(yr, yi, 1.0)

        k9_in = reals if forward else half
        agree(f"K9 {direction.value}", k9(k9_in, *k9_args), k9.plain(k9_in, *k9_args))
        k10_out = k10(half, *k10_args)
        agree(f"K10 {direction.value}", k10_out, k10.plain(half, *k10_args))
        agree(f"K13col+K6 {direction.value}", k13_walk(), k10_out, 1e-4)
        del k10_out
        x = reals if forward else torch.view_as_complex(half.view(-1, 2))
        fn = plan.compute_forward if forward else plan.compute_backward
        y = fn(x)
        xs = x.view(batch, -1)[:rows].to(torch.float64 if forward else torch.complex128)
        if forward:
            got = torch.view_as_complex(y.view(batch, n_out, bins, 2)[:rows])
            want = torch.fft.rfft2(xs.view(rows, *lengths), norm="ortho")
            library = lambda: torch.fft.rfft2(reals.view(batch, *lengths), norm="ortho")
        else:
            got = y.view(batch, *lengths)[:rows]
            want = torch.fft.irfft2(xs.view(rows, n_out, bins), s=lengths, norm="ortho")
            library = lambda: torch.fft.irfft2(x.view(batch, n_out, bins), s=lengths,
                                               norm="ortho")
        excess = (got.to(want.dtype) - want).abs().max().item() / (
            oracle_tol(n_out * n) * scale)
        if not excess <= 1.0:
            raise SmokeFailure(f"afno {direction.value}: {excess:.2f}x the oracle bound")
        del y, got, want
        ms = {"call": time_ms(lambda: fn(x)), "K9": time_ms(lambda: k9(k9_in, *k9_args)),
              "K10": time_ms(lambda: k10(half, *k10_args)), "K13col+K6": time_ms(k13_walk),
              "torch.fft": time_ms(library)}
        print(f"afno   {direction.value:8s} {batch} x {n_out}x{n} call {ms['call']:.3f} ms "
              f"| K9 at {n} over {batch * n_out} rows {ms['K9']:.3f} | K10 at "
              f"({batch}, {n_out}, {bins}) {ms['K10']:.3f} | K13's column form with K6 "
              f"around it {ms['K13col+K6']:.3f} | torch.fft {ms['torch.fft']:.3f} | bound "
              f"{bound / HBM_BYTES_PER_MS:.3f} ms (bytes) | oracle {excess:.3f} | {card}")
        out[direction.value] = ms
    return out


def k9_phase(pf, card: str, cases=K9_ALONE, device: str = "cuda") -> dict:
    """K9 alone at ``cases``, both directions (scale 0.5 forward, 1/n
    backward): each call held to its plain version, then timed beside its
    byte bound and its multiple of it.  Prints one line a case and
    direction; returns ``{(n, batch, direction): (ms, bound_ms)}``."""
    out = {}
    for n, batch in cases:
        plan = pf.Descriptor(lengths=[n], number_of_transforms=batch,
                             domain=pf.Domain.REAL, forward_scale=0.5,
                             backward_scale=1.0 / n).commit(device=device)
        x = random_raw(batch * n, seed=n, device=device)
        spec = half_spectra(batch, n, seed=n + 1, device=device)
        for direction in (pf.Direction.FORWARD, pf.Direction.BACKWARD):
            kind, kernel, args, inp, _ = real_case(plan, direction, x, spec)
            if kind != "small_real":
                raise SmokeFailure(f"K9 n={n}: the route runs {kind}, not K9")
            got, want = kernel(inp, *args), kernel.plain(inp, *args)
            rel = (got - want).abs().max().item() / want.abs().max().item()
            if not rel <= KERNEL_TOL:
                raise SmokeFailure(f"K9 n={n} {direction.value}: max|kernel - "
                                   f"plain| = {rel:.2e}·max|plain|")
            del got, want
            ms = time_ms(lambda: kernel(inp, *args))
            bound, by = bound_of("small_real", n, batch)
            out[(n, batch, direction.value)] = (ms, bound)
            print(f"alone  K9 n={n:<4d} h={n // 2:<4d} batch={batch:<8d} "
                  f"{direction.value:8s} kernel {ms:.3f} ms | bound {bound:.3f} ms "
                  f"({by}) | {ms / bound:.2f}x bound | {card}")
        del plan, x, spec, inp
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


def hashed_uniform(numel: int, seed: int, dtype=torch.float32,
                   device: str = "cuda") -> torch.Tensor:
    """``numel`` values in [-1, 1) from integer hashing of their index and
    ``seed``: the same on every card, torch version and random generator."""
    i = torch.arange(numel, dtype=torch.int64, device=device) + seed * 0x9E3779B9
    i = (i * 0x2545F491) & 0xFFFFFFFF
    i = ((i ^ (i >> 15)) * 0x2C1B3C6D) & 0xFFFFFFFF
    i = i ^ (i >> 12)
    return ((i & 0xFFFFFF).to(torch.float64) / 2**23 - 1.0).to(dtype)


def fp32_digests(pf, device: str = "cuda", cases=FP32_DIGEST_CASES) -> dict:
    """``{case: sha256}`` of K9's and K10's float32 outputs at
    ``FP32_DIGEST_CASES``, both directions, each kernel called with the
    tables and arguments of the committed plan's step (K9 at scale 1 and
    1/n, K10 AFNO's orthonormal scale) on ``hashed_uniform`` inputs: equal
    digests from two trees mean the kernels' outputs are equal bit for
    bit."""
    import hashlib

    fastpath = sys.modules[pf.__name__ + ".fastpath"]
    out = {}
    for kernel, n, batch in cases:
        if kernel == "K9":
            plan = pf.Descriptor(lengths=[n], number_of_transforms=batch,
                                 domain=pf.Domain.REAL,
                                 backward_scale=1.0 / n).commit(device=device)
        else:
            lengths, _, scale = AFNO
            plan = pf.Descriptor(lengths=list(lengths), number_of_transforms=batch[0],
                                 domain=pf.Domain.REAL, forward_scale=scale,
                                 backward_scale=scale).commit(device=device)
        for direction in (pf.Direction.FORWARD, pf.Direction.BACKWARD):
            entry = plan._raw_fast[direction]
            if kernel == "K9":
                step = fastpath.real_step(entry)
                numel = batch * (n if direction == pf.Direction.FORWARD else n + 2)
            else:
                step = next(st for st in entry.steps if isinstance(st, fastpath.Col))
                numel = 2 * batch[0] * n * batch[1]
            fn, args = step.kernel_args(plan)
            y = fn(hashed_uniform(numel, n, device=device), *args)
            out[f"{kernel} n={n} {direction.value}"] = hashlib.sha256(
                y.cpu().numpy().tobytes()).hexdigest()
            del y
        del plan
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


def dns_phase(pf, card: str, case: tuple = DNS, device: str = "cuda") -> dict:
    """The Taylor-Green DNS call (``DNS``) in float64 through the committed
    plan, each direction: its steps (K9 over batch·L0·L1 rows of L2, K10 down
    each outer axis of the half spectrum) each held to its plain version
    at ``DNS_TOL`` and timed alone; the whole call held to ``torch.fft`` in
    complex128 at ``DNS_TOL`` of the reference's root mean square, launching one
    K9 ``radix_f64`` and one K10 ``radix_f64`` an outer axis and nothing in
    float32, timed beside one ``rfftn``/``irfftn`` call and the call's byte
    bound in double (8 bytes a real, 16 a bin).  Prints one line a
    direction; returns ``{direction: {name: ms}}`` with ``"err"``, the
    call's error."""
    from portfft_tpu_torch import fastpath
    from portfft_tpu_torch.utils import tracing

    lengths, batch, bscale = case
    *outer, n = lengths
    bins = n // 2 + 1
    dims = tuple(range(1, 1 + len(lengths)))
    plan = pf.Descriptor(lengths=list(lengths), number_of_transforms=batch,
                         domain=pf.Domain.REAL, precision="fp64",
                         backward_scale=bscale).commit(device=device)
    points, half_n = batch * math.prod(lengths), batch * math.prod(outer) * bins
    reals = hashed_uniform(points, 1, torch.float64, device)
    half = hashed_uniform(2 * half_n, 2, torch.float64, device)
    bound = (8 * points + 16 * half_n) / HBM_BYTES_PER_MS
    out = {}

    def agree(what: str, got, want) -> None:
        rel = (got - want).abs().max().item() / want.abs().max().item()
        if not rel <= DNS_TOL:
            raise SmokeFailure(f"dns {what}: max|kernel - plain| = {rel:.2e}·max|plain|")

    for direction in (pf.Direction.FORWARD, pf.Direction.BACKWARD):
        forward = direction == pf.Direction.FORWARD
        entry = plan._raw_fast[direction]
        ms = {}
        for step in entry.steps:
            kernel, args = step.kernel_args(plan)
            x = reals if isinstance(step, fastpath.SmallReal) and forward else half
            name = f"{kernel.kernel} {'rows' if kernel.kernel == 'K9' else step.rest}"
            got = kernel(x, *args)
            if got.dtype != torch.float64:
                raise SmokeFailure(f"dns {name}: {got.dtype} output")
            agree(f"{name} {direction.value}", got, kernel.plain(x, *args))
            del got
            ms[name] = time_ms(lambda: kernel(x, *args))
        x = reals if forward else torch.view_as_complex(half.view(-1, 2))
        fn = plan.compute_forward if forward else plan.compute_backward
        launches = {k: tracing.launches(k) for k in ("K9", "K10")}
        paths = {k: tracing.paths(k) for k in ("K9", "K10")}
        y = fn(x)
        if device == "cuda":
            torch.cuda.synchronize()
            ran = {k: tracing.launches(k) - v for k, v in launches.items()}
            new = {k: {p: c - paths[k].get(p, 0) for p, c in tracing.paths(k).items()
                       if c != paths[k].get(p, 0)} for k in paths}
            if ran != {"K9": 1, "K10": len(outer)} or new != {
                    "K9": {"radix_f64": 1}, "K10": {"radix_f64": len(outer)}}:
                raise SmokeFailure(f"dns {direction.value}: launches {ran}, paths {new}")
        if forward:
            got = torch.view_as_complex(y.view(batch, *outer, bins, 2))
            want = torch.fft.rfftn(x.view(batch, *lengths), dim=dims)
            library = lambda: torch.fft.rfftn(x.view(batch, *lengths), dim=dims)  # noqa: E731
        else:
            got = y.view(batch, *lengths)
            spec = x.view(batch, *outer, bins)
            want = torch.fft.irfftn(spec, s=lengths, dim=dims) * (points // batch * bscale)
            library = lambda: torch.fft.irfftn(spec, s=lengths, dim=dims)  # noqa: E731
        err = ((got - want).abs().max() / want.abs().square().mean().sqrt()).item()
        if not err <= DNS_TOL:
            raise SmokeFailure(f"dns {direction.value}: error {err:.3e} of the rms")
        del y, got, want
        ms.update(call=time_ms(lambda: fn(x)), torch_fft=time_ms(library), err=err)
        steps = " | ".join(f"{k} {v:.3f}" for k, v in ms.items()
                           if k not in ("call", "torch_fft", "err"))
        print(f"dns    {direction.value:8s} {batch} x {'x'.join(map(str, lengths))} fp64 "
              f"call {ms['call']:.3f} ms | {steps} | torch.fft {ms['torch_fft']:.3f} | "
              f"bound {bound:.3f} ms (bytes) | error {err:.3e} of the rms | {card}")
        out[direction.value] = ms
    return out


def k10_case(pf, shape: tuple, dtype, sign: int, scale: float,
             device: str = "cuda") -> tuple:
    """``(kernel, args)`` of K10 at ``shape`` = (bpre, L, rest) in ``dtype``:
    float32 as ``md_kernel_case``, float64 tables from an fp64 REAL commit
    whose outer axis is L."""
    from portfft_tpu_torch.ops import cuda_fft, cuda_multidim

    if dtype == torch.float32:
        return md_kernel_case(pf, "col", shape, sign, scale, device)
    bpre, length, rest = shape
    plan = pf.Descriptor(lengths=[length, 2], domain=pf.Domain.REAL,
                         precision="fp64").commit(device=device)
    sub = cuda_fft.sub_tables(plan.plans[length], sign, plan._bank_keys,
                              plan._bank_arrays)
    return cuda_multidim.col, (bpre, rest, sub, scale)


def k10_phase(pf, card: str, cases=K10_ALONE, device: str = "cuda") -> dict:
    """K10 alone at ``cases``, both directions (scale 1 forward, 1/L
    backward), out of place into a kept buffer: each call held to its plain
    version (``KERNEL_TOL`` in float32, ``DNS_TOL`` in float64, of
    max|plain|) and to ``torch.fft`` along axis 1 in complex128 (4·eps·log2 L
    of its largest element), in place equal to out of place, then timed
    beside its byte bound (16 bytes an element in float32, 32 in float64),
    its plain version and one ``torch.fft`` call along the axis in its own
    precision.  Prints one line a case and direction; returns ``{(shape,
    precision, direction): {name: ms}}``."""
    out = {}
    for shape, dtype in cases:
        bpre, length, rest = shape
        f64 = dtype == torch.float64
        x = hashed_uniform(2 * math.prod(shape), length, dtype, device)
        y = torch.empty_like(x)
        xc = torch.view_as_complex(x.view(*shape, 2))
        eps = torch.finfo(dtype).eps
        bound = (32 if f64 else 16) * math.prod(shape) / HBM_BYTES_PER_MS
        for direction, sign in (("forward", -1), ("backward", +1)):
            what = f"K10 {shape} {dtype} {direction}"
            scale = 1.0 if sign < 0 else 1.0 / length
            kernel, args = k10_case(pf, shape, dtype, sign, scale, device)
            got = kernel(x, *args, out=y)
            plain = kernel.plain(x, *args)
            rel = (got - plain).abs().max().item() / plain.abs().max().item()
            if not rel <= (DNS_TOL if f64 else KERNEL_TOL):
                raise SmokeFailure(f"{what}: max|kernel - plain| = {rel:.2e}·max|plain|")
            del plain
            xd = xc.to(torch.complex128)
            want = (torch.fft.fft(xd, dim=1) if sign < 0
                    else torch.fft.ifft(xd, dim=1) * length) * scale
            del xd
            err = ((torch.view_as_complex(got.view(*shape, 2)) - want).abs().max()
                   / want.abs().max()).item()
            del want
            if not err <= 4 * eps * max(math.log2(length), 1.0):
                raise SmokeFailure(f"{what}: {err / eps:.1f} eps of max|torch.fft|")
            inplace = x.clone()
            kernel(inplace, *args, out=inplace)
            if not torch.equal(inplace, got):
                raise SmokeFailure(f"{what}: in place differs from out of place")
            del inplace
            library = ((lambda: torch.fft.fft(xc, dim=1)) if sign < 0
                       else (lambda: torch.fft.ifft(xc, dim=1)))
            ms = {"kernel": time_ms(lambda: kernel(x, *args, out=y)),
                  "plain": time_ms(lambda: kernel.plain(x, *args)),
                  "torch.fft": time_ms(library)}
            out[(shape, str(dtype).split(".")[-1], direction)] = ms
            print(f"alone  K10 {shape} {str(dtype).split('.')[-1]} {direction:8s} "
                  f"kernel {ms['kernel']:.3f} ms | bound {bound:.3f} ms (bytes) | "
                  f"{ms['kernel'] / bound:.2f}x bound | plain {ms['plain']:.3f} | "
                  f"torch.fft {ms['torch.fft']:.3f} | {err / eps:.2f} eps of "
                  f"torch.fft | {card}")
        del x, y, xc
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


def k1_phase(pf, card: str, cases=K1_ALONE, device: str = "cuda") -> dict:
    """K1 alone at ``cases``, both directions (scale 1 forward, 1/n
    backward), out of place into a kept buffer: each call held to its plain
    version (``KERNEL_TOL`` of max|plain|) and to ``torch.fft`` in
    complex128 (4·eps·log2 n of its largest element), in place equal to out
    of place, on the card one ``radix`` launch a call on
    ``tracing.paths("K1")``, then timed beside its byte bound, its plain
    version and one ``torch.fft`` call.  Prints one line a case and
    direction; returns ``{(n, batch, direction): {name: ms}}``."""
    from portfft_tpu_torch.utils import tracing

    out = {}
    for n, batch in cases:
        plan = pf.Descriptor(lengths=[n], number_of_transforms=batch,
                             backward_scale=1.0 / n).commit(device=device)
        x = hashed_uniform(2 * batch * n, n, device=device)
        y = torch.empty_like(x)
        xc = torch.view_as_complex(x.view(batch, n, 2))
        bound, by = bound_of("direct", n, batch)
        for direction, sign in ((pf.Direction.FORWARD, -1),
                                (pf.Direction.BACKWARD, +1)):
            what = f"K1 n={n} batch={batch} {direction.value}"
            kind, kernel, args = kernel_and_args(plan, direction)
            if kind != "direct":
                raise SmokeFailure(f"{what}: the route runs {kind}, not K1")
            paths = tracing.paths("K1")
            got = kernel(x, *args, out=y)
            if device == "cuda":
                torch.cuda.synchronize()
                if tracing.paths("K1") != {**paths, "radix": paths.get("radix", 0) + 1}:
                    raise SmokeFailure(f"{what}: not one radix launch "
                                       f"({paths} -> {tracing.paths('K1')})")
            plain = kernel.plain(x, *args)
            rel = (got - plain).abs().max().item() / plain.abs().max().item()
            if not rel <= KERNEL_TOL:
                raise SmokeFailure(f"{what}: max|kernel - plain| = {rel:.2e}·max|plain|")
            del plain
            xd = xc.to(torch.complex128)
            want = (torch.fft.fft(xd, dim=1) if sign < 0
                    else torch.fft.ifft(xd, dim=1))
            del xd
            err = ((torch.view_as_complex(got.view(batch, n, 2)) - want).abs().max()
                   / want.abs().max()).item()
            del want
            if not err <= 4 * EPS32 * max(math.log2(n), 1.0):
                raise SmokeFailure(f"{what}: {err / EPS32:.1f} eps of max|torch.fft|")
            inplace = x.clone()
            kernel(inplace, *args, out=inplace)
            if not torch.equal(inplace, got):
                raise SmokeFailure(f"{what}: in place differs from out of place")
            del inplace
            library = ((lambda: torch.fft.fft(xc, dim=1)) if sign < 0
                       else (lambda: torch.fft.ifft(xc, dim=1)))
            ms = {"kernel": time_ms(lambda: kernel(x, *args, out=y)),
                  "plain": time_ms(lambda: kernel.plain(x, *args)),
                  "torch.fft": time_ms(library)}
            out[(n, batch, direction.value)] = ms
            print(f"alone  K1 n={n:<4d} batch={batch:<8d} {direction.value:8s} "
                  f"kernel {ms['kernel']:.3f} ms | bound {bound:.3f} ms ({by}) | "
                  f"{ms['kernel'] / bound:.2f}x bound | plain {ms['plain']:.3f} | "
                  f"torch.fft {ms['torch.fft']:.3f} | {err / EPS32:.2f} eps of "
                  f"torch.fft | {card}")
        del plan, x, y, xc
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


def plane_main_path(pf, counters: dict, card: str) -> tuple[list, dict]:
    """The ``PLANE_ROWS`` through the committed plan: K6 around the
    executor and every K13 or K15 kernel of each row's route must
    launch."""
    from portfft_tpu_torch import fastpath

    results = []
    reset_launches()
    for name, n, batch, dname in PLANE_ROWS:
        direction = pf.Direction(dname)
        forward = direction == pf.Direction.FORWARD
        sign = -1 if forward else +1
        plan = pf.Descriptor(lengths=[n], number_of_transforms=batch).commit(
            device="cuda")
        entry = plan._raw_fast[direction]
        if not isinstance(entry, fastpath.Plane):
            raise SmokeFailure(f"{name}: route {entry}, not the plane path")
        routes = set(entry.routes.values())
        kinds = ["deinterleave", "interleave"]
        kinds += ["chain"] if routes & {"direct", "two_stage", "chain"} else []
        kinds += ["bluestein"] if "bluestein" in routes else []
        x = random_raw(2 * batch * n, seed=0)
        compute = plan.compute_forward if forward else plan.compute_backward
        before = {k: launched(counters[k]) for k in kinds}
        y = compute(x)
        torch.cuda.synchronize()
        rose = {k: launched(counters[k]) - before[k] for k in kinds}
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
              f"{'+'.join(kinds):36s} launches {rose} route {entry.routes} oracle "
              f"max|diff|={excess * oracle_tol(n):.3e} tol={oracle_tol(n):.3e} | "
              f"path {ms:.3f} ms {nbytes / ms / 1e6:.1f} GB/s | plain "
              f"{plain_ms:.3f} ms | torch.fft {library_ms:.3f} ms | bound "
              f"{bound:.3f} ms ({by}) | {card}")
        results.append((name, kinds, n, batch, ms, plain_ms, library_ms))
        del plan, x
        torch.cuda.empty_cache()
    launches = {k: launched(c) for k, c in counters.items()}
    print(f"plane main-path launches: {launches}")
    for kind in ("deinterleave", "interleave", "chain", "bluestein"):
        if launches[kind] == 0:
            raise SmokeFailure(f"kernel {kind} was never launched on the plane path")
    return results, launches


def planes_oracle_excess(yr, yi, xr, xi, shape, dims, sign: int,
                         scale: float, post=None) -> float:
    """``nd_oracle_excess`` on (re, im) planes, the transform times the
    (g1, g2) [k1, k2] ``post`` pair where given (a 1D transform of
    n = g1·g2, output k = k1 + g1·k2), the bound then times max|post|."""
    rows = sample_rows(shape[0])

    def pick(re, im):
        return torch.complex(re.view(shape)[rows], im.view(shape)[rows]).to(
            torch.complex128)

    xs = pick(xr, xi)
    ref = (torch.fft.fftn(xs, dim=dims) if sign < 0
           else torch.fft.ifftn(xs, dim=dims, norm="forward")) * scale
    mag = 1.0
    if post is not None:
        p = torch.complex(post[0], post[1]).to(torch.complex128).T.reshape(-1)
        ref, mag = ref * p, p.abs().max().item()
    n = math.prod(shape[d] for d in dims)
    return ((pick(yr, yi) - ref).abs().max().item()
            / (oracle_tol(n) * abs(scale) * mag))


def global2_planes_case(pf, g1: int, g2: int, sign: int, post_n=None,
                        device: str = "cuda", plans=None):
    """``(kernel, args)`` of a K14 case of g1 x g2 at the direction's
    scale: the subs' tables from 1D commits of g1 and g2 and the twiddle
    from a bank; with ``post_n``, the tables of the length-``post_n``
    Bluestein plan (whose convolution is g1 x g2; ``plans[post_n]`` where
    given, else a new commit) and its post pair for the convolution's
    direction ``sign`` (b̂ forward, the final chirp backward)."""
    from portfft_tpu_torch.ops import cuda_global, torch_fft

    n = g1 * g2
    scale = 0.5 if sign < 0 else 2.0 / n
    if post_n is None:
        bank = torch_fft.TwiddleBank()
        t = bank.twiddle(g1, g2, sign)
        arrays = bank.device_arrays(device)
        tabs = cuda_global.Global2Tables(
            n, sub_tables_of(pf, g1, sign, device),
            sub_tables_of(pf, g2, sign, device),
            (arrays[t + "r"], arrays[t + "i"]))
        return cuda_global.global2_planes, (tabs, scale, None)
    plan = (plans or {}).get(post_n)
    if plan is None:
        plan = pf.Descriptor(lengths=[post_n]).commit(device=device)
    keys, arrays = plan._bank_keys, plan._bank_arrays
    conv = plan.plans[post_n].conv
    if (conv.sub[0].n, conv.sub[1].n) != (g1, g2):
        raise SmokeFailure(f"{post_n}: convolution {conv.describe()}")
    p = keys[("BPOST", post_n, -1)] + ("f" if sign < 0 else "g")
    return cuda_global.global2_planes, (
        cuda_global.global2_tables(conv, sign, keys, arrays), scale,
        (arrays[p + "r"], arrays[p + "i"]))


def axis_case(pf, shape: tuple, sign: int, device: str = "cuda"):
    """``(kernel, args)`` of a K12 case at (bpre, L, rest), at the
    direction's scale."""
    from portfft_tpu_torch.ops import cuda_axis

    bpre, length, rest = shape
    scale = 0.5 if sign < 0 else 2.0 / length
    return cuda_axis.axis_m2, (bpre, rest, sub_tables_of(pf, length, sign, device),
                               scale)


def split_shape(kind: str, case: tuple) -> tuple:
    """The complex view a K14 case (g1, g2, batch, post_n) or a K12 case
    (bpre, L, rest) transforms over its axis 1."""
    if kind == "global2_planes":
        return (case[2], case[0] * case[1])
    return case


def split_case(pf, kind: str, case: tuple, sign: int, device: str = "cuda",
               plans=None):
    """``(kernel, args)`` of a K14 or K12 case."""
    if kind == "global2_planes":
        g1, g2, _, post_n = case
        return global2_planes_case(pf, g1, g2, sign, post_n, device, plans)
    return axis_case(pf, case, sign, device)


def check_split(kind: str, kernel, args: tuple, x, shape: tuple,
                sign: int) -> dict:
    """``check_kernel`` for K14 (against ``fft`` times its post table where
    it has one) or K12 on the raw buffer ``x`` of the complex ``shape``."""
    scale, post = (args[1], args[2]) if kind == "global2_planes" else (args[-1], None)
    return check_against(
        f"{kind} {shape} sign={sign:+d}", kind, on_raw(kernel, math.prod(shape)),
        args, x,
        lambda y: planes_oracle_excess(
            *y.view(-1, 2).unbind(-1), *x.view(-1, 2).unbind(-1), shape, (1,),
            sign, scale, post))


def split_kernel_phase(pf, max_err: dict, card: str, plans: dict) -> dict:
    """Checks K14 at ``GLOBAL_PLANES_CASES`` and K12 at ``AXIS_CASES``, both
    directions, against their plain versions and ``torch.fft`` (for K14
    with post, ``fft`` times the post table), with the two planted faults
    (K14: its inter-pass twiddle conjugated; K12: its roots or inner
    twiddle); a post case takes its tables from ``plans[post_n]`` where the
    plane rows left that plan.  Returns ``{kind: (ms, plain_ms,
    library_ms)}`` of each timed alone forward at ``GLOBAL_PLANES_ALONE`` /
    ``AXIS_ALONE``."""
    alone = {}
    cases = ([("global2_planes", c) for c in GLOBAL_PLANES_CASES]
             + [("axis_m2", c) for c in AXIS_CASES])
    for kind, case in cases:
        shape = split_shape(kind, case)
        numel, n = math.prod(shape), shape[1]
        x = random_raw(2 * numel, seed=n)
        for sign in (-1, +1):
            kernel, args = split_case(pf, kind, case, sign, plans=plans)
            before = launched(kernel)
            r = check_split(kind, kernel, args, x, shape, sign)
            torch.cuda.synchronize()
            if launched(kernel) != before + 2:  # the call and the planted fault
                raise SmokeFailure(f"{kind} {case}: launch counter did not rise")
            report(kind, f"{str(case):26s} sign={sign:+d}", r)
            max_err[kind] = max(max_err.get(kind, 0.0), r["err"])
            if sign < 0 and case[:3] in (GLOBAL_PLANES_ALONE, AXIS_ALONE):
                xr, xi = (t.contiguous() for t in x.view(-1, 2).unbind(-1))
                xc = torch.complex(xr, xi).view(shape)
                ms = time_ms(lambda: kernel(xr, xi, *args))
                plain_ms = time_ms(lambda: kernel.plain(xr, xi, *args))
                library_ms = time_ms(lambda: torch.fft.fft(xc, dim=1))
                bound, by = bound_of(kind, n, numel // n)
                alone[kind] = (ms, plain_ms, library_ms)
                print(f"alone  {kind:14s} {str(case):26s} kernel {ms:.3f} ms | "
                      f"plain {plain_ms:.3f} ms | torch.fft {library_ms:.3f} ms "
                      f"(complex input made outside) | bound {bound:.3f} ms "
                      f"({by}) | {card}")
                del xr, xi, xc
            del kernel, args
        del x
        torch.cuda.empty_cache()
    return alone


def path_kinds(entry) -> list[str]:
    """The kernels a plane-path route (a ``Plane``, or a ``Core``, SPLIT or
    interleaved) launches: K6 around an interleaved walk, K13, K14 and K15
    for the routes of its nodes, K12 for its column axes."""
    from portfft_tpu_torch import fastpath

    values = set(entry.routes.values())
    columns = ({c for _, c in entry.columns} if isinstance(entry, fastpath.Core)
               else set())
    kinds = []
    if isinstance(entry, fastpath.Plane) or not entry.split:
        kinds += ["deinterleave", "interleave"]
    if values & {"direct", "two_stage", "chain"} or "K13col" in columns:
        kinds.append("chain")
    if "global2" in values:
        kinds.append("global2_planes")
    if "bluestein" in values:
        kinds.append("bluestein")
    if "bluestein_bf" in values:
        kinds.append("bluestein_bf")
    if "K12" in columns:
        kinds.append("axis_m2")
    return kinds


def plane_rows(pf, rows, split: bool, counters: dict, card: str,
               must_launch, keep=()) -> tuple[list, dict, dict]:
    """``rows`` (name, lengths, batch, direction) through the committed
    plan, SPLIT planes or an interleaved buffer: every kernel of each
    row's route must launch, a sample of transforms is held to
    ``torch.fft`` at the absolute 2·eps·N·log2(N), and the path, its plain
    chain and one ``torch.fft`` call are timed (for SPLIT the call's
    ``torch.complex`` assembly of the planes is inside the timed call).
    Prints the peak device memory of the row's first call.  Returns the
    rows' numbers, the launches and ``{n: plan}`` of the 1D rows named in
    ``keep`` (their plans stay alive for a later kernel check)."""
    from portfft_tpu_torch import fastpath

    results, kept = [], {}
    reset_launches()
    storage = (pf.ComplexStorage.SPLIT_COMPLEX if split
               else pf.ComplexStorage.INTERLEAVED_COMPLEX)
    for name, lengths, batch, dname in rows:
        direction = pf.Direction(dname)
        forward = direction == pf.Direction.FORWARD
        sign = -1 if forward else +1
        plan = pf.Descriptor(lengths=list(lengths), number_of_transforms=batch,
                             complex_storage=storage).commit(device="cuda")
        entry = plan._raw_fast[direction]
        if not isinstance(entry, (fastpath.Plane, fastpath.Core)):
            raise SmokeFailure(f"{name}: route {entry}, not the plane path")
        kinds = path_kinds(entry)
        n = math.prod(lengths)
        shape, dims = (batch, *lengths), tuple(range(1, len(lengths) + 1))
        x = random_raw(2 * batch * n, seed=0)
        if split:
            xr, xi = (t.contiguous() for t in x.view(-1, 2).unbind(-1))
            inputs = (xr, xi)
            del x
        else:
            inputs = (x,)
        compute = plan.compute_forward if forward else plan.compute_backward
        before = {k: launched(counters[k]) for k in kinds}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        y = compute(*inputs)
        torch.cuda.synchronize()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        rose = {k: launched(counters[k]) - before[k] for k in kinds}
        if min(rose.values()) <= 0:
            raise SmokeFailure(f"{name}: a kernel of the path was not launched: {rose}")
        planes = y if split else y.view(-1, 2).unbind(-1)
        if any(p.shape != (batch * n,) or not torch.isfinite(p).all()
               for p in planes):
            raise SmokeFailure(f"{name}: output of shape "
                               f"{[tuple(p.shape) for p in planes]} or not finite")
        src = inputs if split else inputs[0].view(-1, 2).unbind(-1)
        excess = planes_oracle_excess(*planes, *src, shape, dims, sign, 1.0)
        if not excess <= 1.0:
            raise SmokeFailure(f"{name}: {excess:.3e} times the oracle bound "
                               f"{oracle_tol(n):.3e}")
        del y, planes, src
        ms = time_ms(lambda: compute(*inputs))
        plain = plain_path(plan, entry)
        plain_ms = time_ms(lambda: plain(inputs if split else inputs[0]))
        if split:
            fft = torch.fft.fftn if forward else functools.partial(
                torch.fft.ifftn, norm="forward")
            library_ms = time_ms(lambda: fft(torch.complex(*inputs).view(shape),
                                             dim=dims))
        else:
            library_ms = time_ms(fftn_call(inputs[0], shape, dims, forward))
        nbytes, flops = work("chain", n, batch)
        bound, by = bound_of("chain", n, batch)
        print(f"row {name:24s} {'x'.join(map(str, lengths)):12s} batch={batch:<6d} "
              f"{'+'.join(kinds):40s} launches {rose} route {entry.routes} "
              f"oracle max|diff|={excess * oracle_tol(n):.3e} "
              f"tol={oracle_tol(n):.3e} | path {ms:.3f} ms "
              f"{nbytes / ms / 1e6:.1f} GB/s | plain {plain_ms:.3f} ms | "
              f"torch.fft {library_ms:.3f} ms | bound {bound:.3f} ms ({by}) | "
              f"peak {peak_gib:.2f} GiB | {card}")
        results.append((name, kinds, n, batch, ms, plain_ms, library_ms))
        if name in keep:
            kept[n] = plan
        del plan, inputs, plain
        torch.cuda.empty_cache()
    launches = {k: launched(c) for k, c in counters.items()}
    print(f"{'SPLIT' if split else 'plane rows'} main-path launches: {launches}")
    for kind in must_launch:
        if launches[kind] == 0:
            raise SmokeFailure(f"kernel {kind} was never launched on this path")
    return results, launches, kept


def side_bytes(rows, elem: int, planes: int = 1) -> int:
    """Bytes one side of a layout moves, in 32-byte sectors: each element
    of a run whose elements lie closer than a sector costs its stride (a
    packed side its size), farther apart a whole sector.  ``rows`` is a
    ``utils.layout.Rows``; ``elem`` the bytes of one element of a plane."""
    step = rows.stride if rows.batch == 1 else min(rows.stride, rows.distance)
    return planes * rows.batch * rows.n * min(32, step * elem)


def stride_bound(m: tuple, split: bool) -> tuple[float, str]:
    """``(bound_ms, "bytes")`` of one K7 call on the layout ``m`` = (o, s,
    dist, n, batch): the strided side in sectors, the packed side once."""
    from portfft_tpu_torch.utils.layout import Rows

    rows, planes = Rows(*m), 2 if split else 1
    elem = 4 if split else 8
    nbytes = side_bytes(rows, elem, planes) + planes * rows.batch * rows.n * elem
    return nbytes / HBM_BYTES_PER_MS, "bytes"


def stride_buffer(count: int, split: bool, seed: int, device: str,
                  fill: float | None = None):
    """A raw interleaved buffer of ``count`` elements, or an (re, im) pair
    of planes: random in [-1, 1), or all ``fill``."""
    width = 1 if split else 2

    def one(k):
        if fill is None:
            return random_raw(width * count, seed + k, device)
        return torch.full((width * count,), fill, device=device)

    return (one(0), one(1)) if split else one(0)


def planes_of(buf) -> tuple:
    return buf if isinstance(buf, tuple) else (buf,)


def exact_err(got, want) -> float:
    """max|got - want| over every plane (0.0 for an exact copy)."""
    return max((g - w).abs().max().item()
               for g, w in zip(planes_of(got), planes_of(want)))


def check_stride(name: str, m: tuple, split: bool, device: str = "cuda") -> dict:
    """K7 at the layout ``m`` = (o, s, dist, n, batch): destride, and
    restride with fill_gaps on and off (off on a sentinel-filled ``out``),
    each against its plain version on the same inputs.  They are exact
    copies: max|kernel - plain| must be 0.  Each check must reject two
    planted faults, the kernel run at offset o + 1 and an all-zero
    output.  Returns ``{"err", "caught"}``; raises :class:`SmokeFailure`."""
    from portfft_tpu_torch.ops import cuda_stride

    o, s, dist, n, batch = m
    count = o + (batch - 1) * dist + (n - 1) * s + 2  # room for offset o + 1
    shifted = (o + 1, s, dist, n, batch)
    x = stride_buffer(count, split, 1, device)
    y = stride_buffer(batch * n, split, 2, device)

    def sentinel():
        return stride_buffer(count, split, 0, device, SENTINEL)

    calls = {"destride": (lambda k, mm: k(x, *mm), cuda_stride.destride)}
    for fill in (True, False):
        calls[f"restride fill_gaps={fill}"] = (
            lambda k, mm, fill=fill: k(y, *mm, sentinel(), fill),
            cuda_stride.restride)
    r = {"err": 0.0, "caught": {}}
    for what, (call, kernel) in calls.items():
        got, want = call(kernel, m), call(kernel.plain, m)
        err = exact_err(got, want)
        if not err == 0.0:
            raise SmokeFailure(f"{what} {name} {m}: max|kernel - plain| = {err:.3e}, "
                               "not an exact copy")
        zeros = tuple(torch.zeros_like(g) for g in planes_of(got))
        for fault, bad in (("shifted offset", call(kernel, shifted)),
                           ("zeros", zeros)):
            f_err = exact_err(bad, want)
            if not f_err > 0.0:
                raise SmokeFailure(f"{what} {name}: planted fault ({fault}) passed")
            r["caught"][f"{what} {fault}"] = f_err
        del got, want, zeros
    return r


def stride_kernel_phase(pf, max_err: dict, card: str) -> tuple:
    """Checks K7 at ``STRIDE_CASES``; returns ``(ms, plain_ms, library_ms)``
    of the destride timed alone at ``STRIDE_ALONE``, the library call one
    ``as_strided(...).contiguous()`` of the same view."""
    from portfft_tpu_torch.ops import cuda_stride

    alone = None
    for name, m, split in STRIDE_CASES:
        before = launched(cuda_stride.destride) + launched(cuda_stride.restride)
        r = check_stride(name, m, split)
        torch.cuda.synchronize()
        # destride, two restrides, each with its shifted-offset fault
        if launched(cuda_stride.destride) + launched(cuda_stride.restride) != before + 6:
            raise SmokeFailure(f"K7 {name}: launch counters did not rise by 6")
        print(f"kernel destride/restride {name:20s} {m} "
              f"{'planes' if split else 'interleaved'} max|k-plain|={r['err']:.1e} "
              f"(exact) | planted faults rejected: "
              + " ".join(f"{k}: {v:.2e};" for k, v in r["caught"].items()))
        max_err["destride"] = max(max_err.get("destride", 0.0), r["err"])
        if name == STRIDE_ALONE:
            o, s, dist, n, batch = m
            x = random_raw(2 * (o + (batch - 1) * dist + (n - 1) * s + 1), 3)
            y = random_raw(2 * batch * n, 4)
            out = torch.empty_like(x)
            view = torch.view_as_complex(x.view(-1, 2)).as_strided(
                (batch, n), (dist, s), o)
            ms = time_ms(lambda: cuda_stride.destride(x, *m))
            plain_ms = time_ms(lambda: cuda_stride.destride.plain(x, *m))
            library_ms = time_ms(lambda: view.contiguous())
            re_ms = time_ms(lambda: cuda_stride.restride(y, *m, out, True))
            re_plain = time_ms(lambda: cuda_stride.restride.plain(y, *m, out, True))
            bound, by = stride_bound(m, split)
            alone = (ms, plain_ms, library_ms)
            print(f"alone  destride {name} kernel {ms:.3f} ms | plain "
                  f"{plain_ms:.3f} ms | as_strided().contiguous() {library_ms:.3f} ms "
                  f"| bound {bound:.3f} ms ({by}) | restride fill_gaps kernel "
                  f"{re_ms:.3f} ms, plain {re_plain:.3f} ms | {card}")
            del x, y, out, view
        torch.cuda.empty_cache()
    return alone


def layout_kinds(entry) -> list[str]:
    """The kernels a C2C route launches: K7 destride where its input side
    is strided, the inner route's kernels (a raw route's engine), K7
    restride where its output side is strided."""
    from portfft_tpu_torch import fastpath
    from portfft_tpu_torch.utils.layout import Rows

    inner, src, dst = ((entry.inner, entry.src, entry.dst)
                       if isinstance(entry, fastpath.Layout) else (entry, 0, 0))
    kinds = ["destride"] if isinstance(src, Rows) else []
    if isinstance(inner, (fastpath.Plane, fastpath.Core)):
        kinds += path_kinds(inner)
    else:
        kinds += md_kinds(inner)
    return kinds + (["restride"] if isinstance(dst, Rows) else [])


def elements(buf, rows):
    """The (batch, n) complex view (interleaved) or (re, im) views (SPLIT)
    of the elements a layout's ``rows`` address in ``buf``."""
    if isinstance(buf, tuple):
        return tuple(p.as_strided((rows.batch, rows.n), (rows.distance, rows.stride),
                                  rows.offset) for p in buf)
    c = torch.view_as_complex(buf.view(-1, 2))
    return c.as_strided((rows.batch, rows.n), (rows.distance, rows.stride),
                        rows.offset)


def sampled(buf, rows, sample: list[int]) -> torch.Tensor:
    """The rows ``sample`` of a layout in ``buf`` as complex128."""
    v = elements(buf, rows)
    if isinstance(v, tuple):
        return torch.complex(v[0][sample], v[1][sample]).to(torch.complex128)
    return v[sample].to(torch.complex128)


def layout_main_path(pf, counters: dict, card: str, rows=LAYOUT_ROWS,
                     device: str = "cuda",
                     required=STRIDE_KINDS) -> tuple[list, dict]:
    """``LAYOUT_ROWS`` through the committed plan, forward: every kernel of
    each row's route (``layout_kinds``) must launch; a sample of rows is
    held to ``torch.fft`` at the absolute 2·eps·n·log2(n); every element
    the output layout does not address must be 0 (no out=) or keep the
    sentinel (out=); the path, its plain chain and one ``torch.fft`` call
    on the strided view are timed; the peak device memory of the first
    call is printed."""
    from portfft_tpu_torch.utils.layout import rows_1d

    results = []
    reset_launches()
    fwd = pf.Direction.FORWARD
    for name, n, batch, split, fields, give_out in rows:
        storage = (pf.ComplexStorage.SPLIT_COMPLEX if split
                   else pf.ComplexStorage.INTERLEAVED_COMPLEX)
        desc = pf.Descriptor(lengths=[n], number_of_transforms=batch,
                             complex_storage=storage, **fields)
        plan = desc.commit(device=device)
        entry = plan._raw_fast[fwd]
        kinds = layout_kinds(entry)
        src, dst = rows_1d(desc, fwd), rows_1d(desc, pf.Direction.BACKWARD)
        x = stride_buffer(desc.get_input_count(fwd), split, 0, device)
        count_out = desc.get_output_count(fwd)
        out = (stride_buffer(count_out + 16, split, 0, device, SENTINEL)
               if give_out else None)
        args = (x if split else (x,))

        def compute():
            return plan.compute_forward(*args, out=out)

        before = {k: launched(counters[k]) for k in kinds}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        y = compute()
        torch.cuda.synchronize()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        rose = {k: launched(counters[k]) - before[k] for k in kinds}
        if min(rose.values()) <= 0:
            raise SmokeFailure(f"{name}: a kernel of the path was not launched: {rose}")
        width = 1 if split else 2
        want_len = width * (count_out + 16 if give_out else count_out)
        if any(p.shape != (want_len,) or not torch.isfinite(p).all()
               for p in planes_of(y)):
            raise SmokeFailure(f"{name}: output of shape "
                               f"{[tuple(p.shape) for p in planes_of(y)]} "
                               f"(expected ({want_len},)) or not finite")
        sample = sample_rows(batch)
        ref = torch.fft.fft(sampled(x, src, sample))
        excess = (sampled(y, dst, sample) - ref).abs().max().item() / oracle_tol(n)
        if not excess <= 1.0:
            raise SmokeFailure(f"{name}: {excess:.3e} times the oracle bound "
                               f"{oracle_tol(n):.3e}")
        # everything the output layout does not address: 0, or the sentinel
        rest = tuple(p.clone() for p in planes_of(y))
        v = elements(rest if split else rest[0], dst)
        gap = SENTINEL if give_out else 0.0
        for p in planes_of(v):
            p.fill_(gap if split else complex(gap, gap))
        if any((p != gap).any().item() for p in rest):
            raise SmokeFailure(f"{name}: an element outside the output layout "
                               f"is not {gap}")
        del y, rest, v
        ms = time_ms(compute)
        plain = plain_path(plan, entry)
        plain_ms = time_ms(lambda: plain(x, out))
        if split:
            re_v, im_v = elements(x, src)
            library_ms = time_ms(lambda: torch.fft.fft(torch.complex(re_v, im_v)))
        else:
            view = elements(x, src)
            library_ms = time_ms(lambda: torch.fft.fft(view))
        elem = 4 if split else 8
        planes = 2 if split else 1
        nbytes = side_bytes(src, elem, planes) + side_bytes(dst, elem, planes)
        flops = 5 * n * math.log2(n) * batch
        bound = max(nbytes / HBM_BYTES_PER_MS, flops / FP32_FLOPS_PER_MS)
        by = "bytes" if nbytes / HBM_BYTES_PER_MS >= flops / FP32_FLOPS_PER_MS else "operations"
        print(f"row {name:20s} n={n:<6d} batch={batch:<6d} {'+'.join(kinds):28s} "
              f"launches {rose} oracle max|diff|={excess * oracle_tol(n):.3e} "
              f"tol={oracle_tol(n):.3e} gaps {gap} | path {ms:.3f} ms "
              f"{nbytes / ms / 1e6:.1f} GB/s | plain {plain_ms:.3f} ms | torch.fft "
              f"(strided view) {library_ms:.3f} ms | bound {bound:.3f} ms ({by}) | "
              f"peak {peak_gib:.2f} GiB | {card}")
        results.append((name, kinds, n, batch, ms, plain_ms, library_ms))
        del plan, x, out, args, plain
        torch.cuda.empty_cache()
    launches = {k: launched(c) for k, c in counters.items()}
    print(f"layout main-path launches: {launches}")
    for kind in required:
        if launches[kind] == 0:
            raise SmokeFailure(f"kernel {kind} was never launched on the layout path")
    return results, launches


def tuned_cases(pf, kinds=TUNED_ENGINES) -> list[tuple]:
    """``(kind, n, batch)`` of each tuned engine (``TUNED_ENGINES``, or
    ``kinds``) at every ``TUNED_ROWS`` shape its gate takes: the shapes the
    tuned main path gives it."""
    from portfft_tpu_torch.engines import ENGINES
    from portfft_tpu_torch.planner import plan_1d

    cfg = pf.DeviceConfig()  # the planning geometry is the same on the card
    return [(kind, n, batch) for kind in kinds for _, n, batch in TUNED_ROWS
            if ENGINES[kind].gate(plan_1d(n, cfg, 4), 1, 0)]


def tuned_kernel(plan, kind: str, direction):
    """``(kernel, args)`` of ``plan``'s GLOBAL entry for ``direction`` with
    the engine ``kind`` selected."""
    from portfft_tpu_torch import fastpath
    from portfft_tpu_torch.engines import ENGINES

    entry = fastpath.with_engine(plan, plan._raw_fast[direction],
                                 ENGINES[kind].params)
    return entry.kernel_args(plan)


def tuned_kernel_phase(pf, max_err: dict, card: str) -> dict:
    """Checks K4, K5, K5-ov, K17 (both twiddle modes), K18, K19 and K3-ftw
    at ``tuned_cases``, forward (scale 0.5) and backward (scale 2/n),
    against their plain versions and ``torch.fft`` with the two planted
    faults (K4, K17: the inter-pass twiddle conjugated, as K3, or in the
    factored modes of K17 and K3-ftw the factors A1 and A2; K5, K18: the
    low twiddle factor GB; K19: its factor B1ᵀ).  Returns
    ``{engine: (ms, plain_ms, library_ms)}`` of each timed alone forward at
    ``TUNED_ALONE``; K17, K18, K19 and K3-ftw are timed there beside K3,
    K5-ov and K16."""
    alone, beside = {}, {}
    for kind, n, batch in tuned_cases(pf):
        plan = pf.Descriptor(lengths=[n], number_of_transforms=batch,
                             forward_scale=0.5, backward_scale=2.0 / n
                             ).commit(device="cuda")
        g1, g2 = (s.n for s in plan.plans[n].sub)
        x = random_raw(2 * batch * n, seed=n)
        for direction, sign in ((pf.Direction.FORWARD, -1),
                                (pf.Direction.BACKWARD, +1)):
            kernel, args = tuned_kernel(plan, kind, direction)
            before = launched(kernel)
            r = check_kernel(kind, kernel, args, x, n, sign)
            torch.cuda.synchronize()
            if launched(kernel) != before + 2:  # the call and the planted fault
                raise SmokeFailure(f"{kind} n={n}: launch counter did not rise")
            report(kind, f"{g1}x{g2} batch={batch:<6d} {direction.value:8s}", r)
            name = KERNEL_OF.get(kind, kind)
            max_err[name] = max(max_err.get(name, 0.0), r["err"])
            if sign < 0 and (n, batch) == TUNED_ALONE[kind]:
                ms = time_ms(lambda: kernel(x, *args))
                plain_ms = time_ms(lambda: kernel.plain(x, *args))
                library_ms = time_ms(library_call(x, n, batch, False, True))
                bound, by = bound_of(name, n, batch)
                alone[kind] = (ms, plain_ms, library_ms)
                others = ""
                if name in WRAPPER_ENGINES + ("global2_ftw",):  # beside K3, K5-ov, K16
                    if (n, batch) not in beside:
                        beside[(n, batch)] = {
                            k: time_ms(functools.partial(k3, x, *a3)) for k, (k3, a3)
                            in ((k, tuned_kernel(plan, k, direction)) for k in
                                ("global2", "global_bf_ov", "global3"))}
                    others = "".join(f" | {k} {t:.3f} ms"
                                     for k, t in beside[(n, batch)].items())
                print(f"alone  {kind:16s} n={n:<8d} batch={batch:<6d} kernel "
                      f"{ms:.3f} ms{others} | plain {plain_ms:.3f} ms | torch.fft "
                      f"{library_ms:.3f} ms | bound {bound:.3f} ms ({by}) | {card}")
            del kernel, args
        del plan, x
        torch.cuda.empty_cache()
    return alone


def tuned_main_path(pf, counters: dict, card: str) -> tuple[dict, dict]:
    """``TUNED_ROWS`` through ``Descriptor(...).commit(device="cuda")`` with
    tuning on, in the run's own tuning cache: per row, a recorded entry
    forces each engine whose gate takes the plan (K4, K5, K5-ov, K16, K17 in
    both twiddle modes, K18, K19, K3-ftw) and the row is held to ``torch.fft`` and
    timed; then, with the entry forgotten,
    ``plan.autotune()`` races the engines (each variant's time and the
    winner printed) and the tuned plan is held and timed again.  Peak
    device memory of each forced row's first call is printed.  Returns the
    launches and ``{key: winner}``."""
    from portfft_tpu_torch import tuning
    from portfft_tpu_torch.engines import ENGINES

    os.environ.pop("PORTFFT_NO_TUNING", None)
    winners = {}
    reset_launches()
    fwd = pf.Direction.FORWARD
    try:
        for name, n, batch in TUNED_ROWS:
            desc = pf.Descriptor(lengths=[n], number_of_transforms=batch)
            x = random_raw(2 * batch * n, seed=0)
            plan = desc.commit(device="cuda")
            device, key = plan.config.name, tuning._entry_key(plan, "global2")
            shipped = plan._raw_fast[fwd].engine.name
            del plan
            for kind in (k for k, m, _ in tuned_cases(pf, TUNED_ENGINES + ("global3",))
                         if m == n):
                tuning.record(device, "global2", key, dict(ENGINES[kind].params))
                plan = desc.commit(device="cuda")
                if plan._raw_fast[fwd].engine.name != kind:
                    raise SmokeFailure(f"{name}: the recorded {kind} did not route")
                counter = counters[KERNEL_OF.get(kind, kind)]
                before = launched(counter)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                y = plan.compute_forward(x)
                torch.cuda.synchronize()
                peak_gib = torch.cuda.max_memory_allocated() / 2**30
                if launched(counter) != before + 1:
                    raise SmokeFailure(f"{name}: {kind} was not launched once")
                if y.shape != x.shape or not torch.isfinite(y).all():
                    raise SmokeFailure(f"{name} {kind}: output not finite")
                excess = oracle_excess(y, x, n, batch, -1, 1.0)
                if not excess <= 1.0:
                    raise SmokeFailure(f"{name} {kind}: {excess:.3e} times the "
                                       f"oracle bound {oracle_tol(n):.3e}")
                del y
                ms = time_ms(lambda: plan.compute_forward(x))
                print(f"row {name:12s} n={n:<8d} batch={batch:<6d} forced "
                      f"{kind:16s} oracle max|diff|={excess * oracle_tol(n):.3e} "
                      f"| path {ms:.3f} ms {16 * batch * n / ms / 1e6:.1f} GB/s "
                      f"| peak {peak_gib:.2f} GiB | {card}")
                del plan
                torch.cuda.empty_cache()
            tuning.forget(device, "global2", key)
            plan = desc.commit(device="cuda")
            times = {}
            won = plan.autotune(times=times)
            engine = plan._raw_fast[fwd].engine.name
            y = plan.compute_forward(x)
            torch.cuda.synchronize()
            excess = oracle_excess(y, x, n, batch, -1, 1.0)
            if not excess <= 1.0:
                raise SmokeFailure(f"{name} tuned: {excess:.3e} times the bound")
            del y
            ms = time_ms(lambda: plan.compute_forward(x))
            library_ms = time_ms(library_call(x, n, batch, False, True))
            bound, by = bound_of("global2", n, batch)
            print(f"row {name:12s} n={n:<8d} batch={batch:<6d} autotune ms "
                  f"{json.dumps(times)} -> {won} ({engine}; shipped route "
                  f"{shipped}) | tuned path {ms:.3f} ms | torch.fft "
                  f"{library_ms:.3f} ms | bound {bound:.3f} ms ({by}) | {card}")
            winners[key] = won
            del plan, x
            torch.cuda.empty_cache()
    finally:
        os.environ["PORTFFT_NO_TUNING"] = "1"
    launches = {k: launched(c) for k, c in counters.items()}
    print(f"tuned main-path launches: {launches}")
    print("autotune winners (global2, "
          f"{card}): {json.dumps(winners, sort_keys=True)}")
    for kind in TUNED_KINDS + ("global3",):
        if launches[kind] == 0:
            raise SmokeFailure(f"kernel {kind} was never launched on the tuned path")
    return launches, winners


def tuned_layout_path(pf, counters: dict, card: str) -> tuple[list, dict]:
    """The ``TUNED_LAYOUT`` rows with tuning on and the shipped table only
    (the run's own cache is empty until the tuned main path): each row's
    GLOBAL entry must take the engine the shipped table names for its key,
    not K3, and the row then runs as on the layout main path
    (``layout_main_path``: that engine and K7 launch, oracle, gaps, times)."""
    from portfft_tpu_torch import tuning
    from portfft_tpu_torch.engines import engine_of

    rows = [r for r in LAYOUT_ROWS if r[0] in TUNED_LAYOUT]
    os.environ.pop("PORTFFT_NO_TUNING", None)
    try:
        for name, n, batch, split, fields, _ in rows:
            plan = pf.Descriptor(lengths=[n], number_of_transforms=batch,
                                 **fields).commit(device="cuda")
            key = tuning._entry_key(plan, "global2")
            shipped = tuning.lookup(plan.config.name, "global2", key)
            entry = plan._raw_fast[pf.Direction.FORWARD]
            engine = getattr(entry, "inner", entry).engine.name
            if shipped is None or engine != engine_of(shipped).name:
                raise SmokeFailure(f"{name}: route {engine}, but the shipped table "
                                   f"holds {shipped} for global2/{key}")
            print(f"row {name:20s} shipped global2/{key} {shipped} -> {engine}")
            del plan
        return layout_main_path(pf, counters, card, rows)
    finally:
        os.environ["PORTFFT_NO_TUNING"] = "1"


def tuned_wrapper_path(pf, counters: dict, card: str) -> None:
    """``WRAPPER_ROWS`` with tuning on, in the run's own tuning cache: for
    each of K17, K18 and K19 a recorded entry for the 65536 = 256 x 256
    plan forces it, and real_131072 (K8a over its half length) and
    strided_large (K7 around it) run as on the REAL and layout main paths,
    that engine launched under each wrapper."""
    from portfft_tpu_torch import tuning
    from portfft_tpu_torch.engines import ENGINES

    real = [r for r in REAL_ROWS if r[0] in WRAPPER_ROWS]
    layout = [r for r in LAYOUT_ROWS if r[0] in WRAPPER_ROWS]
    os.environ.pop("PORTFFT_NO_TUNING", None)
    try:
        probe = pf.Descriptor(lengths=[65536]).commit(device="cuda")
        device, key = probe.config.name, tuning._entry_key(probe, "global2")
        del probe
        for kind in WRAPPER_ENGINES:
            tuning.record(device, "global2", key, dict(ENGINES[kind].params))
            print(f"wrappers on a recorded global2/{key} "
                  f"{ENGINES[kind].params}")
            real_main_path(pf, counters, card, real, ("untangle", kind))
            layout_main_path(pf, counters, card, layout, required=("destride", kind))
        tuning.forget(device, "global2", key)
    finally:
        os.environ["PORTFFT_NO_TUNING"] = "1"


def fused_kernel(plan, kind: str, direction):
    """``(kernel, args)`` of ``plan``'s FUSED entry for ``direction`` run by
    the engine ``kind`` (K2-v1 too on a plan with a fold, which no tuned
    entry reaches), the kernel picking its tile."""
    from portfft_tpu_torch.engines import ENGINES

    entry = plan._raw_fast[direction]
    return dataclasses.replace(entry, engine=ENGINES[kind], bt=0).kernel_args(plan)


def fused_kernel_phase(pf, max_err: dict, card: str) -> dict:
    """Checks K2-v1, K2-v2 and K2-v3 at ``FUSED_KERNEL_CASES``, forward
    (scale 0.5) and backward (scale 2/n), against their plain versions and
    ``torch.fft`` with the two planted faults (the inner twiddle
    conjugated, as K2; and zeros).  Returns ``{kind: (ms, plain_ms,
    library_ms)}`` of each timed alone forward at ``FUSED_ALONE``."""
    alone = {}
    for kind, n, batch in FUSED_KERNEL_CASES:
        plan = pf.Descriptor(lengths=[n], number_of_transforms=batch,
                             forward_scale=0.5, backward_scale=2.0 / n
                             ).commit(device="cuda")
        x = random_raw(2 * batch * n, seed=n)
        for direction, sign in ((pf.Direction.FORWARD, -1),
                                (pf.Direction.BACKWARD, +1)):
            kernel, args = fused_kernel(plan, kind, direction)
            before = launched(kernel)
            r = check_kernel(kind, kernel, args, x, n, sign)
            torch.cuda.synchronize()
            if launched(kernel) != before + 2:  # the call and the planted fault
                raise SmokeFailure(f"{kind} n={n}: launch counter did not rise")
            tile = f" bt={args[2]}" if len(args) == 4 else ""
            report(kind, f"n={n:<6d} batch={batch:<7d}{tile} {direction.value:8s}", r)
            max_err[kind] = max(max_err.get(kind, 0.0), r["err"])
            if sign < 0 and (n, batch) == FUSED_ALONE[kind]:
                ms = time_ms(lambda: kernel(x, *args))
                plain_ms = time_ms(lambda: kernel.plain(x, *args))
                library_ms = time_ms(library_call(x, n, batch, False, True))
                bound, by = bound_of(kind, n, batch)
                alone[kind] = (ms, plain_ms, library_ms)
                print(f"alone  {kind:12s} n={n:<8d} batch={batch:<6d}{tile} kernel "
                      f"{ms:.3f} ms | plain {plain_ms:.3f} ms | torch.fft "
                      f"{library_ms:.3f} ms | bound {bound:.3f} ms ({by}) | {card}")
            del kernel, args
        del plan, x
        torch.cuda.empty_cache()
    return alone


def fused_engines_reached(plan0, batch: int) -> list[str]:
    """The FUSED engines a recorded ``fused2`` entry of ``plan0`` can
    select at ``batch``: engines 2 and 3 reach K2-v2 and K2-v3 on a plan
    with a fold, K2-v1 on one without, where the gate takes the plan."""
    from portfft_tpu_torch.engines import ENGINES, engine_of

    return [k for k in FUSED_KINDS
            if engine_of(ENGINES[k].params, plan0).name == k
            and ENGINES[k].gate(plan0, batch, 0)]


def shipped_engine(plan, n: int) -> tuple[str, dict | None]:
    """The engine the tuning table names for the ``fused2`` key of the
    length-``n`` plan (K2 where it names none), and its entry."""
    from portfft_tpu_torch import tuning
    from portfft_tpu_torch.engines import engine_of

    params = tuning.lookup(plan.config.name, "fused2", f"n{n}")
    engine = "fused2" if params is None else engine_of(params, plan.plans[n]).name
    return engine, params


def fused_shipped_path(pf, counters: dict, card: str) -> list:
    """``FUSED_SHIPPED`` with tuning on and only the shipped table (the
    run's cache holds no ``fused2`` entry yet): real_large (REAL 8192 x
    16Ki, K2's engine at h = 4096 and K8a) and bi_in_4096 (K7 and the 4096
    engine).  Each row's FUSED entry must take the engine the shipped table
    names for n4096; the row is then held to ``torch.fft``, its kernels
    must launch, and it is timed."""
    os.environ.pop("PORTFFT_NO_TUNING", None)
    try:
        _, n, batch, _ = next(r for r in REAL_ROWS if r[0] == "real_large")
        plan = pf.Descriptor(lengths=[n], number_of_transforms=batch,
                             domain=pf.Domain.REAL).commit(device="cuda")
        engine, params = shipped_engine(plan, n // 2)
        inner = plan._raw_fast[pf.Direction.FORWARD].inner
        if inner.engine.name != engine:
            raise SmokeFailure(f"real_large: route {inner.engine.name}, but the shipped "
                               f"table holds {params} for fused2/n{n // 2}")
        x = random_raw(batch * n, seed=0)
        before = {k: launched(counters[k]) for k in ("untangle", engine)}
        y = plan.compute_forward(x)
        torch.cuda.synchronize()
        rose = {k: launched(counters[k]) - before[k] for k in before}
        if min(rose.values()) <= 0:
            raise SmokeFailure(f"real_large: a kernel was not launched: {rose}")
        excess = real_oracle_excess(y, x, n, batch, -1, 1.0)
        if not torch.isfinite(y).all() or not excess <= 1.0:
            raise SmokeFailure(f"real_large shipped: {excess:.3e} times the bound")
        del y
        ms = time_ms(lambda: plan.compute_forward(x))
        print(f"row real_large (shipped fused2/n{n // 2} {params} -> {engine}) "
              f"launches {rose} oracle {excess:.2e}×bound | path {ms:.3f} ms | {card}")
        del plan, x
        torch.cuda.empty_cache()
        rows = [r for r in LAYOUT_ROWS if r[0] in FUSED_SHIPPED]
        for name, n, batch, split, fields, _ in rows:
            plan = pf.Descriptor(lengths=[n], number_of_transforms=batch,
                                 **fields).commit(device="cuda")
            engine, params = shipped_engine(plan, n)
            entry = plan._raw_fast[pf.Direction.FORWARD]
            got = getattr(entry, "inner", entry).engine.name
            if got != engine:
                raise SmokeFailure(f"{name}: route {got}, but the shipped table "
                                   f"holds {params} for fused2/n{n}")
            print(f"row {name:20s} shipped fused2/n{n} {params} -> {engine}")
            del plan
        results, _ = layout_main_path(pf, counters, card, rows,
                                      required=("destride",))
        return results
    finally:
        os.environ["PORTFFT_NO_TUNING"] = "1"


def tuned_fused_path(pf, counters: dict, card: str) -> tuple[dict, dict]:
    """``TUNED_FUSED_ROWS`` through ``Descriptor(...).commit(device="cuda")``
    with tuning on, in the run's own tuning cache: per row, a recorded
    ``fused2`` entry forces each engine the plan's entry can reach
    (``fused_engines_reached``, the kernel picking its tile) and the row is
    held to ``torch.fft`` and timed, with its peak device memory; then,
    with the entry forgotten, ``plan.autotune()`` races K2 and every
    engine at every tile its gate takes (a variant the 1e-3 parity gate
    drops fails the run), each variant's time and the winner are printed,
    and the tuned plan is held and timed again (medium_large_1d both
    ways).  Returns the launches and ``{key: winner}`` of the rows a
    variant other than K2 won."""
    from portfft_tpu_torch import race, tuning
    from portfft_tpu_torch.engines import ENGINES

    os.environ.pop("PORTFFT_NO_TUNING", None)
    winners = {}
    reset_launches()
    fwd = pf.Direction.FORWARD
    try:
        for name, n, batch in TUNED_FUSED_ROWS:
            desc = pf.Descriptor(lengths=[n], number_of_transforms=batch)
            x = random_raw(2 * batch * n, seed=0)
            plan = desc.commit(device="cuda")
            device, key = plan.config.name, tuning._entry_key(plan, "fused2")
            shipped = plan._raw_fast[fwd].engine.name
            reached = fused_engines_reached(plan.plans[n], batch)
            del plan
            for kind in reached:
                tuning.record(device, "fused2", key, dict(ENGINES[kind].params))
                plan = desc.commit(device="cuda")
                if plan._raw_fast[fwd].engine.name != kind:
                    raise SmokeFailure(f"{name}: the recorded {kind} did not route")
                before = launched(counters[kind])
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                y = plan.compute_forward(x)
                torch.cuda.synchronize()
                peak_gib = torch.cuda.max_memory_allocated() / 2**30
                if launched(counters[kind]) != before + 1:
                    raise SmokeFailure(f"{name}: {kind} was not launched once")
                if y.shape != x.shape or not torch.isfinite(y).all():
                    raise SmokeFailure(f"{name} {kind}: output not finite")
                excess = oracle_excess(y, x, n, batch, -1, 1.0)
                if not excess <= 1.0:
                    raise SmokeFailure(f"{name} {kind}: {excess:.3e} times the "
                                       f"oracle bound {oracle_tol(n):.3e}")
                del y
                ms = time_ms(lambda: plan.compute_forward(x))
                print(f"row {name:16s} n={n:<6d} batch={batch:<7d} forced "
                      f"{kind:10s} oracle max|diff|={excess * oracle_tol(n):.3e} "
                      f"| path {ms:.3f} ms {16 * batch * n / ms / 1e6:.1f} GB/s "
                      f"| peak {peak_gib:.2f} GiB | {card}")
                del plan
                torch.cuda.empty_cache()
            tuning.forget(device, "fused2", key)
            plan = desc.commit(device="cuda")
            variants = race._variants_for_entry(plan, plan._raw_fast[fwd])
            times = {}
            won = plan.autotune(times=times)
            if won is not None and len(times) != len(variants):
                raise SmokeFailure(f"{name}: autotune dropped a variant at its "
                                   f"parity gate: raced {sorted(times)} of {variants}")
            engine = plan._raw_fast[fwd].engine.name
            checks = [(plan.compute_forward, -1)]
            if name == "medium_large_1d":
                checks.append((plan.compute_backward, +1))
            tuned_ms = []
            for compute, sign in checks:
                y = compute(x)
                torch.cuda.synchronize()
                excess = oracle_excess(y, x, n, batch, sign, 1.0)
                if not excess <= 1.0:
                    raise SmokeFailure(f"{name} tuned sign {sign:+d}: "
                                       f"{excess:.3e} times the bound")
                del y
                tuned_ms.append(time_ms(lambda: compute(x)))
            library_ms = time_ms(library_call(x, n, batch, False, True))
            bound, by = bound_of("fused2", n, batch)
            print(f"row {name:16s} n={n:<6d} batch={batch:<7d} autotune ms "
                  f"{json.dumps(times)} -> {won} ({engine}; shipped route "
                  f"{shipped}) | tuned path {' / '.join(f'{t:.3f}' for t in tuned_ms)} "
                  f"ms | torch.fft {library_ms:.3f} ms | bound {bound:.3f} ms "
                  f"({by}) | {card}")
            if won:
                winners[key] = won
            del plan, x
            torch.cuda.empty_cache()
    finally:
        os.environ["PORTFFT_NO_TUNING"] = "1"
    launches = {k: launched(c) for k, c in counters.items()}
    print(f"tuned FUSED main-path launches: {launches}")
    print(f"autotune winners (fused2, {card}): {json.dumps(winners, sort_keys=True)}")
    for kind in FUSED_KINDS:
        if launches[kind] == 0:
            raise SmokeFailure(f"kernel {kind} was never launched on the tuned "
                               "FUSED path")
    return launches, winners


def col_mm_declines(pf) -> list[int]:
    """The lengths K10 takes (up to 16384) that K10-mm's gate declines: K10
    runs them under ``{"cm": 1}``."""
    from portfft_tpu_torch.ops import cuda_multidim
    from portfft_tpu_torch.planner import plan_1d

    cfg = pf.DeviceConfig()
    plans = (plan_1d(n, cfg, 4) for n in range(2, 16385))
    return [p.n for p in plans
            if cuda_multidim.col_axis_supported(p, cfg.direct_threshold)
            and not cuda_multidim.col_mm_supported(p)]


def mma_kernel_phase(pf, max_err: dict, card: str) -> dict:
    """Checks K10-mm at ``MMA_COL_CASES`` and K16 at ``MMA_GLOBAL_CASES``,
    forward (scale 0.5) and backward (scale 2/N), against their plain
    versions and ``torch.fft`` with the two planted faults.  Returns
    ``{kind: (ms, plain_ms, library_ms)}`` of each timed alone forward at
    ``MMA_ALONE``, where the kernel it stands in for is timed beside it."""
    from portfft_tpu_torch.ops import cuda_multidim

    declined = col_mm_declines(pf)
    print(f"col_mm declines {len(declined)} lengths K10 takes (K10 runs them; "
          f"every DIRECT length off 128ℤ): {declined[:6]} … {declined[-3:]}")
    alone = {}
    for shape in MMA_COL_CASES:
        x = random_raw(2 * math.prod(shape), seed=sum(shape))
        n = shape[1]
        for sign in (-1, +1):
            scale = 0.5 if sign < 0 else 2.0 / n
            kernel, args = md_kernel_case(pf, "col_mm", shape, sign, scale)
            before = launched(kernel)
            r = check_md("col_mm", kernel, args, x, shape, sign)
            torch.cuda.synchronize()
            if launched(kernel) != before + 2:  # the call and the planted fault
                raise SmokeFailure(f"col_mm {shape}: launch counter did not rise")
            report("col_mm", f"{str(shape):18s} sign={sign:+d}", r)
            max_err["col_mm"] = max(max_err.get("col_mm", 0.0), r["err"])
            if sign < 0:  # every case timed beside K10; the table's in full
                ms = time_ms(lambda: kernel(x, *args))
                k10_ms = time_ms(lambda: cuda_multidim.col(x, *args))
                bound, by = bound_of("col_mm", n, math.prod(shape) // n)
                line = (f"col_mm     {str(shape):18s} kernel {ms:.3f} ms | K10 "
                        f"{k10_ms:.3f} ms | bound {bound:.3f} ms ({by})")
                if shape != MMA_ALONE["col_mm"]:
                    print(f"time   {line} | {card}")
                else:
                    plain_ms = time_ms(lambda: kernel.plain(x, *args))
                    library_ms = time_ms(fftn_call(x, shape, (1,), True))
                    alone["col_mm"] = (ms, plain_ms, library_ms)
                    print(f"alone  {line} | plain {plain_ms:.3f} ms | torch.fft "
                          f"{library_ms:.3f} ms | {card}")
            del kernel, args
        del x
        torch.cuda.empty_cache()
    for n, batch in MMA_GLOBAL_CASES:
        plan = pf.Descriptor(lengths=[n], number_of_transforms=batch,
                             forward_scale=0.5, backward_scale=2.0 / n
                             ).commit(device="cuda")
        g1, g2 = (s.n for s in plan.plans[n].sub)
        x = random_raw(2 * batch * n, seed=n)
        for direction, sign in ((pf.Direction.FORWARD, -1),
                                (pf.Direction.BACKWARD, +1)):
            kernel, args = tuned_kernel(plan, "global3", direction)
            before = launched(kernel)
            r = check_kernel("global3", kernel, args, x, n, sign)
            torch.cuda.synchronize()
            if launched(kernel) != before + 2:  # the call and the planted fault
                raise SmokeFailure(f"global3 n={n}: launch counter did not rise")
            report("global3", f"{g1}x{g2} batch={batch:<6d} {direction.value:8s}", r)
            max_err["global3"] = max(max_err.get("global3", 0.0), r["err"])
            if sign < 0 and (n, batch) == MMA_ALONE["global3"]:
                ms = time_ms(lambda: kernel(x, *args))
                k3, k3_args = tuned_kernel(plan, "global2", direction)
                k3_ms = time_ms(lambda: k3(x, *k3_args))
                ov, ov_args = tuned_kernel(plan, "global_bf_ov", direction)
                ov_ms = time_ms(lambda: ov(x, *ov_args))
                plain_ms = time_ms(lambda: kernel.plain(x, *args))
                library_ms = time_ms(library_call(x, n, batch, False, True))
                bound, by = bound_of("global3", n, batch)
                alone["global3"] = (ms, plain_ms, library_ms)
                print(f"alone  global3    n={n:<8d} batch={batch:<6d} kernel {ms:.3f} "
                      f"ms | K3 {k3_ms:.3f} ms | K5-ov {ov_ms:.3f} ms | plain "
                      f"{plain_ms:.3f} ms | torch.fft {library_ms:.3f} ms | bound "
                      f"{bound:.3f} ms ({by}) | {card}")
                del k3_args, ov_args
            del kernel, args
        del plan, x
        torch.cuda.empty_cache()
    return alone


def tuned_md_path(pf, counters: dict, card: str) -> tuple[dict, dict]:
    """``MD_ROWS`` with tuning on, in the run's own tuning cache: per row,
    each variant of its ``multidim`` or ``bi_col`` entry
    (``race._variants_for_entry``) is forced by a recorded entry, must
    route and launch its kernels (K10-mm under ``cm``, no K11 under
    ``{"m2": 0}``), is held to ``torch.fft`` and timed; then, with the
    entry forgotten, ``plan.autotune()`` races the variants (each one's ms
    and the winner printed) and the tuned plan is held and timed.  Returns
    the launches and ``{kind/key: winner}``."""
    from portfft_tpu_torch import fastpath, race, tuning

    os.environ.pop("PORTFFT_NO_TUNING", None)
    winners = {}
    reset_launches()
    try:
        for name, lengths, batch, dname, bi in MD_ROWS:
            direction = pf.Direction(dname)
            forward = direction == pf.Direction.FORWARD
            sign = -1 if forward else +1
            kw = dict(forward_strides=[batch], backward_strides=[batch],
                      forward_distance=1, backward_distance=1) if bi else {}
            desc = pf.Descriptor(lengths=list(lengths), number_of_transforms=batch,
                                 **kw)
            n = math.prod(lengths)
            shape = (1, n, batch) if bi else (batch, *lengths)
            dims = (1,) if bi else tuple(range(1, len(shape)))
            x = random_raw(2 * batch * n, seed=0)
            plan = desc.commit(device="cuda")
            entry = plan._raw_fast[direction]
            inner = getattr(entry, "inner", entry)
            kind, key = inner.tuning_kind, race._key_of(plan, inner)
            device = plan.config.name
            # the static route: no entry of an earlier row or the shipped table
            tuning.record(device, kind, key, {})
            plan = desc.commit(device="cuda")
            entry = plan._raw_fast[direction]
            static = md_kinds(getattr(entry, "inner", entry))
            variants = race._variants_for_entry(plan, entry)
            del plan
            for params in variants:
                tuning.record(device, kind, key, params)
                plan = desc.commit(device="cuda")
                kinds = layout_kinds(plan._raw_fast[direction])
                if ("col_mm" in kinds) != bool(params.get("cm")) or ("md2" in kinds) != (
                        "md2" in static and bool(params.get("m2", 1))):
                    raise SmokeFailure(f"{name}: {params} routed {kinds}")
                compute = plan.compute_forward if forward else plan.compute_backward
                before = {k: launched(counters[k]) for k in kinds}
                y = compute(x)
                torch.cuda.synchronize()
                rose = {k: launched(counters[k]) - before[k] for k in kinds}
                if min(rose.values()) <= 0:
                    raise SmokeFailure(f"{name} {params}: a kernel of the path was "
                                       f"not launched: {rose}")
                if y.shape != x.shape or not torch.isfinite(y).all():
                    raise SmokeFailure(f"{name} {params}: output not finite")
                excess = nd_oracle_excess(y, x, shape, dims, sign, 1.0)
                if not excess <= 1.0:
                    raise SmokeFailure(f"{name} {params}: {excess:.3e} times the "
                                       f"oracle bound {oracle_tol(n):.3e}")
                del y
                ms = time_ms(lambda: compute(x))
                print(f"row {name:22s} forced {json.dumps(params):22s} "
                      f"{'+'.join(kinds):16s} launches {rose} oracle max|diff|="
                      f"{excess * oracle_tol(n):.3e} | path {ms:.3f} ms "
                      f"{16 * batch * n / ms / 1e6:.1f} GB/s | {card}")
                del plan
                torch.cuda.empty_cache()
            tuning.forget(device, kind, key)
            plan = desc.commit(device="cuda")
            times = {}
            won = plan.autotune(times=times)
            compute = plan.compute_forward if forward else plan.compute_backward
            kinds = layout_kinds(plan._raw_fast[direction])
            if won is None or kinds != layout_kinds(
                    fastpath.with_engine(plan, entry, won)):
                raise SmokeFailure(f"{name}: autotune won {won}, routed {kinds}")
            y = compute(x)
            torch.cuda.synchronize()
            excess = nd_oracle_excess(y, x, shape, dims, sign, 1.0)
            if not excess <= 1.0:
                raise SmokeFailure(f"{name} tuned: {excess:.3e} times the bound")
            del y
            ms = time_ms(lambda: compute(x))
            library_ms = time_ms(fftn_call(x, shape, dims, forward))
            print(f"row {name:22s} autotune ms {json.dumps(times)} -> {won} "
                  f"({'+'.join(kinds)}; static {'+'.join(static)}) | tuned path "
                  f"{ms:.3f} ms | torch.fft {library_ms:.3f} ms | {card}")
            winners[f"{kind}/{key}"] = won
            del plan, x
            torch.cuda.empty_cache()
    finally:
        os.environ["PORTFFT_NO_TUNING"] = "1"
    launches = {k: launched(c) for k, c in counters.items()}
    print(f"tuned multi-dim main-path launches: {launches}")
    print(f"autotune winners (multidim/bi_col, {card}): "
          f"{json.dumps(winners, sort_keys=True)}")
    if launches["col_mm"] == 0:
        raise SmokeFailure("kernel col_mm was never launched on the tuned "
                           "multi-dim path")
    return launches, winners


def kernel_table(max_err, c2c_rows, c2c_launches, real_rows, real_launches,
                 alone, md_launches, md_alone, plane_launches,
                 plane_alone, split_launches, split_alone, layout_launches,
                 stride_alone, tuned_launches, tuned_alone, fused_launches,
                 fused_alone, mma_launches, mma_alone, real_plane_launches,
                 real_plane_alone) -> list[dict]:
    """One entry per kernel.  K1-K3 and K9 take their numbers from the first
    main-path row that runs them (the path is that one kernel); K8a and K8b
    from their timing alone at real_large, where no single ``torch.fft``
    call computes the same function; K10 and K11 from their timing alone at
    ``MD_ALONE``, with the launches of the multi-dim main path; K8a-w and
    K15-bf from their timing alone at ``REAL_PLANE_ALONE``, with the
    launches of the REAL plane path (K8a-w has no library call, as K8a)."""
    def entry(kind, launches, ms, plain_ms, library_ms, n, batch, bound=None):
        source, replaces = SOURCES[kind]
        bound, by = bound or bound_of(kind, n, batch)
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
    g1, g2, batch = GLOBAL_PLANES_ALONE
    kernels.append(entry("global2_planes", split_launches["global2_planes"],
                         *split_alone["global2_planes"], g1 * g2, batch))
    bpre, length, rest = AXIS_ALONE
    kernels.append(entry("axis_m2", split_launches["axis_m2"],
                         *split_alone["axis_m2"], length, bpre * rest))
    m, split = next((m, sp) for name, m, sp in STRIDE_CASES if name == STRIDE_ALONE)
    kernels.append(entry("destride", layout_launches["destride"]
                         + layout_launches["restride"], *stride_alone, m[3], m[4],
                         stride_bound(m, split)))
    for kind in TUNED_KINDS:
        kernels.append(entry(kind, tuned_launches[kind], *tuned_alone[kind],
                             *TUNED_ALONE[kind]))
    for kind in FUSED_KINDS:
        kernels.append(entry(kind, fused_launches[kind], *fused_alone[kind],
                             *FUSED_ALONE[kind]))
    bpre, length, rest = MMA_ALONE["col_mm"]
    kernels.append(entry("col_mm", mma_launches["col_mm"], *mma_alone["col_mm"],
                         length, bpre * rest))
    kernels.append(entry("global3", mma_launches["global3"],
                         *mma_alone["global3"], *MMA_ALONE["global3"]))
    for kind in REAL_PLANE_KINDS:
        kernels.append(entry(kind, real_plane_launches[kind],
                             *real_plane_alone[kind], *REAL_PLANE_ALONE[kind]))
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

    # The phases before the tuned ones run the static routes (K3 for GLOBAL
    # plans); the tuned phase writes its own cache, removed at the end.
    tune_dir = tempfile.mkdtemp(prefix="portfft_tuning_")
    os.environ["PORTFFT_NO_TUNING"] = "1"
    os.environ["PORTFFT_TUNING_CACHE"] = os.path.join(tune_dir, "tuning.json")
    try:
        phases_run(t_start, card)
    finally:
        shutil.rmtree(tune_dir, ignore_errors=True)


def phases_run(t_start: float, card: str) -> None:
    import portfft_tpu_torch as pf
    from portfft_tpu_torch.ops import (
        _build,
        cuda_axis,
        cuda_bluestein,
        cuda_chain,
        cuda_fft,
        cuda_global,
        cuda_global_bf,
        cuda_global_ilv,
        cuda_io,
        cuda_multidim,
        cuda_real,
        cuda_stride,
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
                "bluestein": cuda_bluestein.bluestein,
                "global2_planes": cuda_global.global2_planes,
                "axis_m2": cuda_axis.axis_m2,
                "destride": cuda_stride.destride,
                "restride": cuda_stride.restride,
                "global_sq": cuda_global.global_sq,
                "global_bf": cuda_global_bf.global_bf,
                "global_bf_ov": cuda_global_bf.global_bf_ov,
                "fused2_v1": cuda_fft.fused2_v1, "fused2_v2": cuda_fft.fused2_v2,
                "fused2_v3": cuda_fft.fused2_v3, "col_mm": cuda_multidim.col_mm,
                "global3": cuda_global.global3,
                "global_fused": cuda_global.global_fused,
                "global_ilv": cuda_global_ilv.global_ilv,
                "global_bf2": cuda_global_bf.global_bf2,
                "global2_ftw": cuda_global.global2_ftw,
                "untangle_wide": cuda_real.untangle_wide,
                "bluestein_bf": cuda_bluestein.bluestein_bf}
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
    stride_alone = phase("K7 kernels", stride_kernel_phase, pf, max_err, card)
    c2c_rows, c2c_launches = phase("C2C main path", c2c_main_path, pf, counters, card)
    real_rows, real_launches = phase("REAL main path", real_main_path, pf,
                                     counters, card)
    _, md_launches = phase("multi-dim main path", md_main_path, pf, counters, card)
    _, plane_launches = phase("plane main path", plane_main_path, pf, counters,
                              card)
    _, split_launches, _ = phase(
        "SPLIT main path", plane_rows, pf, SPLIT_ROWS, True, counters, card,
        ("chain", "global2_planes", "bluestein", "axis_m2"))
    _, more_launches, kept = phase(
        "plane rows", plane_rows, pf, PLANE_MORE_ROWS, False, counters, card,
        ("deinterleave", "interleave", "chain", "global2_planes", "axis_m2"),
        ("bluestein_50431897",))
    # After the rows: K14's post case at 16384 x 8192 reads the tables of
    # bluestein_50431897's plan, whose host tables take minutes to build.
    split_alone = phase("K14/K12 kernels", split_kernel_phase, pf, max_err,
                        card, kept)
    del kept
    _, layout_launches = phase("layout main path", layout_main_path, pf,
                               counters, card)
    real_plane_alone = phase("REAL plane kernels", real_plane_kernel_phase, pf,
                             max_err, card)
    _, real_plane_launches = phase("REAL plane main path", real_plane_path, pf,
                                   counters, card)
    tuned_alone = phase("tuned GLOBAL kernels", tuned_kernel_phase, pf, max_err,
                        card)
    phase("tuned layout rows", tuned_layout_path, pf, counters, card)
    tuned_launches, _ = phase("tuned main path", tuned_main_path, pf, counters,
                              card)
    phase("tuned wrappers", tuned_wrapper_path, pf, counters, card)
    fused_alone = phase("FUSED kernels", fused_kernel_phase, pf, max_err, card)
    phase("FUSED shipped rows", fused_shipped_path, pf, counters, card)
    fused_launches, _ = phase("tuned FUSED main path", tuned_fused_path, pf,
                              counters, card)
    mma_alone = phase("tensor-core kernels", mma_kernel_phase, pf, max_err, card)
    md_tuned_launches, _ = phase("tuned multi-dim main path", tuned_md_path, pf,
                                 counters, card)
    phase("AFNO", afno_phase, pf, card)
    phase("K9 alone", k9_phase, pf, card)
    phase("fp64 DNS", dns_phase, pf, card)
    phase("K10 alone", k10_phase, pf, card)
    phase("K1 alone", k1_phase, pf, card)
    # K10-mm runs on the tuned multi-dim path, K16 on the tuned GLOBAL one
    mma_launches = {"col_mm": md_tuned_launches["col_mm"],
                    "global3": tuned_launches["global3"]}
    # K14 and K12 run on both paths of this slice
    new_launches = {k: split_launches[k] + more_launches[k] for k in SPLIT_KINDS}
    print(f"phases: {'; '.join(phases)}; total {time.perf_counter() - t_start:.1f} s")
    kernels = kernel_table(max_err, c2c_rows, c2c_launches, real_rows,
                           real_launches, alone, md_launches, md_alone,
                           plane_launches, plane_alone, new_launches, split_alone,
                           layout_launches, stride_alone, tuned_launches,
                           tuned_alone, fused_launches, fused_alone,
                           mma_launches, mma_alone, real_plane_launches,
                           real_plane_alone)
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
