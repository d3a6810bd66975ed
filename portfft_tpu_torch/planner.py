"""Transform planner: factorization and implementation-level selection.

The planning rules of ``portfft_tpu.planner``, in pure Python: the same
``DeviceConfig`` geometry gives the same :class:`Plan1D` for every length,
so each kernel here receives the decomposition its reference counterpart
receives.  Levels:

* DIRECT    — n ≤ ``direct_threshold``: one DFT of the whole length.
* FUSED     — n = a·128 (3 ≤ a ≤ 256) in one two-stage kernel, or a longer
              factor chain whose working set fits the budget.
* GLOBAL    — n = G1·G2 four-step decomposition in two passes.
* BLUESTEIN — n has a prime factor > ``max_factor``: chirp-z through a
              padded convolution.

A GLOBAL split recorded in the tuning table (``tuning.lookup(cfg.name,
"global_split", f"n{n}")``) replaces the rule's split where it factors n,
as in the JAX package.  The JAX package also has a native C++ core of the
same rules; this package does not.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

from .config import DeviceConfig
from .enums import Level


def prime_factorize(n: int) -> list[int]:
    """Trial-division prime factorization, ascending."""
    out = []
    d = 2
    while d * d <= n:
        while n % d == 0:
            out.append(d)
            n //= d
        d += 1 if d == 2 else 2
    if n > 1:
        out.append(n)
    return out


def largest_prime_factor(n: int) -> int:
    return prime_factorize(n)[-1] if n > 1 else 1


def factor_chain(n: int, max_factor: int) -> Optional[list[int]]:
    """Split ``n`` into factors each ≤ ``max_factor``, greedily largest-first
    (fewest passes).

    Returns None when ``n`` has a prime factor exceeding ``max_factor``
    (→ Bluestein).
    """
    if n == 1:
        return [1]
    if largest_prime_factor(n) > max_factor:
        return None
    chain = []
    rest = n
    while rest > 1:
        f = 0
        for cand in range(min(rest, max_factor), 1, -1):
            if rest % cand == 0:
                f = cand
                break
        chain.append(f)
        rest //= f
    return chain


def bluestein_conv_n(n: int, single_pass_cap: int = 128 * 256) -> int:
    """Smallest highly-composite convolution length ≥ 2n−1 for the chirp-z
    transform: the next power of two, or a 3·2^k / 9·2^k size when that is
    shorter (9·2^k only beyond ``single_pass_cap``).  The same rule as the
    JAX package, so both plan the same convolution."""
    need = 2 * n - 1
    best = 1 << need.bit_length()
    for odd in (3, 9):
        c = odd << max(0, (need // odd).bit_length())
        while c < need:
            c *= 2
        if c % 128 == 0 and c < best and (odd == 3 or c > single_pass_cap):
            best = c
    return best


def stage_shapes(factors: list[int]) -> list[tuple[int, int]]:
    """Per-stage (f, m) pairs of the Cooley–Tukey chain: stage i contracts
    factor ``f_i`` over sub-length ``m_i = prod(factors[i+1:])``."""
    shapes = []
    m = math.prod(factors)
    for f in factors:
        m //= f
        shapes.append((f, m))
    return shapes


@dataclasses.dataclass
class Plan1D:
    """Committed plan for one transform dimension."""

    n: int
    level: Level
    #: Stockham factor chain (DIRECT/FUSED); empty for GLOBAL/BLUESTEIN.
    factors: list[int]
    #: GLOBAL: the two four-step sub-plans (n = sub[0].n * sub[1].n).
    sub: Optional[tuple["Plan1D", "Plan1D"]] = None
    #: BLUESTEIN: padded convolution length plan (power of two ≥ 2n-1).
    conv: Optional["Plan1D"] = None

    def describe(self) -> str:
        if self.level == Level.GLOBAL:
            return (
                f"global({self.sub[0].describe()} x {self.sub[1].describe()})"
            )
        if self.level == Level.BLUESTEIN:
            return f"bluestein(n={self.n}, conv={self.conv.describe()})"
        return f"{self.level.value}(n={self.n}, factors={self.factors})"


def fused_vmem_bytes(
    n: int, factors: list[int], batch_tile: int, itemsize: int
) -> int:
    """The JAX package's working-set estimate of its fused kernel, a
    planning budget that decides FUSED against GLOBAL."""
    data = batch_tile * n * itemsize
    in_out = 2 * (2 * data) * 2  # (re+im) in and out, ×2 double buffering
    scratch = 2 * (2 * data)  # ping/pong planes
    tables = sum(2 * f * f * itemsize for f in set(factors))
    tw = sum(2 * f * m * itemsize for f, m in stage_shapes(factors) if m > 1)
    return in_out + scratch + tables + tw


def _fused_capable(n: int, factors, cfg: DeviceConfig, itemsize: int) -> bool:
    if factors is None:
        return False
    return (
        fused_vmem_bytes(n, factors, cfg.sublane, itemsize) <= cfg.vmem_budget
    )


def two_stage_vmem_bytes(a: int, bt: int, itemsize: int = 4) -> int:
    """The JAX package's working-set estimate of its two-stage [a, 128]
    kernel at batch tile ``bt`` (a planning budget)."""
    n = a * 128
    ln = bt * 128
    return (
        2 * 2 * bt * 2 * n * itemsize      # in/out flat blocks, 2 buffers
        + 2 * bt * a * 128 * itemsize      # plane scratches
        + 8 * a * ln * itemsize            # stage tensors + bf16 temps
        + 2 * a * ln * itemsize            # interleave scratch
    )


def two_stage_smem_bytes(a: int, bt: int, engine: str) -> int:
    """Shared memory a block of the FUSED [a, 128] kernel ``engine``
    (``"fused2_v1"``, ``"fused2_v2"`` or ``"fused2_v3"``) takes to hold
    ``bt`` transforms, as the kernels in ``csrc/fft_fused2_v*.cu`` lay it
    out: the a-point and 128-point root tables (float2), then per
    transform K2-v1's two tiles of 128 rows of a + 1 float2, or K2-v2's
    (re, im) planes and K2-v3's float2 tile of a rows of 129 elements.
    Judged against ``config.H100_SMEM_PER_BLOCK``; beside the JAX package's
    ``two_stage_vmem_bytes``, which it does not replace."""
    per = 2 * 128 * (a + 1) if engine == "fused2_v1" else a * 129
    return 8 * (a + 128 + bt * per)


def _two_stage_vmem_ok(a: int, cfg: DeviceConfig, itemsize: int) -> bool:
    """True when the two-stage estimate at the smallest batch tile
    128/gcd(a, 128) fits the budget."""
    bt = 128 // math.gcd(a, 128)
    return two_stage_vmem_bytes(a, bt, itemsize) <= cfg.vmem_budget


def _global_split(n: int, cfg: DeviceConfig, itemsize: int) -> tuple[int, int]:
    """Four-step split n = G1·G2 (returned as ``(G1, G2)``).

    Preference order, the JAX package's pure-Python rule:

    1. Both halves DIRECT (≤ direct_threshold, 8-aligned), balanced.
    2. G1 = a·128 FUSED with G2 DIRECT, minimizing a + 128 + G2 complex
       multiply-adds per element, within the pass-1 working-set budget.
    3. Balanced search over anything plannable (FUSED × FUSED, odd
       radices).  The GLOBAL kernel here does not take these yet.
    """
    root = int(math.isqrt(n))
    # 1) both-direct balanced
    for g1 in range(root, 1, -1):
        if n % g1:
            continue
        g2 = n // g1
        if (
            g2 <= cfg.direct_threshold
            and g1 <= cfg.direct_threshold
            and g2 % 8 == 0
            and g1 % 8 == 0
        ):
            return g2, g1
    # 2) one-fused: G1 = a·128, G2 direct, fewest multiply-adds first
    pass_budget = int(cfg.vmem_bytes * 3 / 4)
    best = None
    for a in (8, 16, 32, 64, 128):
        g1 = a * 128
        if n % g1:
            continue
        g2 = n // g1
        if not (1 < g2 <= cfg.direct_threshold and g2 % 8 == 0):
            continue
        # the JAX package's pass-1 working set at its minimum tile t=64
        if 18 * 64 * g1 * itemsize + 2 * 128 * a * 128 * itemsize > pass_budget:
            continue
        cost = a + 128 + g2
        if best is None or cost < best[0]:
            best = (cost, g1, g2)
    if best is not None:
        return best[1], best[2]
    # 3) legacy balanced search
    fallback = None
    for g1 in range(root, 1, -1):
        if n % g1:
            continue
        g2 = n // g1
        for a, b in ((g2, g1), (g1, g2)):
            ca = factor_chain(a, cfg.max_factor)
            cb = factor_chain(b, cfg.max_factor)
            ok_a = a <= cfg.direct_threshold or _fused_capable(a, ca, cfg, itemsize)
            ok_b = b <= cfg.direct_threshold or _fused_capable(b, cb, cfg, itemsize)
            if ca and cb and ok_a and ok_b:
                return a, b
        if fallback is None:
            fallback = (n // g1, g1)
    if fallback is None:
        # n is prime or near-prime beyond max_factor — caller handles
        # via Bluestein before reaching here.
        raise AssertionError(f"no global split for n={n}")
    return fallback


def plan_1d(n: int, cfg: DeviceConfig, itemsize: int) -> Plan1D:
    """Plan one transform dimension."""
    if n <= cfg.direct_threshold:
        # One DFT of the whole length; primality is irrelevant.
        return Plan1D(n=n, level=Level.DIRECT, factors=[n])

    chain = factor_chain(n, cfg.max_factor)
    if chain is None:
        # Large prime factor: if n itself is a product with large prime p,
        # peel the smooth part into a four-step with the Bluestein side.
        p = largest_prime_factor(n)
        if p == n:
            return Plan1D(
                n=n,
                level=Level.BLUESTEIN,
                factors=[],
                conv=plan_1d(
                    bluestein_conv_n(n, 2 * cfg.max_factor * cfg.lane),
                    cfg,
                    itemsize,
                ),
            )
        return Plan1D(
            n=n,
            level=Level.GLOBAL,
            factors=[],
            sub=(plan_1d(n // p, cfg, itemsize), plan_1d(p, cfg, itemsize)),
        )

    # Prefer the two-stage shape [a, 128] up to a = 2·max_factor (n ≤ 32768
    # on the default geometry), as the JAX package does.
    a = n // cfg.lane
    if (
        n % cfg.lane == 0
        and 3 <= a <= 2 * cfg.max_factor
        and _two_stage_vmem_ok(a, cfg, itemsize)
    ):
        return Plan1D(n=n, level=Level.FUSED, factors=[a, cfg.lane])

    if _fused_capable(n, chain, cfg, itemsize):
        return Plan1D(n=n, level=Level.FUSED, factors=chain)

    g1, g2 = _global_split(n, cfg, itemsize)
    # a measured split (tuning.record(device, "global_split", f"n{n}", ...)),
    # ignored where it does not factor n
    from . import tuning

    tuned = tuning.lookup(cfg.name, "global_split", f"n{n}")
    if tuned and tuned.get("g1", 0) * tuned.get("g2", 0) == n:
        g1, g2 = tuned["g1"], tuned["g2"]
    return Plan1D(
        n=n,
        level=Level.GLOBAL,
        factors=[],
        sub=(plan_1d(g1, cfg, itemsize), plan_1d(g2, cfg, itemsize)),
    )
