"""The work of one call, counted from its shapes alone, and the card's peaks.

Bytes: each input byte read once and each output byte written once, whatever
the kernels read again: 16·batch·N for a C2C call of N points a transform,
4·batch·N + 8·batch·N/n·(n/2 + 1) for an R2C call whose last axis is n (the
upstream ``throughput`` counter, portFFT ``ops_estimate.hpp:47-50``).
Flops: the nominal 5·N·log2 N a complex transform and 2.5·N·log2 N a real
one.  Neither depends on which kernels run the call, so a fused or split
kernel leaves the count as it is.

The least time of a call is the larger of its bytes over the memory rate and
its flops over the fp32 rate outside the tensor cores, at the published peaks
of an H100 SXM at its full 700 W (NVIDIA's data sheet).  A card set to a
lower power limit runs slower; the harness reports the limit beside every
share of these peaks.
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def points(lengths) -> int:
    """Points of one transform: the product of its lengths."""
    return math.prod(lengths)


def work(domain: str, lengths, batch: int) -> tuple[int, float]:
    """``(bytes, flops)`` of one forward call of ``batch`` transforms of
    ``lengths`` in ``domain`` (``"COMPLEX"`` or ``"REAL"``)."""
    n = points(lengths)
    lg = max(math.log2(n), 1.0)
    if domain == "COMPLEX":
        return 16 * batch * n, 5.0 * n * lg * batch
    if domain == "REAL":
        bins = n // lengths[-1] * (lengths[-1] // 2 + 1)
        return 4 * batch * n + 8 * batch * bins, 2.5 * n * lg * batch
    raise ValueError(f"unknown domain {domain!r}")


def input_bytes(domain: str, lengths, batch: int) -> int:
    """Bytes of one forward call's input."""
    return (8 if domain == "COMPLEX" else 4) * batch * points(lengths)


def least_time(domain: str, lengths, batch: int) -> tuple[float, str]:
    """``(seconds, bound_by)``: the least time the card could take for one
    call, and whether its bytes or its flops set it."""
    nbytes, flops = work(domain, lengths, batch)
    by_bytes, by_flops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return max(by_bytes, by_flops), "bytes" if by_bytes >= by_flops else "flops"
