"""Stride / distance / layout helpers (same rules as
``portfft_tpu.utils.layout``)."""

from __future__ import annotations

import math
from typing import Sequence

from ..enums import Direction, Layout


def default_strides(lengths: Sequence[int]) -> list[int]:
    """Row-major strides for ``lengths`` with contiguous last dimension:
    ``[prod(l1..ld-1), prod(l2..ld-1), ..., 1]``."""
    d = len(lengths)
    strides = [1] * d
    for i in range(d - 2, -1, -1):
        strides[i] = strides[i + 1] * lengths[i + 1]
    return strides


def flattened_length(lengths: Sequence[int]) -> int:
    """Product of all lengths."""
    return math.prod(lengths)


def has_default_strides_and_distance(
    lengths: Sequence[int], strides: Sequence[int], distance: int
) -> bool:
    """True if strides/distance equal the packed default."""
    return (
        list(strides) == default_strides(lengths)
        and distance == flattened_length(lengths)
    )


def is_batch_interleaved(
    lengths: Sequence[int],
    strides: Sequence[int],
    distance: int,
    number_of_transforms: int,
) -> bool:
    """True for 1D transforms laid out batch-innermost: ``distance == 1``
    and ``stride == number_of_transforms``."""
    return (
        len(lengths) == 1
        and distance == 1
        and list(strides) == [number_of_transforms]
    )


def classify_layout(
    lengths: Sequence[int],
    strides: Sequence[int],
    distance: int,
    number_of_transforms: int,
) -> Layout:
    """PACKED / BATCH_INTERLEAVED / UNPACKED."""
    if has_default_strides_and_distance(lengths, strides, distance):
        return Layout.PACKED
    if is_batch_interleaved(lengths, strides, distance, number_of_transforms):
        return Layout.BATCH_INTERLEAVED
    return Layout.UNPACKED


def get_layout(descriptor, direction: Direction) -> Layout:
    """Layout of the given domain of a descriptor."""
    return classify_layout(
        descriptor.domain_lengths(direction),
        descriptor.get_strides(direction),
        descriptor.get_distance(direction),
        descriptor.number_of_transforms,
    )
