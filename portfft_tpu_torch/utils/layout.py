"""Stride / distance / layout helpers (same rules as
``portfft_tpu.utils.layout``), and :class:`Rows`, the affine map of a 1D
layout that the strided copy kernel K7 (``ops/cuda_stride``) takes.

The JAX package gathers a layout that is no regular rectangle through a
host or traced index array (``committed._indices``, ``_indices_traced``).
Nothing here needs one: every 1D layout is one affine map, which K7 takes
whatever its stride and distance, and multi-dimensional transforms are
PACKED (validation), so an offset is all they carry.
"""

from __future__ import annotations

import dataclasses
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


@dataclasses.dataclass(frozen=True)
class Rows:
    """A 1D layout: element (b, j) of the domain's buffer sits at
    ``offset + b·distance + j·stride``, for b < ``batch`` and j < ``n``."""

    offset: int
    stride: int
    distance: int
    n: int
    batch: int

    def index_bound(self) -> int:
        """Largest element index the layout touches (the JAX package's
        ``_index_bound`` of a 1D layout)."""
        return (self.offset + self.distance * (self.batch - 1)
                + self.stride * (self.n - 1))

    @property
    def contiguous(self) -> bool:
        """Whether the elements are one packed block at ``offset``."""
        return self.stride == 1 and self.distance == self.n


def rows_1d(descriptor, direction: Direction) -> Rows:
    """The :class:`Rows` of a 1D domain, for any strides and distance (the
    JAX package's ``_regular_1d`` without its rectangle test).  With one
    transform the declared distance is never read: it becomes the span, so
    nothing is sized by it."""
    (n,) = descriptor.domain_lengths(direction)
    (stride,) = descriptor.get_strides(direction)
    batch = descriptor.number_of_transforms
    distance = (descriptor.get_distance(direction) if batch > 1
                else (n - 1) * stride + 1)
    return Rows(descriptor.get_offset(direction), stride, distance, n, batch)
