"""Commit-time descriptor validation.

The rules of ``portfft_tpu.validation``: the same configurations raise
:class:`InvalidConfiguration` (inconsistent problems — zero sizes,
overlapping batches, in-place stride mismatches) and
:class:`UnsupportedConfiguration` (valid but outside the supported
envelope).  What this package cannot run yet is declined later, at plan
registration (``fastpath.register``).
"""

from __future__ import annotations

from typing import Sequence

from .enums import Direction, Domain, Layout, Placement
from .exceptions import InvalidConfiguration, UnsupportedConfiguration
from .utils.layout import get_layout


def _validate_lengths(lengths: Sequence[int]) -> None:
    if len(lengths) == 0:
        raise InvalidConfiguration(
            "Invalid lengths, must have at least 1 dimension"
        )
    for i, length in enumerate(lengths):
        if length <= 0:
            raise InvalidConfiguration(
                f"Invalid lengths[{i}]={length}, must be positive"
            )


def _validate_strides_distance_basic(
    lengths, number_of_transforms, strides, distance, domain_str
) -> None:
    if len(strides) != len(lengths):
        raise InvalidConfiguration(
            f"Mismatching {domain_str} strides length got {len(strides)} "
            f"expected {len(lengths)}"
        )
    for i, stride in enumerate(strides):
        if stride <= 0:
            raise InvalidConfiguration(
                f"Invalid {domain_str} stride[{i}]={stride}, must be positive"
            )
    if number_of_transforms > 1 and distance <= 0:
        # negative distances would walk before the buffer start and the
        # overlap checks' modular walk assumes a positive step
        raise InvalidConfiguration(
            f"Invalid {domain_str} distance {distance}, must be positive for "
            "batched FFTs"
        )


def _multidim_overlap_check(
    lengths, number_of_transforms, strides, distance, domain_str
) -> None:
    """No overlap within/between batches for N-D transforms.

    Treat batch as one extra dimension with stride ``distance``, sort
    dimensions by stride, and demand each dimension's extent fits under the
    next-larger stride.
    """
    gen_strides = list(strides)
    gen_sizes = list(lengths)
    if number_of_transforms > 1:
        gen_strides.append(distance)
        gen_sizes.append(number_of_transforms)
    order = sorted(range(len(gen_sizes)), key=lambda i: gen_strides[i])
    for prev, cur in zip(order, order[1:]):
        if gen_strides[prev] * gen_sizes[prev] > gen_strides[cur]:
            raise InvalidConfiguration(
                f"Domain {domain_str}: multi-dimension strides are not large "
                "enough to avoid overlap"
            )


def _1d_overlap_check(
    lengths, number_of_transforms, strides, distance, domain_str
) -> None:
    """Batches of strided 1D FFTs must not collide.

    Modular-arithmetic walk: any collision implies a collision with batch
    0, and only the first index of each batch needs checking.
    """
    fft_size = lengths[0]
    stride = strides[0]

    first_batch_limit = stride * fft_size
    first_length_limit = distance * number_of_transforms
    if (stride <= distance and first_batch_limit <= distance) or (
        distance <= stride and first_length_limit <= stride
    ):
        return

    b = 1
    while b < number_of_transforms:
        batch_first_idx = b * distance
        column = batch_first_idx % stride
        if column == 0:
            if batch_first_idx >= first_batch_limit:
                return
            raise InvalidConfiguration(
                f"Domain {domain_str}: batch {b} collides with first batch "
                f"at index {batch_first_idx}"
            )
        skip, rem = divmod(stride - column, distance)
        b += skip + (1 if rem else 0)


def _strides_distance_check(
    lengths, number_of_transforms, strides, distance, domain_str
) -> None:
    _validate_strides_distance_basic(
        lengths, number_of_transforms, strides, distance, domain_str
    )
    if len(lengths) > 1:
        _multidim_overlap_check(
            lengths, number_of_transforms, strides, distance, domain_str
        )
    else:
        _1d_overlap_check(
            lengths, number_of_transforms, strides, distance, domain_str
        )


def _validate_strides_distance(desc) -> None:
    fwd_lengths = desc.domain_lengths(Direction.FORWARD)
    bwd_lengths = desc.domain_lengths(Direction.BACKWARD)
    if desc.placement == Placement.IN_PLACE and desc.domain == Domain.REAL:
        # asymmetric domains share one buffer via the FFTW padded layout
        # (validated in _validate_real_in_place); check each domain alone
        _strides_distance_check(
            fwd_lengths, desc.number_of_transforms, desc.forward_strides,
            desc.forward_distance, "forward",
        )
        _strides_distance_check(
            bwd_lengths, desc.number_of_transforms, desc.backward_strides,
            desc.backward_distance, "backward",
        )
        return
    if desc.placement == Placement.IN_PLACE:
        if list(desc.forward_strides) != list(desc.backward_strides):
            raise InvalidConfiguration(
                "Invalid forward and backward strides must match for "
                "in-place configurations"
            )
        if desc.forward_distance != desc.backward_distance:
            raise InvalidConfiguration(
                "Invalid forward and backward distances must match for "
                "in-place configurations"
            )
        _strides_distance_check(
            fwd_lengths,
            desc.number_of_transforms,
            desc.forward_strides,
            desc.forward_distance,
            "forward",
        )
    else:
        _strides_distance_check(
            fwd_lengths,
            desc.number_of_transforms,
            desc.forward_strides,
            desc.forward_distance,
            "forward",
        )
        _strides_distance_check(
            bwd_lengths,
            desc.number_of_transforms,
            desc.backward_strides,
            desc.backward_distance,
            "backward",
        )


def _validate_layout(desc) -> None:
    """Layout envelope: multi-dimensional transforms require the default
    (packed) layout in both domains."""
    if len(desc.lengths) > 1:
        fwd = get_layout(desc, Direction.FORWARD)
        bwd = get_layout(desc, Direction.BACKWARD)
        if fwd != Layout.PACKED or bwd != Layout.PACKED:
            raise UnsupportedConfiguration(
                "Multi-dimensional transforms are only supported with "
                "default data layout"
            )


def _validate_real_in_place(desc) -> None:
    """In-place R2C/C2R uses the FFTW padded layout: 1D, interleaved, unit
    strides, real rows padded to ``2·(n/2+1)`` elements so the half spectrum
    overwrites the same buffer (FFTW's in-place real-data layout)."""
    from .enums import ComplexStorage

    h1 = desc.lengths[-1] // 2 + 1
    if len(desc.lengths) != 1:
        raise UnsupportedConfiguration(
            "in-place REAL transforms are 1D only"
        )
    if desc.complex_storage != ComplexStorage.INTERLEAVED_COMPLEX:
        raise UnsupportedConfiguration(
            "in-place REAL transforms require INTERLEAVED_COMPLEX storage"
        )
    if list(desc.forward_strides) != [1] or list(desc.backward_strides) != [1]:
        raise UnsupportedConfiguration(
            "in-place REAL transforms require unit strides"
        )
    if desc.forward_distance != 2 * h1:
        raise InvalidConfiguration(
            "in-place REAL requires the FFTW padded forward distance "
            f"2*(n/2+1) = {2 * h1}, got {desc.forward_distance}"
        )
    if desc.backward_distance != h1:
        raise InvalidConfiguration(
            "in-place REAL requires backward distance n/2+1 = "
            f"{h1}, got {desc.backward_distance}"
        )
    if desc.forward_offset != 2 * desc.backward_offset:
        raise InvalidConfiguration(
            "in-place REAL offsets must address the same buffer position "
            "(forward_offset == 2*backward_offset)"
        )


def validate_descriptor(desc) -> None:
    """Validate as much as possible at commit time.

    REAL-domain transforms need an even last dimension, and in-place REAL
    the FFTW padded layout.
    """
    if desc.domain == Domain.REAL:
        if desc.lengths and desc.lengths[-1] % 2:
            raise UnsupportedConfiguration(
                "REAL domain transforms require an even last dimension"
            )
        if desc.placement == Placement.IN_PLACE:
            _validate_real_in_place(desc)

    if desc.number_of_transforms <= 0:
        raise InvalidConfiguration(
            f"Invalid number of transform {desc.number_of_transforms}, "
            "must be positive"
        )

    _validate_lengths(desc.lengths)
    _validate_strides_distance(desc)
    _validate_layout(desc)
