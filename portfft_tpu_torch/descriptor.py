"""FFT problem description — the user-facing entry point.

The fields, defaults, buffer-count math and ``to_dict``/``from_dict`` of
``portfft_tpu.descriptor.Descriptor``, so a problem described for the JAX
package describes the same problem here.  ``commit()`` validates it and
returns a :class:`~portfft_tpu_torch.committed.CommittedDescriptor` bound to
one torch device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from .committed import CommittedDescriptor
from .enums import ComplexStorage, Direction, Domain, Placement, inv
from .exceptions import InvalidConfiguration, UnsupportedConfiguration
from .utils.layout import default_strides, flattened_length
from .validation import validate_descriptor

_PRECISION_ALIASES = {
    "fp32": np.float32,
    "fp64": np.float64,
    "float32": np.float32,
    "float64": np.float64,
    "single": np.float32,
    "double": np.float64,
}


def _canonical_precision(precision) -> np.dtype:
    if isinstance(precision, str):
        key = precision.lower()
        if key not in _PRECISION_ALIASES:
            raise ValueError(f"Unknown precision {precision!r}")
        return np.dtype(_PRECISION_ALIASES[key])
    dt = np.dtype(precision)
    if dt not in (np.dtype(np.float32), np.dtype(np.float64)):
        raise ValueError(f"precision must be fp32 or fp64, got {dt}")
    return dt


@dataclasses.dataclass
class Descriptor:
    """FFT problem parameters.

    Attributes
    ----------
    lengths:
        Size of each transform dimension, most-significant first (contiguous
        dimension last).
    precision:
        ``fp32`` (default) or ``fp64``.
    domain:
        ``Domain.COMPLEX`` (C2C) or ``Domain.REAL``.
    forward_scale / backward_scale:
        Factor applied to the output of the respective direction.  A
        forward+backward round trip with both scales 1 multiplies the data
        by the product of the lengths.
    number_of_transforms:
        Batch count per compute call.
    complex_storage:
        INTERLEAVED_COMPLEX or SPLIT_COMPLEX.
    placement:
        IN_PLACE or OUT_OF_PLACE.
    forward_strides / backward_strides:
        Element strides per dimension in each domain; element ``[i1..id]`` of
        batch ``b`` lives at ``offset + distance*b + sum(strides[k]*ik)``.
    forward_distance / backward_distance:
        Elements between consecutive batches (default: product of lengths).
    forward_offset / backward_offset:
        Elements before the first used element of the buffer.
    """

    lengths: Sequence[int]
    precision: object = np.float32
    domain: Domain = Domain.COMPLEX
    forward_scale: float = 1.0
    backward_scale: float = 1.0
    number_of_transforms: int = 1
    complex_storage: ComplexStorage = ComplexStorage.INTERLEAVED_COMPLEX
    placement: Placement = Placement.OUT_OF_PLACE
    forward_strides: Optional[Sequence[int]] = None
    backward_strides: Optional[Sequence[int]] = None
    forward_distance: Optional[int] = None
    backward_distance: Optional[int] = None
    forward_offset: int = 0
    backward_offset: int = 0

    def __post_init__(self):
        self.lengths = [int(x) for x in self.lengths]
        if not self.lengths:
            raise InvalidConfiguration(
                "Invalid lengths, must have at least 1 dimension"
            )
        self.precision = _canonical_precision(self.precision)
        if self.forward_strides is None:
            self.forward_strides = default_strides(self.lengths)
        else:
            self.forward_strides = [int(s) for s in self.forward_strides]
        bwd_lengths = self.domain_lengths(Direction.BACKWARD)
        if self.backward_strides is None:
            self.backward_strides = default_strides(bwd_lengths)
        else:
            self.backward_strides = [int(s) for s in self.backward_strides]
        if self.forward_distance is None:
            if (
                self.domain == Domain.REAL
                and self.placement == Placement.IN_PLACE
                and len(self.lengths) == 1
            ):
                # FFTW in-place r2c layout: real rows padded to 2·(n/2+1)
                self.forward_distance = 2 * (self.lengths[-1] // 2 + 1)
            else:
                self.forward_distance = flattened_length(self.lengths)
        if self.backward_distance is None:
            self.backward_distance = flattened_length(bwd_lengths)
        self.forward_distance = int(self.forward_distance)
        self.backward_distance = int(self.backward_distance)
        self.forward_offset = int(self.forward_offset)
        self.backward_offset = int(self.backward_offset)
        self.number_of_transforms = int(self.number_of_transforms)

    # -- accessors -----------------------------------------------------------

    def get_flattened_length(self) -> int:
        """Flattened single-batch length, ignoring strides."""
        return flattened_length(self.lengths)

    def domain_lengths(self, direction: Direction) -> list[int]:
        """Logical element grid of the given domain's buffers: ``lengths``,
        except the backward domain of a REAL transform, whose last dimension
        holds ``n//2 + 1`` complex elements."""
        if self.domain == Domain.REAL and direction == Direction.BACKWARD:
            return list(self.lengths[:-1]) + [self.lengths[-1] // 2 + 1]
        return list(self.lengths)

    def get_strides(self, direction: Direction) -> list[int]:
        return list(
            self.forward_strides
            if direction == Direction.FORWARD
            else self.backward_strides
        )

    def get_distance(self, direction: Direction) -> int:
        return (
            self.forward_distance
            if direction == Direction.FORWARD
            else self.backward_distance
        )

    def get_offset(self, direction: Direction) -> int:
        return (
            self.forward_offset
            if direction == Direction.FORWARD
            else self.backward_offset
        )

    def get_scale(self, direction: Direction) -> float:
        return (
            self.forward_scale
            if direction == Direction.FORWARD
            else self.backward_scale
        )

    # -- buffer-count math ---------------------------------------------------

    def _buffer_count(
        self, lengths, strides: Sequence[int], distance: int, offset: int
    ) -> int:
        """offset + last accessed index + 1."""
        last = (self.number_of_transforms - 1) * distance
        for length, stride in zip(lengths, strides):
            last += (length - 1) * stride
        return offset + last + 1

    def get_input_count(self, direction: Direction) -> int:
        """Required element count of the input buffer for ``direction``:
        complex elements for complex-domain buffers, real elements for the
        real domain.  In-place REAL shares one padded buffer between both
        domains, so the count covers whichever domain needs more."""
        count = self._buffer_count(
            self.domain_lengths(direction),
            self.get_strides(direction),
            self.get_distance(direction),
            self.get_offset(direction),
        )
        if self.domain == Domain.REAL and self.placement == Placement.IN_PLACE:
            other = self._buffer_count(
                self.domain_lengths(inv(direction)),
                self.get_strides(inv(direction)),
                self.get_distance(inv(direction)),
                self.get_offset(inv(direction)),
            )
            if direction == Direction.FORWARD:
                return max(count, 2 * other)  # real units
            return max(count, (other + 1) // 2)  # complex units
        return count

    def get_output_count(self, direction: Direction) -> int:
        """Required element count of the output buffer for ``direction``."""
        return self.get_input_count(inv(direction))

    # -- serialization -------------------------------------------------------

    def to_dict(self) -> dict:
        """JSON-serializable problem description (the same keys and values
        as ``portfft_tpu.Descriptor.to_dict``)."""
        return {
            "lengths": list(self.lengths),
            "precision": str(np.dtype(self.precision)),
            "domain": self.domain.value,
            "forward_scale": float(self.forward_scale),
            "backward_scale": float(self.backward_scale),
            "number_of_transforms": self.number_of_transforms,
            "complex_storage": self.complex_storage.value,
            "placement": self.placement.value,
            "forward_strides": list(self.forward_strides),
            "backward_strides": list(self.backward_strides),
            "forward_distance": self.forward_distance,
            "backward_distance": self.backward_distance,
            "forward_offset": self.forward_offset,
            "backward_offset": self.backward_offset,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Descriptor":
        d = dict(d)
        d["domain"] = Domain(d["domain"])
        d["complex_storage"] = ComplexStorage(d["complex_storage"])
        d["placement"] = Placement(d["placement"])
        return cls(**d)

    # -- commit --------------------------------------------------------------

    def commit(self, device=None, mesh=None):
        """Validate and plan the transform on one torch device.

        ``device`` is ``"cuda"``, ``"cuda:1"``, ``"cpu"`` or a
        ``torch.device``.  ``None`` means CUDA and raises
        :class:`UnsupportedConfiguration` when no CUDA device is available;
        the CPU is used only when asked for by name, and then every kernel
        runs as its plain PyTorch version.  ``mesh`` (a distributed plan) is
        not ported yet (ROADMAP Queue 1 item 15) and raises
        :class:`UnsupportedConfiguration`.
        """
        validate_descriptor(self)
        if mesh is not None:
            raise UnsupportedConfiguration(
                "distributed plans (commit(mesh=...)) are not ported yet "
                "(ROADMAP Queue 1 item 15)"
            )
        return CommittedDescriptor(dataclasses.replace(self), device=device)
