"""Public enums of the PyTorch port.

Same names and values as ``portfft_tpu.enums``, so a descriptor serialized
by either package reads back in the other.  The four levels keep the JAX
package's meaning:

* ``Level.DIRECT``  — one DFT of the whole length (n ≤ 512 on the default
  plan geometry).
* ``Level.FUSED``   — the two-stage split n = a·128 in one kernel.
* ``Level.GLOBAL``  — the four-step split n = G1·G2 in two passes through
  device memory.
* ``Level.BLUESTEIN`` — chirp-z for sizes with a large prime factor.
"""

import enum


class Domain(enum.Enum):
    """Transform domain."""

    REAL = "real"
    COMPLEX = "complex"


class ComplexStorage(enum.Enum):
    """Layout of complex values.

    INTERLEAVED_COMPLEX: (re, im) adjacent — also the memory layout of a
    ``torch.complex64`` tensor.
    SPLIT_COMPLEX: separate re / im buffers.
    """

    INTERLEAVED_COMPLEX = "interleaved_complex"
    SPLIT_COMPLEX = "split_complex"


class Placement(enum.Enum):
    """In-place vs out-of-place execution."""

    IN_PLACE = "in_place"
    OUT_OF_PLACE = "out_of_place"


class Direction(enum.Enum):
    """Transform direction."""

    FORWARD = "forward"
    BACKWARD = "backward"


def inv(direction: Direction) -> Direction:
    """Opposite direction."""
    return (
        Direction.BACKWARD if direction == Direction.FORWARD else Direction.FORWARD
    )


class Level(enum.Enum):
    """Planner-selected implementation level."""

    DIRECT = "direct"
    FUSED = "fused"
    GLOBAL = "global"
    BLUESTEIN = "bluestein"


class Layout(enum.Enum):
    """Data layout classification."""

    #: Default strides and distance; each transform contiguous, batches
    #: stored one after the other: ``buf[idx + N * batch]``.
    PACKED = "packed"
    #: Arbitrary strides / distance.
    UNPACKED = "unpacked"
    #: ``distance == 1`` and ``stride[-1] == number_of_transforms``:
    #: ``buf[idx * batch_count + batch]``.
    BATCH_INTERLEAVED = "batch_interleaved"
