"""portfft_tpu_torch — the batched FFT framework of ``portfft_tpu`` on
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (H100).

The describe → commit → execute API of the JAX package::

    import portfft_tpu_torch as pfft
    desc = pfft.Descriptor(lengths=[4096], number_of_transforms=1024)
    plan = desc.commit(device="cuda")
    y = plan.compute_forward(x)      # x: complex64 tensor on the card
    x2 = plan.compute_backward(y)    # unnormalized inverse

This version runs C2C fp32 with INTERLEAVED storage, in-place or
out-of-place: 1D PACKED of every length (the main path; the lengths no
single kernel takes, such as primes past 512, run on the plane path: K6
deinterleave, the executor with K13, K14 and K15, K6 interleave), 1D
BATCH_INTERLEAVED (``forward_strides=[batch]``, ``forward_distance=1``
and the same backward), and multi-dimensional PACKED of any rank
(``Descriptor(lengths=[512, 512], number_of_transforms=256)``; shapes the
raw kernels decline run the plane path's per-axis walk with K12); C2C fp32
with SPLIT_COMPLEX storage (``complex_storage=ComplexStorage.SPLIT_COMPLEX``,
``plan.compute_forward(re, im)`` returns ``(re, im)``), any rank; every
C2C buffer layout the JAX package takes: offsets at any rank, any 1D
strides and distances (the strided copy kernel K7 around the packed
route), ``out=`` buffers (``plan.compute_forward(x, out=y)`` writes the
results into ``y`` and keeps its other elements); and the 1D REAL fp32
path, R2C forward and C2R backward (``domain=Domain.REAL``), INTERLEAVED
PACKED with zero offsets, out-of-place.  Other configurations raise
:class:`UnsupportedConfiguration` at commit, naming the ROADMAP item that
will port them.  ``commit(device="cpu")`` runs the kernels' plain PyTorch
versions.  The package never imports JAX.
"""

from . import tuning
from .committed import CommittedDescriptor
from .config import DeviceConfig, resolve_device_config
from .descriptor import Descriptor
from .enums import (
    ComplexStorage,
    Direction,
    Domain,
    Layout,
    Level,
    Placement,
    inv,
)
from .exceptions import (
    InternalError,
    InvalidConfiguration,
    OutOfVmemError,
    PortFFTError,
    UnsupportedConfiguration,
)

__all__ = [
    "CommittedDescriptor",
    "ComplexStorage",
    "Descriptor",
    "DeviceConfig",
    "Direction",
    "Domain",
    "InternalError",
    "InvalidConfiguration",
    "Layout",
    "Level",
    "OutOfVmemError",
    "Placement",
    "PortFFTError",
    "UnsupportedConfiguration",
    "inv",
    "resolve_device_config",
    "tuning",
]

__version__ = "0.1.0"
