"""Carry a plan's state over from the JAX package.

An FFT plan holds no weights: its state is the problem description and the
constant tables.  Both carry over as plain data (dicts and numpy arrays), so
nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .descriptor import Descriptor
from .ops.torch_fft import TwiddleBank


def descriptor_from_reference(d: dict) -> Descriptor:
    """This package's :class:`Descriptor` from the output of
    ``portfft_tpu.Descriptor.to_dict()`` (the same keys and values)."""
    return Descriptor.from_dict(d)


def bank_from_reference(
    host: dict[str, np.ndarray | None], device
) -> dict[str, torch.Tensor]:
    """The device tables this package's kernels read, taken from the JAX
    package's ``TwiddleBank.host``.

    Key strings are shared, so the result can stand in for
    ``TwiddleBank.device_arrays(device)`` of a plan built here; that
    includes the REAL post-twiddles ``R{f|b}{n}`` and the tables of the
    tuned GLOBAL engines: K5's and K18's ``GA``/``GB``/``U``, K16's ``G``,
    the factored ``Q`` and ``Y`` (the reference's ``ZQ``) that K17 and K3-ftw
    read, K19's ``G2…L`` (of its orientations, the two K19 reads), and
    K15-bf's digit-permuted ``…_bl…`` tables (the reference's ``BLT``,
    ``BLP``, ``BLB``).  Only float32 tables
    are carried: the JAX package's bf16 tables (its matrix-unit precision
    scheme, among them the small-n REAL stacks ``RS…k``) have no reader in
    this package, whose small-n REAL matrix is its own float32
    ``RM{f|b}{n}_{scale}m``.
    """
    bank = TwiddleBank(np.float32)
    for name, arr in host.items():
        if arr is None or np.asarray(arr).dtype == np.float32:
            bank.host[name] = None if arr is None else np.ascontiguousarray(arr)
    return bank.device_arrays(torch.device(device))
