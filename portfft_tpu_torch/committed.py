"""Committed plan: plans, constant tables on the device, and the kernel that
runs each direction.

Counterpart of ``portfft_tpu.committed.CommittedDescriptor`` for the slices
this package covers (``fastpath.py``): C2C fp32 INTERLEAVED with zero
offsets, out-of-place or in-place, as 1D PACKED (K1, K2 or K3, or the
plane path K6 → executor with K13/K15 → K6 for every other length), 1D
BATCH_INTERLEAVED (K10) and multi-dimensional PACKED of any rank (K11 and
K10, or the last axis's 1D kernel and K10); and 1D REAL fp32 (R2C forward,
C2R backward) INTERLEAVED PACKED with zero offsets, out-of-place; forward
and backward each with its own scale.

C2C I/O types follow the JAX package's ``_to_raw``/``_from_raw``:

* a numpy array — complex (cast to complex64) or raw float32 (re, im)
  pairs — gives a numpy array of the same kind;
* a torch tensor — complex64 or raw float32 — gives a tensor of the same
  kind on the same device.  A tensor on another device than the plan's
  raises :class:`InvalidConfiguration`.

IN_PLACE writes the result into the caller's buffer (a tensor or a numpy
array) and returns that buffer; the JAX package donates its device buffer
instead.  Elements past the descriptor's input count are left as they
are.  Out-of-place returns a new buffer of exactly the output count.

REAL I/O follows the JAX package's ``_compute_real``: forward takes a real
buffer (numpy or float tensor; a complex one raises
:class:`InvalidConfiguration`) and returns the half spectra, complex64 for
numpy input and raw float32 pairs of ``batch·(n+2)`` scalars for a tensor;
backward takes the half spectra (complex or raw pairs) and returns
``batch·n`` float32 reals, numpy for numpy input.
"""

from __future__ import annotations

import numpy as np
import torch

from . import fastpath
from .config import resolve_device_config
from .enums import Direction, Domain, Placement
from .exceptions import InvalidConfiguration, UnsupportedConfiguration
from .ops.torch_fft import TwiddleBank, collect_bank_keys
from .planner import plan_1d
from .utils.logging import trace


def resolve_device(device) -> torch.device:
    """``None`` or ``"cuda"`` -> the current CUDA device, raising
    :class:`UnsupportedConfiguration` when CUDA is not available; ``"cpu"``
    only when named."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise UnsupportedConfiguration(
                "no CUDA device is available; commit(device='cpu') runs the "
                "plain PyTorch versions of the kernels"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type != "cpu":
        raise UnsupportedConfiguration(f"device type {dev.type!r} is not supported")
    return dev


class CommittedDescriptor:
    """A planned FFT bound to one torch device."""

    def __init__(self, descriptor, device=None):
        self.descriptor = descriptor
        self.device = resolve_device(device)
        self.config = resolve_device_config(self.device)
        self.precision = np.dtype(descriptor.precision)
        # One plan per distinct dimension length, as in the JAX package.
        self.plans = {
            n: plan_1d(n, self.config, self.precision.itemsize)
            for n in set(descriptor.lengths)
        }
        n_last = descriptor.lengths[-1]
        real = descriptor.domain == Domain.REAL
        # REAL, even n past the small path: the h = n/2 complex plan of the
        # packed half-length transform.  The JAX package adds it from
        # n = 1024 (below that its plane path is faster on a TPU); here the
        # small path ends at 512, so 512 < n < 1024 gets it too.
        half = real and n_last > fastpath.SMALL_REAL_MAX_N
        if half and n_last // 2 not in self.plans:
            self.plans[n_last // 2] = plan_1d(
                n_last // 2, self.config, self.precision.itemsize
            )
        self._bank = TwiddleBank(np.float32)
        self._bank_keys: dict = {}
        self._raw_fast = fastpath.register(self)
        # the tables of the kernels the entries run, both directions
        keys = self._bank_keys
        for direction, sign in ((Direction.FORWARD, -1), (Direction.BACKWARD, +1)):
            if half:
                collect_bank_keys(self.plans[n_last // 2], sign, self._bank, keys)
                keys[("R", n_last, sign)] = self._bank.rfft_untangle(n_last, sign)
            elif real:
                keys[("W", n_last, sign)] = self._bank.dft(n_last, sign)
                keys[("RM", n_last, sign)] = self._bank.real_small(
                    n_last, sign, float(descriptor.get_scale(direction))
                )
            else:  # every axis length's tables: rows, columns, K11
                for n in set(descriptor.lengths):
                    collect_bank_keys(self.plans[n], sign, self._bank, keys)
        self._bank_arrays = self._bank.device_arrays(self.device)
        self._fns = {
            direction: fastpath.build_fn(self, entry)
            for direction, entry in self._raw_fast.items()
        }
        trace(
            "committed:",
            self.plan_description(),
            f"device={self.device}",
            {dn.value: e[0] for dn, e in self._raw_fast.items()},
        )

    # -- public API ----------------------------------------------------------

    def compute_forward(self, x, x_imag=None, *, out=None, out_imag=None):
        """Forward transform of one interleaved buffer (complex, or raw
        float (re, im) pairs)."""
        return self._compute(Direction.FORWARD, x, x_imag, out, out_imag)

    def compute_backward(self, x, x_imag=None, *, out=None, out_imag=None):
        """Backward (inverse, unnormalized, × backward_scale) transform."""
        return self._compute(Direction.BACKWARD, x, x_imag, out, out_imag)

    def plan_description(self) -> dict:
        """Human-readable plan summary (one entry per dimension length)."""
        return {n: p.describe() for n, p in self.plans.items()}

    # -- internals -----------------------------------------------------------

    def _compute(self, direction, x, x_imag, out, out_imag):
        d = self.descriptor
        if d.placement == Placement.IN_PLACE and (
            out is not None or out_imag is not None
        ):
            raise InvalidConfiguration(
                "out= must not be given for an IN_PLACE committed descriptor"
            )
        if out is not None or out_imag is not None:
            raise UnsupportedConfiguration(
                "out= buffers are not ported yet (ROADMAP Queue 1 item 8)"
            )
        if x_imag is not None:
            raise InvalidConfiguration(
                "INTERLEAVED_COMPLEX storage takes a single complex buffer"
            )
        if d.domain == Domain.REAL:
            return self._compute_real(direction, x)
        return self._compute_interleaved(direction, x)

    def _check_device(self, x: torch.Tensor) -> None:
        if x.device != self.device:
            raise InvalidConfiguration(
                f"tensor on {x.device} given to a plan committed on "
                f"{self.device}"
            )

    def _to_raw(self, x):
        """Any accepted interleaved buffer -> (flat float32 tensor on the
        plan's device, kind, aliases) where ``aliases`` says whether the
        tensor shares memory with ``x``."""
        if isinstance(x, torch.Tensor):
            self._check_device(x)
            if x.is_complex():
                flat = x.to(torch.complex64).contiguous().reshape(-1)
                raw = torch.view_as_real(flat).reshape(-1)
                kind = "torch_complex"
            else:
                raw = x.to(torch.float32).contiguous().reshape(-1)
                kind = "torch_raw"
            aliases = raw.data_ptr() == x.data_ptr()
        else:
            arr = np.asarray(x)
            if np.iscomplexobj(arr):
                host = np.ascontiguousarray(arr, dtype=np.complex64)
                host = host.reshape(-1).view(np.float32)
                kind = "np_complex"
            else:
                host = np.ascontiguousarray(arr, dtype=np.float32).reshape(-1)
                kind = "np_raw"
            raw = torch.from_numpy(host).to(self.device)
            aliases = (
                isinstance(x, np.ndarray)
                and raw.device.type == "cpu"
                and np.shares_memory(host, x)
            )
        if raw.numel() % 2:
            raise InvalidConfiguration(
                "raw interleaved buffer must have an even number of scalars"
            )
        return raw, kind, aliases

    @staticmethod
    def _from_raw(raw: torch.Tensor, kind: str):
        if kind == "np_complex":
            return raw.cpu().numpy().view(np.complex64)
        if kind == "np_raw":
            return raw.cpu().numpy()
        if kind == "torch_complex":
            return torch.view_as_complex(raw.view(-1, 2))
        return raw

    def _compute_interleaved(self, direction, x):
        d = self.descriptor
        raw, kind, aliases = self._to_raw(x)
        need = 2 * d.get_input_count(direction)  # == the output count here
        if raw.numel() < need:
            raise InvalidConfiguration(
                f"input buffer has {raw.numel() // 2} complex elements, "
                f"needs {need // 2}"
            )
        fn = self._fns[direction]
        if d.placement != Placement.IN_PLACE:
            return self._from_raw(fn(raw[:need]), kind)
        fn(raw[:need], out=raw[:need])
        if aliases:
            return x
        # x could not be viewed as a flat float32 buffer on this device:
        # copy the result back into it
        if isinstance(x, torch.Tensor):
            src = self._from_raw(raw, kind).reshape(x.shape)
            x.copy_(src)
            return x
        np.copyto(x, self._from_raw(raw, kind).reshape(np.shape(x)), casting="unsafe")
        return x

    def _to_real(self, x):
        """A real buffer -> (flat float32 tensor on the plan's device,
        whether ``x`` is a tensor)."""
        if isinstance(x, torch.Tensor):
            self._check_device(x)
            if x.is_complex():
                raise InvalidConfiguration(
                    "REAL domain forward input must be a real buffer"
                )
            return x.to(torch.float32).contiguous().reshape(-1), True
        arr = np.asarray(x)
        if np.iscomplexobj(arr):
            raise InvalidConfiguration(
                "REAL domain forward input must be a real buffer"
            )
        host = np.ascontiguousarray(arr, dtype=np.float32).reshape(-1)
        return torch.from_numpy(host).to(self.device), False

    def _compute_real(self, direction, x):
        """R2C forward / C2R backward, out-of-place (see the module
        docstring for the I/O types)."""
        d = self.descriptor
        fn = self._fns[direction]
        if direction == Direction.FORWARD:
            real, is_tensor = self._to_real(x)
            need = d.get_input_count(direction)
            if real.numel() < need:
                raise InvalidConfiguration(
                    f"real input buffer has {real.numel()} elements, needs {need}"
                )
            y = fn(real[:need])
            return y if is_tensor else self._from_raw(y, "np_complex")
        raw, kind, _ = self._to_raw(x)
        need = 2 * d.get_input_count(direction)
        if raw.numel() < need:
            raise InvalidConfiguration(
                f"half-spectrum input buffer has {raw.numel() // 2} complex "
                f"elements, needs {need // 2}"
            )
        y = fn(raw[:need])
        return self._from_raw(y, "np_raw") if kind.startswith("np") else y
