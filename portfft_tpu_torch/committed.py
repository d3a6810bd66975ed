"""Committed plan: plans, constant tables on the device, and the kernel that
runs each direction.

Counterpart of ``portfft_tpu.committed.CommittedDescriptor`` for the slices
this package covers (``fastpath.py``): C2C fp32, INTERLEAVED or
SPLIT_COMPLEX, out-of-place or in-place, in every buffer layout the JAX
package accepts: offsets at any rank, strides and distances in 1D
(multi-dim is PACKED, as validation requires).  The 1D PACKED transform
runs K1, K2 or K3, or the plane path K6 → executor with K13/K14/K15 → K6
for every other length; 1D BATCH_INTERLEAVED in both domains runs K10
where it takes the length; multi-dimensional PACKED of any rank runs K11
and K10, or the last axis's 1D kernel and K10, or else the plane path's
per-axis walk with K12 between K6; SPLIT runs the per-axis walk with no
K6.  Any other 1D layout runs the strided copy kernel K7 around the packed
route.  And REAL fp32 (R2C forward, C2R backward) INTERLEAVED PACKED with
zero offsets, out-of-place: the last axis on K9 up to n = 512, else the C2C
transform of h = n/2 (a raw kernel or the plane path) with K8a/K8a-w or
K8b; at rank 2 and more the outer axes on K10 in place on the half
spectrum (after the last axis forward, before it backward).  Forward and
backward each have their own scale.

C2C I/O types follow the JAX package's ``_to_raw``/``_from_raw``:

* a numpy array — complex (cast to complex64) or raw float32 (re, im)
  pairs — gives a numpy array of the same kind;
* a torch tensor — complex64 or raw float32 — gives a tensor of the same
  kind on the same device.  A tensor on another device than the plan's
  raises :class:`InvalidConfiguration`.

Buffers, as the JAX package's ``_compute_interleaved`` and
``_compute_split``: the input is at least ``get_input_count(direction)``
elements long (more are ignored).  With no ``out=``, out-of-place returns
a new buffer of exactly ``get_output_count(direction)`` elements, zero
wherever the output layout puts no result (gaps, the leading offset).  An
``out=`` buffer, at least the output count long, gets the results at the
output layout's addresses and keeps every other element; a tensor or a
writable numpy ``out`` is written in place and returned (the JAX package
returns a new array holding the same values).  IN_PLACE treats the input
buffer as ``out``: all input is read before any output is written, so the
forward and backward offsets may differ.  The JAX package donates its
device buffer instead.

SPLIT I/O: the (re, im) planes as two real buffers, numpy arrays or float
tensors, and the result as a (re, im) pair of the same kinds (numpy
float32, or float32 tensors on the plan's device); ``out=`` is a (re, im)
pair, or ``out`` and ``out_imag``.

REAL I/O follows the JAX package's ``_compute_real``: forward takes a real
buffer (numpy or float tensor; a complex one raises
:class:`InvalidConfiguration`) and returns the half spectra, complex64 for
numpy input and raw float32 pairs of ``batch·∏outer·(n+2)`` scalars for a
tensor (n the last length, ∏outer the product of the others, 1 in 1D);
backward takes the half spectra (complex or raw pairs) and returns
``batch·∏outer·n`` float32 reals, numpy for numpy input.

fp64 (``precision="fp64"``) runs the REAL routes whose every step has a
double kernel (K9, K10; ``fastpath._check_f64``): the same I/O in double,
float64 reals and complex128 spectra (raw float64 pairs for a tensor), the
tables banked in float64.  Any other fp64 descriptor raises at commit.
"""

from __future__ import annotations

import numpy as np
import torch

from . import fastpath, race
from .config import resolve_device_config
from .enums import ComplexStorage, Direction, Domain, Placement
from .exceptions import InvalidConfiguration, UnsupportedConfiguration
from .ops.torch_fft import TwiddleBank, collect_bank_keys
from .planner import plan_1d
from .utils import tracing
from .utils.logging import TRACES_ENABLED, trace
from .utils.tracing import PROFILER


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
        # the plan's scalar on the card: float32, or float64 at fp64
        self._real = torch.float64 if self.precision.itemsize == 8 else torch.float32
        self._complex = torch.complex128 if self._real == torch.float64 else torch.complex64
        self._bank = TwiddleBank(self.precision)
        self._bank_keys: dict = {}
        self._raw_fast = fastpath.register(self)
        # the tables of the kernels the entries run, both directions
        keys = self._bank_keys
        for direction, sign in ((Direction.FORWARD, -1), (Direction.BACKWARD, +1)):
            if half:
                collect_bank_keys(self.plans[n_last // 2], sign, self._bank, keys)
                keys[("R", n_last, sign)] = self._bank.rfft_untangle(n_last, sign)
            elif real:
                # K9's matrix holds the scale of its step: 1 forward where
                # the outer axes' last column step takes the direction's
                keys[("W", n_last, sign)] = self._bank.dft(n_last, sign)
                keys[("RM", n_last, sign)] = self._bank.real_small(
                    n_last, sign, fastpath.real_step(self._raw_fast[direction]).scale
                )
            # every C2C axis length's tables (rows, columns, K11); a REAL
            # transform's outer axes (columns)
            for n in set(descriptor.lengths[:-1] if real else descriptor.lengths):
                collect_bank_keys(self.plans[n], sign, self._bank, keys)
        self._bank_arrays = self._bank.device_arrays(self.device)
        self._build_fns()

    def _register(self) -> None:
        """Choose the entries again (after ``autotune`` recorded a winner)
        and rebuild their functions; the banked tables cover every
        engine."""
        self._raw_fast = fastpath.register(self)
        self._build_fns()

    def _build_fns(self) -> None:
        self._fns = {
            direction: fastpath.build_fn(self, entry)
            for direction, entry in self._raw_fast.items()
        }
        if TRACES_ENABLED:
            trace(
                "committed:",
                self.plan_description(),
                f"device={self.device}",
                {dn.value: type(e).__name__ for dn, e in self._raw_fast.items()},
            )

    # -- public API ----------------------------------------------------------

    def compute_forward(self, x, x_imag=None, *, out=None, out_imag=None):
        """Forward transform of one interleaved buffer (complex, or raw
        float (re, im) pairs), or for SPLIT_COMPLEX of the planes ``x``
        and ``x_imag``."""
        return self._compute(Direction.FORWARD, x, x_imag, out, out_imag)

    def compute_backward(self, x, x_imag=None, *, out=None, out_imag=None):
        """Backward (inverse, unnormalized, × backward_scale) transform."""
        return self._compute(Direction.BACKWARD, x, x_imag, out, out_imag)

    def plan_description(self) -> dict:
        """Human-readable plan summary (one entry per dimension length)."""
        return {n: p.describe() for n, p in self.plans.items()}

    def autotune(self, iters: int = 5, times=None):
        """Race the kernels that can run this plan's GLOBAL, FUSED,
        multi-dim or BATCH_INTERLEAVED transform on the plan's device
        (GLOBAL and FUSED: the engines of ``engines.ENGINES`` whose gates
        take the plan; multi-dim: ``{"cm": 1}`` and ``{"m2": 0}``;
        BATCH_INTERLEAVED: ``{"cm": 1}``), record the fastest in the
        tuning cache, switch both directions to it and return its
        parameters; None where the plan has nothing to race.  A REAL
        transform races its half-length transform's and records under that
        length.  ``times`` (a dict), where given, receives each variant's
        ms per call.  See ``race.autotune``."""
        return race.autotune(self, iters, times)

    # -- internals -----------------------------------------------------------

    def _compute(self, direction, x, x_imag, out, out_imag):
        """One call, inside the span ``portfft.call`` while a profiler
        records (``utils.tracing``)."""
        if PROFILER._is_profiler_enabled:
            return tracing.run("portfft.call", self._call, direction, x, x_imag,
                               out, out_imag, note=direction.value)
        return self._call(direction, x, x_imag, out, out_imag)

    def _call(self, direction, x, x_imag, out, out_imag):
        d = self.descriptor
        if d.placement == Placement.IN_PLACE and (
            out is not None or out_imag is not None
        ):
            raise InvalidConfiguration(
                "out= must not be given for an IN_PLACE committed descriptor"
            )
        if d.complex_storage == ComplexStorage.SPLIT_COMPLEX:
            if x_imag is None:
                raise InvalidConfiguration(
                    "SPLIT_COMPLEX storage requires both real and imaginary "
                    "buffers"
                )
            return self._compute_split(direction, x, x_imag, out, out_imag)
        if x_imag is not None or out_imag is not None:
            raise InvalidConfiguration(
                "INTERLEAVED_COMPLEX storage takes a single complex buffer"
            )
        if d.domain == Domain.REAL:
            if out is not None:
                raise UnsupportedConfiguration(
                    "out= buffers of REAL transforms are not ported yet: they "
                    "come with the REAL plane path (ROADMAP Queue 1 item 9)"
                )
            return self._compute_real(direction, x)
        return self._compute_interleaved(direction, x, out)

    def _check_device(self, x: torch.Tensor) -> None:
        if x.device != self.device:
            raise InvalidConfiguration(
                f"tensor on {x.device} given to a plan committed on "
                f"{self.device}"
            )

    def _to_raw(self, x):
        """Any accepted interleaved buffer -> (flat tensor of the plan's
        scalar on its device, kind, aliases) where ``aliases`` says whether
        the tensor shares memory with ``x``."""
        real = self.precision.type
        if isinstance(x, torch.Tensor):
            self._check_device(x)
            if x.is_complex():
                flat = x.to(self._complex).contiguous().reshape(-1)
                raw = torch.view_as_real(flat).reshape(-1)
                kind = "torch_complex"
            else:
                raw = x.to(self._real).contiguous().reshape(-1)
                kind = "torch_raw"
            aliases = raw.data_ptr() == x.data_ptr()
        else:
            arr = np.asarray(x)
            if np.iscomplexobj(arr):
                host = np.ascontiguousarray(arr, dtype=np.result_type(real, np.complex64))
                host = host.reshape(-1).view(real)
                kind = "np_complex"
            else:
                host = np.ascontiguousarray(arr, dtype=real).reshape(-1)
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
            host = raw.cpu().numpy()
            return host.view(np.result_type(host.dtype, np.complex64))
        if kind == "np_raw":
            return raw.cpu().numpy()
        if kind == "torch_complex":
            return torch.view_as_complex(raw.view(-1, 2))
        return raw

    @staticmethod
    def _give_back(x, t: torch.Tensor, value, aliases: bool):
        """The caller's buffer ``x`` holding ``value`` (``t``, the flat
        tensor it was converted to, as ``x``'s kind): ``x`` itself where
        ``t`` is its memory or it can be written (a tensor, a writable numpy
        array), else ``value``."""
        if aliases:
            return x
        if isinstance(x, torch.Tensor):
            x.copy_(value.reshape(x.shape))
            return x
        if isinstance(x, np.ndarray) and x.flags.writeable:
            np.copyto(x, value.reshape(x.shape), casting="unsafe")
            return x
        return value

    def _compute_interleaved(self, direction, x, out):
        """Interleaved C2C (``portfft_tpu``'s ``_compute_interleaved``): an
        input buffer at least the input count long; ``out=None`` returns a
        new buffer of exactly the output count, zero where no result lands;
        an ``out`` buffer, at least the output count long, gets the results
        at the output layout's addresses and keeps its other elements, and
        a tensor or writable numpy ``out`` is written in place and
        returned; IN_PLACE does the same to the input buffer."""
        d = self.descriptor
        raw, kind, aliases = self._to_raw(x)
        need = d.get_input_count(direction)
        if raw.numel() < 2 * need:
            raise InvalidConfiguration(
                f"input buffer has {raw.numel() // 2} complex elements, "
                f"needs {need}"
            )
        fn = self._fns[direction]
        need_out = d.get_output_count(direction)
        if d.placement == Placement.IN_PLACE:
            dest, okind, oaliases, out = raw, kind, aliases, x
        elif out is None:
            return self._from_raw(fn(raw), kind)
        else:
            dest, okind, oaliases = self._to_raw(out)
        if dest.numel() < 2 * need_out:
            raise InvalidConfiguration(
                f"output buffer has {dest.numel() // 2} complex elements, "
                f"needs {need_out}"
            )
        fn(raw, dest)
        return self._give_back(out, dest, self._from_raw(dest, okind), oaliases)

    def _to_plane(self, x):
        """A SPLIT buffer (real numpy array or tensor) -> (flat float32
        tensor on the plan's device, whether ``x`` is a tensor, whether the
        tensor shares memory with ``x``)."""
        if isinstance(x, torch.Tensor):
            self._check_device(x)
            if x.is_complex():
                raise InvalidConfiguration(
                    "SPLIT_COMPLEX buffers must be real planes"
                )
            t = x.to(torch.float32).contiguous().reshape(-1)
            return t, True, t.data_ptr() == x.data_ptr()
        arr = np.asarray(x)
        if np.iscomplexobj(arr):
            raise InvalidConfiguration("SPLIT_COMPLEX buffers must be real planes")
        host = np.ascontiguousarray(arr, dtype=np.float32).reshape(-1)
        t = torch.from_numpy(host).to(self.device)
        aliases = (isinstance(x, np.ndarray) and t.device.type == "cpu"
                   and np.shares_memory(host, x))
        return t, False, aliases

    def _compute_split(self, direction, x_re, x_im, out, out_imag):
        """SPLIT_COMPLEX C2C (``portfft_tpu``'s ``_compute_split``): the
        (re, im) planes in, the (re, im) planes out, each of the kind it
        came as (numpy float32, or a float32 tensor on the plan's device),
        with the buffer rules of ``_compute_interleaved``.  ``out`` is a
        (re, im) pair, or ``out`` and ``out_imag``."""
        d = self.descriptor
        planes = [self._to_plane(x) for x in (x_re, x_im)]
        need = d.get_input_count(direction)
        if min(t.numel() for t, _, _ in planes) < need:
            raise InvalidConfiguration(f"split input buffers need {need} elements")
        xs = (planes[0][0], planes[1][0])
        fn = self._fns[direction]
        if isinstance(out, tuple) and out_imag is None:
            out, out_imag = out
        if d.placement == Placement.IN_PLACE:
            outs, dests = (x_re, x_im), planes
        elif out is None and out_imag is None:
            return tuple(y if is_tensor else y.cpu().numpy()
                         for y, (_, is_tensor, _) in zip(fn(xs), planes))
        elif out is None or out_imag is None:
            raise InvalidConfiguration(
                "SPLIT_COMPLEX out= takes both the real and the imaginary "
                "buffer"
            )
        else:
            outs, dests = (out, out_imag), [self._to_plane(o) for o in (out, out_imag)]
        need_out = d.get_output_count(direction)
        if min(t.numel() for t, _, _ in dests) < need_out:
            raise InvalidConfiguration(
                f"split output buffers need {need_out} elements"
            )
        fn(xs, tuple(t for t, _, _ in dests))
        return tuple(
            self._give_back(o, t, t if is_tensor else t.cpu().numpy(), aliases)
            for o, (t, is_tensor, aliases) in zip(outs, dests))

    def _to_real(self, x):
        """A real buffer -> (flat tensor of the plan's scalar on its device,
        whether ``x`` is a tensor)."""
        if isinstance(x, torch.Tensor):
            self._check_device(x)
            if x.is_complex():
                raise InvalidConfiguration(
                    "REAL domain forward input must be a real buffer"
                )
            return x.to(self._real).contiguous().reshape(-1), True
        arr = np.asarray(x)
        if np.iscomplexobj(arr):
            raise InvalidConfiguration(
                "REAL domain forward input must be a real buffer"
            )
        host = np.ascontiguousarray(arr, dtype=self.precision).reshape(-1)
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
