"""Exception hierarchy (the class names of ``portfft_tpu.exceptions``)."""


class PortFFTError(Exception):
    """Base error of the framework."""


class InternalError(PortFFTError):
    """Unexpected internal failure."""


class InvalidConfiguration(PortFFTError):
    """The descriptor or a buffer is invalid — e.g. overlapping batches,
    zero lengths, a buffer too short for the descriptor."""


class UnsupportedConfiguration(PortFFTError):
    """The descriptor is valid but not supported by this build."""


class OutOfVmemError(UnsupportedConfiguration):
    """A kernel's on-chip working set does not fit on this device.  The
    name is kept from the JAX package so callers catch one class in both."""
