"""Rounding to a lower precision, for the controls of the configurations'
plain references."""

from __future__ import annotations

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32, or complex64 by its parts) rounded to TF32's 10-bit
    mantissa, to nearest with ties to even: what a tensor core keeps of an
    fp32 operand."""
    if x.is_complex():
        return torch.view_as_complex(round_tf32(torch.view_as_real(x)))
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)
