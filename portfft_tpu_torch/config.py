"""Device configuration.

:class:`DeviceConfig` carries two kinds of fields:

* the **planning geometry** — ``lane``, ``sublane``, ``vmem_bytes``,
  ``vmem_budget_fraction``, ``max_factor``, ``direct_threshold``.  These
  are the JAX package's planning budgets for its TPU kernels
  (``portfft_tpu.config``), kept at its CPU defaults so this package plans
  every length into the same decomposition as the reference and the parity
  tests compare like with like.  They are not properties of the card.  Re-deriving them for Hopper
  is ROADMAP Queue 1 item 3.
* the **card's properties** — streaming multiprocessors, shared memory per
  block and L2 size, read from ``torch.cuda.get_device_properties``.  They
  describe the device; the plan does not read them.

The module's ``H100_*`` constants are the **Hopper planning geometry**: an
H100's opt-in shared memory per block, its portable thread-block cluster
size, its L2 cache and its streaming multiprocessors, from NVIDIA's data
sheet.  The gates of the single-sweep GLOBAL kernels K4 and K5
(``ops/cuda_global.sq_cluster``, ``ops/cuda_global_bf.global_bf_supported``),
K5's batch chunk and K11's path count (``ops/cuda_multidim.md2_path``) read
them.  They are constants, not card properties, so a plan committed on the CPU
takes the route it takes on the card.
"""

from __future__ import annotations

import dataclasses

import torch

H100_SMEM_PER_BLOCK = 227 * 2**10
H100_CLUSTER = 8
H100_L2_BYTES = 50 * 10**6
H100_SM_COUNT = 132


@dataclasses.dataclass(frozen=True)
class DeviceConfig:
    """Planning geometry plus the properties of the device a plan runs on."""

    name: str = "cpu"
    #: Planning geometry (the reference's budgets, see the module docstring).
    lane: int = 128
    sublane: int = 8
    vmem_bytes: int = 16 * 2**20
    vmem_budget_fraction: float = 0.55
    max_factor: int = 128
    direct_threshold: int = 512
    #: Card properties (0 on the CPU).
    sm_count: int = 0
    smem_per_block_bytes: int = 0
    l2_bytes: int = 0

    @property
    def vmem_budget(self) -> int:
        return int(self.vmem_bytes * self.vmem_budget_fraction)


def _card_name(device_name: str) -> str:
    """``"NVIDIA H100 80GB HBM3"`` -> ``"cuda_h100"``."""
    words = device_name.lower().replace("nvidia", "").split()
    return "cuda_" + (words[0] if words else "unknown")


def resolve_device_config(device: torch.device) -> DeviceConfig:
    """Configuration for a torch device (``cuda:i`` or ``cpu``)."""
    if device.type != "cuda":
        return DeviceConfig(name=device.type)
    props = torch.cuda.get_device_properties(device)
    return DeviceConfig(
        name=_card_name(props.name),
        sm_count=props.multi_processor_count,
        smem_per_block_bytes=getattr(
            props, "shared_memory_per_block_optin", 0
        ),
        l2_bytes=getattr(props, "L2_cache_size", 0),
    )
