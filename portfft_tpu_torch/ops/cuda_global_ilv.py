"""K18 ``global_ilv``: the wrapper of the mixed-radix single-sweep GLOBAL
kernel (``csrc/fft_global_ilv.cu``), its gate, tables and plain version.

Counterpart of ``portfft_tpu/ops/pallas_global_ilv.py::global_ilv_raw_call``
(the tuned engine ``{"eng": 8}``).  It computes K5's function with each sub
g = A·128 for any A = 2^a·3^b ≤ 16 (``torch_fft.ilv_factor``: A = 1, 2, 3,
4, 6, 8, 9, 12, 16), so 3·2^k and 9·2^k subs such as 384 and 1152, which
K5's power-of-two rule declines, run single sweep:

* pass 1, per column n2: the A1-point slab DFT over the 128-point slabs as
  radix-2 and radix-3 butterflies with snapped constants
  (``torch_fft.mixed_radix_dft``; cos 2π/3 = −1/2 is exact, √3/2 one
  rounded constant), natural order in and out, the digit twiddle
  U1[kA1, iB1] = w_G1^(kA1·iB1), one 128-point DFT, and w_n^(k1·n2) =
  GA[kA1, n2]·GB[kB1, n2];
* pass 2, per row k1: the same over n2 with A2 and U2, stored
  out[k1 + G1·k2], k2 = kA2 + A2·kB2.

The TPU kernel keeps (re, im) interleaved in its lanes and multiplies by
i with a lane pair-swap against pair-duplicated tables; on the card every
complex value is a ``float2`` from load to store, so neither the swap nor
those tables have a counterpart here: K18 reads K5's ``U``, ``GA`` and
``GB`` and runs K5's schedule (cooperative, an L2-sized chunk a round).
The JAX package runs its pass-2 butterfly as a DIF with digit-reversed
slab positions (``digit_rev_traced``); the slab DFT here is in natural
order, so no position map is needed.  Same rule as ``cuda_fft``: CPU
tensors go to the plain version, CUDA tensors to the kernel, and nothing
falls back.
"""

from __future__ import annotations

from ..enums import Level
from ..planner import Plan1D
from ..utils import tracing
from .cuda_global_bf import BfTables, bf_tile, global_bf_plain, launch_sweep
from .torch_fft import ilv_factor


def global_ilv_supported(plan: Plan1D) -> bool:
    """K18's gate: a GLOBAL plan whose subs are both A·128 with A =
    2^a·3^b ≤ 16 (``ilv_factor``), each pass's tile within the shared
    memory of a block (``bf_tile``).  The JAX package's
    ``global_ilv_supported`` is the same factor rule with its VMEM estimate
    (``ilv_est_bytes``) and its x3 matmul precision; neither budget applies
    here."""
    if plan.level != Level.GLOBAL:
        return False
    g1, g2 = plan.sub[0].n, plan.sub[1].n
    return bool(ilv_factor(g1) and ilv_factor(g2) and bf_tile(g1)
                and bf_tile(g2))


#: K18's plain version: K5's decomposition, whose slab DFT is mixed radix
#: (``torch_fft.mixed_radix_dft``); its tables are K5's
#: (``cuda_global_bf.bf_tables``), at the mixed-radix factors.
global_ilv_plain = global_bf_plain


@tracing.kernel("K18", ("sweep_kernel",))
def global_ilv(raw, batch: int, t: BfTables, scale: float, out=None):
    """K18: ``batch`` GLOBAL transforms of length ``t.g1 · t.g2`` in one
    cooperative launch, K5's schedule (per chunk of ``t.chunk`` transforms,
    pass 1 into a scratch slot in L2, a grid-wide barrier, pass 2 into
    ``out``, which may be ``raw``) with the mixed-radix slab DFTs."""
    return launch_sweep("global_ilv", raw, batch, t, scale, out, 1)


global_ilv.plain = global_ilv_plain
