"""glue_pct (plane executor, device trace): the share of the traced
segment's busy time in device operations that ``tracing.kernels_of`` maps
to no kernel of the port (the PyTorch copies and multiplies of the plane
executor's walk: a moved axis made contiguous and put back, a scale after
K13), in percent: the union of their intervals over the union of every
operation's.  None where the program has no tracer or the trace holds no
device operation."""

import dataclasses


def read(run):
    try:
        from portfft_tpu_torch.utils import tracing
    except ImportError:
        return None
    trc = run.trace
    if trc is None or not trc.ops:
        return None
    names = {name for name, _, _ in trc.ops}
    glue = {name for name in names if not tracing.kernels_of(name)}
    others = dataclasses.replace(trc, ops=[op for op in trc.ops if op[0] in glue])
    return others.busy_s() / trc.busy_s() * 100
