"""The reduction of a ``torch.profiler`` trace to what the per-layer metrics
read: the device's operations, the harness's own host spans, the union of
the device's busy intervals, and the idle gaps between them.

Every time here is in seconds on the profiler's clock, on which host spans
and device operations share one timeline.
"""

from __future__ import annotations

import bisect
import dataclasses

#: The spans the harness records around its own calls into the program's
#: layers; an idle gap of the device is labelled by the innermost of them
#: that the host was in.
SPANS = ("commit", "compute_forward", "compute_backward", "synchronize",
         "rotate", "traced_window")


@dataclasses.dataclass
class Trace:
    """One traced segment of the window: its device operations ``(name,
    start, end)``, the harness spans ``(name, start, end)`` inside it, its
    span on the profiler's clock, and how many rounds of calls it holds."""

    ops: list
    spans: list
    start: float
    end: float
    rounds: int

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def kernels(self) -> list:
        """The operations that are kernels (not memset or memcpy)."""
        return [op for op in self.ops if not op[0].startswith(("Memset", "Memcpy"))]

    def busy(self) -> list:
        """The union of the device's busy intervals inside the segment,
        merged and in order."""
        merged: list = []
        clipped = ((max(lo, self.start), min(hi, self.end)) for _, lo, hi in self.ops)
        for lo, hi in sorted(c for c in clipped if c[1] > c[0]):
            if merged and lo <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], hi)
            else:
                merged.append([lo, hi])
        return merged

    def busy_s(self) -> float:
        return sum(hi - lo for lo, hi in self.busy())

    def gaps(self) -> list:
        """``(label, seconds)`` of every idle gap of the device inside the
        segment, labelled by the harness span the host was in when the gap
        began (the latest begun, where spans nest), or ``host`` outside
        them."""
        spans = sorted((s for s in self.spans if s[0] != "traced_window"),
                       key=lambda s: s[1])
        starts = [s[1] for s in spans]

        def label(t: float) -> str:
            i = bisect.bisect_right(starts, t) - 1
            return spans[i][0] if i >= 0 and t < spans[i][2] else "host"

        out, t = [], self.start
        for lo, hi in self.busy() + [[self.end, self.end]]:
            if lo > t:
                out.append((label(t), lo - t))
            t = max(t, hi)
        return out

    def lost_events(self) -> bool:
        """Whether the profiler dropped device events: every kernel runs the
        same number of times in each round of calls, so each kernel name's
        count is a multiple of the rounds."""
        counts: dict = {}
        for name, _, _ in self.kernels():
            counts[name] = counts.get(name, 0) + 1
        return not counts or any(c % self.rounds for c in counts.values())

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time (summed by name), and
        the idle gaps: their totals by label (``all:<label>``), then the
        longest single ones, ``top`` entries each at most."""
        by_op: dict = {}
        for name, lo, hi in self.ops:
            key = name[:120]
            by_op[key] = by_op.get(key, 0.0) + (hi - lo)
        gaps = self.gaps()
        by_label: dict = {}
        for label, s in gaps:
            by_label[f"all:{label}"] = by_label.get(f"all:{label}", 0.0) + s
        idle = sorted(by_label.items(), key=lambda kv: -kv[1])
        idle += sorted(gaps, key=lambda g: -g[1])[: max(top - len(idle), 0)]
        return {
            "device_ops": [list(kv) for kv in
                           sorted(by_op.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": [list(g) for g in idle[:top]],
        }


def collect(prof, rounds: int) -> Trace:
    """The :class:`Trace` of a finished profile of one segment, which the
    harness marked with a ``traced_window`` span."""
    ops, spans = [], []
    for e in prof.events():
        lo, hi = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.name in SPANS:
            # a span may also show on the device's timeline, as an
            # annotation over the kernels it launched: not an operation
            if e.device_type.name == "CUDA":
                continue
            spans.append((e.name, lo, hi))
        elif e.device_type.name == "CUDA":
            ops.append((e.name, lo, hi))
    window = [s for s in spans if s[0] == "traced_window"]
    if len(window) != 1:
        raise RuntimeError(f"the trace holds {len(window)} traced_window spans, not 1")
    _, start, end = window[0]
    ops = [op for op in ops if op[1] >= start]  # not the harness's primer before it
    return Trace(ops=ops, spans=spans, start=start, end=end, rounds=rounds)
