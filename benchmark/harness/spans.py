"""The program's own spans in a traced window, for the per-layer metrics
that read them.

The port records its stages as ``torch.profiler`` ranges
(``qkd_ldpc_v_tpu_torch.utils.span``: ``sim.combination``, ``sim.chunk``,
``channel.keys``, ``protocol.round``, ``parallel.reduce``, ...), which the
Chrome trace holds as ``user_annotation`` events on the clock of the
device's kernels and copies. These functions read them from a ``Trace``,
or from rank 0's trace of a ``MultiTrace`` (the one that keeps its host
events). Each returns ``None`` where the trace holds none of the spans it
reads, as a program that records no spans leaves it.
"""

from __future__ import annotations

from bisect import bisect_right
from typing import Dict, List, Optional, Tuple

SPAN_CAT = "user_annotation"


def _one(trace):
    """The trace of one card: rank 0's of a ``MultiTrace``."""
    traces = getattr(trace, "traces", None)
    return traces[0] if traces is not None else trace


def intervals(trace, name: str) -> List[Tuple[float, float]]:
    """(start, end) in µs of the spans called ``name``, or of every span
    whose name starts with ``name`` where it ends in a dot, in time order."""
    if trace is None:
        return []
    prefix = name.endswith(".")
    out = []
    for e in _one(trace).host:
        if str(e.get("cat", "")).lower() != SPAN_CAT:
            continue
        n = str(e.get("name", ""))
        if n == name or (prefix and n.startswith(name)):
            s = float(e["ts"])
            out.append((s, s + float(e["dur"])))
    return sorted(out)


class Cover:
    """A union of intervals, asked how much of it lies inside ``[s, e]``."""

    def __init__(self, spans) -> None:
        merged: List[List[float]] = []
        for s, e in sorted(spans):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.starts = [s for s, _ in merged]
        self.ends = [e for _, e in merged]
        self.before = [0.0]
        for s, e in merged:
            self.before.append(self.before[-1] + e - s)

    def _upto(self, t: float) -> float:
        """Covered length before ``t``."""
        i = bisect_right(self.starts, t) - 1
        if i < 0:
            return 0.0
        return self.before[i] + min(t, self.ends[i]) - self.starts[i]

    def inside(self, s: float, e: float) -> float:
        return self._upto(e) - self._upto(s)

    def holds(self, t: float) -> bool:
        i = bisect_right(self.starts, t) - 1
        return i >= 0 and t <= self.ends[i]


def busy(trace) -> Cover:
    """The union of the card's kernel, copy and memset intervals."""
    return Cover((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                 for e in _one(trace).device)


def idle_ms_per_span(trace, name: str) -> Optional[float]:
    """Milliseconds inside the spans ``name`` in which the card ran nothing,
    over the number of those spans."""
    found = intervals(trace, name)
    if not found:
        return None
    cover = busy(trace)
    idle = sum((e - s) - cover.inside(s, e) for s, e in found)
    return idle / 1e3 / len(found)


def device_ms_launched_in(trace, name: str) -> Optional[float]:
    """Device milliseconds of the operations whose launching host event
    (the one the device event's ``External id`` names) starts inside a
    span ``name``. ``None`` where there is no such span or no operation
    launched inside one."""
    found = intervals(trace, name)
    if not found:
        return None
    inside = Cover(found)
    one = _one(trace)
    starts: Dict[object, float] = {}
    for e in one.host:
        ext = (e.get("args") or {}).get("External id")
        if ext is not None:
            starts.setdefault(ext, float(e["ts"]))
    total = 0.0
    hits = 0
    for e in one.device:
        ext = (e.get("args") or {}).get("External id")
        if ext in starts and inside.holds(starts[ext]):
            total += float(e["dur"])
            hits += 1
    return total / 1e3 if hits else None


def total_ms(trace, name: str) -> Optional[float]:
    """Milliseconds inside the spans ``name`` (their union)."""
    found = intervals(trace, name)
    if not found:
        return None
    cover = Cover(found)
    return cover.before[-1] / 1e3


def ms_outside_children(trace, name: str, child: str) -> Optional[float]:
    """Milliseconds inside the spans ``name`` and outside their ``child``
    spans, summed."""
    found = intervals(trace, name)
    if not found:
        return None
    cover = Cover(intervals(trace, child))
    return sum((e - s) - cover.inside(s, e) for s, e in found) / 1e3


def count(trace, name: str) -> int:
    return len(intervals(trace, name))
