"""The device trace of a traced sub-window: ``torch.profiler`` over the
host and the card, its Chrome trace read back, and the reductions the
per-layer metrics and the breakdown take from it.

``busy_share`` is a copy of the port's smoke-test reduction (the union of
the device's kernel, copy and memset intervals, and the span of every
timed event). ``Trace`` keeps the events inside the benchmark's own
``bench.window`` annotation, clipped to it, so the traced window is exactly
the work the benchmark put there.
"""

from __future__ import annotations

import json
import re
import tempfile
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
WINDOW = "bench.window"
NAME_CHARS = 120


def busy_share(events, cats=DEVICE_CATS):
    """(busy ms, window ms) of a Chrome trace: the union of the device's
    kernel and copy intervals, and the span of every timed event."""
    timed_events = [e for e in events if "ts" in e and "dur" in e]
    start = min(float(e["ts"]) for e in timed_events)
    end = max(float(e["ts"]) + float(e["dur"]) for e in timed_events)
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in timed_events
                   if str(e.get("cat", "")).lower() in cats)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e3, (end - start) / 1e3


def _cat(e) -> str:
    return str(e.get("cat", "")).lower()


def _merged(spans):
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """The events of one traced window (µs timestamps, as the Chrome trace
    has them), clipped to the window annotation."""

    def __init__(self, events: List[dict]) -> None:
        marks = [e for e in events if e.get("name") == WINDOW
                 and "ts" in e and "dur" in e]
        if not marks:
            raise RuntimeError(f"the trace has no {WINDOW!r} annotation")
        w0 = float(marks[0]["ts"])
        w1 = w0 + float(marks[0]["dur"])
        self.t0, self.t1 = w0, w1
        kept = []
        for e in events:
            if "ts" not in e or "dur" not in e or e is marks[0]:
                continue
            s = float(e["ts"])
            t = s + float(e["dur"])
            if t <= w0 or s >= w1:
                continue
            clipped = dict(e)
            clipped["ts"] = max(s, w0)
            clipped["dur"] = min(t, w1) - clipped["ts"]
            kept.append(clipped)
        self.device = [e for e in kept if _cat(e) in DEVICE_CATS]
        self.host = [e for e in kept if _cat(e) in HOST_CATS]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def busy_s(self) -> float:
        """Seconds in which an operation ran on the device."""
        if not self.device:
            return 0.0
        mark = {"ts": self.t0, "dur": self.t1 - self.t0, "cat": "window"}
        busy_ms, _ = busy_share(self.device + [mark])
        return busy_ms / 1e3

    def kernel_seconds(self, pattern: str) -> Tuple[float, int]:
        """(device seconds, launches) of the kernels whose name matches."""
        rx = re.compile(pattern)
        hits = [e for e in self.device
                if _cat(e) == "kernel" and rx.search(str(e.get("name", "")))]
        return sum(float(e["dur"]) for e in hits) / 1e6, len(hits)

    def device_seconds_except(self, pattern: str) -> float:
        """Device seconds of every kernel, copy and memset whose name does
        not match ``pattern``."""
        rx = re.compile(pattern)
        return sum(float(e["dur"]) for e in self.device
                   if not rx.search(str(e.get("name", "")))) / 1e6

    def device_ops(self, top: int = 10) -> List[list]:
        """Device seconds by operation name (cut to ``NAME_CHARS``)."""
        totals: Dict[str, float] = {}
        for e in self.device:
            name = str(e.get("name", ""))[:NAME_CHARS]
            totals[name] = totals.get(name, 0.0) + float(e["dur"]) / 1e6
        return [[k, v] for k, v in
                sorted(totals.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """Idle device time summed by what the host was doing: each gap
        between device intervals goes to the innermost host event that
        covers most of it."""
        busy = _merged((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                       for e in self.device)
        edges = [self.t0] + [x for s, e in busy for x in (s, e)] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        names = [str(e.get("name", "")) for e in self.host]
        h0 = np.array([float(e["ts"]) for e in self.host])
        h1 = h0 + np.array([float(e["dur"]) for e in self.host])
        totals: Dict[str, float] = {}
        for g0, g1 in gaps:
            label = "(no host event)"
            if len(names):
                overlap = np.minimum(h1, g1) - np.maximum(h0, g0)
                covering = overlap >= 0.5 * (g1 - g0)
                pool = covering if covering.any() else overlap > 0
                if pool.any():
                    # The innermost (shortest) of the host events that
                    # cover most of the gap.
                    idx = np.flatnonzero(pool)
                    label = names[int(idx[np.argmin((h1 - h0)[idx])])]
            totals[label] = totals.get(label, 0.0) + (g1 - g0) / 1e6
        return [[k, v] for k, v in
                sorted(totals.items(), key=lambda kv: -kv[1])[:top]]


@contextmanager
def traced():
    """Profile the body on the host and the card; yields a list that holds
    the ``Trace`` once the body has run. The body's work must sit inside
    ``torch.profiler.record_function(WINDOW)``."""
    from torch.profiler import ProfilerActivity, profile, supported_activities

    if ProfilerActivity.CUDA not in supported_activities():
        raise RuntimeError("this torch build cannot trace the card (no CUPTI)")
    holder: List[Trace] = []
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    try:
        yield holder
    finally:
        prof.stop()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    trace = Trace(events)
    if not any(_cat(e) == "kernel" for e in trace.device):
        raise RuntimeError("the trace records no device kernel in the window")
    holder.append(trace)

