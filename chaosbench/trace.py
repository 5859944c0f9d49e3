"""Reads a ``torch.profiler`` trace of the measured window.

From the profiler's raw events, as ``chip_smoke.device_times`` reads them
(raw events, not ``key_averages()``, whose event tree takes minutes to
build over a window's hundreds of thousands of launches):

- the device time of each device event name (kernels, copies, sets);
- the device time of the kernels launched inside each CPU-side
  ``record_function`` range of a given set of names (a kernel's
  ``linked_correlation_id`` names the runtime call that launched it);
- the device's busy time: the union of its events' intervals inside the
  window, the CPU-side range ``chaosbench.window``;
- the idle time, by what the host was doing: each gap between busy
  intervals goes to the innermost ``chaosbench.*`` range around its middle.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field

PREFIX = "chaosbench."
WINDOW = PREFIX + "window"
#: a gap that falls inside no range of the harness: the replay loop's own
#: work between the harness's calls.
BETWEEN = "between calls"


@dataclass
class Trace:
    window_s: float
    busy_s: float
    #: device event name -> (seconds, count), inside the window
    device: dict = field(default_factory=dict)
    #: range name -> (seconds of device time launched inside it, count)
    ranges: dict = field(default_factory=dict)
    #: what the host was doing -> seconds the device sat idle meanwhile
    idle: dict = field(default_factory=dict)

    @property
    def device_s(self) -> float:
        return sum(s for s, _ in self.device.values())

    def seconds_of(self, needle: str) -> float:
        """Device seconds of the events whose name holds ``needle``."""
        return sum(s for name, (s, _) in self.device.items() if needle in name)


def short_name(name: str) -> str:
    """A kernel's name without its return type and argument list."""
    name = name.removeprefix("void ")
    cut = name.find("(")
    return (name[:cut] if cut > 0 else name)[:120]


def read(events, range_names=()) -> Trace:
    """The trace of the window from a profile's raw events (``prof.profiler
    .kineto_results.events()``); ``range_names``: the CPU ranges whose
    kernels' device time to attribute."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device = []  # (start, end, name, linked correlation id)
    launch_ns = {}  # runtime call correlation id -> its start
    spans = {name: [] for name in range_names}
    harness = []  # (start, end, label)
    window = None
    for e in events:
        name = e.name()
        start, dur = e.start_ns(), e.duration_ns()
        if e.device_type() == cuda:
            if dur <= 0 or name.startswith(PREFIX) or name in spans:
                continue  # a range's device-side marker
            device.append((start, start + dur, name, e.linked_correlation_id()))
        elif name == WINDOW:
            window = (start, start + dur)
        elif name.startswith(PREFIX):
            harness.append((start, start + dur, name[len(PREFIX):]))
        elif name in spans:
            spans[name].append((start, start + dur))
        elif e.linked_correlation_id() == 0 and e.correlation_id() > 0:
            launch_ns[e.correlation_id()] = start
    if window is None:
        raise ValueError(f"the trace has no {WINDOW!r} range")
    w0, w1 = window
    device = sorted(d for d in device if d[1] > w0 and d[0] < w1)

    per_name = {}
    for start, end, name, _ in device:
        s, n = per_name.get(name, (0.0, 0))
        per_name[name] = (s + (min(end, w1) - max(start, w0)) / 1e9, n + 1)

    ranges = {}
    for name, intervals in spans.items():
        intervals.sort()
        starts = [s for s, _ in intervals]
        ns = 0
        for start, end, _, corr in device:
            t = launch_ns.get(corr)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= intervals[i][1]:
                ns += end - start
        ranges[name] = (ns / 1e9, len(intervals))

    busy, gaps, cursor = 0, [], w0
    for start, end, _, _ in device:
        start, end = max(start, w0), min(end, w1)
        if start > cursor:
            gaps.append((cursor, start))
        if end > cursor:
            busy += end - max(start, cursor)
            cursor = end
    if w1 > cursor:
        gaps.append((cursor, w1))
    return Trace(window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9, device=per_name,
                 ranges=ranges, idle=_idle_by_label(gaps, harness))


def _idle_by_label(gaps, harness):
    """Each gap's length, summed by the innermost harness range open at the
    gap's middle (ranges nest, so the innermost is the last one opened)."""
    marks = sorted([(s, 1, i) for i, (s, _, _) in enumerate(harness)]
                   + [(e, 0, i) for i, (_, e, _) in enumerate(harness)])
    out, open_, m = {}, [], 0
    for g0, g1 in gaps:
        mid = (g0 + g1) / 2
        while m < len(marks) and marks[m][0] <= mid:
            _, opening, i = marks[m]
            if opening:
                open_.append(i)
            elif i in open_:
                open_.remove(i)
            m += 1
        label = harness[open_[-1]][2] if open_ else BETWEEN
        out[label] = out.get(label, 0.0) + (g1 - g0) / 1e9
    return out


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The ``breakdown`` of a result line: the device events that took most
    time and the host activities under which the device sat idle longest."""
    ops = {}
    for name, (s, _) in trace.device.items():
        key = short_name(name)
        ops[key] = ops.get(key, 0.0) + s
    return {"device_ops": [[k, v] for k, v in sorted(ops.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": [[k, v] for k, v in sorted(trace.idle.items(),
                                                    key=lambda kv: -kv[1])[:top]]}
