"""What the device did in a traced window, from `torch.profiler`'s
events: the union of the device's activity intervals, the operations that
took most of it, and the idle gaps, each named by the benchmark's span
that was open on the host when it began and the device operation that
ended it.

The window is the benchmark's `bench.window` span.  Device activity is
every event the profiler puts on the CUDA device (kernels, copies,
fills), save the benchmark's own spans, which the profiler mirrors onto
the device's timeline, and CUPTI's "Command Buffer Full" records, which
are the host waiting on a full launch queue.  An idle gap is cut where a
request span begins or ends: the part inside a span is named "<span>,
after <the device op before>" where the span ends inside the gap (the
host's work at the end of the span) and "<span>, before <the device op
after>" otherwise.

Each prove's kernels (copies and fills left out) are kept in launch order,
for the per-layer readers that split a prove into stages by the program's
kernel names (`stage_seconds`).  Where request spans overlap (more than
one request in flight), a kernel belongs to no one prove, and no prove's
kernels are kept.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple

WINDOW = "bench.window"
SPANS = ("bench.witness", "bench.device_prove")


PROVE = "bench.device_prove"
COPY = ("Memcpy", "Memset")

Interval = Tuple[int, int, str]           # start, end (ns), short name


class TraceData(NamedTuple):
    window_s: float
    busy_s: float
    device_ops: List[Tuple[str, float]]   # by summed seconds, top 10
    idle_gaps: List[Tuple[str, float]]    # by summed seconds, top 10
    proves: Optional[List[List[Interval]]]  # each prove's kernels


def short(name: str) -> str:
    """A kernel's name without its return type, namespace, template
    arguments and parameters."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            break
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip()[:100] or name[:100]


def _ns(ev, what: str) -> int:
    f = getattr(ev, what + "_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(ev, what + "_us")() * 1000)


def _events(prof):
    """(device intervals [(start, end, name)], spans {name: [(start,
    end)]}) in nanoseconds of the profiler's clock."""
    dev, spans = [], defaultdict(list)
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        start = _ns(ev, "start")
        end = start + _ns(ev, "duration")
        if "CUDA" in str(ev.device_type()):
            if not name.startswith(("Command Buffer Full", "bench.")):
                dev.append((start, end, name))
        elif name == WINDOW or name in SPANS:
            spans[name].append((start, end))
    dev.sort()
    for v in spans.values():
        v.sort()
    return dev, spans


class _Spans:
    """The request spans (which do not overlap), looked up by time."""

    def __init__(self, spans):
        self.items = sorted((s, e, name.split(".", 1)[1])
                            for name in SPANS for s, e in spans.get(name, ()))
        self.starts = [s for s, _, _ in self.items]

    def segments(self, g0: int, g1: int, before: str, after: str):
        """[(label, ns)] of the gap [g0, g1), cut at the spans' ends."""
        out, t = [], g0
        while t < g1:
            i = bisect.bisect_right(self.starts, t) - 1
            if i >= 0 and t < self.items[i][1]:
                end = min(self.items[i][1], g1)
                name = self.items[i][2]
                out.append((f"{name}, before {after}" if end == g1
                            else f"{name}, after {before}", end - t))
            else:
                nxt = self.starts[i + 1] if i + 1 < len(self.starts) else g1
                end = min(nxt, g1)
                out.append(("between requests", end - t))
            t = end
        return out


def read(prof) -> Optional[TraceData]:
    """None when the profiler saw no window or no device activity."""
    dev, spans = _events(prof)
    if not spans.get(WINDOW) or not dev:
        return None
    w0, w1 = spans[WINDOW][0][0], spans[WINDOW][-1][1]
    by_name: Dict[str, float] = defaultdict(float)
    gaps: Dict[str, float] = defaultdict(float)
    req = _Spans(spans)
    busy, cursor, last = 0, w0, "the window's start"

    def gap(g0, g1, after):
        for label, ns in req.segments(g0, g1, last, after):
            gaps[label] += ns / 1e9

    for s, e, name in dev:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        op = short(name)
        by_name[op] += (e - s) / 1e9
        if s > cursor:
            gap(cursor, s, op)
        if e > cursor:
            busy += e - max(s, cursor)
            cursor, last = e, op
    if w1 > cursor:
        gap(cursor, w1, "the window's end")

    def top(d):
        return sorted(d.items(), key=lambda kv: -kv[1])[:10]

    return TraceData((w1 - w0) / 1e9, busy / 1e9, top(by_name), top(gaps),
                     _proves(dev, spans.get(PROVE, []), w0, w1))


def _proves(dev, spans, w0: int, w1: int):
    """The kernels that start inside each prove span of the window, or
    None where the spans overlap."""
    spans = [(s, e) for s, e in spans if w0 <= s and e <= w1]
    if any(b[0] < a[1] for a, b in zip(spans, spans[1:])):
        return None
    kernels = [(s, e, short(n)) for s, e, n in dev
               if not n.startswith(COPY)]
    starts = [k[0] for k in kernels]
    return [kernels[bisect.bisect_left(starts, s):
                    bisect.bisect_right(starts, e)] for s, e in spans]


def busy_seconds(intervals) -> float:
    """The union of the intervals' lengths."""
    total, cursor = 0, None
    for s, e, _ in sorted(intervals):
        if cursor is None or s > cursor:
            total += e - s
            cursor = e
        elif e > cursor:
            total += e - cursor
            cursor = e
    return total / 1e9


def split_after(kernels, pattern: str, then: str = "") -> Optional[int]:
    """The index just past a prove's last kernel whose name matches
    `pattern` and the run of kernels matching `then` right after it;
    None where no kernel matches `pattern`."""
    hits = [i for i, k in enumerate(kernels) if re.search(pattern, k[2])]
    if not hits:
        return None
    i = hits[-1] + 1
    while then and i < len(kernels) and re.search(then, kernels[i][2]):
        i += 1
    return i


def before_split(pattern: str, then: str = ""):
    """A stage: a prove's kernels up to `split_after`."""
    def pick(kernels):
        i = split_after(kernels, pattern, then)
        return None if i is None else kernels[:i]
    return pick


def after_split(pattern: str, then: str = ""):
    """A stage: a prove's kernels from `split_after` on."""
    def pick(kernels):
        i = split_after(kernels, pattern, then)
        return None if i is None else kernels[i:]
    return pick


def stage_seconds(data: Optional[TraceData], pick) -> Optional[float]:
    """The device's busy seconds in one stage of a prove, the mean over
    the window's proves; None where the trace holds no prove or a prove
    has no such stage."""
    if data is None or not data.proves:
        return None
    times = []
    for kernels in data.proves:
        stage = pick(kernels)
        if not stage:
            return None
        times.append(busy_seconds(stage))
    return sum(times) / len(times)
