"""What the benchmark reads from a ``torch.profiler`` trace of its window.

The device is busy where any CUDA activity (kernel, copy, set) runs: the
union of their intervals, as ``chip_smoke.py``'s ``Smoke.profile`` takes
it. An idle gap is labelled by what the host was doing in its middle: the
innermost benchmark span (``pb::...``) and the innermost host operation
the profiler recorded on the benchmark's thread then ("host" where there
was none: Python code of the port or of the benchmark).
"""

from __future__ import annotations

import dataclasses
import re

SPAN_PREFIX = "pb::"
WINDOW = SPAN_PREFIX + "window"


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: dict  # device activity name -> seconds inside the window
    idle_gaps: list  # [label, seconds], the largest first


def union(intervals) -> tuple:
    """(total length, merged intervals) of (start, end) pairs."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1][1] = b
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), merged


def gaps(merged, start, end) -> list:
    """The idle (start, end) intervals of [start, end] between merged busy
    intervals."""
    out, t = [], start
    for a, b in merged:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if end > t:
        out.append((t, end))
    return out


def label_gaps(idle, host_events) -> dict:
    """Seconds of idle time by label. ``host_events`` are (start, end, name)
    of one thread, properly nested; times in nanoseconds."""
    events = sorted(host_events, key=lambda e: (e[0], -e[1]))  # parents first
    totals: dict = {}
    stack, j = [], 0
    for a, b in sorted(idle, key=lambda g: g[0] + g[1]):
        mid = (a + b) / 2
        while j < len(events) and events[j][0] <= mid:
            while stack and stack[-1][1] <= events[j][0]:
                stack.pop()
            stack.append(events[j])
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        spans = [name for _, _, name in stack if name.startswith(SPAN_PREFIX)]
        span = spans[-1] if spans else "outside spans"
        inner = stack[-1][2] if stack and not stack[-1][2].startswith(SPAN_PREFIX) else "host"
        label = f"{span} > {inner}"
        totals[label] = totals.get(label, 0.0) + (b - a) / 1e9
    return totals


def short_name(name: str, width: int = 100) -> str:
    """A kernel's name without namespaces of its own, casts or parameters."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0:
            cut = i
            break
    return name[:cut][:width]


_IDENT = re.compile(r"([A-Za-z_][\w:]*)\s*[<(]")


def identifier(name: str) -> tuple:
    """(base identifier, template arguments or "") of a device activity."""
    short = short_name(name, 10_000)
    m = _IDENT.match(short)
    if not m:
        return short, ""
    base = m.group(1).split("::")[-1]
    return base, short[m.end(1):] if short[m.end(1):].startswith("<") else ""


def mirrored(event) -> bool:
    """A device-side copy of a host annotation (``gpu_user_annotation``):
    its name is the benchmark's span, or the profiler says so where its
    version can."""
    kind = getattr(event, "activity_type", None)
    return (event.name().startswith(SPAN_PREFIX) or event.is_user_annotation()
            or (kind is not None and "annotation" in kind()))


def summarize(prof, torch, top: int = 10) -> TraceSummary | None:
    """The window's device time, busy union, device activities by name and
    labelled idle gaps, or None where the trace holds no window. Reads the
    profiler's raw events (``kineto_results``): building ``prof.events()``
    takes a minute a million events. A device activity is every CUDA event
    but the ranges the profiler mirrors from host annotations."""
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    window = next((e for e in events if e.name() == WINDOW), None)
    if window is None:
        return None
    w0 = window.start_ns()
    w1 = w0 + window.duration_ns()
    thread = window.start_thread_id()
    device, host = [], []
    for e in events:
        a = e.start_ns()
        b = a + e.duration_ns()
        if e.device_type() == cuda:
            if mirrored(e):
                continue
            a, b = max(a, w0), min(b, w1)
            if b > a:
                device.append((a, b, e.name()))
        elif e.start_thread_id() == thread and b > w0 and a < w1 and e.name() != WINDOW:
            host.append((a, b, e.name()))
    busy_ns, merged = union((a, b) for a, b, _ in device)
    kernels: dict = {}
    for a, b, name in device:
        kernels[name] = kernels.get(name, 0.0) + (b - a) / 1e9
    idle = label_gaps(gaps(merged, w0, w1), host)
    return TraceSummary(window_s=(w1 - w0) / 1e9, busy_s=busy_ns / 1e9, kernels=kernels,
                        idle_gaps=sorted(idle.items(), key=lambda kv: -kv[1])[:top])


def breakdown(summary: TraceSummary, top: int = 10) -> dict:
    by_short: dict = {}
    for name, seconds in summary.kernels.items():
        key = short_name(name)
        by_short[key] = by_short.get(key, 0.0) + seconds
    ops = sorted(by_short.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in summary.idle_gaps[:top]]}
