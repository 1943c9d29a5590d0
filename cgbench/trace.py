"""From a torch.profiler trace of a few solves to the device's busy time,
its kernel count, and the breakdown the result line carries.

The traced window is the span the harness opens around the solves (SPAN):
it starts before the first launch and ends after a synchronise. Every
device event in it (kernels, copies, fills) counts as busy; the union of
their intervals is the busy time, so overlapping events count once. An idle
gap is named by the innermost host operation that was running at its
middle, on the thread that opened the span. The span's own image on the
device timeline is no device operation and is left out.
"""

from __future__ import annotations

from collections import defaultdict

from torch.autograd import DeviceType

SPAN = "cgbench.traced_solves"
TOP = 10
NAME_CHARS = 120
NO_HOST_OP = "(no host op)"


def _is_copy(name):
    return name.startswith(("Memcpy", "Memset"))


def _is_annotation(event, span):
    """A span's image on the device timeline (record_function draws one
    there): no operation of the device."""
    return event.name == span or getattr(event, "is_user_annotation", False)


def _top(totals):
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]
    return [[name[:NAME_CHARS], seconds] for name, seconds in ranked]


def _union(intervals):
    """Merged [start, end] intervals of sorted (start, end) pairs."""
    merged = []
    for s, e in intervals:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _name_gaps(gaps, host):
    """The innermost host event containing each gap's middle. host: (start,
    end, name) of one thread, sorted by start then by longest first, so a
    parent comes before its children."""
    names, stack, j = [], [], 0
    for g0, g1 in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = 0.5 * (g0 + g1)
        while j < len(host) and host[j][0] <= mid:
            while stack and stack[-1][1] <= host[j][0]:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        names.append((stack[-1][2] if stack else NO_HOST_OP, g1 - g0))
    return names


def reduce(events, span=SPAN):
    """A dict of the traced window (None where the trace holds no span or
    no device event in it): busy_s, window_s, kernels (device events that
    are not copies or fills), device_ops and idle_gaps ([name, seconds],
    the TOP largest totals by name). Times in the events are in us."""
    events = list(events)
    marks = [e for e in events
             if e.name == span and e.device_type == DeviceType.CPU]
    if not marks:
        return None
    mark = marks[0]
    w0, w1 = mark.time_range.start, mark.time_range.end
    dev = sorted((max(e.time_range.start, w0), min(e.time_range.end, w1),
                  e.name) for e in events
                 if e.device_type == DeviceType.CUDA
                 and not _is_annotation(e, span)
                 and e.time_range.end > w0 and e.time_range.start < w1)
    if not dev:
        return None
    ops = defaultdict(float)
    for s, e, name in dev:
        ops[name] += (e - s) * 1e-6
    busy = _union((s, e) for s, e, _ in dev)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    host = sorted(((e.time_range.start, e.time_range.end, e.name)
                   for e in events
                   if e.device_type == DeviceType.CPU and e is not mark
                   and e.thread == mark.thread and not e.is_async
                   and e.time_range.end > e.time_range.start),
                  key=lambda h: (h[0], -h[1]))
    idle = defaultdict(float)
    for name, us in _name_gaps(gaps, host):
        idle[name] += us * 1e-6
    return {
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "window_s": (w1 - w0) * 1e-6,
        "kernels": sum(not _is_copy(name) for _, _, name in dev),
        "device_ops": _top(ops),
        "idle_gaps": _top(idle),
    }
