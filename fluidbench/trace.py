"""The traced window: a ``torch.profiler`` trace of a few units after the
measured window, and its reduction to the numbers the per-layer metrics
read.

The work runs inside a ``fluidbench.window`` span and closes on a
synchronize; marker kernels (``torch.cuda._sleep``, 32 a side, between
10 ms host pauses) bracket it, since a session can lose its first device
records.  A trace counts only if a marker survived on each side of the
work and none lies inside it; a lossy trace is taken again, up to three
times.  Every number below comes from that one window: the window's
length is the span's, and a device operation counts for the part of it
that lies inside the span.

The port's own spans (``fluid.*``, operator ranges on the host) are
summarized by name: how often they ran, their host time and the device
time of the operations launched inside them.  A device operation's span is
found from its launch: the CPU event whose ``kernels`` list it, then up
``cpu_parent`` to the first ``fluid.*`` event, the innermost span.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict, deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

MARKERS = 32
TRIES = 3
SPAN = "fluidbench.window"
PORT = "fluid."  # the port's spans
MARKER = "spin_kernel"
TOP = 10
NAME_CHARS = 160  # a device operation's name as the breakdown gives it

Interval = Tuple[float, float]


def union(intervals: Sequence[Interval]) -> List[Interval]:
    """The union of [start, end) intervals as disjoint sorted intervals."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(iv: Interval, lo: float, hi: float) -> Optional[Interval]:
    a, b = max(iv[0], lo), min(iv[1], hi)
    return (a, b) if b > a else None


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def is_readback(name: str) -> bool:
    return name.startswith("Memcpy DtoH")


def summarize(window: Interval, device: Sequence[Tuple[str, float, float]],
              host: Sequence[tuple],
              links: Optional[Sequence[Optional[int]]] = None) -> dict:
    """The traced window's numbers from its events, times in seconds:
    ``device`` and ``host`` are (name, start, end) of the device operations
    (markers excluded) and of the host's spans and calls; a host event may
    carry a fourth element, the index in ``host`` of its parent (or None).
    ``links[i]``, where given, is the index in ``host`` of the event that
    launched device operation ``i`` (or None).  A device operation named
    ``fluid.*`` is a port span projected onto the device's timeline, not
    device work, and is left out.

    ``busy_s``: the union of the device operations inside the window;
    ``kernel_s``: the kernels' time (copies and memsets excluded);
    ``readback_s``: the device-to-host copies' time; ``device_ops``: the
    device time by operation name, largest first; ``idle_gaps``: the idle
    time of the device by what the host was doing at the gap's middle (its
    innermost span or call, or "host python between calls"), largest
    first; ``spans``: for each port span (``fluid.*``) inside the window,
    {``count``, ``host_s``, ``device_s``}, ``device_s`` being the device
    time of the operations whose launch lies in it and in no inner port
    span (0 without ``links``)."""
    lo, hi = window
    inside, launched = [], []
    for i, (name, a, b) in enumerate(device):
        iv = clip((a, b), lo, hi)
        if iv and not name.startswith(PORT):
            inside.append((name, iv))
            launched.append(links[i] if links is not None else None)
    busy = union([iv for _, iv in inside])
    by_name: Dict[str, float] = defaultdict(float)
    for name, (a, b) in inside:
        by_name[name[:NAME_CHARS]] += b - a
    gaps, at = [], lo
    for a, b in busy + [(hi, hi)]:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    calls = sorted((a, b, name) for name, a, b, *_ in host if name != SPAN)
    starts = [a for a, _, _ in calls]
    idle: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid)
        what = "host python between calls"
        for j in range(i - 1, max(i - 257, -1), -1):
            if calls[j][1] > mid:  # the latest call still open: the innermost
                what = calls[j][2]
                break
        idle[what] += b - a

    spans: Dict[str, dict] = defaultdict(lambda: {"count": 0, "host_s": 0.0, "device_s": 0.0})
    for name, a, b, *_ in host:
        iv = clip((a, b), lo, hi) if name.startswith(PORT) else None
        if iv:
            spans[name]["count"] += 1
            spans[name]["host_s"] += iv[1] - iv[0]
    for (_, (a, b)), j in zip(inside, launched):
        while j is not None and not host[j][0].startswith(PORT):
            j = host[j][3] if len(host[j]) > 3 else None
        if j is not None:
            spans[host[j][0]]["device_s"] += b - a

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return {
        "window_s": hi - lo,
        "busy_s": sum(b - a for a, b in busy),
        "kernel_s": sum(b - a for name, (a, b) in inside if not is_copy(name)),
        "readback_s": sum(b - a for name, (a, b) in inside if is_readback(name)),
        "device_ops": top(by_name),
        "idle_gaps": top(idle),
        "spans": dict(spans),
    }


def launches(cpu: Sequence, dev: Sequence) -> List[Optional[int]]:
    """For each device event of ``dev`` (in start order), the index in
    ``cpu`` (in start order) of the event whose ``kernels`` list it, or
    None.  A ``kernels`` entry names its operation's name, device and
    duration; operations alike in all three are paired in order."""
    waiting: Dict[tuple, deque] = defaultdict(deque)
    for j, e in enumerate(cpu):
        for k in e.kernels:
            waiting[(k.name, k.device, k.duration)].append(j)
    out: List[Optional[int]] = []
    for e in dev:
        q = waiting.get((e.name, e.device_index, e.time_range.elapsed_us()))
        out.append(q.popleft() if q else None)
    return out


def _markers() -> None:
    time.sleep(0.01)
    for _ in range(MARKERS):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    time.sleep(0.01)


def traced(work: Callable[[], object]) -> Optional[dict]:
    """Run ``work()`` under the profiler between markers: the trace's
    summary (:func:`summarize`), or None after :data:`TRIES` lossy traces."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(TRIES):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            _markers()
            with torch.profiler.record_function(SPAN):
                work()
                torch.cuda.synchronize()
            _markers()
        events = prof.events()
        # the span also shows on the device's timeline, as an annotation
        dev = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                      and e.name != SPAN), key=lambda e: e.time_range.start)
        spans = [e for e in events if e.name == SPAN
                 and e.device_type == torch.autograd.DeviceType.CPU]
        marker = [MARKER in e.name for e in dev]
        work_at = [i for i, m in enumerate(marker) if not m]
        if not (spans and work_at and marker[0] and marker[-1]
                and not any(marker[work_at[0]:work_at[-1]])):
            continue
        us = 1e-6
        span = spans[0].time_range
        ops = [e for e, m in zip(dev, marker) if not m]
        device = [(e.name, e.time_range.start * us, e.time_range.end * us) for e in ops]
        cpu = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
        index = {id(e): j for j, e in enumerate(cpu)}
        host = [(e.name, e.time_range.start * us, e.time_range.end * us,
                 index.get(id(e.cpu_parent))) for e in cpu]
        return summarize((span.start * us, span.end * us), device, host, launches(cpu, ops))
    return None
