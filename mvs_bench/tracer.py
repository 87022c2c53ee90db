"""Spans and the device trace of the traced run.

``StageTimer`` is a copy of the program's ``utils/profiling.StageTimer``:
a span on a CUDA device is timed by a pair of CUDA events on its current
stream, read once complete, so the host never waits for it. Here each span
also keeps its host interval on the profiler's clock (Unix nanoseconds), so
that the trace can say which stage the host was in.

The profiler records the card's activity only (kernels, copies, sets): at
the port's millions of launches a sweep, recording every host operation as
well slows a sweep about twofold and its events take minutes to read.
:func:`reduce_trace` turns the device events over the window into the
device's busy time, its launches, the hand-written kernels' time and the
breakdown of device operations and idle gaps. The program runs on one
stream; the benchmark's probes run on a stream of their own
(:mod:`.probes`), whose events are left out.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import time
from typing import Deque, Dict, Iterator, List, Optional, Tuple

from . import roofline


class StageTimer:
    """Seconds per named span; CUDA spans by events on the device. Every
    span's host interval is kept in :attr:`intervals`."""

    def __init__(self, device=None) -> None:
        import torch
        self.device = device
        self.intervals: List[Tuple[str, int, int]] = []
        self._totals: Dict[str, float] = collections.defaultdict(float)
        self.counts: Dict[str, int] = collections.defaultdict(int)
        self._pending: Deque[Tuple[str, object, object]] = \
            collections.deque()
        self._cuda = (device is not None
                      and torch.device(device).type == "cuda")

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        import torch
        h0 = time.time_ns()
        try:
            if not self._cuda:
                t0 = time.perf_counter()
                try:
                    yield
                finally:
                    self._totals[name] += time.perf_counter() - t0
                    self.counts[name] += 1
                return
            stream = torch.cuda.current_stream(self.device)
            start = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            try:
                yield
            finally:
                end = torch.cuda.Event(enable_timing=True)
                end.record(stream)
                self._pending.append((name, start, end))
                self.counts[name] += 1
                self._collect(wait=False)
        finally:
            self.intervals.append((name, h0, time.time_ns()))

    __call__ = span

    def _collect(self, wait: bool) -> None:
        while self._pending:
            name, start, end = self._pending[0]
            if wait:
                end.synchronize()
            elif not end.query():
                return
            self._totals[name] += start.elapsed_time(end) / 1e3
            self._pending.popleft()

    @property
    def totals(self) -> Dict[str, float]:
        self._collect(wait=True)
        return dict(self._totals)


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    launches: int                      # kernel launches of the program
    kernel_s: Dict[str, float]         # hand-written kernels, by device name
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    other_s: float                     # device time on the probes' streams
    events: int
    streams: Dict[int, int]            # events per stream


DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _kind_by_name(name: str) -> str:
    """The activity of a device event that does not carry it: copies and
    sets are named so by the profiler, the rest are kernels."""
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _short(name: str, n: int = 96) -> str:
    name = " ".join(name.split())
    return name if len(name) <= n else name[:n - 3] + "..."


def device_events(events) -> List[tuple]:
    """(start_ns, end_ns, name, stream, activity) of every device event."""
    from torch.autograd import DeviceType
    cuda = DeviceType.CUDA
    out = []
    if not events:
        return out
    typed = hasattr(events[0], "activity_type")
    streams = hasattr(events[0], "device_resource_id")
    for e in events:
        if e.device_type() != cuda:
            continue
        name = e.name()
        kind = e.activity_type() if typed else _kind_by_name(name)
        if kind in DEVICE_ACTIVITIES:
            out.append((e.start_ns(), e.end_ns(), name,
                        e.device_resource_id() if streams else 0, kind))
    return out


def reduce_trace(device: List[tuple], window: Tuple[int, int],
                 host_ranges: List[Tuple[str, int, int]]) -> TraceSummary:
    """Reduce device events (:func:`device_events`) over ``window`` (Unix
    ns) to a :class:`TraceSummary`. The program's stream is the one that
    ran the hand-written kernels (else the one with the most events); the
    others' time is ``other_s``. An idle gap of the program's stream is
    attributed to the host range (``host_ranges``: name, start, end) open
    at its start, else to "other host work"."""
    w0, w1 = window
    inside = [ev for ev in device if ev[1] > w0 and ev[0] < w1]
    # A few hundred distinct names among millions of events: classify each
    # name once.
    names = {}
    for ev in inside:
        if ev[2] not in names:
            names[ev[2]] = (_short(ev[2]),
                            next((dn for dn in roofline.DEVICE_NAMES
                                  if dn in ev[2]), None))
    per_stream = collections.Counter(ev[3] for ev in inside)
    own = collections.Counter(ev[3] for ev in inside if names[ev[2]][1])
    main = (own or per_stream).most_common(1)[0][0] if inside else None

    ours, other_s = [], 0.0
    by_name = collections.defaultdict(float)
    kernel_s = collections.defaultdict(float)
    launches = 0
    for a, b, name, stream, kind in inside:
        if stream != main:
            other_s += (min(b, w1) - max(a, w0)) / 1e9
            continue
        a, b = max(a, w0), min(b, w1)
        ours.append((a, b))
        short, own_name = names[name]
        by_name[short] += (b - a) / 1e9
        launches += kind == "kernel"
        if own_name is not None:
            kernel_s[own_name] += (b - a) / 1e9
    busy = _union(ours)
    busy_s = sum(b - a for a, b in busy) / 1e9

    st = sorted((a, b, n) for n, a, b in host_ranges)
    st_starts = [s[0] for s in st]
    gaps = collections.defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for i in range(0, len(edges) - 1, 2):
        a, b = edges[i], edges[i + 1]
        if b <= a:
            continue
        j = bisect.bisect_right(st_starts, a) - 1
        label = (st[j][2] if j >= 0 and st[j][1] >= a
                 else "other host work")
        gaps[label] += (b - a) / 1e9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gap_top = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return TraceSummary(window_s=(w1 - w0) / 1e9, busy_s=busy_s,
                        launches=launches, kernel_s=dict(kernel_s),
                        device_ops=top, idle_gaps=gap_top, other_s=other_s,
                        events=len(inside), streams=dict(per_stream))


def profiler():
    """A profiler of the card's activity only, started by ``__enter__`` and
    ended by :func:`stop`. Nothing on the host is recorded, so it needs no
    correlation of host and device events."""
    import torch
    from torch._C._profiler import _ExperimentalConfig
    try:
        config = _ExperimentalConfig(disable_external_correlation=True)
    except TypeError:
        config = _ExperimentalConfig()
    return torch.autograd.profiler.profile(
        use_device="cuda", use_cpu=False, use_kineto=True,
        experimental_config=config)


def stop(log=None):
    """End the running profiler and return its device events
    (:func:`device_events`), without the profile object's own
    post-processing (a Python object per event: minutes at millions of
    launches)."""
    import torch
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    results = torch.autograd._disable_profiler()
    done = getattr(torch.autograd.profiler, "_run_on_profiler_stop", None)
    if done is not None:
        done()
    t1 = time.perf_counter()
    events = results.events()
    t2 = time.perf_counter()
    out = device_events(events)
    if log is not None:
        log(f"trace: stop {t1 - t0:.3f} s, {len(events)} events "
            f"{t2 - t1:.3f} s, device events {time.perf_counter() - t2:.3f}"
            " s")
    return out


class WindowClock:
    """The window's bounds on the profiler's clock (Unix ns)."""

    def __init__(self) -> None:
        self.bounds: Optional[Tuple[int, int]] = None

    @contextlib.contextmanager
    def __call__(self):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.bounds = (t0, time.time_ns())
