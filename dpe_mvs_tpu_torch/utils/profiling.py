"""Stage timing.

Port of :class:`dpe_mvs_tpu.utils.profiling.StageTimer`: spans with named
stages, summed per run (the per-stage lines ``verbose`` prints come from
here). A span without a device is timed by the host's clock. A span given a
CUDA device is timed on that device's stream by a pair of CUDA events: the
time from the stream reaching the span's start to its reaching the span's
end, so that it counts the device's work of the span (and the host's, where
the device waited for it) without ever blocking the host. Events are read
once they have completed, and all of them when ``totals`` is read.

:data:`BRANCHES` counts the full-resolution branches as the engine takes
them (host-side counts, no device work): the rect cost field's row bands,
the weak machinery's streamed anchor profiles, regathered probe-center
disparities and row bands, bf16 screening volumes and scanned view-selection
draws.
"""
from __future__ import annotations

import collections
import contextlib
import time
from typing import Deque, Dict, Iterator, Tuple

import torch


class StageTimer:
    """Accumulates seconds per named stage."""

    def __init__(self) -> None:
        self._totals: Dict[str, float] = collections.defaultdict(float)
        self.counts: Dict[str, int] = collections.defaultdict(int)
        self._pending: Deque[Tuple[str, object, object]] = \
            collections.deque()

    @contextlib.contextmanager
    def span(self, name: str, device=None) -> Iterator[None]:
        """Time the block as stage ``name``: by the host's clock, or with a
        CUDA ``device`` by events on its current stream."""
        if device is None or torch.device(device).type != "cuda":
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self._totals[name] += time.perf_counter() - t0
                self.counts[name] += 1
            return
        stream = torch.cuda.current_stream(device)
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

    def _collect(self, wait: bool) -> None:
        """Add the pending spans whose end event has completed (all of them,
        waiting, with ``wait``), oldest first."""
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
        """Seconds per stage, every span included."""
        self._collect(wait=True)
        return self._totals

    def summary(self) -> str:
        rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
        return "\n".join(f"{name:<28s} {tot:8.2f}s  x{self.counts[name]}"
                         for name, tot in rows)


GLOBAL_TIMER = StageTimer()

# Full-resolution branches taken so far, by name (see the module docstring);
# reset with ``BRANCHES.clear()``.
BRANCHES: collections.Counter = collections.Counter()
