"""Stage timing, and what the program records while a timer is attached.

Port of :class:`dpe_mvs_tpu.utils.profiling.StageTimer`: spans with named
stages, summed per run (the per-stage lines ``verbose`` prints come from
here). A span without a device is timed by the host's clock. A span given a
CUDA device is timed on that device's stream by a pair of CUDA events: the
time from the stream reaching the span's start to its reaching the span's
end, so that it counts the device's work of the span (and the host's, where
the device waited for it) without ever blocking the host. Events are read
once they have completed, and all of them when ``totals`` is read. Every
span also keeps its host interval on ``time.time_ns()``, the clock of the
profiler's device events (:attr:`StageTimer.intervals`), and its parent, the
span open on the same thread when it began (:attr:`StageTimer.parents`).

:func:`attach` hands a timer to the program for a block (``process_problem``
attaches the ``timer`` it is given for the whole sweep). While a timer is
attached, :func:`span` opens ``timer(name)`` around the engine's stages and
the weak stage's steps (``weak.ransac``, ``weak.sites``,
``weak.candidates``, ``weak.refine``, ``weak.final_cost``, ``weak.apply``),
and :data:`SYNCS` counts the host synchronisations, keyed by the innermost
:func:`span` open on the thread that synchronised (``"(no span)"`` outside
every span). With nothing attached, :func:`span` returns one shared
``nullcontext`` and nothing is counted.

The count: PyTorch's CUDA sync debug mode (``torch.cuda.set_sync_debug_mode``
"warn") raises a warning, "called a synchronizing CUDA operation", from
every synchronising copy (``.item()``, ``.cpu()``, ``torch.as_tensor`` of
host data onto the card, a boolean mask's ``nonzero``) and stream
synchronisation. While a timer is attached the mode is on and a hook on
``warnings.showwarning`` counts each such warning, however often one line
raises it, in place of printing it; every other warning is shown as before.
``torch.cuda.synchronize``, which the mode does not flag, is counted once
per call by a wrapper. Not counted: synchronisations the debug mode does
not flag (an implicit one in ``cudaHostAlloc`` or ``cudaFree`` under the
caching allocator, ``torch.cuda.Event.synchronize``, collectives of
``torch.distributed``), and those of threads that hold no Python frame.

:data:`BRANCHES` counts the full-resolution branches as the engine takes
them (host-side counts, no device work, always on): the rect cost field's
row bands, the weak machinery's streamed anchor profiles, regathered
probe-center disparities and row bands, bf16 screening volumes and scanned
view-selection draws.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import threading
import time
import warnings
from typing import Deque, Dict, Iterator, List, Optional, Tuple

import torch


class StageTimer:
    """Accumulates seconds per named stage (on ``device`` where a span
    names none). Every span's host interval is kept in :attr:`intervals`
    as ``(name, t0_ns, t1_ns)``, its parent's name (or None) at the same
    index of :attr:`parents`."""

    def __init__(self, device=None) -> None:
        self.device = device
        self.intervals: List[Tuple[str, int, int]] = []
        self.parents: List[Optional[str]] = []
        self._totals: Dict[str, float] = collections.defaultdict(float)
        self._child_s: Dict[str, float] = collections.defaultdict(float)
        self.counts: Dict[str, int] = collections.defaultdict(int)
        self._pending: Deque[Tuple[str, Optional[str], object, object]] = \
            collections.deque()
        self._open = threading.local()

    @contextlib.contextmanager
    def span(self, name: str, device=None) -> Iterator[None]:
        """Time the block as stage ``name``: by the host's clock, or with a
        CUDA ``device`` (this call's, else the timer's) by events on its
        current stream."""
        device = self.device if device is None else device
        stack = _open_names(self._open)
        parent = stack[-1] if stack else None
        stack.append(name)
        h0 = time.time_ns()
        try:
            if device is None or torch.device(device).type != "cuda":
                t0 = time.perf_counter()
                try:
                    yield
                finally:
                    self._add(name, parent, time.perf_counter() - t0)
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
                self._pending.append((name, parent, start, end))
                self.counts[name] += 1
                self._collect(wait=False)
        finally:
            stack.pop()
            self.intervals.append((name, h0, time.time_ns()))
            self.parents.append(parent)

    __call__ = span

    def _add(self, name: str, parent: Optional[str], seconds: float) -> None:
        self._totals[name] += seconds
        if parent is not None:
            self._child_s[parent] += seconds

    def _collect(self, wait: bool) -> None:
        """Add the pending spans whose end event has completed (all of them,
        waiting, with ``wait``), oldest first."""
        while self._pending:
            name, parent, start, end = self._pending[0]
            if wait:
                end.synchronize()
            elif not end.query():
                return
            self._add(name, parent, start.elapsed_time(end) / 1e3)
            self._pending.popleft()

    @property
    def totals(self) -> Dict[str, float]:
        """Seconds per stage, every span included."""
        self._collect(wait=True)
        return self._totals

    def summary(self) -> str:
        """A line per stage, longest first: its total, its self time (the
        total less what its child spans took), its count and the host
        synchronisations counted under it (:data:`SYNCS`)."""
        rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
        return "\n".join(
            f"{name:<28s} {tot:9.3f}s  self {tot - self._child_s[name]:9.3f}s"
            f"  x{self.counts[name]}  syncs {SYNCS[name]}"
            for name, tot in rows)


GLOBAL_TIMER = StageTimer()

# Full-resolution branches taken so far, by name (see the module docstring);
# reset with ``BRANCHES.clear()``.
BRANCHES: collections.Counter = collections.Counter()

# Host synchronisations while a timer is attached, by the innermost span
# open on the thread that synchronised; reset with ``SYNCS.clear()``.
SYNCS: collections.Counter = collections.Counter()
NO_SPAN = "(no span)"
SYNC_MESSAGE = "called a synchronizing CUDA operation"

_NULL = contextlib.nullcontext()
_attached = None                     # the attached timer, or None
_thread = threading.local()          # .names: this thread's open spans


def _open_names(local: threading.local) -> List[str]:
    """The calling thread's list of open spans in ``local``."""
    names = getattr(local, "names", None)
    if names is None:
        names = local.names = []
    return names


def span(name: str):
    """``timer(name)`` of the attached timer, as the innermost open span of
    this thread; with none attached, a shared no-op context."""
    if _attached is None:
        return _NULL
    return _open_span(_attached, name)


@contextlib.contextmanager
def _open_span(timer, name: str) -> Iterator[None]:
    names = _open_names(_thread)
    names.append(name)
    try:
        with timer(name):
            yield
    finally:
        names.pop()


@contextlib.contextmanager
def attach(timer) -> Iterator[None]:
    """Attach ``timer`` (a callable ``timer(name)`` returning a context
    manager) for the block: :func:`span` opens its spans and the host
    synchronisations are counted. ``None`` attaches nothing; inside another
    attached block the inner timer takes the spans until it ends."""
    global _attached
    if timer is None:
        yield
        return
    outer, _attached = _attached, timer
    try:
        if outer is not None:
            yield
        else:
            with _counting_syncs():
                yield
    finally:
        _attached = outer


def outermost(timer):
    """``timer`` for the spans opened inside none of its own: a sweep's
    stages, each timed whole, with the weak stage's steps left to their
    stage. For timers that synchronise or reset the device's counters as a
    span begins, which a nested span would break up."""
    depth = [0]

    @contextlib.contextmanager
    def outer(name: str) -> Iterator[None]:
        if depth[0]:
            yield
            return
        depth[0] += 1
        try:
            with timer(name):
                yield
        finally:
            depth[0] -= 1
    return outer


def _count_sync() -> None:
    names = getattr(_thread, "names", None)
    SYNCS[names[-1] if names else NO_SPAN] += 1


@contextlib.contextmanager
def _counting_syncs() -> Iterator[None]:
    """PyTorch's sync warnings counted, not shown, for the block; the
    previous warning filters, hook, debug mode and ``synchronize``
    restored after it, however it ends."""
    cuda = torch.cuda.is_available()
    with warnings.catch_warnings():
        warnings.filterwarnings("always", message=SYNC_MESSAGE)
        shown = warnings.showwarning

        def show(message, category, filename, lineno, file=None,
                 line=None):
            if str(message).startswith(SYNC_MESSAGE):
                _count_sync()
            else:
                shown(message, category, filename, lineno, file, line)

        warnings.showwarning = show
        synchronize = torch.cuda.synchronize

        @functools.wraps(synchronize)
        def counted_synchronize(*args, **kwargs):
            # The debug mode does not flag a device synchronisation.
            _count_sync()
            return synchronize(*args, **kwargs)

        torch.cuda.synchronize = counted_synchronize
        mode = None
        try:
            if cuda:
                mode = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("warn")
            yield
        finally:
            if mode is not None:
                torch.cuda.set_sync_debug_mode(mode)
            torch.cuda.synchronize = synchronize
