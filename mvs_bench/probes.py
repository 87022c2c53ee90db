"""Wrappers the benchmark puts around the program's five kernel entries.

``rowgather.row_gather`` / ``bilinear_x`` and ``gather2d.gather2d`` /
``gather2d_hwc`` / ``gather2d_pick`` are looked up by module attribute at
every call site, so replacing the attribute sees every launch. A wrapper
counts the entry's launches per sweep, copies the inputs and output of the
launches drawn for the correctness check to the host (on the program's
stream, right after the launch), and in the traced run adds each launch's
bound (:mod:`.roofline`) on the device, on a stream of its own that the
trace reduction leaves out.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np

from . import roofline

ENTRIES = (("rowgather", "row_gather"), ("rowgather", "bilinear_x"),
           ("gather2d", "gather2d"), ("gather2d", "gather2d_hwc"),
           ("gather2d", "gather2d_pick"))


@dataclasses.dataclass
class Capture:
    name: str
    args: tuple            # host copies
    out: object            # host copy


def _copy(t):
    """A host copy of ``t`` that does not wait for the device: into pinned
    memory on the current stream (read once the window has synchronised).
    A strided view is copied as the span of storage it covers, so nothing
    is allocated on the card."""
    import torch
    if not isinstance(t, torch.Tensor):
        return t
    if t.device.type != "cuda":
        return t.detach().clone()
    src = t.view(torch.int32) if t.dtype == torch.uint32 else t
    if src.is_contiguous():
        buf = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        buf.copy_(src, non_blocking=True)
        return HostView(buf, None, t.dtype)
    extent = 1 + sum((n - 1) * st for n, st in zip(src.shape, src.stride()))
    flat = src.as_strided((extent,), (1,), src.storage_offset())
    buf = torch.empty(extent, dtype=src.dtype, pin_memory=True)
    buf.copy_(flat, non_blocking=True)
    return HostView(buf, (tuple(src.shape), tuple(src.stride())), t.dtype)


@dataclasses.dataclass
class HostView:
    """A copied tensor: its host buffer and, for a strided view, the view's
    shape and strides in it."""
    buf: object
    view: Optional[tuple]
    dtype: object

    def tensor(self):
        import torch
        t = self.buf if self.view is None else self.buf.as_strided(*self.view)
        return t.view(torch.uint32) if self.dtype == torch.uint32 else t


def host(t):
    """The host tensor of a copy made by :func:`_copy`."""
    return t.tensor() if isinstance(t, HostView) else t


class KernelProbe:
    """Installed over the program's kernel modules (``modules``: name ->
    module), undone by :meth:`remove`.

    Of each entry's launches in each sweep, one drawn uniformly by ``rng``
    is kept (reservoir sampling: the i-th launch replaces the kept one with
    probability 1 / i), its inputs and output copied to the host without
    waiting for the device. ``account`` adds every launch's bound in a
    device accumulator. ``replace``, given, computes an entry's
    output in place of the kernel (the control)."""

    def __init__(self, modules: Dict[str, object], rng: np.random.Generator,
                 account: bool = False,
                 replace: Optional[Callable] = None) -> None:
        self.modules = modules
        self.rng = rng
        self.account = account
        self.replace = replace
        self.sweep = -1
        self.calls: Dict[str, int] = {n: 0 for _m, n in ENTRIES}
        self.per_sweep: List[Dict[str, int]] = []
        self.kept: Dict[str, Capture] = {}
        self.captures: List[Capture] = []
        self.bound_s = None         # device accumulator (account)
        self._orig = {}
        self._side = None           # the probes' own CUDA stream
        for mod_name, name in ENTRIES:
            mod = modules[mod_name]
            self._orig[name] = getattr(mod, name)
            setattr(mod, name, self._wrap(mod, name, self._orig[name]))

    def remove(self) -> None:
        for mod_name, name in ENTRIES:
            setattr(self.modules[mod_name], name, self._orig[name])

    def start_sweep(self) -> None:
        """Close the previous sweep and open the next."""
        self._close()
        self.sweep += 1
        self.calls = {n: 0 for _m, n in ENTRIES}

    def finish(self) -> None:
        self._close()
        self.sweep = -1

    def _close(self) -> None:
        if self.sweep >= 0:
            self.per_sweep.append(dict(self.calls))
            self.captures += [self.kept[n] for _m, n in ENTRIES
                              if n in self.kept]
        self.kept = {}

    def _wrap(self, mod, name, orig):
        counters = mod.LAUNCHES

        def entry(*args):
            before = counters.get(name, 0)
            if self.replace is not None:
                out = self.replace(name, args)
                counters[name] = before + 1
            else:
                out = orig(*args)
            launched = (counters.get(name, 0) != before
                        or args[0].device.type == "cpu")
            if not launched or self.sweep < 0:
                return out
            k = self.calls[name]
            self.calls[name] = k + 1
            if self.rng.random() * (k + 1) < 1.0:
                # Copied on the program's stream, right after the launch:
                # the program may write its tensors in place later (a
                # copy on another stream could read them after that).
                self.kept[name] = Capture(
                    name, tuple(_copy(a) for a in args), _copy(out))
            if self.account:
                with self._stream(args + (out,)):
                    self._add(name, args, out)
            return out

        entry.__wrapped__ = orig
        return entry

    @contextlib.contextmanager
    def _stream(self, tensors):
        """Run the probe's own device work on a stream of its own, after
        the program's work so far, keeping ``tensors`` from reuse until it
        is done."""
        import torch
        t0 = tensors[0]
        if t0.device.type != "cuda":
            yield
            return
        if self._side is None:
            self._side = torch.cuda.Stream(t0.device)
        main = torch.cuda.current_stream(t0.device)
        self._side.wait_stream(main)
        for t in tensors:
            if isinstance(t, torch.Tensor):
                t.record_stream(self._side)
        with torch.cuda.stream(self._side):
            yield

    def _add(self, name, args, out) -> None:
        import torch
        dev = args[0].device
        if self.bound_s is None:
            self.bound_s = torch.zeros((), dtype=torch.float64, device=dev)
        n_bytes, ops = roofline.launch_work(name, args, out)
        self.bound_s += (n_bytes.to(torch.float64)
                         / roofline.HBM_BYTES_PER_S).clamp(
            min=ops / roofline.F32_OPS_PER_S)

    def missing(self) -> List[str]:
        """Entries that launched in the window of which no launch was
        copied."""
        have = {c.name for c in self.captures}
        launched = {n for counts in self.per_sweep for n in counts
                    if counts[n]}
        return sorted(launched - have)
