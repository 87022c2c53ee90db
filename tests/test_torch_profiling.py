"""The port's tracer (``dpe_mvs_tpu_torch.utils.profiling``) and the
benchmark's readers of what it records.

  * ``StageTimer`` keeps every span's host interval on ``time.time_ns()``
    with its parent, and its summary gives each name's self time; the
    benchmark's ``reduce_trace`` reads those intervals as they are and puts
    an idle gap inside the inner span down to it;
  * ``span`` is one shared no-op with no timer attached;
  * ``SYNCS`` counts the sync warnings only while a timer is attached, under
    the innermost span of the thread that raised them, every one of them
    even from one line, and lets every other warning through; ``attach``
    restores the warning state however its block ends; a nested attach
    gives the inner timer the spans, ``outermost`` times only the outer
    ones;
  * the five per-layer readers on a synthetic context;
  * on a card (``gpu``): ``.item()``, ``torch.as_tensor`` of a host number
    onto the card and ``torch.cuda.synchronize`` count one each, a fill
    none.

No JAX: ``python -m pytest --noconftest -m gpu tests/test_torch_profiling.py``
runs the card's test on a machine without it.
"""
import threading
import time
import warnings

import pytest
import torch

from dpe_mvs_tpu_torch.utils import profiling
from dpe_mvs_tpu_torch.utils.profiling import StageTimer
from mvs_bench import manifest, tracer

SYNC = profiling.SYNC_MESSAGE + " (Triggered internally at CUDAFunctions.h)"
WEAK_READERS = {"weak.sites_s": "weak.sites",
                "weak.candidates_s": "weak.candidates",
                "weak.refine_s": "weak.refine",
                "weak.final_cost_s": "weak.final_cost"}


@pytest.fixture
def syncs():
    profiling.SYNCS.clear()
    yield profiling.SYNCS
    profiling.SYNCS.clear()


def _self_s(timer, name):
    for line in timer.summary().splitlines():
        words = line.split()
        if words[0] == name:
            return float(words[words.index("self") + 1].rstrip("s"))
    raise KeyError(name)


def test_stage_timer_intervals_parents_and_self_time():
    timer = StageTimer()
    before = time.time_ns()
    with timer("outer"):
        time.sleep(0.01)
        with timer.span("inner"):
            time.sleep(0.03)
        with timer("inner"):
            time.sleep(0.03)
    after = time.time_ns()
    assert [n for n, _, _ in timer.intervals] == ["inner", "inner", "outer"]
    assert timer.parents == ["outer", "outer", None]
    for _, t0, t1 in timer.intervals:
        assert before <= t0 <= t1 <= after
    (_, a0, a1), (_, b0, b1), (_, o0, o1) = timer.intervals
    assert o0 <= a0 <= a1 <= b0 <= b1 <= o1
    totals = timer.totals
    assert timer.counts == {"outer": 1, "inner": 2}
    assert totals["inner"] >= 0.06 and totals["outer"] >= totals["inner"]
    own = _self_s(timer, "outer")
    assert own == pytest.approx(totals["outer"] - totals["inner"], abs=2e-3)
    assert own >= 0.009
    assert _self_s(timer, "inner") == pytest.approx(totals["inner"],
                                                    abs=2e-3)


def test_reduce_trace_reads_the_intervals():
    timer = StageTimer()
    with timer("weak"):
        time.sleep(0.002)
        with timer("weak.candidates"):
            time.sleep(0.02)
        time.sleep(0.01)
    (_, i0, i1), (_, o0, o1) = timer.intervals
    ms = 1_000_000
    # The device busy to 1 ms into the inner span, idle to 1 ms before its
    # end, busy to 1 ms after it, idle for 2 ms, busy to the outer span's
    # end, then idle for 5 ms.
    device = [(o0, i0 + ms, "k1", 7, "kernel"),
              (i1 - ms, i1 + ms, "k2", 7, "kernel"),
              (i1 + 3 * ms, o1, "k3", 7, "kernel")]
    summary = tracer.reduce_trace(device, (o0, o1 + 5 * ms),
                                  timer.intervals)
    gaps = dict(summary.idle_gaps)
    assert gaps["weak.candidates"] == pytest.approx((i1 - i0 - 2 * ms) / 1e9)
    # A gap after the inner span ended, in the outer one or past it, is
    # put down to other host work.
    assert gaps["other host work"] == pytest.approx(7 * ms / 1e9)
    assert summary.launches == 3


def test_span_is_a_shared_noop_when_detached(syncs):
    assert profiling.span("a") is profiling.span("b")
    with pytest.warns(UserWarning, match=profiling.SYNC_MESSAGE):
        with profiling.span("a"):
            warnings.warn(SYNC)
    assert not syncs


def test_syncs_counted_only_attached_and_by_innermost_span(syncs):
    timer = StageTimer()
    seen = {}

    def worker(name):
        if name is None:
            warnings.warn(SYNC)
        else:
            with profiling.span(name):
                warnings.warn(SYNC)
                seen[name] = True

    with warnings.catch_warnings(record=True) as shown:
        warnings.simplefilter("always")
        warnings.warn(SYNC)
        with profiling.attach(timer):
            with profiling.span("outer"):
                with profiling.span("inner"):
                    warnings.warn(SYNC)
                    for name in (None, "thread"):
                        t = threading.Thread(target=worker, args=(name,))
                        t.start()
                        t.join(timeout=30)
                        assert not t.is_alive()
                warnings.warn(SYNC)
            warnings.warn(SYNC)
        warnings.warn(SYNC)
    assert seen == {"thread": True}
    assert dict(syncs) == {"inner": 1, "outer": 1, profiling.NO_SPAN: 2,
                           "thread": 1}
    assert len(shown) == 2                 # the two outside the block
    assert timer.counts == {"outer": 1, "inner": 1, "thread": 1}
    assert timer.parents[timer.intervals.index(next(
        iv for iv in timer.intervals if iv[0] == "thread"))] is None


def test_hook_counts_every_call_and_passes_other_warnings(syncs):
    filters, show = list(warnings.filters), warnings.showwarning
    sync = torch.cuda.synchronize
    with warnings.catch_warnings(record=True) as shown:
        warnings.simplefilter("default")
        with profiling.attach(StageTimer()):
            assert torch.cuda.synchronize is not sync
            for _ in range(3):
                warnings.warn(SYNC)            # the same line each time
            warnings.warn("something else", RuntimeWarning)
    assert syncs[profiling.NO_SPAN] == 3
    assert [str(w.message) for w in shown] == ["something else"]
    assert shown[0].category is RuntimeWarning
    with pytest.raises(ValueError):
        with profiling.attach(StageTimer()):
            raise ValueError
    assert warnings.filters == filters and warnings.showwarning is show
    assert torch.cuda.synchronize is sync
    assert profiling.span("x") is profiling.span("y")


def test_nested_attach_gives_the_inner_timer_the_spans(syncs):
    outer, inner = StageTimer(), StageTimer()
    with warnings.catch_warnings():
        with profiling.attach(outer):
            with profiling.attach(inner):
                with profiling.span("a"):
                    warnings.warn(SYNC)
            with profiling.span("b"):
                pass
    assert dict(inner.counts) == {"a": 1} and dict(outer.counts) == {"b": 1}
    assert dict(syncs) == {"a": 1}


def test_outermost_times_only_the_outer_spans(syncs):
    timer = StageTimer()
    with warnings.catch_warnings():
        with profiling.attach(profiling.outermost(timer)):
            for stage in ("strong", "weak"):
                with profiling.span(stage):
                    with profiling.span("weak.refine"):
                        warnings.warn(SYNC)
    assert dict(timer.counts) == {"strong": 1, "weak": 1}
    assert dict(syncs) == {"weak.refine": 2}


@pytest.mark.parametrize("name", sorted(WEAK_READERS))
def test_weak_span_readers(name):
    reader = manifest.load_metric(name)
    span = WEAK_READERS[name]
    assert reader.LAYER == "engine.stages weak stages, engine.weak_rect"
    assert reader.read({"spans": {span: 6.0, "weak": 9.0}, "sweeps": 3}) \
        == 2.0
    assert reader.read({"spans": {"weak": 9.0}, "sweeps": 3}) is None
    assert reader.read({"spans": {span: 6.0}, "sweeps": 0}) is None


def test_syncs_reader(monkeypatch):
    reader = manifest.load_metric("host.syncs_per_sweep")
    monkeypatch.setattr(profiling, "SYNCS",
                        profiling.collections.Counter(a=3, b=5))
    assert reader.read({"sweeps": 2}) == 4.0
    assert reader.read({"sweeps": 0}) is None
    monkeypatch.setattr(profiling, "SYNCS", profiling.collections.Counter())
    assert reader.read({"sweeps": 2}) is None
    monkeypatch.delattr(profiling, "SYNCS")     # a program without the count
    assert reader.read({"sweeps": 2}) is None


@pytest.mark.gpu
def test_gpu_sync_count(syncs):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.ones((), device="cuda")
    torch.cuda.synchronize()
    cases = {"item": (lambda: x.item(), 1),
             "as_tensor": (lambda: torch.as_tensor(0.5, device="cuda"), 1),
             "synchronize": (lambda: torch.cuda.synchronize(), 1),
             "full": (lambda: torch.full((), 0.5, device="cuda"), 0)}
    mode = torch.cuda.get_sync_debug_mode()
    with profiling.attach(StageTimer("cuda")):
        for name, (op, want) in cases.items():
            for _ in range(2):
                syncs.clear()
                with profiling.span(name):
                    op()
                assert dict(syncs) == ({name: want} if want else {}), name
    assert torch.cuda.get_sync_debug_mode() == mode
