"""Seconds a sweep spends in ``pipeline.schedule.process_problem``'s host
side: the ``load``, ``rectify``, ``src-depth rectify`` and ``writeback``
spans of the window, over its sweeps."""
LAYER = "pipeline.schedule.process_problem, host side"
MOVES = "mpix_per_s"
SPANS = ("load", "rectify", "src-depth rectify", "writeback")


def read(ctx):
    spans = ctx["spans"]
    if not ctx["sweeps"] or not any(s in spans for s in SPANS):
        return None
    return sum(spans.get(s, 0.0) for s in SPANS) / ctx["sweeps"]
