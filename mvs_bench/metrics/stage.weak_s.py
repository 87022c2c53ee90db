"""Seconds a sweep spends in the weak-texture stages of
``engine.stages.run_sweep_staged`` (``engine.weak_rect``): the ``weakprep``
and ``weak`` spans of the window, over its sweeps."""
LAYER = "engine.stages weak stages, engine.weak_rect"
MOVES = "mpix_per_s"
SPANS = ("weakprep", "weak")


def read(ctx):
    spans = ctx["spans"]
    if not ctx["sweeps"] or not any(s in spans for s in SPANS):
        return None
    return sum(spans.get(s, 0.0) for s in SPANS) / ctx["sweeps"]
