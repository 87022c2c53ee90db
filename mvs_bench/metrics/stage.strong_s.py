"""Seconds a sweep spends in the strong propagation of
``engine.stages.run_sweep_staged`` (``engine.strong_rect``,
``engine.rectcost``): the ``strong`` spans of the window, over its
sweeps."""
LAYER = "engine.stages strong stage, engine.strong_rect, engine.rectcost"
MOVES = "mpix_per_s"


def read(ctx):
    if not ctx["sweeps"] or "strong" not in ctx["spans"]:
        return None
    return ctx["spans"]["strong"] / ctx["sweeps"]
