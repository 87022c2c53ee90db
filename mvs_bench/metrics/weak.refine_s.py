"""Seconds a sweep spends in the weak stage's refinement
(``engine.weak_rect``): the current plane's cost, the fit-plane trial and
the 5 perturbation trials; the program's ``weak.refine`` spans of the
window, over its sweeps."""
LAYER = "engine.stages weak stages, engine.weak_rect"
MOVES = "mpix_per_s"
SPAN = "weak.refine"


def read(ctx):
    if not ctx["sweeps"] or SPAN not in ctx["spans"]:
        return None
    return ctx["spans"][SPAN] / ctx["sweeps"]
