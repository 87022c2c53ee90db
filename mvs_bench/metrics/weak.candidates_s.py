"""Seconds a sweep spends on the weak stage's candidates
(``engine.weak_rect``): the 8 anchor planes' deformable costs, view
selection, the geometric term and the pick; the program's
``weak.candidates`` spans of the window, over its sweeps."""
LAYER = "engine.stages weak stages, engine.weak_rect"
MOVES = "mpix_per_s"
SPAN = "weak.candidates"


def read(ctx):
    if not ctx["sweeps"] or SPAN not in ctx["spans"]:
        return None
    return ctx["spans"][SPAN] / ctx["sweeps"]
