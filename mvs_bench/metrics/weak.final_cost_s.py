"""Seconds a sweep spends on the weak stage's final cost
(``engine.weak_rect``): the bands' outputs joined, the full-frame
strong-NCC cost of the proposal and its compaction; the program's
``weak.final_cost`` spans of the window, over its sweeps."""
LAYER = "engine.stages weak stages, engine.weak_rect"
MOVES = "mpix_per_s"
SPAN = "weak.final_cost"


def read(ctx):
    if not ctx["sweeps"] or SPAN not in ctx["spans"]:
        return None
    return ctx["spans"][SPAN] / ctx["sweeps"]
