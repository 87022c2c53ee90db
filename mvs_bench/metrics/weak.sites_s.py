"""Seconds a sweep spends gathering the weak stage's sites
(``engine.weak_rect``): the anchors' state at the weak sites and, per row
band, the band's anchor profiles; the program's ``weak.sites`` spans of the
window, over its sweeps."""
LAYER = "engine.stages weak stages, engine.weak_rect"
MOVES = "mpix_per_s"
SPAN = "weak.sites"


def read(ctx):
    if not ctx["sweeps"] or SPAN not in ctx["spans"]:
        return None
    return ctx["spans"][SPAN] / ctx["sweeps"]
