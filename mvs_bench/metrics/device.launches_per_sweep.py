"""Kernel launches of the program in the traced window, over its sweeps
(the benchmark's own probes left out)."""
LAYER = "device"
MOVES = "mpix_per_s"


def read(ctx):
    trace = ctx["trace"]
    if trace is None or not ctx["sweeps"] or trace.launches <= 0:
        return None
    return trace.launches / ctx["sweeps"]
