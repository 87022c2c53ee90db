"""The share of the traced window in which no operation of the program ran
on the card, in percent (the union of its kernel, copy and set intervals in
the profiler's trace)."""
LAYER = "device"
MOVES = "mpix_per_s"


def read(ctx):
    trace = ctx["trace"]
    if trace is None or trace.window_s <= 0.0 or trace.busy_s <= 0.0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
