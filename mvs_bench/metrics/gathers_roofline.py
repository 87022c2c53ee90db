"""The five hand-written kernels' share of their roofline, in percent: the
sum of every launch's bound (``mvs_bench/roofline.py``, from the launch's
shapes and the image elements its indices touch) over the sum of their
device time in the window's trace, by kernel name."""
LAYER = "ops.rowgather, ops.gather2d kernels (csrc/*.cu)"
MOVES = "mpix_per_s"


def read(ctx):
    trace, bound = ctx["trace"], ctx["kernel_bound_s"]
    if trace is None or bound is None:
        return None
    device_s = sum(trace.kernel_s.values())
    if device_s <= 0.0:
        return None
    return 100.0 * bound / device_s
