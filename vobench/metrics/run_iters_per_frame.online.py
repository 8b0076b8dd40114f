"""The ``gauss_newton.run`` route's iterations a traced frame, all levels:
the timers' iterations (``vobench/run_timer.py``), which equal the
iterations the estimates read."""
from vobench import run_timer


def read(ctx):
    got = run_timer.levels(ctx, "run_iters_per_frame")
    if got is None:
        return None
    return sum(it for it, _ in got.values()) / ctx.traced_frames
