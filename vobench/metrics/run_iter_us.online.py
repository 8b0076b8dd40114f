"""Microseconds of device time a ``gauss_newton.run`` iteration at the
finest level (L0) over the traced frames: the L0 timer's nanoseconds over
its iterations (``vobench/run_timer.py``), each iteration from its start
node to its stop node on the device's clock."""
from vobench import run_timer


def read(ctx):
    got = run_timer.levels(ctx, "run_iter_us")
    if got is None or 0 not in got:
        return None
    its, ns = got[0]
    return ns / its / 1e3
