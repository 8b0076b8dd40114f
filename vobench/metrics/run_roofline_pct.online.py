"""The ``gauss_newton.run`` route's share of its roofline over the traced
frames: the sum over its levels of the iterations times the least time of
one iteration at the level's (C, K) (``run_timer.run_iteration``, the
shapes from the configuration: ``run_timer.level_shape``), over the
timers' device time (``vobench/run_timer.py``), in percent."""
from vobench import roofline, run_timer


def read(ctx):
    got = run_timer.levels(ctx, "run_roofline_pct")
    if got is None:
        return None
    bound = sum(its * roofline.bound_s(*run_timer.run_iteration(
        *run_timer.level_shape(ctx.cell.config, level)))[0]
        for level, (its, _) in got.items())
    ns = sum(ns for _, ns in got.values())
    if not ns:
        ctx.log("run_roofline_pct: the run timers read no time: not "
                "reported")
        return None
    return 100.0 * bound / (ns * 1e-9)
