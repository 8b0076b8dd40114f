"""The level_gn kernel's share of its roofline over the traced sequence:
the sum of each launch's least time (``roofline.level_gn`` at the level
shape and GN iterations it ran at) over the sum of the launches' device
times (torch.profiler kernel events), in percent.  Not reported where the
trace's level_gn events differ in number from the port's settled
``launch_count`` for the same slice."""
from vobench import roofline


def read(ctx):
    if ctx.trace is None:
        return None
    events = ctx.trace.named("level_gn_kernel")
    shapes = ctx.level_gn_launches
    launched = ctx.launches.get("level_gn", 0)
    if not events or len(events) != launched or len(shapes) != launched:
        ctx.log(f"level_gn_roofline_pct: {len(events)} trace events, "
                f"{launched} launches counted, {len(shapes)} launch shapes: "
                f"not reported")
        return None
    bound = sum(roofline.bound_s(*roofline.level_gn(C, K, it))[0]
                for C, K, it in shapes)
    return 100.0 * bound / (sum(e["dur"] for e in events) * 1e-6)
