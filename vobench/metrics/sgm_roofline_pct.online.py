"""The SGM aggregation's share of its roofline over the traced frames: the
sum of each call's least time (``roofline.sgm_call``: the (H, W, D) cost
volume read once and the sum written once) over the device time of its
carry and tile passes (torch.profiler kernel events), in percent.  Not
reported where the trace's passes differ in number from the port's
settled ``launch_count`` (one carry and one tile pass a call)."""
from vobench import roofline


def read(ctx):
    if ctx.trace is None:
        return None
    carry = ctx.trace.named("sgm_carry_kernel")
    tile = ctx.trace.named("sgm_tile_kernel")
    calls = ctx.launches.get("sgm", 0)
    if (not calls or len(carry) != calls or len(tile) != calls
            or len(ctx.sgm_calls) != calls):
        ctx.log(f"sgm_roofline_pct: {len(carry)} carry and {len(tile)} tile "
                f"events, {calls} calls counted, {len(ctx.sgm_calls)} call "
                f"shapes: not reported")
        return None
    bound = sum(roofline.bound_s(*roofline.sgm_call(*s))[0]
                for s in ctx.sgm_calls)
    dur = sum(e["dur"] for e in carry + tile) * 1e-6
    return 100.0 * bound / dur
