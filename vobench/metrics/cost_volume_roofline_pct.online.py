"""The census cost volume's share of its roofline over the traced frames:
the sum of each matcher call's least time (the (H, W, D) float32 volume
written once, the two (H, W) uint8 census code images read once) over the
device time of the ``census_cost_kernel`` events (torch.profiler kernel
events), in percent.  Not reported where the events, the port's settled
``census_cost`` launch count (one a call) and the traced calls' shapes
differ in number: a program that builds the volume without that kernel
reports nothing here.

The time is the kernel's own event time.  Up to an L2's worth of the
volume's writes (50 MB on an H100) is still on the chip when the event
ends and reaches DRAM while the next kernel (SGM's carry pass) runs, so
the share reads up to 1 / (1 - L2 / volume) times the kernel's true one,
x1.27 at 376x1241x128: 96% in the cells' traces against 86% back to back
on an H100 (x1.12).  At x1.12 a kernel past about 89% of its bound reads
over 100%, past 94% over 105%, with a byte count that is right."""
from vobench import roofline


def read(ctx):
    if ctx.trace is None:
        return None
    events = ctx.trace.named("census_cost_kernel")
    calls = ctx.launches.get("census_cost", 0)
    if not calls or len(events) != calls or len(ctx.sgm_calls) != calls:
        ctx.log(f"cost_volume_roofline_pct: {len(events)} kernel events, "
                f"{calls} launches counted, {len(ctx.sgm_calls)} call "
                f"shapes: not reported")
        return None
    bound = sum(roofline.bound_s(roofline.F32 * H * W * D + 2 * H * W, 0)[0]
                for H, W, D in ctx.sgm_calls)
    dur = sum(e["dur"] for e in events) * 1e-6
    return 100.0 * bound / dur
