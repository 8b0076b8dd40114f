"""The level_gn kernel's share of its roofline over the traced frames: the
least time of all their level solves' bytes and operations together
(``roofline.level_gn`` summed over the solves, then ``roofline.bound_s``)
over the launches' device time (torch.profiler kernel events), in percent.

The solves' shapes come from the program's counters (``gn_solves``,
``gn_points``, ``gn_channel_points``, ``gn_iter_points``,
``gn_iter_channel_points``: sums of 1, K, C K, it K and it C K over the
solves), which is enough because ``roofline.level_gn`` is affine in K,
C K, it K and it C K: its coefficients are differences of it at unit
shapes.  The bound of the sum is at most the sum of each launch's bound
(``level_gn_roofline_pct.reprocess``), and equal to it where every launch
is bound by the same peak.  Not reported where the trace's level_gn
events, the counted solves and the port's settled ``launch_count`` for
the same slice differ in number (a program without the counters counts
no solves)."""
from vobench import program_spans, roofline

COUNTERS = ("gn_solves", "gn_points", "gn_channel_points", "gn_iter_points",
            "gn_iter_channel_points")


def summed(n, k, ck, itk, itck):
    """(bytes, operations) of ``n`` launches whose K, C K, it K and it C K
    sum to ``k``, ``ck``, ``itk`` and ``itck``: the sum of
    ``roofline.level_gn`` over them."""
    f = roofline.level_gn

    def diff(a, b):
        return tuple(x - y for x, y in zip(a, b))
    base = f(0, 0, 0)
    per_k = diff(f(0, 1, 0), base)
    per_ck = diff(f(1, 1, 0), f(0, 1, 0))
    per_itk = diff(f(0, 1, 1), f(0, 1, 0))
    per_itck = diff(diff(f(1, 1, 1), f(1, 1, 0)), per_itk)
    return tuple(n * a + k * b + ck * c + itk * d + itck * e
                 for a, b, c, d, e in zip(base, per_k, per_ck, per_itk,
                                          per_itck))


def read(ctx):
    from bpvo_tpu_torch.utils import profiling
    if ctx.trace is None:
        return None
    fs = program_spans.frames(ctx, profiling, "level_gn_roofline_pct")
    if fs is None:
        return None
    sums = [sum(f.counted(c) for f in fs) for c in COUNTERS]
    events = ctx.trace.named("level_gn_kernel")
    launched = ctx.launches.get("level_gn", 0)
    if not events or not len(events) == sums[0] == launched:
        ctx.log(f"level_gn_roofline_pct: {len(events)} trace events, "
                f"{sums[0]} solves counted, {launched} launches counted: "
                f"not reported")
        return None
    bound = roofline.bound_s(*summed(*sums))[0]
    return 100.0 * bound / (sum(e["dur"] for e in events) * 1e-6)
