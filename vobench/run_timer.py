"""The ``gauss_newton.run`` route's own clock over the traced frames, for
the ``run_*`` readers of the online cells.

The port times each level's ``run`` solve with a ``utils.graphs.Timer``
named ``gn.run.L<level>``: a start and a stop node around each iteration,
since torch.profiler records a WHILE body's kernels once a replay, not
once an iteration.  Its nanoseconds and iterations reach the program's
counters ``gn.run.L<level>.ns`` and ``gn.run.L<level>.iterations`` only
when the launch counts are settled, which the harness does right before
and right after the traced slice (``program.settled_counts``) and never
again before the readers run.  So the slice's share is each counter now
less its value at the first traced frame's start.  ``PoseEstimator``
counts ``gn_run_iters`` (the iterations of its ``run`` solves, from its
read) at every estimate: a reading is given only where the timers'
iterations over the slice equal that counter over the traced frames, and
are more than none.  A program without the timers gives nothing.
``run_iteration`` is the least work of one iteration, for the share of
the route's roofline (with ``vobench/roofline.py``'s peaks and per-element
operation counts)."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from vobench import program_spans
from vobench.reference import vo as ref_vo
from vobench.roofline import F32, OPS_LEVEL_CHANNEL, OPS_LEVEL_POINT

PREFIX = "gn.run.L"


def levels(ctx, who: str) -> Optional[Dict[int, Tuple[int, int]]]:
    """{level: (iterations, ns)} of the traced frames' ``run`` solves, or
    None (logged, naming the metric ``who``)."""
    from bpvo_tpu_torch.utils import profiling
    fs = program_spans.frames(ctx, profiling, who)
    if fs is None:
        return None
    now, start = profiling.counts(), fs[0].sgm.counts0
    out = {}
    for name in now:
        if name.startswith(PREFIX) and name.endswith(".iterations"):
            level = int(name[len(PREFIX):-len(".iterations")])
            base = name[:-len(".iterations")]
            its = now[name] - start.get(name, 0)
            ns = now.get(base + ".ns", 0) - start.get(base + ".ns", 0)
            if its:
                out[level] = (its, ns)
    counted = sum(f.counted("gn_run_iters") for f in fs)
    timed = sum(it for it, _ in out.values())
    if not timed or timed != counted:
        ctx.log(f"{who}: the run timers counted {timed} iterations, the "
                f"estimates {counted}: not reported")
        return None
    return out


def level_shape(cfg, level: int) -> Tuple[int, int, int]:
    """(C, K, pixels) of ``level`` under the configuration: the
    descriptor's channels, the template capacity and the level's pixel
    count (each level ceil(n / 2) of the one below, as cv::pyrDown)."""
    p = ref_vo.Params.from_config(cfg["params"])
    rows, cols = cfg["camera"]["rows"], cfg["camera"]["cols"]
    for _ in range(level):
        rows, cols = -(-rows // 2), -(-cols // 2)
    C = 8 if p.descriptor == "BITPLANES" else 1
    return C, ref_vo.capacity(p, rows, cols, level), rows * cols


def run_iteration(C: int, K: int, pixels: int) -> Tuple[int, int]:
    """(bytes, operations) of one ``gauss_newton.run`` iteration over K
    template points of C channels on a level of ``pixels`` pixels a
    channel, for ``roofline.bound_s``: ``fused_linearize``'s bytes and
    operations as chip_smoke.py bounds its kernel-table rows 2 and 3, plus
    the reduction around it.

    Read once: the warped coordinates u, v (K,) f32 and their mask (K,) u8,
    pixels (C, K) f32, Jacobians (C, K, 6) f32, sigma f32, and the image
    where the points sample it: 4 taps a point and channel (bilinear), at
    most each of its pixels once.  Written once: channel 0's residuals (K,)
    f32, the weights (C, K) f32 and H, g, f (43 f32).  The reduction: H,
    g and f read back for the 6x6 solve and the pose (16 f32) written.
    Operations: the projection of each point and, per point and channel,
    the sample, weight and sums (``roofline.OPS_LEVEL_POINT`` and
    ``OPS_LEVEL_CHANNEL``: a level_gn iteration's, whose loop body is the
    same linearization)."""
    read = (2 * K * F32 + K + C * K * F32 + C * K * 6 * F32 + F32
            + C * min(4 * K, pixels) * F32)
    written = K * F32 + C * K * F32 + 43 * F32
    reduction = 43 * F32 + 16 * F32
    ops = K * (OPS_LEVEL_POINT + OPS_LEVEL_CHANNEL * C)
    return read + written + reduction, ops

