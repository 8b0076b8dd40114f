"""Median host milliseconds of ``VisualOdometry.add_frame`` over the
window's frames (host clock; the call ends in its own read of the pose)."""
import statistics


def read(ctx):
    v = ctx.samples.get("add_frame_ms")
    return statistics.median(v) if v else None
