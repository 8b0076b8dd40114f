"""Median milliseconds of ``TpuSGM.run`` over the window's frames, between
CUDA events recorded on the stream before and after the call (which ends
in the disparity's copy to the host)."""
import statistics


def read(ctx):
    v = ctx.samples.get("matcher_ms")
    return statistics.median(v) if v else None
