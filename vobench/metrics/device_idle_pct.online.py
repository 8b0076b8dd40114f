"""The device's idle share of the window: 1 - (device busy time a frame)
x (the window's frames) / (the window's time), in percent.  The busy time
a frame is the union of kernel, memcpy and memset intervals in the traced
frames over their number; the frames and the time are the untraced
window's.  The traced frames' own wall time is not used: the profiler
slows the host's launches, which would read as idle."""


def read(ctx):
    t = ctx.trace
    if (t is None or t.lo is None or not ctx.traced_frames
            or not ctx.window_s):
        return None
    busy = t.busy_s / ctx.traced_frames * ctx.frames
    return 100.0 * (1.0 - busy / ctx.window_s)
