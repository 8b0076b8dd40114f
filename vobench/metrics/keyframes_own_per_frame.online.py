"""The program's ``keyframes_own`` counter (keyframes made without a
candidate: the frame becomes the keyframe from its own disparity) over
the traced frames, a frame.  A program that counts no keyframes (no
``keyframes`` counter) gives nothing."""
from vobench import program_spans


def read(ctx):
    from bpvo_tpu_torch.utils import profiling
    fs = program_spans.frames(ctx, profiling, "keyframes_own_per_frame")
    if fs is None:
        return None
    if "keyframes" not in fs[-1].add.counts1:
        ctx.log("keyframes_own_per_frame: the program counts no keyframes: "
                "not reported")
        return None
    return sum(f.counted("keyframes_own") for f in fs) / len(fs)
