"""The program's ``device_reads`` counter (results brought to the host:
the disparity, each pose estimate, a keyframe's point cloud) over the
traced frames, a frame."""
from vobench import program_spans


def read(ctx):
    from bpvo_tpu_torch.utils import profiling
    fs = program_spans.frames(ctx, profiling, "device_reads_per_frame")
    if fs is None:
        return None
    return sum(f.counted("device_reads") for f in fs) / len(fs)
