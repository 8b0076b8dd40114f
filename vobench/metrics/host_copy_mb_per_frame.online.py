"""The program's ``h2d_bytes`` and ``d2h_bytes`` counters (bytes copied
from host memory to the card and read back) over the traced frames, in
MB (1e6 bytes) a frame."""
from vobench import program_spans


def read(ctx):
    from bpvo_tpu_torch.utils import profiling
    fs = program_spans.frames(ctx, profiling, "host_copy_mb_per_frame")
    if fs is None:
        return None
    return sum(f.counted("h2d_bytes") + f.counted("d2h_bytes")
               for f in fs) / len(fs) / 1e6
