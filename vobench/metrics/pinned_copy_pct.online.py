"""The share of the host copies' bytes over the traced frames that moved
by DMA from or into page-locked host memory: 100 x (``h2d_pinned_bytes``
+ ``d2h_pinned_bytes``) / (``h2d_bytes`` + ``d2h_bytes``), in %.  A
program that counts no pinned bytes (the counters are newer than the
spans) reads 0."""
from vobench import program_spans


def read(ctx):
    from bpvo_tpu_torch.utils import profiling
    fs = program_spans.frames(ctx, profiling, "pinned_copy_pct")
    if fs is None:
        return None
    pinned = sum(f.counted("h2d_pinned_bytes") + f.counted("d2h_pinned_bytes")
                 for f in fs)
    total = sum(f.counted("h2d_bytes") + f.counted("d2h_bytes") for f in fs)
    return 100.0 * pinned / total
