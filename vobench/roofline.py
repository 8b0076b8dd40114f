"""Operations and bytes of the kernels the cells time, from their shapes,
and the H100's published peaks: the least time a launch could take, to
which its measured time is held.

Bytes count each input byte read once and each output byte written once,
whatever a kernel reads again.  Operations count the f32 arithmetic the
algorithm needs.  The peaks, the per-element operation counts and the
bound's rule (the larger of bytes over bandwidth and operations over the
f32 rate) are copied from the repository's chip_smoke.py (``_bound``,
``PEAK_*``, ``OPS_*``), where they were set for the kernel table of
PERF.md; they are kept here so that no later change to the program moves
the yardstick.

A share is stated against the published peak; the card's power limit,
read by nvidia-smi, is printed beside it in every run.
"""
from __future__ import annotations

from typing import Tuple

# NVIDIA H100 SXM data sheet, dense, at the full 700 W: HBM3 bandwidth and
# the f32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12

# f32 operations per element (chip_smoke.py): a level_gn iteration
# projects each point (~20) and per point and channel samples, weighs and
# adds to H, g, f (~71); a sigma estimate runs the 16-step median
# bisection (~32 a point); SGM ~8 per cost per direction, 4 directions
OPS_LEVEL_POINT, OPS_LEVEL_CHANNEL, OPS_MEDIAN_POINT = 20, 71, 32
OPS_SGM_COST = 32
F32 = 4


def bound_s(nbytes: float, ops: float) -> Tuple[float, str]:
    """(least seconds for ``nbytes`` moved and ``ops`` f32 operations, and
    which of the two sets it: "bytes" or "operations")."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_F32_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def level_gn(C: int, K: int, iterations: int = 1) -> Tuple[int, int]:
    """(bytes, operations) of one level_gn launch over K template points
    of C channels that runs ``iterations`` GN iterations and estimates
    sigma at least once.

    Read once: points (K, 3) f32, valid (K,) u8, pixels (C, K) f32,
    Jacobians (C, K, 6) f32, the start pose (4, 4) f32, the Hartley scale
    and centre (4) f32, and the image where the points sample it: 4 taps a
    point and channel (bilinear).  Written once: the pose (4, 4), the
    stats (8), H (6, 6), g (6) and the weights (C, K)."""
    read = (K * 3 * F32 + K + C * K * F32 + C * K * 6 * F32 + 16 * F32
            + 4 * F32 + 4 * C * K * F32)
    written = (16 + 8 + 36 + 6) * F32 + C * K * F32
    ops = (iterations * K * (OPS_LEVEL_POINT + OPS_LEVEL_CHANNEL * C)
           + K * OPS_MEDIAN_POINT)
    return read + written, ops


def sgm_call(H: int, W: int, D: int) -> Tuple[int, int]:
    """(bytes, operations) of one 4-direction aggregation (the carry and
    tile passes together): the (H, W, D) f32 cost volume read once, the
    summed (H, W, D) f32 volume written once."""
    return 2 * H * W * D * F32, OPS_SGM_COST * H * W * D
