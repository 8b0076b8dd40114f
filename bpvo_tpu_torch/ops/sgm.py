"""SGM scan-line cost aggregation: the hand-written CUDA kernel
``csrc/sgm.cu``, its wrappers and the plain PyTorch version (counterpart of
``bpvo_tpu/ops/pallas/sgm_kernel.py`` and of
``bpvo_tpu/data/stereo._aggregate_4dir_scan``).

On the card ``aggregate_4dir`` is two launches: a carry pass that scans
all four directions at once and keeps only the carry entering each tile,
then a tile pass that re-runs the directions across each tile from those
carries and writes the sum once.  ``aggregate_direction`` is the first
pass alone, storing every position.

The cost volume is (H, W, D) float32 with the disparity axis innermost.
``aggregate_direction`` and ``aggregate_4dir`` take the plain version for CPU
tensors only.  For CUDA tensors they launch the kernel or raise; they never
fall back.
"""
from __future__ import annotations

import ctypes

import torch

# kernel launch sets made by the wrappers in this process, one per call (the
# plain version is not counted)
launch_count = 0


def _aggregate_scan(cost_seq, p1: float, p2: float):
    """cost_seq (T, B, D): the recurrence along T for B parallel scan lines,
    one torch step per position (stereo.py:235-248)."""
    prev = cost_seq[0]
    out = [prev]
    for c in cost_seq[1:]:
        m = torch.amin(prev, dim=-1, keepdim=True)
        up = torch.cat([prev[:, :1] + p1, prev[:, :-1] + p1], dim=-1)
        dn = torch.cat([prev[:, 1:] + p1, prev[:, -1:] + p1], dim=-1)
        best = torch.minimum(torch.minimum(prev, up),
                             torch.minimum(dn, m + p2))
        prev = c + best - m
        out.append(prev)
    return torch.stack(out)


def aggregate_direction_reference(cost, p1: float, p2: float):
    """Plain version of ``aggregate_direction``: left to right along W."""
    return _aggregate_scan(cost.transpose(0, 1), p1, p2).transpose(0, 1)


def aggregate_4dir_reference(cost, p1: float, p2: float):
    """Plain version of ``aggregate_4dir``: left->right + right->left +
    top->bottom + bottom->top, summed in that order (stereo.py:250-258)."""
    c_lr = cost.transpose(0, 1)                              # (W, H, D)
    a = _aggregate_scan(c_lr, p1, p2)
    a = a + _aggregate_scan(c_lr.flip(0), p1, p2).flip(0)
    a = a.transpose(0, 1)                                    # (H, W, D)
    a = a + _aggregate_scan(cost, p1, p2)
    return a + _aggregate_scan(cost.flip(0), p1, p2).flip(0)


def pass_launches(cost, p1: float, p2: float, n_dirs: int = 4, lib=None):
    """``(out, {pass name: launch})`` for one aggregation of the CUDA tensor
    ``cost`` along ``n_dirs`` (1 or 4) directions: each launch enqueues its
    pass (in the dict's order) and returns the C entry point's CUDA status;
    ``out`` holds the result once all have run.  ``lib`` is the kernels'
    library by default, or a build of ``sgm.cu`` alone bound by
    ``_build.bind_sgm``."""
    from bpvo_tpu_torch.ops import _build
    lib = lib or _build.library()
    H, W, D = cost.shape
    out = torch.empty_like(cost)
    stream = ctypes.c_void_p(torch.cuda.current_stream(cost.device).cuda_stream)
    args = (H, W, D, float(p1), float(p2))
    ptr = ctypes.c_void_p
    if n_dirs == 1:    # the carry kernel storing every position
        return out, {"carry": lambda: lib.bpvo_sgm_carry_pass(
            ptr(cost.data_ptr()), ptr(out.data_ptr()), *args, 1, stream)}
    # the carries that enter each tile of the tile pass
    scratch = torch.empty(lib.bpvo_sgm_scratch_floats(H, W, D),
                          dtype=torch.float32, device=cost.device)
    return out, {
        "carry": lambda: lib.bpvo_sgm_carry_pass(
            ptr(cost.data_ptr()), ptr(scratch.data_ptr()), *args, 4, stream),
        "tile": lambda: lib.bpvo_sgm_tile_pass(
            ptr(cost.data_ptr()), ptr(scratch.data_ptr()),
            ptr(out.data_ptr()), *args, stream)}


def _launch(cost, p1: float, p2: float, n_dirs: int):
    global launch_count
    if cost.dim() != 3 or cost.dtype != torch.float32:
        raise ValueError(f"sgm: cost must be float32 (H, W, D), got "
                         f"{cost.dtype} {tuple(cost.shape)}")
    if not cost.is_contiguous():
        raise ValueError("sgm: cost must be contiguous")
    H, W, D = cost.shape
    if H < 1 or W < 1 or not 1 <= D <= 256 or cost.numel() >= 2 ** 40:
        raise ValueError(f"sgm: unsupported shape {tuple(cost.shape)}")
    from bpvo_tpu_torch.ops import _build
    out, launches = pass_launches(cost, p1, p2, n_dirs)
    for launch in launches.values():
        _build.launch(_build.library(), "sgm", launch())
    with _build.count_lock:
        launch_count += 1
    return out


def _check_device(cost):
    if cost.device.type not in ("cpu", "cuda"):
        raise ValueError(f"sgm: unsupported device {cost.device}")


def aggregate_direction(cost, p1: float, p2: float):
    """Aggregate a (H, W, D) cost volume left to right along W."""
    _check_device(cost)
    if cost.device.type == "cpu":
        return aggregate_direction_reference(cost, p1, p2)
    return _launch(cost, p1, p2, n_dirs=1)


def aggregate_4dir(cost, p1: float, p2: float):
    """Sum of the 4 directional aggregations of a (H, W, D) cost volume."""
    _check_device(cost)
    if cost.device.type == "cpu":
        return aggregate_4dir_reference(cost, p1, p2)
    return _launch(cost, p1, p2, n_dirs=4)
