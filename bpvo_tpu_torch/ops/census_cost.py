"""The census Hamming cost volume of a stereo pair: the hand-written CUDA
kernel ``csrc/census_cost.cu``, its wrapper and its plain PyTorch version
(counterpart of the cost in ``bpvo_tpu/data/stereo.py``, which XLA fuses:
the JAX package has no Pallas kernel here).

``out[y, x, d]`` is the Hamming distance between the packed census codes
(H, W) uint8 of the left image at column x and of the right image at
column x - d, and 8 where x < d (stereo.py:212-218): an integer 0..8 held
exactly in float32, with the disparity axis innermost, as ``ops.sgm``
reads it.

``census_cost_volume`` takes the plain version for CPU tensors only.  For
CUDA tensors it launches the kernel or raises; it never falls back.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

# popcount of every byte, for the Hamming distance of packed census codes
_POPCOUNT = np.array([bin(i).count("1") for i in range(256)], np.float32)

# the kernel stages D + 63 bytes of codes a block in shared memory, far
# under the 48 KB a block gets at this D
MAX_DISPARITIES = 16384

# kernel launches made by ``census_cost_volume`` in this process, one a
# call (the plain version is not counted)
launch_count = 0


@functools.lru_cache(maxsize=None)
def _popcount_table(device: str) -> torch.Tensor:
    """``_POPCOUNT`` on ``device``, copied there once: a copy from the host
    on every call could not be captured into a CUDA graph."""
    return torch.as_tensor(_POPCOUNT, device=device)


def census_cost_volume_reference(cL, cR, num_disparities: int):
    """Plain PyTorch version, on any device: built with D innermost in a
    fixed number of tensor ops for any D: one gather of the right codes at
    column x - d, XOR with the left codes, code 255 (popcount 8) where
    x < d, and one lookup in the popcount table."""
    W = cL.shape[1]
    src = (torch.arange(W, device=cL.device)[:, None]
           - torch.arange(num_disparities, device=cL.device))      # (W, D)
    codes = cR[:, src.clamp(min=0)] ^ cL[:, :, None]
    codes.masked_fill_(src < 0, 255)
    return _popcount_table(str(cL.device))[codes.int()]


def census_cost_volume(cL, cR, num_disparities: int):
    """(H, W) uint8 codes of the left and right images -> (H, W, D) float32
    Hamming cost volume.  CPU tensors take
    ``census_cost_volume_reference``; CUDA tensors launch
    ``csrc/census_cost.cu`` once, on the current stream, into a fresh
    ``torch.empty`` volume, with no synchronisation (so a CUDA graph can
    capture the call)."""
    global launch_count
    if cL.device.type == "cpu":
        return census_cost_volume_reference(cL, cR, num_disparities)
    if cL.device.type != "cuda":
        raise ValueError(f"census_cost_volume: unsupported device "
                         f"{cL.device}")
    from bpvo_tpu_torch.ops import _build
    if cL.dim() != 2:
        raise ValueError(f"census_cost_volume: codes must be (H, W), got "
                         f"{tuple(cL.shape)}")
    H, W = cL.shape
    D = int(num_disparities)
    _build.check_tensors("census_cost_volume", cL.device,
                         {"cL": (cL, (H, W), torch.uint8),
                          "cR": (cR, (H, W), torch.uint8)})
    if (not 1 <= H < 65536 or W < 1 or not 1 <= D <= MAX_DISPARITIES
            or H * W * D >= 2 ** 31):
        raise ValueError(f"census_cost_volume: unsupported shape "
                         f"{(H, W, D)}")
    lib = _build.library()
    out = torch.empty(H, W, D, dtype=torch.float32, device=cL.device)
    stream = torch.cuda.current_stream(cL.device).cuda_stream
    ptr = ctypes.c_void_p
    rc = lib.bpvo_census_cost(ptr(cL.data_ptr()), ptr(cR.data_ptr()),
                              ptr(out.data_ptr()), H, W, D, ptr(stream))
    _build.launch(lib, "census_cost", rc)
    with _build.count_lock:
        launch_count += 1
    return out
