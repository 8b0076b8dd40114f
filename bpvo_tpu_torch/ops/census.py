"""3x3 census transform and bit-plane extraction: the hand-written CUDA
kernel ``csrc/census.cu``, its wrapper and its plain PyTorch version
(counterpart of ``bpvo_tpu/ops/census.py`` and of
``bpvo_tpu/ops/pallas/census_kernel.py``).

Bit b of a pixel is ``neighbor_b >= center`` for the 8-neighborhood in
row-major order (reference census.cc:46-57); the one-pixel border is zero.

``census_planes`` takes the plain version for CPU tensors only.  For CUDA
tensors it launches the kernel or raises; it never falls back.
"""
from __future__ import annotations

import ctypes

import torch

# (dy, dx) offsets for bits 0..7 (reference census.cc:46-57)
NEIGHBOR_OFFSETS = (
    (-1, -1), (-1, 0), (-1, 1),
    (0, -1), (0, 1),
    (1, -1), (1, 0), (1, 1),
)

_BIT_WEIGHTS = (1, 2, 4, 8, 16, 32, 64, 128)

# kernel launches made by ``census_planes`` in this process (the plain
# version is not counted)
launch_count = 0


def census_planes_reference(I):
    """Plain PyTorch version: (..., H, W) -> (..., 8, H, W) float32 {0, 1}
    comparison planes with a zeroed one-pixel border."""
    I = I.to(torch.float32)
    H, W = I.shape[-2], I.shape[-1]
    planes = [torch.roll(I, (-dy, -dx), dims=(-2, -1)) >= I
              for dy, dx in NEIGHBOR_OFFSETS]
    out = torch.stack(planes, dim=-3).to(torch.float32)
    mask = torch.zeros(H, W, dtype=torch.float32, device=I.device)
    mask[1:-1, 1:-1] = 1.0
    return out * mask


def census_planes(I):
    """(..., H, W) float image -> (..., 8, H, W) float32 {0, 1} planes.

    CPU tensors take ``census_planes_reference``; a CUDA tensor launches
    ``csrc/census.cu`` once per (H, W) image."""
    global launch_count
    if I.device.type == "cpu":
        return census_planes_reference(I)
    if I.device.type != "cuda":
        raise ValueError(f"census_planes: unsupported device {I.device}")
    H, W = I.shape[-2], I.shape[-1]
    if not 1 <= H < 65536 or W < 1 or H * W >= 2 ** 31:
        raise ValueError(f"census_planes: unsupported shape {tuple(I.shape)}")
    from bpvo_tpu_torch.ops import _build
    lib = _build.library()
    lead = tuple(I.shape[:-2])
    src = I.to(torch.float32).contiguous().reshape(-1, H, W)
    out = torch.empty(src.shape[0], 8, H, W, dtype=torch.float32,
                      device=I.device)
    stream = torch.cuda.current_stream(I.device).cuda_stream
    ptr = ctypes.c_void_p
    for n in range(src.shape[0]):
        rc = lib.bpvo_census_planes(ptr(src[n].data_ptr()),
                                    ptr(out[n].data_ptr()), H, W, ptr(stream))
        _build.launch(lib, "census", rc)
        with _build.count_lock:
            launch_count += 1
    return out.reshape(lead + (8, H, W))


def census(I):
    """Packed 8-bit census (reference census.cc:59-91): (..., H, W) ->
    (..., H, W) uint8 with bit b set when neighbor b >= center."""
    planes = census_planes(I).to(torch.uint8)
    w = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8, device=planes.device)
    return torch.sum(planes * w[:, None, None], dim=-3, dtype=torch.uint8)


def extract_bitplanes(C):
    """Unpack a packed census image into 8 float {0, 1} channels (reference
    bitplanes_descriptor.cc:39-57)."""
    bits = torch.tensor(_BIT_WEIGHTS, dtype=C.dtype, device=C.device)
    return ((C[..., None, :, :] & bits[:, None, None]) > 0).to(torch.float32)
