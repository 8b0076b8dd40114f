"""Dense descriptors: image (H, W) -> channels (C, H, W) (counterpart of
``bpvo_tpu/ops/descriptors.py``).  The intensity and Bit-Planes descriptors
are ported; the other six types come with the descriptor-zoo slice."""
from __future__ import annotations

import torch

from bpvo_tpu_torch.config import AlgorithmParameters
from bpvo_tpu_torch.ops import census as census_ops
from bpvo_tpu_torch.ops import imgproc
from bpvo_tpu_torch.types import DescriptorType


def num_channels(t: DescriptorType, p: AlgorithmParameters) -> int:
    if t == DescriptorType.INTENSITY:
        return 1
    if t == DescriptorType.BITPLANES:
        return 8
    raise NotImplementedError(f"descriptor {t.value} is not ported yet")


def intensity(I):
    return I[None].to(torch.float32)


def bitplanes(I, sigma_ct: float = -1.0, sigma_bp: float = 0.5):
    """8-channel Bit-Planes descriptor (bitplanes_descriptor.cc:37-91): an
    optional 3x3 Gaussian blur before the census transform (sigma_ct), the
    8 comparison planes as {0, 1} channels, each optionally smoothed with a
    5x5 Gaussian (sigma_bp)."""
    I = I.to(torch.float32)
    if sigma_ct > 0:
        I = imgproc.imsmooth(I, sigma_ct, ksize=3)
    planes = census_ops.census_planes(I)
    if sigma_bp > 0:
        planes = imgproc.imsmooth(planes, sigma_bp, ksize=5)
    return planes


def compute(I, p: AlgorithmParameters):
    """Factory: image (H, W) -> descriptor channels (C, H, W)."""
    if p.descriptor == DescriptorType.INTENSITY:
        return intensity(I)
    if p.descriptor == DescriptorType.BITPLANES:
        return bitplanes(I, p.sigmaPriorToCensusTransform, p.sigmaBitPlanes)
    raise NotImplementedError(
        f"descriptor {p.descriptor.value} is not ported yet: it comes with "
        f"the descriptor-zoo slice")


def saliency(channels):
    """Default saliency: sum over channels of |gradient| magnitude."""
    return imgproc.gradient_absolute_magnitude_acc(channels)
