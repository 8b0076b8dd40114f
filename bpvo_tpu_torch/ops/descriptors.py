"""Dense descriptors: image (H, W) -> channels (C, H, W) (counterpart of
``bpvo_tpu/ops/descriptors.py``; reference dense_descriptor.cc:38-100).

- Intensity            1 channel
- IntensityAndGradient 3: {I, 0.5 Ix, 0.5 Iy}
- Laplacian            1: cv::Laplacian
- DescriptorFields1    5: {I, Ix+, Ix-, Iy+, Iy-}, smoothed
- DescriptorFields2    10: first and second order pos/neg fields (the
                       intended Ixy, not the reference's reuse of the Ixx
                       buffer)
- BitPlanes            8 census-bit planes
- CentralDifference    (2r+1)^2-1: I(x) - I(x + offset), smoothed
- Latch                8 x latchNumBytes: box-filtered SSD comparisons of the
                       learned patch triplets (``ops/latch_table.py``)

Every stencil is shifted slice-and-accumulate (elementwise ops only, no
convolution routine and so no TF32 path on the card).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from bpvo_tpu_torch.config import AlgorithmParameters
from bpvo_tpu_torch.ops import census as census_ops
from bpvo_tpu_torch.ops import imgproc
from bpvo_tpu_torch.ops.latch_table import LATCH_TRIPLETS
from bpvo_tpu_torch.types import DescriptorType


def num_channels(t: DescriptorType, p: AlgorithmParameters) -> int:
    if t in (DescriptorType.INTENSITY, DescriptorType.LAPLACIAN):
        return 1
    if t == DescriptorType.INTENSITY_AND_GRADIENT:
        return 3
    if t == DescriptorType.DESCRIPTOR_FIELDS_FIRST_ORDER:
        return 5
    if t == DescriptorType.DESCRIPTOR_FIELDS_SECOND_ORDER:
        return 10
    if t == DescriptorType.BITPLANES:
        return 8
    if t == DescriptorType.CENTRAL_DIFFERENCE:
        return (2 * p.centralDifferenceRadius + 1) ** 2 - 1
    if t == DescriptorType.LATCH:
        return 8 * p.latchNumBytes
    raise ValueError(f"unknown descriptor type {t}")


def intensity(I):
    return I[None].to(torch.float32)


def intensity_and_gradient(I, sigma: float = 0.0):
    """{I, 0.5 Ix, 0.5 Iy}; smoothing (if any) applies to the gradient
    channels only (reference gradient_descriptor.cc:42-64)."""
    I = I.to(torch.float32)
    Is = imgproc.imsmooth(I, sigma) if sigma > 0 else I
    return torch.stack([I, imgproc.xgradient(Is), imgproc.ygradient(Is)])


def laplacian(I, kernel_size: int = 1):
    """cv::Laplacian: ksize 1 is the stencil [[0,1,0],[1,-4,1],[0,1,0]],
    larger ones d2/dx2 + d2/dy2 with Sobel-style smoothing."""
    if kernel_size <= 1:
        k = np.array([[0, 1, 0], [1, -4, 1], [0, 1, 0]], np.float32)
    else:
        k1 = np.array([1, -2, 1], np.float32)
        smooth = np.array([1, 2, 1], np.float32)
        k = np.outer(smooth, k1) + np.outer(k1, smooth)
    return imgproc.conv2d_same(I.to(torch.float32), k)[None]


def _split_pos_neg(G, sigma: float):
    """pos = max(G, 0), neg = min(G, 0), each optionally smoothed
    (reference gradient_descriptor.cc:80-99)."""
    pos = torch.clamp(G, min=0.0)
    neg = torch.clamp(G, max=0.0)
    if sigma > 0:
        pos = imgproc.imsmooth(pos, sigma)
        neg = imgproc.imsmooth(neg, sigma)
    return pos, neg


def _smoothed_gradients(I, sigma1: float):
    I = I.to(torch.float32)
    Is = imgproc.imsmooth(I, sigma1) if sigma1 > 0 else I
    return I, imgproc.xgradient(Is), imgproc.ygradient(Is)


def descriptor_fields_1(I, sigma1: float = 0.75, sigma2: float = 1.75):
    I, gx, gy = _smoothed_gradients(I, sigma1)
    return torch.stack([I, *_split_pos_neg(gx, sigma2),
                        *_split_pos_neg(gy, sigma2)])


def descriptor_fields_2(I, sigma1: float = 0.75, sigma2: float = 1.75):
    _, gx, gy = _smoothed_gradients(I, sigma1)
    chans = []
    for g in (gx, imgproc.xgradient(gx), imgproc.ygradient(gx), gy,
              imgproc.ygradient(gy)):
        chans.extend(_split_pos_neg(g, sigma2))
    return torch.stack(chans)


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


def shift_clamp(I, dy: int, dx: int):
    """I(y + dy, x + dx) with edge-replicated borders (no wrap-around)."""
    H, W = I.shape[-2], I.shape[-1]
    lead = I.shape[:-2]
    x = I.reshape((-1, 1, H, W))
    x = F.pad(x, (max(-dx, 0), max(dx, 0), max(-dy, 0), max(dy, 0)),
              mode="replicate")
    y0, x0 = max(dy, 0), max(dx, 0)
    return x[..., y0:y0 + H, x0:x0 + W].reshape(lead + (H, W))


def central_difference(I, radius: int = 3, sigma_before: float = 0.75,
                       sigma_after: float = 1.75):
    """I(x) - I(x + offset) for every offset of the (2r+1)^2 window but the
    centre, in raster order (central_difference_descriptor.cc:35-101)."""
    I = I.to(torch.float32)
    Is = imgproc.imsmooth(I, sigma_before) if sigma_before > 0 else I
    out = torch.stack([Is - shift_clamp(Is, dy, dx)
                       for dy in range(-radius, radius + 1)
                       for dx in range(-radius, radius + 1)
                       if dy or dx])
    return imgproc.imsmooth(out, sigma_after) if sigma_after > 0 else out


def _latch_triplets(n: int):
    """The first n learned triplets as (anchor, a, b) (y, x) offsets: table
    row (ax, ay, bx, by, cx, cy) has anchor B, bit = SSD(A,B) < SSD(C,B)."""
    t = LATCH_TRIPLETS[:n].astype(np.int32)
    return np.stack([t[:, [3, 2]], t[:, [1, 0]], t[:, [5, 4]]], axis=1)


def latch(I, num_bytes: int = 1, half_ssd_size: int = 1,
          sigma_pre: float = 2.0, sigma_post: float = 1.75):
    """Dense LATCH (reference latch_descriptor.cc): per triplet (anchor, a,
    b), bit = SSD(P_a, P_anchor) < SSD(P_b, P_anchor) over
    (2 half_ssd_size + 1)^2 patches, computed as box-filtered squared
    differences of edge-clamped shifts of the 3x3-blurred (sigma 2) image;
    each bit becomes 255 b - 128, Gaussian-smoothed (sigma 1.75)
    (latch_descriptor.cc:142, :1070-1082).  ``latchRotationInvariance`` has
    no effect on dense keypoints (all share one angle,
    latch_descriptor.cc:126-131) and is ignored, as in the JAX package."""
    I = I.to(torch.float32)
    if sigma_pre > 0:
        I = imgproc.imsmooth(I, sigma_pre, ksize=3)
    box = np.ones((2 * half_ssd_size + 1,), np.float32)

    def patch_ssd(off_a, off_b):
        d = (shift_clamp(I, int(off_a[0]), int(off_a[1]))
             - shift_clamp(I, int(off_b[0]), int(off_b[1])))
        return imgproc._sep_conv2d(d * d, box, box)

    chans = []
    for anchor, a, b in _latch_triplets(8 * num_bytes):
        bit = (255.0 * (patch_ssd(a, anchor) < patch_ssd(b, anchor)).to(
            torch.float32) - 128.0)
        chans.append(imgproc.imsmooth(bit, sigma_post)
                     if sigma_post > 0 else bit)
    return torch.stack(chans)


def compute(I, p: AlgorithmParameters):
    """Factory: image (H, W) -> descriptor channels (C, H, W)
    (reference dense_descriptor.cc:38-90 ``DenseDescriptor::Create``)."""
    t = p.descriptor
    if t == DescriptorType.INTENSITY:
        return intensity(I)
    if t == DescriptorType.INTENSITY_AND_GRADIENT:
        return intensity_and_gradient(I)
    if t == DescriptorType.LAPLACIAN:
        return laplacian(I, p.laplacianKernelSize)
    if t == DescriptorType.DESCRIPTOR_FIELDS_FIRST_ORDER:
        return descriptor_fields_1(I, p.dfSigma1, p.dfSigma2)
    if t == DescriptorType.DESCRIPTOR_FIELDS_SECOND_ORDER:
        return descriptor_fields_2(I, p.dfSigma1, p.dfSigma2)
    if t == DescriptorType.BITPLANES:
        return bitplanes(I, p.sigmaPriorToCensusTransform, p.sigmaBitPlanes)
    if t == DescriptorType.CENTRAL_DIFFERENCE:
        return central_difference(I, p.centralDifferenceRadius,
                                  p.centralDifferenceSigmaBefore,
                                  p.centralDifferenceSigmaAfter)
    if t == DescriptorType.LATCH:
        return latch(I, p.latchNumBytes, p.latchHalfSsdSize)
    raise ValueError(f"unknown descriptor type {t}")


def saliency(channels):
    """Default saliency: sum over channels of |gradient| magnitude
    (reference dense_descriptor.cc:92-100)."""
    return imgproc.gradient_absolute_magnitude_acc(channels)
