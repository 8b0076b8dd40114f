"""Image-processing ops on (..., H, W) float32 tensors: central-difference
gradients, saliency, strict local maxima, separable Gaussian smoothing,
pyrDown and the level-strided disparity (counterpart of
``bpvo_tpu/ops/imgproc.py``)."""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def xgradient(I, scale=0.5):
    """Horizontal central difference times ``scale``, one-sided at the left
    and right borders (reference imgproc.h:216-240)."""
    g = torch.empty_like(I)
    g[..., :, 1:-1] = scale * (I[..., :, 2:] - I[..., :, :-2])
    g[..., :, 0] = scale * (I[..., :, 1] - I[..., :, 0])
    g[..., :, -1] = scale * (I[..., :, -1] - I[..., :, -2])
    return g


def ygradient(I, scale=0.5):
    """Vertical central difference times ``scale``, one-sided at the top and
    bottom borders (reference imgproc.h:242-265)."""
    g = torch.empty_like(I)
    g[..., 1:-1, :] = scale * (I[..., 2:, :] - I[..., :-2, :])
    g[..., 0, :] = scale * (I[..., 1, :] - I[..., 0, :])
    g[..., -1, :] = scale * (I[..., -1, :] - I[..., -2, :])
    return g


def gradient_absolute_magnitude(I):
    """Saliency: |I(x+1,y) - I(x-1,y)| + |I(x,y+1) - I(x,y-1)|, no 0.5
    factor, one-pixel border zeroed (reference imgproc.cc:33-142)."""
    Ix = torch.abs(I[..., 1:-1, 2:] - I[..., 1:-1, :-2])
    Iy = torch.abs(I[..., 2:, 1:-1] - I[..., :-2, 1:-1])
    return F.pad(Ix + Iy, (1, 1, 1, 1))


def gradient_absolute_magnitude_acc(channels):
    """Saliency accumulated over the channel axis (-3)."""
    return torch.sum(gradient_absolute_magnitude(channels), dim=-3)


def is_local_max(S, radius: int = 1):
    """Strict local-maximum mask within ``radius``: S[y,x] beats every
    neighbour of the (2r+1)^2 window; out-of-image neighbours never win.
    radius <= 0 returns all-True (NMS disabled)."""
    if radius <= 0:
        return torch.ones_like(S, dtype=torch.bool)
    H, W = S.shape[-2], S.shape[-1]
    P = F.pad(S, (radius, radius, radius, radius), value=float("-inf"))
    result = torch.ones_like(S, dtype=torch.bool)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            if dy == 0 and dx == 0:
                continue
            nb = P[..., radius + dy:radius + dy + H, radius + dx:radius + dx + W]
            result &= S > nb
    return result


def gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    """OpenCV-compatible 1D Gaussian kernel (cv2.getGaussianKernel
    semantics), float32."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _reflect_pad(I, ry: int, rx: int):
    """reflect-101 border padding (cv2 BORDER_REFLECT_101) of the trailing
    (H, W) axes."""
    lead = I.shape[:-2]
    x = I.reshape((-1, 1) + tuple(I.shape[-2:]))
    x = F.pad(x, (rx, rx, ry, ry), mode="reflect")
    return x.reshape(lead + tuple(x.shape[-2:]))


def _sep_conv2d(I, ky: np.ndarray, kx: np.ndarray):
    """Separable 2D correlation with reflect-101 borders on (..., H, W), as
    shifted slice-and-accumulate in the JAX package's order (rows first, taps
    summed left to right).  Elementwise ops only: no convolution routine, so
    no TF32 path on the card."""
    ry, rx = len(ky) // 2, len(kx) // 2
    Ip = _reflect_pad(I, ry, rx)
    H, W = I.shape[-2], I.shape[-1]
    rows = Ip[..., 0:H, :] * float(ky[0])
    for i in range(1, len(ky)):
        rows = rows + Ip[..., i:i + H, :] * float(ky[i])
    out = rows[..., :, 0:W] * float(kx[0])
    for j in range(1, len(kx)):
        out = out + rows[..., :, j:j + W] * float(kx[j])
    return out


def conv2d_same(I, k: np.ndarray):
    """2D correlation of (..., H, W) with the small kernel ``k`` and
    reflect-101 borders, as shifted slice-and-accumulate (taps in row-major
    order; zero taps skipped)."""
    ry, rx = k.shape[0] // 2, k.shape[1] // 2
    Ip = _reflect_pad(I, ry, rx)
    H, W = I.shape[-2], I.shape[-1]
    out = None
    for i in range(k.shape[0]):
        for j in range(k.shape[1]):
            if k[i, j] == 0:
                continue
            term = Ip[..., i:i + H, j:j + W] * float(k[i, j])
            out = term if out is None else out + term
    return out


def imsmooth(I, sigma: float, ksize: int = 0):
    """Gaussian smoothing (cv::GaussianBlur).  ``ksize=0`` derives the
    aperture from sigma like OpenCV: 2*ceil(3*sigma)+1, at least 3."""
    if sigma <= 0:
        return I
    if ksize <= 0:
        ksize = max(3, int(2 * np.ceil(3.0 * sigma) + 1))
    if ksize % 2 == 0:
        ksize += 1
    k = gaussian_kernel_1d(ksize, sigma)
    return _sep_conv2d(I, k, k)


_PYR_KERNEL = (1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16)


@functools.lru_cache(maxsize=None)
def _filter_decimate_matrix(n: int, device: str) -> torch.Tensor:
    """Banded (ceil(n/2), n) matrix: the 5-tap pyrDown filter with
    reflect-101 borders fused with 2x decimation.  Cached per size and
    device, and never evicted: a captured CUDA graph reads it at its
    address; callers never write to it."""
    m = -(-n // 2)
    M = np.zeros((m, n), np.float32)
    k = np.asarray(np.float32(_PYR_KERNEL), np.float64)
    for i in range(m):
        for j, kv in enumerate(k):
            idx = 2 * i + j - 2
            if idx < 0:
                idx = -idx
            if idx >= n:
                idx = 2 * (n - 1) - idx
            M[i, idx] += kv
    return torch.from_numpy(M).to(device)


def pyr_down(I):
    """Gaussian 5-tap blur + 2x decimation with ``cv::pyrDown`` semantics;
    output size ceil(dim/2).  Two plain matrix products, as in the JAX
    package."""
    H, W = I.shape[-2], I.shape[-1]
    dev = str(I.device)
    My = _filter_decimate_matrix(H, dev)
    Mx = _filter_decimate_matrix(W, dev)
    return (My @ I) @ Mx.T


def disparity_at_level(D, level: int):
    """Level-l disparity D[y << l, x << l], in full-resolution pixel units."""
    s = 1 << level
    return D if s == 1 else D[..., ::s, ::s]
