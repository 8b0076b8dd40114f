"""Sub-pixel sampling of descriptor channels at warped points (counterpart of
``bpvo_tpu/ops/interp.py``; reference photo_error.cc:267-459): LINEAR and
COSINE read a point's 2x2 footprint, CUBIC (Catmull-Rom, A = -0.5) and
CUBIC_HERMITE its 4x4 one, as flat gathers from the row-major image.
Points are clamped before the gather and zeroed by the valid mask; the
cubic border bound is the correct one where the reference reads one row
out of bounds."""
from __future__ import annotations

import math

import torch

from bpvo_tpu_torch.types import InterpolationType

_TWO_TAP = (InterpolationType.LINEAR, InterpolationType.COSINE)
_FOUR_TAP = (InterpolationType.CUBIC, InterpolationType.CUBIC_HERMITE)


def border_bounds(method: InterpolationType):
    """(lo, hi_x, hi_y): a point is valid iff lo <= floor(u) < W - hi_x and
    lo <= floor(v) < H - hi_y (reference photo_error.cc:348-349)."""
    if method in _TWO_TAP:
        return 0, 1, 1
    if method in _FOUR_TAP:
        return 1, 3, 3
    raise ValueError(f"unknown interpolation {method}")


def valid_mask(u, v, rows: int, cols: int, method: InterpolationType):
    """In-bounds test of the method's footprint."""
    xi = torch.floor(u)
    yi = torch.floor(v)
    lo, hi_x, hi_y = border_bounds(method)
    return (xi >= lo) & (xi < cols - hi_x) & (yi >= lo) & (yi < rows - hi_y)


def _coeffs_cubic(f):
    """Catmull-Rom-style cubic weights, A = -0.5 (photo_error.cc:267-280)."""
    A = -0.5
    c0 = ((A * (f + 1) - 5 * A) * (f + 1) + 8 * A) * (f + 1) - 4 * A
    c1 = ((A + 2) * f - (A + 3)) * f * f + 1
    c2 = ((A + 2) * (1 - f) - (A + 3)) * (1 - f) * (1 - f) + 1
    c3 = 1.0 - c0 - c1 - c2
    return c0, c1, c2, c3


def _hermite_1d(y0, y1, y2, y3, mu):
    """Cubic Hermite through 4 samples, bias 0 and tension 0
    (photo_error.cc:292-334)."""
    mu2 = mu * mu
    mu3 = mu2 * mu
    m0 = 0.5 * (y1 - y0) + 0.5 * (y2 - y1)
    m1 = 0.5 * (y2 - y1) + 0.5 * (y3 - y2)
    a0 = 2 * mu3 - 3 * mu2 + 1.0
    a1 = mu3 - 2 * mu2 + mu
    a2 = mu3 - mu2
    a3 = -2 * mu3 + 3 * mu2
    return a0 * y1 + a1 * m0 + a2 * m1 + a3 * y2


def sample(channels, u, v, valid, method=InterpolationType.LINEAR):
    """Sample (C, H, W) ``channels`` at the points (u, v), each (N,).
    Returns (C, N) float32 with zeros where ``valid`` is False."""
    C, H, W = channels.shape
    xi = torch.floor(u)
    yi = torch.floor(v)
    xf = u - xi
    yf = v - yi
    lo, hi_x, hi_y = border_bounds(method)
    # clamp in float (NaN -> 0) before the integer cast; masked points only
    xi = torch.nan_to_num(xi).clamp(lo, W - 1 - hi_x).long()
    yi = torch.nan_to_num(yi).clamp(lo, H - 1 - hi_y).long()
    flat = channels.reshape(C, H * W)

    def at(dy, dx):
        return flat[:, (yi + dy) * W + (xi + dx)]

    if method in _TWO_TAP:
        if method == InterpolationType.COSINE:
            xf = (1.0 - torch.cos(xf * math.pi)) * 0.5
            yf = (1.0 - torch.cos(yf * math.pi)) * 0.5
        row0 = (1.0 - xf) * at(0, 0) + xf * at(0, 1)
        row1 = (1.0 - xf) * at(1, 0) + xf * at(1, 1)
        out = (1.0 - yf) * row0 + yf * row1
    elif method == InterpolationType.CUBIC:
        cx = _coeffs_cubic(xf)
        cy = _coeffs_cubic(yf)
        out = None
        for j, dy in enumerate((-1, 0, 1, 2)):
            row = cx[0] * at(dy, -1)
            for i, dx in enumerate((0, 1, 2), start=1):
                row = row + cx[i] * at(dy, dx)
            out = cy[j] * row if out is None else out + cy[j] * row
    else:
        rows = [_hermite_1d(*(at(dy, dx) for dx in (-1, 0, 1, 2)), xf)
                for dy in (-1, 0, 1, 2)]
        out = _hermite_1d(*rows, yf)
    return torch.where(valid[None, :], out, 0.0)
