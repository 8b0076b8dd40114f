"""Keyframe template store: selected points, per-channel pixel values and
analytic Jacobians, with photometric residual evaluation (counterpart of
``bpvo_tpu/vo/template_data.py``; reference template_data.cc:37-189).

Fixed capacity K per level with a valid mask; valid points sit at the front
in raster order.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from bpvo_tpu_torch.config import AlgorithmParameters
from bpvo_tpu_torch.ops import descriptors, interp, selection
from bpvo_tpu_torch.types import GradientEstimationType, InterpolationType
from bpvo_tpu_torch.vo import warp as warp_mod


class TemplateData(NamedTuple):
    """One pyramid level's keyframe template."""
    points: torch.Tensor      # (K, 3) back-projected points (padding: (0,0,1))
    pixels: torch.Tensor      # (C, K) descriptor values at selected pixels
    jacobians: torch.Tensor   # (C, K, 6) analytic Jacobians at identity
    valid: torch.Tensor       # (K,) bool selection mask
    num_valid: torch.Tensor   # () int64
    norm_scale: torch.Tensor  # () Hartley normalization scale s
    norm_center: torch.Tensor  # (3,) Hartley normalization center c
    rows: torch.Tensor        # (K,) int64 pixel y
    cols: torch.Tensor        # (K,) int64 pixel x

    @property
    def capacity(self) -> int:
        return self.points.shape[0]

    @property
    def num_channels(self) -> int:
        return self.pixels.shape[0]


def _gather_at(channels, rows, cols, dy=0, dx=0):
    """channels (C, H, W) -> (C, K) values at (rows+dy, cols+dx), clamped."""
    C, H, W = channels.shape
    y = torch.clamp(rows + dy, 0, H - 1)
    x = torch.clamp(cols + dx, 0, W - 1)
    return channels.reshape(C, H * W)[:, y * W + x]


def _channel_gradients(channels, rows, cols, method: GradientEstimationType):
    """CD3 = 0.5 (I[x+1] - I[x-1]); CD5 = (I[x-2] - 8 I[x-1] + 8 I[x+1]
    - I[x+2]) / 18 (reference template_data.cc:112-131)."""
    def at(dy, dx):
        return _gather_at(channels, rows, cols, dy, dx)

    if method == GradientEstimationType.CD3:
        gx = 0.5 * (at(0, 1) - at(0, -1))
        gy = 0.5 * (at(1, 0) - at(-1, 0))
    elif method == GradientEstimationType.CD5:
        nn = 1.0 / 18.0
        gx = nn * (at(0, -2) - 8.0 * at(0, -1) + 8.0 * at(0, 1) - at(0, 2))
        gy = nn * (at(-2, 0) - 8.0 * at(-1, 0) + 8.0 * at(1, 0) - at(2, 0))
    else:
        raise ValueError(f"unknown gradient estimation {method}")
    return gx, gy


def select_and_backproject(channels, disparity, cam: warp_mod.CameraModel,
                           p: AlgorithmParameters, capacity: int):
    """Stage 1 of the template build: pixel selection, back-projection and
    Hartley normalization (JAX bpvo_tpu/vo/template_data.py:80-128).  The
    sharded VO runs it on every rank and slices its output, so each rank
    keeps the single-device selection.  Returns (sel, points (K, 3),
    norm_scale, norm_center)."""
    C, H, W = channels.shape
    sel = selection.select_pixels(
        descriptors.saliency(channels), disparity, capacity,
        min_saliency=p.minSaliency, nms_radius=p.nonMaxSuppRadius,
        use_nms=H * W >= p.minNumPixelsForNonMaximaSuppression,
        min_disparity=p.minValidDisparity, max_disparity=p.maxValidDisparity,
        border=max(p.nonMaxSuppRadius, 3))
    d_safe = torch.where(sel.valid, sel.disparity, 1.0)
    xf, yf = sel.cols.to(torch.float32), sel.rows.to(torch.float32)
    if p.warpType == "DisparitySpace":
        # points (x-cx, y-cy, d), no normalization (reference
        # disparity_space_warp.h:86-89)
        points = warp_mod.disparity_space_make_points(cam, xf, yf, d_safe)
        s, c = warp_mod.identity_normalization(points.dtype, points.device)
    else:
        points = warp_mod.make_points(cam, xf, yf, d_safe)
        # padding slots get the finite dummy point (0, 0, 1): Z must stay
        # nonzero or 1/Z puts inf/NaN into the Jacobians that masking
        # cannot remove
        # (filled on the device: no host copy, so capturable)
        dummy = torch.zeros(3, dtype=points.dtype, device=points.device)
        dummy[2].fill_(1.0)
        points = torch.where(sel.valid[:, None], points, dummy)
        if p.withNormalization:
            s, c = warp_mod.hartley_normalization(points, sel.valid)
        else:
            s, c = warp_mod.identity_normalization(points.dtype,
                                                   points.device)
    return sel, points, s, c


def build_from_selection(channels, cam: warp_mod.CameraModel,
                         p: AlgorithmParameters, rows, cols, valid,
                         num_valid, points, s, c) -> TemplateData:
    """Stage 2 of the template build: per-point descriptor values, CD3/CD5
    gradients and Jacobians (JAX template_data.py:131-149).  The point-axis
    inputs may be one rank's slice of the selection."""
    pixels = _gather_at(channels, rows, cols)
    gx, gy = _channel_gradients(channels, rows, cols, p.gradientEstimation)
    J = (warp_mod.disparity_space_jacobian(cam, points, gx, gy)
         if p.warpType == "DisparitySpace"
         else warp_mod.jacobian(cam, points, gx, gy, s, c))   # (C, K, 6)
    pixels = torch.where(valid[None, :], pixels, 0.0)
    J = torch.where(valid[None, :, None], J, 0.0)
    return TemplateData(points=points, pixels=pixels, jacobians=J,
                        valid=valid, num_valid=num_valid, norm_scale=s,
                        norm_center=c, rows=rows, cols=cols)


def set_data(channels, disparity, cam: warp_mod.CameraModel,
             p: AlgorithmParameters, capacity: int, level: int) -> TemplateData:
    """Build a template from descriptor channels (C, H, W) and the
    level-strided disparity (H, W) (``imgproc.disparity_at_level``)."""
    sel, points, s, c = select_and_backproject(channels, disparity, cam, p,
                                               capacity)
    return build_from_selection(channels, cam, p, sel.rows, sel.cols,
                                sel.valid, sel.num_valid, points, s, c)


def compute_residuals(tdata: TemplateData, channels,
                      cam: warp_mod.CameraModel, T,
                      method: InterpolationType, warp: str = "RigidBody"):
    """r = I1(warp(x)) - I0(x) for all channels: project the K points by T
    (``warp`` "RigidBody" or "DisparitySpace"), mask out-of-view points,
    sample, subtract the template pixels.
    Returns (r (C, K), valid (K,)) with invalid entries zeroed."""
    _, H, W = channels.shape
    project = (warp_mod.disparity_space_project if warp == "DisparitySpace"
               else warp_mod.project)
    u, v, Z = project(cam, T, tdata.points)
    ok = tdata.valid & (Z > 1e-6) & interp.valid_mask(u, v, H, W, method)
    I1 = interp.sample(channels, u, v, ok, method)
    return (I1 - tdata.pixels) * ok[None, :], ok
