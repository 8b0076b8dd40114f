"""Rigid-body SE(3) warp: stereo back-projection, analytic photometric
Jacobians and Hartley normalization, and the disparity-space warp
(counterpart of ``bpvo_tpu/vo/warp.py``, where the Jacobians are derived;
reference rigid_body_warp.h, disparity_space_warp.{h,cc}).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from bpvo_tpu_torch.core import se3


class CameraModel(NamedTuple):
    """Pinhole intrinsics + stereo baseline for one pyramid level.  The values
    are Python floats holding float32-rounded numbers, so they enter tensor
    arithmetic as float32 scalars without a device copy."""
    fx: float
    fy: float
    cx: float
    cy: float
    baseline: float

    @classmethod
    def from_K(cls, K, baseline):
        K = np.array(K, dtype=np.float32)
        return cls(fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
                   cy=float(K[1, 2]), baseline=float(np.float32(baseline)))

    def K(self, device=None):
        return torch.tensor([[self.fx, 0.0, self.cx],
                             [0.0, self.fy, self.cy],
                             [0.0, 0.0, 1.0]], dtype=torch.float32,
                            device=device)

    def at_level(self, level: int) -> "CameraModel":
        """K scales by 0.5 per level while the baseline doubles, so that
        Z = fx*b/d stays metric with full-resolution disparities."""
        if level == 0:
            return self
        s = 1.0 / (1 << level)
        return CameraModel(fx=self.fx * s, fy=self.fy * s, cx=self.cx * s,
                           cy=self.cy * s, baseline=self.baseline * (1 << level))


def make_points(cam: CameraModel, x, y, d):
    """Stereo back-projection (x, y, d) -> (N, 3) points: Z = fx b / d."""
    Z = cam.fx * cam.baseline / d
    X = (x - cam.cx) * Z / cam.fx
    Y = (y - cam.cy) * Z / cam.fy
    return torch.stack([X, Y, Z], dim=-1)


def hartley_normalization(points, valid):
    """(s, c) with X' = s (X - c): zero mean and sqrt(3) mean norm over the
    valid points."""
    w = valid.to(points.dtype)
    n = torch.clamp(torch.sum(w), min=1.0)
    c = torch.sum(points * w[:, None], dim=0) / n
    m = torch.sum(torch.linalg.norm(points - c, dim=-1) * w) / n
    s = math.sqrt(3.0) / torch.clamp(m, min=1e-6)
    return s, c


def identity_normalization(dtype=torch.float32, device=None):
    return (torch.ones((), dtype=dtype, device=device),
            torch.zeros(3, dtype=dtype, device=device))


def normalization_matrix(s, c):
    """T_n = [sI | -sc; 0 1]."""
    s = torch.as_tensor(s, dtype=torch.float32)
    c = torch.as_tensor(c, dtype=torch.float32, device=s.device)
    T = torch.eye(4, dtype=torch.float32, device=s.device) * s
    T[3, 3].fill_(1.0)   # a kernel: no host copy, so capturable
    T[:3, 3] = -s * c
    return T


def params_to_pose(p, s, c):
    """Twist increment -> 4x4 pose: T_n^{-1} exp(p) T_n."""
    Tn = normalization_matrix(s, c)
    Tn_inv = normalization_matrix(1.0 / s, -s * c)   # [ (1/s) I | c ]
    return Tn_inv @ se3.exp(p) @ Tn


def project(cam: CameraModel, T, points):
    """Warp + pinhole projection of (N, 3) points by T (4, 4) -> (u, v, Z)."""
    Xw = points @ T[:3, :3].T + T[:3, 3]
    Z = Xw[:, 2]
    zi = 1.0 / Z
    u = cam.fx * Xw[:, 0] * zi + cam.cx
    v = cam.fy * Xw[:, 1] * zi + cam.cy
    return u, v, Z


def jacobian(cam: CameraModel, points, gx, gy, s, c):
    """Batched analytic 1x6 photometric Jacobian at the identity pose.

    ``points`` (N, 3); ``gx``/``gy`` (..., N) channel gradients at the template
    pixels.  Returns (..., N, 6) in twist order (w1 w2 w3 v1 v2 v3).
    """
    X, Y, Z = points[:, 0], points[:, 1], points[:, 2]
    zi = 1.0 / Z
    zi2 = zi * zi
    a = gx * cam.fx
    b = gy * cam.fy
    q = (a * X + b * Y) * zi2
    Xc, Yc, Zc = X - c[0], Y - c[1], Z - c[2]
    j_w1 = -q * Yc - b * Zc * zi
    j_w2 = q * Xc + a * Zc * zi
    j_w3 = (b * Xc - a * Yc) * zi
    inv_s = 1.0 / s
    j_v1 = a * zi * inv_s
    j_v2 = b * zi * inv_s
    j_v3 = -q * inv_s
    return torch.stack([j_w1, j_w2, j_w3, j_v1, j_v2, j_v3], dim=-1)


# ---------------------------------------------------------------------------
# the disparity-space warp (reference bpvo/disparity_space_warp.{h,cc})
# ---------------------------------------------------------------------------

def disparity_space_G(cam: CameraModel, device=None):
    """G maps the homogeneous 3D point to the centred disparity-space point
    q = (x-cx, y-cy, d, 1) up to scale (disparity_space_warp.cc:36-46); a
    rigid pose T acts on q as G T G^-1."""
    fx, fy, b = cam.fx, cam.fy, cam.baseline
    return torch.tensor([[fx, 0.0, 0.0, 0.0], [0.0, fy, 0.0, 0.0],
                         [0.0, 0.0, 0.0, fx * b], [0.0, 0.0, 1.0, 0.0]],
                        dtype=torch.float32, device=device)


def disparity_space_G_inv(cam: CameraModel, device=None):
    fx, fy, b = cam.fx, cam.fy, cam.baseline
    f32 = np.float32
    return torch.tensor([[float(f32(1) / f32(fx)), 0.0, 0.0, 0.0],
                         [0.0, float(f32(1) / f32(fy)), 0.0, 0.0],
                         [0.0, 0.0, 0.0, 1.0],
                         [0.0, 0.0, float(f32(1) / (f32(fx) * f32(b))), 0.0]],
                        dtype=torch.float32, device=device)


def disparity_space_make_points(cam: CameraModel, x, y, d):
    """Template points of the disparity-space warp: (x-cx, y-cy, d)."""
    return torch.stack([x - cam.cx, y - cam.cy, d], dim=-1)


def disparity_space_project(cam: CameraModel, T, points):
    """Warp disparity-space points (N, 3) by the rigid pose T and project:
    pw = (G T G^-1) (p, 1), (u, v) = pw[:2] / pw[3] + (cx, cy).  Returns
    (u, v, w), w = pw[3] > 0 iff the point is in front of the camera."""
    dev = points.device
    H = (disparity_space_G(cam, dev) @ T.to(torch.float32)
         @ disparity_space_G_inv(cam, dev))
    q = torch.cat([points, torch.ones_like(points[:, :1])], dim=-1)
    pw = q @ H.T
    wi = 1.0 / pw[:, 3]
    return pw[:, 0] * wi + cam.cx, pw[:, 1] * wi + cam.cy, pw[:, 3]


def disparity_space_jacobian(cam: CameraModel, points, gx, gy):
    """Batched 1x6 photometric Jacobian of the disparity-space warp at the
    identity, twist order (w1 w2 w3 v1 v2 v3): ``points`` (N, 3), ``gx``/
    ``gy`` (..., N) -> (..., N, 6)."""
    x, y, d = points[:, 0], points[:, 1], points[:, 2]
    fx, fy = cam.fx, cam.fy
    k = d / (fx * cam.baseline)
    t4 = gx * x + gy * y
    j_w1 = -gy * fy - t4 * y / fy
    j_w2 = gx * fx + t4 * x / fx
    j_w3 = gy * fy * x / fx - gx * fx * y / fy
    j_v1 = gx * fx * k
    j_v2 = gy * fy * k
    j_v3 = -t4 * k
    return torch.stack([j_w1, j_w2, j_w3, j_v1, j_v2, j_v3], dim=-1)


def disparity_space_warp_points(cam: CameraModel, T, xyd):
    """(x, y, d) points warped by the rigid pose T -> (x', y', d'):
    back-project, move, project."""
    x, y, d = xyd[:, 0], xyd[:, 1], xyd[:, 2]
    u, v, Z = project(cam, T, make_points(cam, x, y, d))
    return torch.stack([u, v, cam.fx * cam.baseline / Z], dim=-1)
