"""SE(3) Lie-group math on torch tensors (counterpart of ``bpvo_tpu/core/se3.py``).

Branch-free closed forms with Taylor fallbacks near theta = 0, batched over
leading axes.  Twist ordering ``p = (w1, w2, w3, v1, v2, v3)``: rotation first,
matching the photometric Jacobian in ``vo/warp.py``.
"""
from __future__ import annotations

import math

import torch

_EPS = 1e-12


def hat(w):
    """3-vector -> skew-symmetric matrix, hat(w) @ x == cross(w, x)."""
    w1, w2, w3 = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(w1)
    return torch.stack([
        torch.stack([z, -w3, w2], dim=-1),
        torch.stack([w3, z, -w1], dim=-1),
        torch.stack([-w2, w1, z], dim=-1),
    ], dim=-2)


def _sinc_coeffs(t2):
    """A = sin(t)/t, B = (1-cos t)/t^2, C = (1-A)/t^2, Taylor when t^2 < 1e-8."""
    theta = torch.sqrt(torch.clamp(t2, min=_EPS))
    small = t2 < 1e-8
    A = torch.where(small, 1.0 - t2 / 6.0 + t2 * t2 / 120.0,
                    torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - t2 / 24.0 + t2 * t2 / 720.0,
                    (1.0 - torch.cos(theta)) / torch.clamp(t2, min=_EPS))
    C = torch.where(small, 1.0 / 6.0 - t2 / 120.0 + t2 * t2 / 5040.0,
                    (1.0 - A) / torch.clamp(t2, min=_EPS))
    return A, B, C


def _eye3_like(W):
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def exp(p):
    """Twist (..., 6) -> SE(3) matrix (..., 4, 4) via closed-form Rodrigues."""
    w, v = p[..., :3], p[..., 3:]
    A, B, C = _sinc_coeffs(torch.sum(w * w, dim=-1))
    W = hat(w)
    W2 = W @ W
    eye = _eye3_like(W)
    R = eye + A[..., None, None] * W + B[..., None, None] * W2
    V = eye + B[..., None, None] * W + C[..., None, None] * W2
    t = (V @ v[..., None])[..., 0]
    return _compose_rt(R, t)


def _compose_rt(R, t):
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3].fill_(1.0)   # a kernel: no host copy, so capturable
    return torch.cat([top, bottom], dim=-2)


def log(T):
    """SE(3) matrix (..., 4, 4) -> twist (..., 6)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    t2_small = 2.0 * (1.0 - cos_theta)
    small = t2_small < 1e-8
    theta = torch.arccos(torch.where(small, torch.zeros_like(cos_theta),
                                     cos_theta))
    t2 = torch.where(small, t2_small, theta * theta)
    k = torch.where(small, 0.5 + t2_small / 12.0,
                    theta / torch.clamp(2.0 * torch.sin(theta), min=_EPS))
    w = k[..., None] * torch.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], dim=-1)
    A, B, _ = _sinc_coeffs(t2)
    W = hat(w)
    W2 = W @ W
    coef = torch.where(small, 1.0 / 12.0 + t2 / 720.0,
                       (1.0 - A / torch.clamp(2.0 * B, min=_EPS))
                       / torch.clamp(t2, min=_EPS))
    Vinv = _eye3_like(W) - 0.5 * W + coef[..., None, None] * W2
    v = (Vinv @ t[..., None])[..., 0]
    return torch.cat([w, v], dim=-1)


def inverse(T):
    """Rigid-transform inverse without a general 4x4 solve."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    ti = -(Rt @ T[..., :3, 3:4])[..., 0]
    return _compose_rt(Rt, ti)


def rotation_to_euler_deg(T):
    """Rotation of (..., 4, 4) (or 3x3) -> (x, y, z) Euler angles in degrees,
    for the keyframing rotation-magnitude test (reference vo.cc:210-216,
    math_utils.h:204-260)."""
    R = torch.as_tensor(T)[..., :3, :3]
    sy = torch.sqrt(R[..., 0, 0] ** 2 + R[..., 1, 0] ** 2)
    x = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    y = torch.atan2(-R[..., 2, 0], torch.clamp(sy, min=_EPS))
    z = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return torch.stack([x, y, z], dim=-1) * (180.0 / math.pi)
