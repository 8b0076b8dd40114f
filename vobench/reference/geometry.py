"""SE(3) helpers of the reference: the exponential map on torch tensors
(closed-form Rodrigues) and, for judging poses, the inverse and the
logarithm in float64 numpy."""
from __future__ import annotations

import numpy as np
import torch


def hat(w):
    """(..., 3) -> (..., 3, 3) skew-symmetric matrices."""
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def exp(p):
    """Twist (6,) [omega, v] -> (4, 4) SE(3) matrix in the twist's dtype."""
    w, v = p[:3], p[3:]
    th2 = torch.sum(w * w)
    th = torch.sqrt(th2)
    small = th2 < 1e-10
    th_s = torch.where(small, torch.ones_like(th), th)
    A = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th_s) / th_s)
    B = torch.where(small, 0.5 - th2 / 24.0,
                    (1.0 - torch.cos(th_s)) / (th_s * th_s))
    C = torch.where(small, 1.0 / 6.0 - th2 / 120.0,
                    (th_s - torch.sin(th_s)) / (th_s * th_s * th_s))
    W = hat(w)
    W2 = W @ W
    eye = torch.eye(3, dtype=p.dtype, device=p.device)
    R = eye + A * W + B * W2
    V = eye + B * W + C * W2
    T = torch.eye(4, dtype=p.dtype, device=p.device)
    T[:3, :3] = R
    T[:3, 3] = V @ v
    return T


def inv_np(T) -> np.ndarray:
    """Inverse of a rigid (4, 4) transform, float64."""
    T = np.asarray(T, np.float64)
    out = np.eye(4)
    out[:3, :3] = T[:3, :3].T
    out[:3, 3] = -T[:3, :3].T @ T[:3, 3]
    return out


def log_np(T) -> np.ndarray:
    """SE(3) logarithm of a (4, 4) float64 matrix -> twist [omega, v]."""
    T = np.asarray(T, np.float64)
    R, t = T[:3, :3], T[:3, 3]
    c = np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    th = np.arccos(c)
    if th < 1e-8:
        w = 0.5 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                            R[1, 0] - R[0, 1]])
        return np.concatenate([w, t])
    w = th / (2.0 * np.sin(th)) * np.array(
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    W = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    Vinv = (np.eye(3) - 0.5 * W + (1.0 / th ** 2) * (
        1.0 - th * np.sin(th) / (2.0 * (1.0 - np.cos(th)))) * (W @ W))
    return np.concatenate([w, Vinv @ t])


def pose_gap(A, B) -> float:
    """|log(A B^-1)|: the twist norm (radians and metres together) by which
    two rigid motions differ."""
    return float(np.linalg.norm(log_np(np.asarray(A, np.float64)
                                       @ inv_np(B))))
