"""Synthetic KITTI-shape plane sequence (numpy + scipy), the port's copy of
``bpvo_tpu.data.synthetic.value_noise_texture`` and of
``bench.synthesize_sequence``, with the per-frame SE(3) step computed by the
port's ``se3``.

A slanted textured plane is rendered analytically (inverse plane homography
in float64) under a constant per-frame camera motion, with its exact
disparity, so the ground-truth motion of every frame is known.  The right
view of a stereo pair is rendered the same way from the right camera's pose
(``bpvo_tpu.data.synthetic.SyntheticPlaneDataset.right_image``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from bpvo_tpu_torch.core import se3

ROWS, COLS = 376, 1241          # KITTI sequence 00
STEP_TWIST = (0.0005, 0.001, 0.0008, 0.006, 0.002, 0.03)


@functools.lru_cache(maxsize=4)
def _noise_grid(seed: int) -> np.ndarray:
    from scipy.ndimage import gaussian_filter
    g = np.random.default_rng(seed).standard_normal(
        (2048, 2048)).astype(np.float32)
    g = gaussian_filter(g, 1.5, mode="wrap")
    g = (g / g.std()).astype(np.float32)
    g.setflags(write=False)
    return g


def value_noise_texture(x, y, seed: int = 7):
    """Non-periodic texture: two octaves of smoothed random noise (wrap
    period 2048 px), bilinearly sampled at arbitrary (x, y)."""
    g = _noise_grid(seed)
    n = g.shape[0]

    def samp(xs, ys):
        xi = np.floor(xs).astype(np.int64)
        yi = np.floor(ys).astype(np.int64)
        xf = (xs - xi).astype(np.float32)
        yf = (ys - yi).astype(np.float32)
        x0, x1 = xi % n, (xi + 1) % n
        y0, y1 = yi % n, (yi + 1) % n
        return ((1 - yf) * ((1 - xf) * g[y0, x0] + xf * g[y0, x1])
                + yf * ((1 - xf) * g[y1, x0] + xf * g[y1, x1]))

    return (128.0 + 55.0 * samp(x * 0.5, y * 0.5)
            + 35.0 * samp(x * 0.15 + 577.0, y * 0.15 + 231.0))


def step_pose() -> np.ndarray:
    """The sequence's per-frame motion X_{i+1} = step X_i, as float64 (4,4)."""
    return se3.exp(torch.tensor(STEP_TWIST, dtype=torch.float32)).to(
        torch.float64).numpy()


FX, BASELINE = 718.856, 0.537


def _scene(rows, cols):
    """Camera matrix (float64), plane normal and offset, pixel grid."""
    K = np.array([[FX, 0, cols / 2.0], [0, FX, rows / 2.0], [0, 0, 1]],
                 np.float64)
    n_pl = np.array([0.12, 0.22, 1.0])
    n_pl /= np.linalg.norm(n_pl)
    uu, vv = np.meshgrid(np.arange(cols, dtype=np.float64),
                         np.arange(rows, dtype=np.float64))
    return K, n_pl, 8.0 * n_pl[2], uu, vv


def _render(T, K, n_pl, d_pl, uu, vv):
    """The plane seen by a camera at warp pose T (X_cam = T X_0), rendered
    through the inverse plane homography."""
    R, t = T[:3, :3], T[:3, 3]
    Hinv = np.linalg.inv(K @ (R + np.outer(t, n_pl) / d_pl) @ np.linalg.inv(K))
    w = Hinv[2, 0] * uu + Hinv[2, 1] * vv + Hinv[2, 2]
    x0 = (Hinv[0, 0] * uu + Hinv[0, 1] * vv + Hinv[0, 2]) / w
    y0 = (Hinv[1, 0] * uu + Hinv[1, 1] * vv + Hinv[1, 2]) / w
    return value_noise_texture(x0, y0).astype(np.float32)


def synthesize_sequence(n_frames, rows=ROWS, cols=COLS):
    """Returns (K (3,3) float32, baseline, [(image, disparity)] * n_frames),
    each frame a float32 (rows, cols) pair."""
    K, n_pl, d_pl, uu, vv = _scene(rows, cols)
    step = step_pose()
    rays = np.stack([(uu - K[0, 2]) / K[0, 0], (vv - K[1, 2]) / K[1, 1],
                     np.ones_like(uu)], -1)
    frames = []
    T = np.eye(4)
    for _ in range(n_frames):
        image = _render(T, K, n_pl, d_pl, uu, vv)
        n1 = T[:3, :3] @ n_pl
        Z = (d_pl + n1 @ T[:3, 3]) / (rays @ n1)
        frames.append((image, (FX * BASELINE / Z).astype(np.float32)))
        T = step @ T
    return K.astype(np.float32), BASELINE, frames


def synthesize_stereo_sequence(n_frames, rows=ROWS, cols=COLS):
    """The same sequence as stereo pairs: returns (K, baseline,
    [(left, right, disparity)] * n_frames).  The right camera sits
    +baseline along x, so its pose is the left one with T[0, 3] -= baseline
    and it is rendered exactly like the left view (as
    ``SyntheticPlaneDataset.right_image``); the disparity is the exact one
    of the left view."""
    K, baseline, frames = synthesize_sequence(n_frames, rows, cols)
    K64, n_pl, d_pl, uu, vv = _scene(rows, cols)
    step = step_pose()
    out = []
    T = np.eye(4)
    for image, disp in frames:
        Tr = T.copy()
        Tr[0, 3] -= baseline
        out.append((image, _render(Tr, K64, n_pl, d_pl, uu, vv), disp))
        T = step @ T
    return K, baseline, out
