"""The benchmark's traffic source: a slanted plane with a non-periodic
value-noise texture, seen by the KITTI-00 camera under a constant motion,
rendered on the device from the seed (the geometry, texture formula and
per-frame twist of the port's synthetic plane scene, rewritten in torch).

The seed sets only the textures: each sequence's 2048x2048 noise grid is
drawn by a ``torch.Generator`` on the device from the seed and the
sequence's index, smoothed (Gaussian, sigma 1.5, wrap-around) and
normalized.  The motion and the geometry come from the configuration, so
every seed gives the same frames' sizes, disparities and keyframe rhythm.
A frame is rendered through the inverse plane homography in float64 and
stored as float32: the left image, the exact disparity, and with a stereo
rig the right image (the left camera moved by -baseline along x).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from vobench.reference import geometry

GRID = 2048
GRID_SIGMA = 1.5


class Camera(NamedTuple):
    rows: int
    cols: int
    fx: float
    baseline: float

    def K(self) -> np.ndarray:
        return np.array([[self.fx, 0, self.cols / 2.0],
                         [0, self.fx, self.rows / 2.0], [0, 0, 1]],
                        np.float64)


def camera_of(cfg: Dict) -> Camera:
    c = cfg["camera"]
    return Camera(int(c["rows"]), int(c["cols"]), float(c["fx"]),
                  float(c["baseline"]))


def sub_seed(seed: int, index: int) -> int:
    """A 63-bit generator seed for sequence ``index`` of ``seed``."""
    ss = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), int(index)])
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


def _gaussian_wrap(g, sigma: float):
    """scipy.ndimage.gaussian_filter(g, sigma, mode="wrap") (truncate 4)
    along both axes, in float64."""
    r = int(4.0 * sigma + 0.5)
    x = torch.arange(-r, r + 1, dtype=torch.float64, device=g.device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    k = (k / k.sum()).tolist()
    for dim in (0, 1):
        g = sum(torch.roll(g, shifts=-(j - r), dims=dim) * k[j]
                for j in range(2 * r + 1))
    return g


def noise_grid(seed: int, device) -> torch.Tensor:
    """The (GRID, GRID) float32 smoothed unit-variance noise of a seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    g = torch.randn((GRID, GRID), generator=gen, device=device,
                    dtype=torch.float32).to(torch.float64)
    g = _gaussian_wrap(g, GRID_SIGMA)
    return (g / g.std(unbiased=False)).to(torch.float32)


def texture(grid, x, y):
    """128 + 55 n(x/2, y/2) + 35 n(0.15 x + 577, 0.15 y + 231), n the
    bilinearly sampled, wrapped noise grid; float64 coordinates."""
    n = grid.shape[0]

    def samp(xs, ys):
        xi, yi = torch.floor(xs), torch.floor(ys)
        xf, yf = (xs - xi).to(torch.float32), (ys - yi).to(torch.float32)
        xi, yi = xi.long(), yi.long()
        x0, x1 = xi % n, (xi + 1) % n
        y0, y1 = yi % n, (yi + 1) % n
        g = grid
        return ((1 - yf) * ((1 - xf) * g[y0, x0] + xf * g[y0, x1])
                + yf * ((1 - xf) * g[y1, x0] + xf * g[y1, x1]))

    return (128.0 + 55.0 * samp(x * 0.5, y * 0.5)
            + 35.0 * samp(x * 0.15 + 577.0, y * 0.15 + 231.0))


def step_pose(twist) -> np.ndarray:
    """The per-frame motion X_{i+1} = step X_i: se3 exp of the float32
    twist [omega, v], as float64."""
    return geometry.exp(torch.tensor(twist, dtype=torch.float32)).to(
        torch.float64).numpy()


class Scene:
    """The plane (unit normal n, offset d: n . X = d in the first camera)
    and the camera's pixel grid on the device."""

    def __init__(self, cam: Camera, plane_normal, plane_depth: float,
                 device):
        self.cam = cam
        n = np.asarray(plane_normal, np.float64)
        self.n = n / np.linalg.norm(n)
        self.d = float(plane_depth) * self.n[2]
        self.K = cam.K()
        self.device = device
        vv, uu = torch.meshgrid(
            torch.arange(cam.rows, dtype=torch.float64, device=device),
            torch.arange(cam.cols, dtype=torch.float64, device=device),
            indexing="ij")
        self.uu, self.vv = uu, vv

    def _homography_inv(self, T) -> np.ndarray:
        R, t = T[:3, :3], T[:3, 3]
        return np.linalg.inv(self.K @ (R + np.outer(t, self.n) / self.d)
                             @ np.linalg.inv(self.K))

    def image(self, grid, T) -> torch.Tensor:
        """The plane seen by a camera at warp pose T (X_cam = T X_0)."""
        Hi = self._homography_inv(np.asarray(T, np.float64))
        uu, vv = self.uu, self.vv
        w = Hi[2, 0] * uu + Hi[2, 1] * vv + Hi[2, 2]
        x0 = (Hi[0, 0] * uu + Hi[0, 1] * vv + Hi[0, 2]) / w
        y0 = (Hi[1, 0] * uu + Hi[1, 1] * vv + Hi[1, 2]) / w
        return texture(grid, x0, y0).to(torch.float32)

    def disparity(self, T) -> torch.Tensor:
        """fx b / Z of the plane at every pixel of the camera at T."""
        T = np.asarray(T, np.float64)
        n1 = T[:3, :3] @ self.n
        d1 = self.d + float(n1 @ T[:3, 3])
        K = self.K
        ray_dot = (((self.uu - K[0, 2]) / K[0, 0]) * n1[0]
                   + ((self.vv - K[1, 2]) / K[1, 1]) * n1[1] + n1[2])
        Z = d1 / ray_dot
        return (self.cam.fx * self.cam.baseline / Z).to(torch.float32)


class Sequence(NamedTuple):
    images: torch.Tensor             # (F, H, W) float32, left
    disparities: torch.Tensor        # (F, H, W) float32, exact
    rights: Optional[torch.Tensor]   # (F, H, W) float32, or None


def poses(twist, n_frames: int) -> np.ndarray:
    step = step_pose(twist)
    out = np.empty((n_frames, 4, 4))
    T = np.eye(4)
    for i in range(n_frames):
        out[i] = T
        T = step @ T
    return out


def render_sequence(scene: Scene, grid, twist, n_frames: int,
                    stereo: bool) -> Sequence:
    Ts = poses(twist, n_frames)
    cam = scene.cam
    shape = (n_frames, cam.rows, cam.cols)
    dev = scene.device
    images = torch.empty(shape, dtype=torch.float32, device=dev)
    disps = torch.empty(shape, dtype=torch.float32, device=dev)
    rights = (torch.empty(shape, dtype=torch.float32, device=dev)
              if stereo else None)
    for i, T in enumerate(Ts):
        images[i] = scene.image(grid, T)
        disps[i] = scene.disparity(T)
        if stereo:
            Tr = T.copy()
            Tr[0, 3] -= cam.baseline
            rights[i] = scene.image(grid, Tr)
    return Sequence(images, disps, rights)
