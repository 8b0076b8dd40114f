"""Synthetic scenes (numpy + scipy): the port's copy of
``bpvo_tpu/data/synthetic.py`` (the five dataset classes, ``write_sequence``
and ``value_noise_texture``) and of ``bench.synthesize_sequence``, with
every SE(3) step computed by the port's ``se3``.

A slanted textured plane is rendered analytically (inverse plane homography
in float64) under a constant per-frame camera motion, with its exact
disparity, so the ground-truth motion of every frame is known.  The right
view of a stereo pair is rendered the same way from the right camera's pose
(``bpvo_tpu.data.synthetic.SyntheticPlaneDataset.right_image``).
"""
from __future__ import annotations

import functools
import os
from typing import Optional

import numpy as np
import torch

from bpvo_tpu_torch.config import ConfigFile
from bpvo_tpu_torch.core import se3
from bpvo_tpu_torch.data import imageio
from bpvo_tpu_torch.data.dataset import Dataset, DatasetFrame, StereoCalibration
from bpvo_tpu_torch.vo.device_vo import resolve_device

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


def _exp64(twist) -> np.ndarray:
    """``se3.exp`` of a float32 twist [omega, v], as a float64 (4, 4)."""
    return se3.exp(torch.tensor(twist, dtype=torch.float32)).to(
        torch.float64).numpy()


def step_pose() -> np.ndarray:
    """The sequence's per-frame motion X_{i+1} = step X_i, as float64 (4,4)."""
    return _exp64(STEP_TWIST)


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


class SyntheticPlaneDataset(Dataset):
    def __init__(self, rows: int = 240, cols: int = 320,
                 twist_per_frame=(0.0005, 0.001, 0.0008, 0.006, 0.002, 0.03),
                 n_frames: int = 100, fx: float = 0.0, baseline: float = 0.12,
                 z0: float = 8.0, texture: str = "sinusoid"):
        self._rows, self._cols = rows, cols
        fx = fx or 0.8 * cols
        self._K = np.array([[fx, 0, cols / 2.0], [0, fx, rows / 2.0],
                            [0, 0, 1]], np.float64)
        self._baseline = baseline
        self._n = n_frames
        n_pl = np.array([0.12, 0.22, 1.0])
        self._n_pl = n_pl / np.linalg.norm(n_pl)
        self._d_pl = z0 * self._n_pl[2]
        self._texture_kind = texture
        self._step = _exp64(twist_per_frame)
        uu, vv = np.meshgrid(np.arange(cols, dtype=np.float64),
                             np.arange(rows, dtype=np.float64))
        self._uu, self._vv = uu, vv
        K = self._K
        self._rays = np.stack([(uu - K[0, 2]) / K[0, 0],
                               (vv - K[1, 2]) / K[1, 1],
                               np.ones_like(uu)], -1)

    @classmethod
    def from_config(cls, cf: ConfigFile) -> "SyntheticPlaneDataset":
        return cls(rows=cf.get("SyntheticRows", 240, int),
                   cols=cf.get("SyntheticCols", 320, int),
                   n_frames=cf.get("SyntheticNumFrames", 100, int))

    def _texture(self, x, y):
        # "sinusoid" is the historical default (globally periodic — a known
        # aliasing hazard for direct trackers, kept for the parity diagnosis);
        # "noise" is the non-degenerate value-noise texture.
        if getattr(self, "_texture_kind", "sinusoid") == "noise":
            return value_noise_texture(x, y)
        return (128 + 60 * np.sin(x / 7.0) * np.cos(y / 9.0)
                + 40 * np.sin((x + 2 * y) / 13.0))

    def pose_at(self, i: int) -> np.ndarray:
        """Ground-truth warp pose of frame i wrt frame 0 (X_i = T X_0)."""
        return np.linalg.matrix_power(self._step, i)

    def gt_world_pose(self, i: int) -> np.ndarray:
        """Camera-to-world pose (trajectory convention: inverse of pose_at)."""
        return np.linalg.inv(self.pose_at(i))

    def get_frame(self, i: int) -> Optional[DatasetFrame]:
        if i >= self._n:
            return None
        T = self.pose_at(i)
        K, uu, vv = self._K, self._uu, self._vv
        R, t = T[:3, :3], T[:3, 3]
        Hm = K @ (R + np.outer(t, self._n_pl) / self._d_pl) @ np.linalg.inv(K)
        Hinv = np.linalg.inv(Hm)
        w = Hinv[2, 0] * uu + Hinv[2, 1] * vv + Hinv[2, 2]
        x0 = (Hinv[0, 0] * uu + Hinv[0, 1] * vv + Hinv[0, 2]) / w
        y0 = (Hinv[1, 0] * uu + Hinv[1, 1] * vv + Hinv[1, 2]) / w
        I = self._texture(x0, y0).astype(np.float32)
        n1 = R @ self._n_pl
        d1 = self._d_pl + n1 @ t
        Z = d1 / (self._rays @ n1)
        D = (self._K[0, 0] * self._baseline / Z).astype(np.float32)
        return DatasetFrame(image=I, disparity=D, filename=f"synthetic/{i:06d}")

    def right_image(self, i: int) -> Optional[np.ndarray]:
        """Right-camera view of frame i, rendered analytically.

        The right camera sits +baseline along x in the left frame, so a
        point X in left-camera coords is X - [b, 0, 0] in right-camera
        coords: T_right = Trans(-b) @ pose_at(i), and the plane homography
        machinery renders the view exactly like the left one (no
        resampling).  Together with ``get_frame`` this provides an exact
        stereo pair whose true disparity is the returned GT disparity —
        the fixture for StereoDataset-in-the-VO-loop tests (reference
        utils/dataset.cc:103-135 runs a matcher on such pairs per frame)."""
        if i >= self._n:
            return None
        T = self.pose_at(i).copy()
        T[0, 3] -= self._baseline
        K, uu, vv = self._K, self._uu, self._vv
        R, t = T[:3, :3], T[:3, 3]
        Hm = K @ (R + np.outer(t, self._n_pl) / self._d_pl) @ np.linalg.inv(K)
        Hinv = np.linalg.inv(Hm)
        w = Hinv[2, 0] * uu + Hinv[2, 1] * vv + Hinv[2, 2]
        x0 = (Hinv[0, 0] * uu + Hinv[0, 1] * vv + Hinv[0, 2]) / w
        y0 = (Hinv[1, 0] * uu + Hinv[1, 1] * vv + Hinv[1, 2]) / w
        return self._texture(x0, y0).astype(np.float32)

    @property
    def calibration(self) -> StereoCalibration:
        return StereoCalibration(K=self._K.astype(np.float32),
                                 baseline=self._baseline)

    @property
    def image_size(self):
        return (self._rows, self._cols)

    @property
    def name(self):
        return "synthetic-plane"


class SyntheticCorridorDataset(Dataset):
    """Non-planar textured scene (rectangular corridor: two walls + floor +
    ceiling + far wall) rendered exactly by per-pixel ray casting, observed
    under a rotation-heavy trajectory (forward motion + sinusoidal yaw/roll).

    Harder than :class:`SyntheticPlaneDataset` in exactly the ways the
    reference's real sequences are harder than a plane: multiple depth layers,
    depth discontinuities at the wall/floor seams, and dominant rotation.
    The corridor interior is convex, so taking the nearest positive plane
    intersection renders occlusion correctly.
    """

    def __init__(self, rows: int = 240, cols: int = 320, n_frames: int = 100,
                 fx: float = 0.0, baseline: float = 0.12,
                 half_width: float = 2.0, half_height: float = 1.5,
                 far_z: float = 30.0, speed: float = 0.05,
                 yaw_amp_deg: float = 0.8, roll_amp_deg: float = 0.25):
        self._rows, self._cols = rows, cols
        fx = fx or 0.8 * cols
        self._K = np.array([[fx, 0, cols / 2.0], [0, fx, rows / 2.0],
                            [0, 0, 1]], np.float64)
        self._baseline = baseline
        self._n = n_frames
        # planes in frame-0 camera coords as n . X = d with the camera inside
        # (x right, y down, z forward): left/right walls, floor, ceiling, far wall
        self._planes = [
            (np.array([1.0, 0.0, 0.0]), half_width),    # right wall  x = +w
            (np.array([-1.0, 0.0, 0.0]), half_width),   # left wall   x = -w
            (np.array([0.0, 1.0, 0.0]), half_height),   # floor       y = +h
            (np.array([0.0, -1.0, 0.0]), half_height),  # ceiling     y = -h
            (np.array([0.0, 0.0, 1.0]), far_z),         # far wall    z = far
        ]
        # per-plane in-plane texture axes (u_dir, v_dir)
        self._axes = [
            (np.array([0.0, 1.0, 0.0]), np.array([0.0, 0.0, 1.0])),
            (np.array([0.0, 1.0, 0.0]), np.array([0.0, 0.0, 1.0])),
            (np.array([1.0, 0.0, 0.0]), np.array([0.0, 0.0, 1.0])),
            (np.array([1.0, 0.0, 0.0]), np.array([0.0, 0.0, 1.0])),
            (np.array([1.0, 0.0, 0.0]), np.array([0.0, 1.0, 0.0])),
        ]
        # precompute the cumulative ground-truth poses T_i (X_i = T_i X_0)
        yaw_amp = np.deg2rad(yaw_amp_deg)
        roll_amp = np.deg2rad(roll_amp_deg)
        poses = [np.eye(4)]
        for k in range(n_frames):
            yaw = yaw_amp * np.sin(2 * np.pi * k / 40.0)
            roll = roll_amp * np.cos(2 * np.pi * k / 55.0)
            pitch = 0.3 * yaw_amp * np.sin(2 * np.pi * k / 27.0)
            # se3.exp convention is [omega(3), v(3)] — rotation first
            step = _exp64([pitch, yaw, roll, 0.002, 0.001, speed])
            poses.append(step @ poses[-1])
        self._poses = poses
        uu, vv = np.meshgrid(np.arange(cols, dtype=np.float64),
                             np.arange(rows, dtype=np.float64))
        K = self._K
        self._rays = np.stack([(uu - K[0, 2]) / K[0, 0],
                               (vv - K[1, 2]) / K[1, 1],
                               np.ones_like(uu)], -1)

    @classmethod
    def from_config(cls, cf: ConfigFile) -> "SyntheticCorridorDataset":
        return cls(rows=cf.get("SyntheticRows", 240, int),
                   cols=cf.get("SyntheticCols", 320, int),
                   n_frames=cf.get("SyntheticNumFrames", 100, int))

    @staticmethod
    def _texture(u, v, k):
        f1 = 5.0 + 1.7 * k
        f2 = 8.0 + 2.3 * k
        return (128 + 52 * np.sin(u * f1 + 0.7 * k) * np.cos(v * f2)
                + 36 * np.sin((u * 2.1 + v * 3.3) * (4.0 + k))
                + 18 * np.cos(u * 17.0 - v * 11.0 + k))

    def pose_at(self, i: int) -> np.ndarray:
        """Ground-truth warp pose of frame i wrt frame 0 (X_i = T X_0)."""
        return self._poses[i]

    def gt_world_pose(self, i: int) -> np.ndarray:
        return np.linalg.inv(self._poses[i])

    def get_frame(self, i: int) -> Optional[DatasetFrame]:
        if i >= self._n:
            return None
        T = self._poses[i]
        R, t = T[:3, :3], T[:3, 3]
        A, b = R.T, -R.T @ t            # X_0 = A X_i + b
        rays = self._rays
        Z_best = np.full(rays.shape[:2], np.inf)
        I = np.zeros(rays.shape[:2])
        for k, ((n0, d0), (ud, vd)) in enumerate(zip(self._planes, self._axes)):
            n_i = R @ n0                 # plane normal in frame-i coords
            d_i = d0 - n0 @ b
            denom = rays @ n_i
            with np.errstate(divide="ignore", invalid="ignore"):
                Z = d_i / denom
            Z = np.where(np.isfinite(Z), Z, -1.0)
            valid = (Z > 0.05) & (Z < Z_best)
            if not valid.any():
                continue
            X_i = rays * np.where(valid, Z, 1.0)[..., None]
            X_0 = X_i @ A.T + b
            tex = self._texture(X_0 @ ud, X_0 @ vd, k)
            I = np.where(valid, tex, I)
            Z_best = np.where(valid, Z, Z_best)
        Z_best = np.where(np.isfinite(Z_best), Z_best, 1e6)
        D = (self._K[0, 0] * self._baseline / Z_best).astype(np.float32)
        return DatasetFrame(image=I.astype(np.float32), disparity=D,
                            filename=f"corridor/{i:06d}")

    @property
    def calibration(self) -> StereoCalibration:
        return StereoCalibration(K=self._K.astype(np.float32),
                                 baseline=self._baseline)

    @property
    def image_size(self):
        return (self._rows, self._cols)

    @property
    def name(self):
        return "synthetic-corridor"


class SyntheticOccluderDataset(SyntheticPlaneDataset):
    """Plane scene plus an INDEPENDENTLY MOVING textured square occluder.

    The occluder is a fronto-parallel quad at ``z_occ`` (closer than the
    background plane) translating with its own velocity — so its pixels are
    both an occlusion boundary and a rigid-scene violation the M-estimator
    must reject (the robustness scenario VERDICT round-2 item 5 asks for;
    no reference analogue — halismai/bpvo is only ever run on real scenes
    where this occurs naturally).  Disparity is geometrically exact for the
    composited scene.
    """

    def __init__(self, rows: int = 240, cols: int = 320, n_frames: int = 100,
                 z_occ: float = 3.0, half_size: float = 0.55,
                 occ_vel=(-0.012, 0.004, 0.0), texture: str = "noise",
                 **kw):
        super().__init__(rows=rows, cols=cols, n_frames=n_frames,
                         texture=texture, **kw)
        self._z_occ = z_occ
        self._half = half_size
        self._occ_vel = np.asarray(occ_vel, np.float64)

    @classmethod
    def from_config(cls, cf: ConfigFile) -> "SyntheticOccluderDataset":
        return cls(rows=cf.get("SyntheticRows", 240, int),
                   cols=cf.get("SyntheticCols", 320, int),
                   n_frames=cf.get("SyntheticNumFrames", 100, int))

    def get_frame(self, i: int) -> Optional[DatasetFrame]:
        frame = super().get_frame(i)
        if frame is None:
            return None
        I = frame.image.copy()
        D = frame.disparity.copy()
        T = self.pose_at(i)
        R, t = T[:3, :3], T[:3, 3]
        # occluder quad in frame-0 coords: fronto-parallel plane z = z_occ,
        # center drifting with its own velocity
        center0 = np.array([0.35, -0.1, self._z_occ]) + i * self._occ_vel
        n_i = R @ np.array([0.0, 0.0, 1.0])
        d_i = self._z_occ - np.array([0.0, 0.0, 1.0]) @ (-R.T @ t)
        denom = self._rays @ n_i
        with np.errstate(divide="ignore", invalid="ignore"):
            Z = d_i / denom
        Z = np.where(np.isfinite(Z), Z, -1.0)
        X_i = self._rays * np.maximum(Z, 0.0)[..., None]
        X_0 = X_i @ R + (-R.T @ t)          # back to frame-0 coords
        du = X_0[..., 0] - center0[0]
        dv = X_0[..., 1] - center0[1]
        hit = ((Z > 0.05) & (np.abs(du) < self._half)
               & (np.abs(dv) < self._half))
        # its own texture, anchored to the OBJECT (moves with it)
        tex = value_noise_texture(du * 220.0 + 900.0, dv * 220.0 + 1400.0,
                                  seed=11)
        Zb = self._K[0, 0] * self._baseline / np.maximum(D, 1e-6)
        front = hit & (Z < Zb)
        I[front] = tex[front]
        D[front] = (self._K[0, 0] * self._baseline / Z)[front]
        return DatasetFrame(image=I.astype(np.float32),
                            disparity=D.astype(np.float32),
                            filename=f"occluder/{i:06d}")

    @property
    def name(self):
        return "synthetic-occluder"


class SyntheticIlluminationDataset(SyntheticPlaneDataset):
    """Plane scene under TIME-VARYING LOCAL ILLUMINATION: a moving soft
    shadow, a moving spotlight, and an oscillating vignette.  Geometry and
    motion are identical to the plain noise plane; only the photometry moves.

    This is the scenario Bit-Planes exists for (reference README.md:8-14, the
    arXiv:1602.00307 companion paper): the census transform compares each
    pixel only against its 3x3 neighbors (census.cc:59-91), so LOCALLY-smooth
    illumination fields cancel out of every comparison, while raw intensity's
    brightness-constancy assumption is violated outright.

    Two design findings baked in (measured during round 4):

    * GLOBAL gain/bias changes are nearly harmless to intensity VO — the
      auto-scaled M-estimator makes the weight profile scale-free, so a pure
      contrast change barely moves the photometric minimum.  The stressor
      must be SPATIALLY varying (shadow/spot/vignette), which couples into
      the geometric Jacobians.
    * Frequent keyframing (every ~4 frames) lets intensity re-anchor to the
      new illumination before much error accrues.  The discriminating
      experiment therefore also throttles keyframes (see run_parity's
      plane_illum profile: larger minTranslationMagToKeyFrame, no
      frac-of-good-points keyframes) so templates PERSIST across lighting
      change — the regime the Bit-Planes paper targets.  Measured at 60
      frames: intensity ATE 0.0003 m (no illumination) -> 0.057 m (under
      this illumination) while BitPlanes holds 0.007 -> 0.009 m.
    """

    def __init__(self, rows: int = 240, cols: int = 320, n_frames: int = 100,
                 texture: str = "noise", shadow_amp: float = 0.65,
                 shadow_sigma: float = 70.0, spot_amp: float = 0.8,
                 spot_sigma: float = 60.0, vignette_amp: float = 0.25,
                 vignette_osc: float = 0.2, vignette_period: float = 11.0,
                 **kw):
        super().__init__(rows=rows, cols=cols, n_frames=n_frames,
                         texture=texture, **kw)
        self._sha, self._shs = shadow_amp, shadow_sigma
        self._spa, self._sps = spot_amp, spot_sigma
        self._va, self._vo, self._vp = (vignette_amp, vignette_osc,
                                        vignette_period)

    @classmethod
    def from_config(cls, cf: ConfigFile) -> "SyntheticIlluminationDataset":
        return cls(rows=cf.get("SyntheticRows", 240, int),
                   cols=cf.get("SyntheticCols", 320, int),
                   n_frames=cf.get("SyntheticNumFrames", 100, int))

    def get_frame(self, i: int) -> Optional[DatasetFrame]:
        frame = super().get_frame(i)
        if frame is None:
            return None
        I = frame.image
        uu, vv = self._uu, self._vv
        W, H = self._cols, self._rows
        # shadow and spotlight sweep along incommensurate paths
        c1u = (0.10 + 0.85 * ((i * 0.045) % 1.0)) * W
        c1v = (0.15 + 0.75 * ((i * 0.062) % 1.0)) * H
        c2u = (0.90 - 0.85 * ((i * 0.053) % 1.0)) * W
        c2v = (0.80 - 0.70 * ((i * 0.041) % 1.0)) * H
        shadow = 1.0 - self._sha * np.exp(
            -((uu - c1u) ** 2 + (vv - c1v) ** 2) / (2.0 * self._shs ** 2))
        spot = 1.0 + self._spa * np.exp(
            -((uu - c2u) ** 2 + (vv - c2v) ** 2) / (2.0 * self._sps ** 2))
        r2 = (((uu - W / 2) ** 2 + (vv - H / 2) ** 2)
              / ((W / 2) ** 2 + (H / 2) ** 2))
        vig = 1.0 - (self._va
                     + self._vo * np.sin(2 * np.pi * i / self._vp)) * r2
        I2 = shadow * spot * vig * I
        return DatasetFrame(image=np.clip(I2, 0, 255).astype(np.float32),
                            disparity=frame.disparity,
                            filename=f"illum/{i:06d}")

    @property
    def name(self):
        return "synthetic-illumination"


class SyntheticStereoPlaneDataset(SyntheticPlaneDataset):
    """Plane scene delivered as STEREO PAIRS run through a real matcher —
    the synthetic analogue of the reference's StereoDataset operational mode
    (utils/dataset.cc:103-135: imread left/right -> stereo_alg->run -> VO),
    with exact GT disparity available for matcher-error diagnostics.

    The returned frame's disparity comes from the configured
    ``StereoAlgorithm`` (not GT), so any consumer exercises the full
    stereo -> template -> VO chain."""

    def __init__(self, *args, stereo_algorithm=None, device="cuda", **kw):
        kw.setdefault("texture", "noise")
        super().__init__(*args, **kw)
        if stereo_algorithm is None:
            from bpvo_tpu_torch.data.stereo import TpuBlockMatching
            stereo_algorithm = TpuBlockMatching(num_disparities=48,
                                                sad_window=9)
        self._stereo = stereo_algorithm
        self._device = resolve_device(device)

    @classmethod
    def from_config(cls, cf: ConfigFile, device="cuda"
                    ) -> "SyntheticStereoPlaneDataset":
        from bpvo_tpu_torch.data.stereo import create_stereo_algorithm
        return cls(rows=cf.get("SyntheticRows", 240, int),
                   cols=cf.get("SyntheticCols", 320, int),
                   n_frames=cf.get("SyntheticNumFrames", 100, int),
                   baseline=cf.get("SyntheticBaseline", 0.5, float),
                   stereo_algorithm=create_stereo_algorithm(cf),
                   device=device)

    def gt_disparity(self, i: int) -> Optional[np.ndarray]:
        return super().get_frame(i).disparity if i < self._n else None

    def get_frame(self, i: int) -> Optional[DatasetFrame]:
        frame = super().get_frame(i)
        if frame is None:
            return None
        R = self.right_image(i)
        D = self._stereo.run(frame.image, R, device=self._device)
        return DatasetFrame(image=frame.image, disparity=D,
                            filename=f"synthetic_stereo/{i:06d}")

    @property
    def name(self):
        return "synthetic-stereo-plane"


read_pfm = imageio.read_pfm
write_pfm = imageio.write_pfm


def write_sequence(dataset: Dataset, out_dir: str,
                   n_frames: Optional[int] = None) -> int:
    """Write a synthetic dataset to disk for head-to-head runs
    (synthetic.py:505-534): ``left/%06d.png`` (8-bit grey, so both packages
    read byte-identical pixels), ``disp/%06d.pfm`` (float32, lossless),
    ``calib.txt`` (fx fy cx cy baseline) and ``gt_kitti.txt`` (ground-truth
    camera-to-world 3x4 rows, KITTI devkit format)."""
    os.makedirs(os.path.join(out_dir, "left"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "disp"), exist_ok=True)
    count = 0
    gt_rows = []
    for i in range(n_frames if n_frames is not None else 10 ** 9):
        frame = dataset.get_frame(i)
        if frame is None:
            break
        img = np.clip(np.round(frame.image), 0, 255).astype(np.uint8)
        imageio.imwrite(os.path.join(out_dir, "left", f"{i:06d}.png"), img)
        write_pfm(os.path.join(out_dir, "disp", f"{i:06d}.pfm"),
                  frame.disparity)
        gt = dataset.gt_world_pose(i)
        gt_rows.append(" ".join(f"{v:.9g}" for v in gt[:3].reshape(-1)))
        count += 1
    K, b = dataset.calibration.K, dataset.calibration.baseline
    with open(os.path.join(out_dir, "calib.txt"), "w") as f:
        f.write(f"{K[0, 0]} {K[1, 1]} {K[0, 2]} {K[1, 2]} {b}\n")
    with open(os.path.join(out_dir, "gt_kitti.txt"), "w") as f:
        f.write("\n".join(gt_rows) + "\n")
    return count
