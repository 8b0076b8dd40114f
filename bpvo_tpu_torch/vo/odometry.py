"""VisualOdometry: the public frame-to-frame API (counterpart of
``bpvo_tpu/vo/odometry.py``; reference vo.{h,cc}, vo_frame.{h,cc}).

``VisualOdometry(K, baseline, image_size, params, device)`` then
``add_frame(image, disparity) -> Result``.  The descriptor pyramids,
templates and level solves run on ``device``; the keyframe bookkeeping, the
trajectory and the Result live on the host, with one read of the device per
pose estimate.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from bpvo_tpu_torch.config import AlgorithmParameters
from bpvo_tpu_torch.ops import pyramid, selection
from bpvo_tpu_torch.types import KeyFramingReason, Result
from bpvo_tpu_torch.vo import device_vo
from bpvo_tpu_torch.vo import warp as warp_mod
from bpvo_tpu_torch.vo.point_cloud import PointCloud
from bpvo_tpu_torch.vo.pose_estimator import PoseEstimator
from bpvo_tpu_torch.vo.trajectory import Trajectory


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


class _Frame:
    """One frame's descriptor pyramid, plus its templates once it is the
    keyframe (reference VisualOdometryFrame)."""

    def __init__(self):
        self.clear()

    def set_data(self, image, disparity, n_levels: int,
                 p: AlgorithmParameters, device):
        self.image = image
        self.disparity = torch.as_tensor(disparity, dtype=torch.float32).to(
            device)
        self.templates = None
        self.channels = device_vo._compute_channels_pyr(
            torch.as_tensor(image, dtype=torch.float32).to(device), p,
            n_levels)

    @property
    def has_template(self) -> bool:
        return self.templates is not None

    def set_template(self, cams, p: AlgorithmParameters, capacities):
        self.templates = device_vo._build_templates(
            self.channels, self.disparity, cams, p, capacities)

    def clear(self):
        self.channels = ()
        self.templates = None
        self.disparity = None
        self.image = None

    @property
    def empty(self) -> bool:
        return not self.channels


class VisualOdometry:
    """``VisualOdometry(K, baseline, image_size, params, device)`` then
    ``add_frame(image, disparity) -> Result`` (reference vo.h:31-105)."""

    def __init__(self, K, baseline: float, image_size,
                 params: Optional[AlgorithmParameters] = None, device="cuda"):
        p = params or AlgorithmParameters()
        rows, cols = image_size
        if p.numPyramidLevels <= 0:
            p = p.replace(
                numPyramidLevels=p.num_pyramid_levels_for(rows, cols))
        self._p = p
        self._rows, self._cols = rows, cols
        self.device = device_vo.resolve_device(device)
        base_cam = warp_mod.CameraModel.from_K(K, baseline)
        self._cams = tuple(base_cam.at_level(l)
                           for l in range(p.numPyramidLevels))
        shapes = pyramid.level_shapes(rows, cols, p.numPyramidLevels)
        self._capacities = tuple(
            selection.capacity_for_level(p, r, c, l)
            for l, (r, c) in enumerate(shapes))
        self._pose_estimator = PoseEstimator(p)
        self._trajectory = Trajectory()
        self._T_kf = np.eye(4, dtype=np.float32)
        self._ref, self._cur, self._prev = _Frame(), _Frame(), _Frame()
        self._ba_window = None   # enable_bundle_adjustment()

    @property
    def params(self) -> AlgorithmParameters:
        return self._p

    @property
    def trajectory(self) -> Trajectory:
        return self._trajectory

    def num_points_at_level(self, level: int = -1) -> int:
        if level < 0:
            level = self._p.maxTestLevel
        if not self._ref.has_template:
            return 0
        return int(self._ref.templates[level].num_valid)

    def enable_bundle_adjustment(self, window_size: int = 8, group=None,
                                 ba_options=None):
        """Refine the last ``window_size`` keyframe poses by windowed
        photometric BA after every new keyframe
        (``parallel/bundle_adjustment.py``; JAX odometry.py:141-152).
        ``group``: a ``parallel.collectives.Reducer`` to split the points
        over its ranks (each rank runs this VisualOdometry on the same
        frames), or None.  On CUDA each optimize is one replay of the
        window size's BA graph (with no reducer or a one-rank nccl group)
        and one
        read of the refined poses."""
        from bpvo_tpu_torch.parallel.bundle_adjustment import (BAOptions,
                                                               KeyframeWindow)
        self._ba_window = KeyframeWindow(
            window_size, self._cams[self._p.maxTestLevel],
            ba_options or BAOptions(), reducer=group, device=self.device)

    def refined_keyframe_poses(self) -> np.ndarray:
        """(N_kf, 4, 4) camera-to-world poses of the keyframes in the BA
        window, after the latest optimization."""
        if self._ba_window is None or len(self._ba_window) == 0:
            return np.zeros((0, 4, 4))
        return np.stack([np.linalg.inv(T) for T in self._ba_window._poses])

    def _ba_on_keyframe(self, T_world: np.ndarray):
        """Push the keyframe (its template and channels at maxTestLevel,
        its camera-from-world pose) and optimize the window (JAX
        odometry.py:202-211)."""
        if self._ba_window is None or not self._ref.has_template:
            return
        lvl = self._p.maxTestLevel
        self._ba_window.push(self._ref.templates[lvl],
                             self._ref.channels[lvl],
                             np.linalg.inv(T_world).astype(np.float32))
        if len(self._ba_window) >= 2:
            self._ba_window.optimize()

    def save(self, path: str) -> None:
        """Checkpoint the state in the JAX package's format
        (bpvo_tpu/vo/odometry.py:162-181): the keyframe's and the
        candidate's raw image and disparity, ``T_kf`` and the trajectory;
        templates are a function of those and ``load`` rebuilds them."""
        payload = {
            "T_kf": self._T_kf,
            "trajectory": (np.stack(self._trajectory.poses)
                           if len(self._trajectory) else np.zeros((0, 4, 4))),
        }
        if self._ref.image is not None:
            payload["ref_image"] = _numpy(self._ref.image)
            payload["ref_disparity"] = _numpy(self._ref.disparity)
        if not self._prev.empty and self._prev.image is not None:
            payload["prev_image"] = _numpy(self._prev.image)
            payload["prev_disparity"] = _numpy(self._prev.disparity)
        np.savez_compressed(path, **payload)

    def load(self, path: str) -> None:
        """Restore a state ``save`` of either package wrote (same camera,
        parameters and image size) (bpvo_tpu/vo/odometry.py:183-200)."""
        if not path.endswith(".npz"):
            path = path + ".npz"
        p = self._p
        with np.load(path) as data:
            self._T_kf = data["T_kf"].astype(np.float32)
            self._trajectory = Trajectory()
            for T in data["trajectory"]:
                self._trajectory.poses.append(T)
            if "ref_image" in data.files:
                self._ref = _Frame()
                self._ref.set_data(data["ref_image"], data["ref_disparity"],
                                   p.numPyramidLevels, p, self.device)
                self._ref.set_template(self._cams, p, self._capacities)
            if "prev_image" in data.files:
                self._prev = _Frame()
                self._prev.set_data(data["prev_image"],
                                    data["prev_disparity"],
                                    p.numPyramidLevels, p, self.device)

    def _estimate(self, T_init, **kw):
        return self._pose_estimator.estimate(
            self._ref.templates, self._cur.channels, self._cams,
            torch.as_tensor(T_init, dtype=torch.float32).to(self.device), **kw)

    def add_frame(self, image, disparity) -> Result:
        """Estimate the motion of ``image`` wrt the current keyframe
        (reference vo.cc:125-197).  ``image`` and ``disparity`` are (rows,
        cols) arrays or tensors."""
        p = self._p
        if tuple(image.shape) != (self._rows, self._cols):
            raise ValueError(f"image size {tuple(image.shape)} != "
                             f"{(self._rows, self._cols)}")
        self._cur.set_data(image, disparity, p.numPyramidLevels, p,
                           self.device)

        if not self._ref.has_template:
            # first frame (vo.cc:133-139)
            self._ref, self._cur = self._cur, self._ref
            self._ref.set_template(self._cams, p, self._capacities)
            self._trajectory.push(self._T_kf)
            return Result(pose=np.eye(4), covariance=np.eye(6),
                          is_keyframe=True,
                          keyframing_reason=KeyFramingReason.FIRST_FRAME,
                          optimizer_statistics=[])

        T_est, stats = self._estimate(self._T_kf,
                                      multistart_px=p.coarseInitOffsetPx)
        reason = self._should_keyframe(T_est)
        is_kf = reason != KeyFramingReason.NO_KEYFRAMING

        point_cloud = None
        used_candidate = False
        if not is_kf:
            # keep cur as a future keyframe candidate (vo.cc:148-153)
            self._prev, self._cur = self._cur, self._prev
            pose = T_est @ np.linalg.inv(self._T_kf)
            self._T_kf = T_est
        else:
            point_cloud = self._extract_point_cloud()
            if self._prev.empty:
                # no candidate: the current frame becomes the keyframe
                # (vo.cc:166-177)
                self._ref, self._cur = self._cur, self._ref
                self._ref.set_template(self._cams, p, self._capacities)
                pose = T_est @ np.linalg.inv(self._T_kf)
                self._T_kf = np.eye(4, dtype=np.float32)
            else:
                # the candidate becomes the keyframe and the pose is
                # re-estimated against it (vo.cc:178-188), from
                # keyframeReestimateStartLevel, warm-started by the measured
                # candidate->current motion behind the cost gate
                used_candidate = True
                self._prev, self._ref = self._ref, self._prev
                self._prev.clear()
                self._ref.set_template(self._cams, p, self._capacities)
                if p.keyframeReestimateStartLevel >= 0:
                    start2 = min(max(p.keyframeReestimateStartLevel,
                                     p.maxTestLevel),
                                 len(self._cur.channels) - 1)
                    alt = torch.as_tensor(
                        (T_est @ np.linalg.inv(self._T_kf)).astype(np.float32)
                    ).to(self.device)
                else:
                    start2, alt = -1, None
                T_est, stats = self._estimate(np.eye(4, dtype=np.float32),
                                              start_level=start2,
                                              alt_init=alt)
                pose = T_est
                self._T_kf = T_est

        self._trajectory.push(pose)
        if point_cloud is not None:
            point_cloud.pose = self._trajectory.back()
        if is_kf and self._ba_window is not None:
            # the new keyframe's world pose: this frame's, or the
            # candidate's (one step back) when the candidate became it
            idx = len(self._trajectory) - (2 if used_candidate else 1)
            self._ba_on_keyframe(self._trajectory[max(idx, 0)])
        return Result(pose=np.asarray(pose),
                      covariance=self._pose_estimator.last_covariance(),
                      is_keyframe=is_kf, keyframing_reason=reason,
                      optimizer_statistics=stats, point_cloud=point_cloud)

    def _should_keyframe(self, T_est: np.ndarray) -> KeyFramingReason:
        """(reference vo.cc:199-224), with the Euler magnitude in degrees
        as the reference documents it (types.h:313-320)."""
        p = self._p
        t_sq = float(np.sum(T_est[:3, 3] ** 2))
        if t_sq > p.minTranslationMagToKeyFrame ** 2:
            return KeyFramingReason.LARGE_TRANSLATION
        R = T_est[:3, :3]
        sy = np.sqrt(R[0, 0] ** 2 + R[1, 0] ** 2)
        euler = np.array([np.arctan2(R[2, 1], R[2, 2]),
                          np.arctan2(-R[2, 0], max(sy, 1e-12)),
                          np.arctan2(R[1, 0], R[0, 0])])
        if p.rotationKeyframeInDegrees:
            euler = np.degrees(euler)
        if float(np.sum(euler ** 2)) > p.minRotationMagToKeyFrame ** 2:
            return KeyFramingReason.LARGE_ROTATION
        frac = self._pose_estimator.fraction_of_good_points(
            p.goodPointThreshold)
        if frac < p.maxFractionOfGoodPointsToKeyFrame:
            return KeyFramingReason.SMALL_FRAC_OF_GOOD_POINTS
        return KeyFramingReason.NO_KEYFRAMING

    def _extract_point_cloud(self) -> Optional[PointCloud]:
        """(reference vo.cc:260-281): the keyframe's template points at
        maxTestLevel, grey-coloured from its image, weighted by the last IRLS
        weights."""
        p = self._p
        if not self._ref.has_template:
            return None
        td = self._ref.templates[p.maxTestLevel]
        valid = td.valid.cpu().numpy()
        pts = td.points.cpu().numpy()[valid]
        if p.warpType == "DisparitySpace":
            # the template holds (x-cx, y-cy, d): back-project for the cloud
            cam = self._cams[p.maxTestLevel]
            xyd = torch.from_numpy(pts)
            pts = warp_mod.make_points(
                cam, xyd[:, 0] + cam.cx, xyd[:, 1] + cam.cy,
                torch.clamp(xyd[:, 2], min=1e-3)).numpy()
        w = self._pose_estimator.last_weights()
        if w is not None and w.shape[1] == td.capacity:
            weights = w[0].cpu().numpy()[valid]
        else:
            weights = np.ones(len(pts), np.float32)
        scale = 1 << p.maxTestLevel
        ys = np.clip(td.rows.cpu().numpy()[valid] * scale, 0, self._rows - 1)
        xs = np.clip(td.cols.cpu().numpy()[valid] * scale, 0, self._cols - 1)
        c = _numpy(self._ref.image)[ys, xs].astype(np.uint8)
        colors = np.stack([c, c, c, np.full_like(c, 255)], axis=1)
        return PointCloud(points=pts.astype(np.float32), colors=colors,
                          weights=weights.astype(np.float32))
