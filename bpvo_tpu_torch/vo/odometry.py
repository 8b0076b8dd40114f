"""VisualOdometry: the public frame-to-frame API (counterpart of
``bpvo_tpu/vo/odometry.py``; reference vo.{h,cc}, vo_frame.{h,cc}).

``VisualOdometry(K, baseline, image_size, params, device)`` then
``add_frame(image, disparity) -> Result``.  The descriptor pyramids,
templates and pose estimates run on ``device``; the keyframe bookkeeping,
the trajectory, the Result and the point cloud live on the host.

On CUDA (no verbose level) the three programs JAX jits are CUDA graphs of
one ``utils.graphs.GraphCache``, a graph per static key: the frame's
descriptor pyramid (``_process_frame``: parameters, levels, image shape),
the keyframe's templates (``_set_templates_all``: parameters, capacities,
cameras) and the whole coarse-to-fine estimate (``_estimate_all``,
``PoseEstimator.estimate``).  A frame that is not a keyframe is then one
replay of the frame graph, one of the estimate graph and one read of the
device; a keyframe adds a replay of the template graph and, when the
candidate becomes the keyframe, a second estimate replay and read.  The
graphs' outputs are copied out, so no tensor a frame or the BA window
keeps is a buffer a later replay overwrites.  On the CPU, or with a
verbose level, the same functions run eagerly.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from bpvo_tpu_torch.config import AlgorithmParameters
from bpvo_tpu_torch.types import KeyFramingReason, Result
from bpvo_tpu_torch.utils import graphs as graphs_mod
from bpvo_tpu_torch.utils import profiling
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
    keyframe (reference VisualOdometryFrame).  ``graphs``: the
    ``GraphCache`` the pyramid and the templates run through (JAX's
    ``_process_frame`` and ``_set_templates_all``), or None (eager)."""

    def __init__(self):
        self.clear()

    def set_data(self, image, disparity, n_levels: int,
                 p: AlgorithmParameters, device, graphs=None):
        self.image = image
        with profiling.annotate("vo.upload"):
            self.disparity = profiling.upload(
                torch.as_tensor(disparity, dtype=torch.float32), device)
            image = profiling.upload(
                torch.as_tensor(image, dtype=torch.float32), device)
        self.templates = None
        with profiling.annotate("vo.frame"):
            if graphs is None:
                self.channels = device_vo._compute_channels_pyr(image, p,
                                                                n_levels)
            else:
                self.channels = graphs.jit(
                    ("frame", p, n_levels), (image,),
                    lambda b: device_vo._compute_channels_pyr(b[0], p,
                                                              n_levels))

    @property
    def has_template(self) -> bool:
        return self.templates is not None

    def set_template(self, cams, p: AlgorithmParameters, capacities,
                     graphs=None):
        if graphs is None:
            self.templates = device_vo._build_templates(
                self.channels, self.disparity, cams, p, capacities)
        else:
            self.templates = graphs.jit(
                ("templates", p, capacities, cams),
                (self.channels, self.disparity),
                lambda b: device_vo._build_templates(b[0], b[1], cams, p,
                                                     capacities))

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
    ``add_frame(image, disparity) -> Result`` (reference vo.h:31-105).

    Routes, chosen statically by device and configuration (as
    ``DeviceVO``'s): on CUDA with no verbose level the pyramid, the
    templates and each pose estimate are replays of graphs of
    ``self._graphs`` (a ``GraphCache``; see the module docstring); on the
    CPU, or with a verbose level (a line per iteration), ``self._graphs``
    is None and they run eagerly."""

    def __init__(self, K, baseline: float, image_size,
                 params: Optional[AlgorithmParameters] = None, device="cuda"):
        p, self._cams, self._capacities, opts = device_vo._setup_levels(
            K, baseline, image_size, params or AlgorithmParameters())
        self._p = p
        self._rows, self._cols = image_size
        self.device = device_vo.resolve_device(device)
        self._pose_estimator = PoseEstimator(p, opts)
        # the graphed route (see the class docstring)
        self._graphs = graphs_mod.route(None, self.device, None, {}, opts)
        self._trajectory = Trajectory()
        self._T_kf = np.eye(4, dtype=np.float32)
        self._ref, self._cur, self._prev = _Frame(), _Frame(), _Frame()
        self._ba_window = None   # enable_bundle_adjustment()
        # the keyframe branch's counters, there from the start: a reader
        # tells a program that counts none from one that made none yet
        profiling.count("keyframes", 0)
        profiling.count("keyframes_own", 0)

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
        frames), or None.  On CUDA with no reducer, a one-rank nccl group
        or an nccl group over the cards of one host (``graphs.capturable``:
        its all-reduces the peer kernel) each optimize is one replay of
        the window size's BA graph
        (in ``self._graphs`` on the graphed route) and one read of the
        refined poses; the graphs of every size from 2 to ``window_size``
        are captured here, on a placeholder keyframe of the real shapes
        (a zero frame's channels and template at maxTestLevel), so the
        frame loop pays no capture."""
        from bpvo_tpu_torch.parallel.bundle_adjustment import (BAOptions,
                                                               KeyframeWindow)
        cache = self._graphs if self._graphs is not None and \
            graphs_mod.capturable(group, self.device) else None
        self._ba_window = KeyframeWindow(
            window_size, self._cams[self._p.maxTestLevel],
            ba_options or BAOptions(), reducer=group, device=self.device,
            cache=cache)
        if self._ba_window.graphed():
            with graphs_mod.uncounted():
                frame = _Frame()
                zeros = torch.zeros(self._rows, self._cols,
                                    dtype=torch.float32, device=self.device)
                self._set_data(frame, zeros, zeros)
                self._set_template(frame)
            lvl = self._p.maxTestLevel
            self._ba_window.capture(frame.templates[lvl], frame.channels[lvl])

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
                self._set_data(self._ref, data["ref_image"],
                               data["ref_disparity"])
                self._set_template(self._ref)
            if "prev_image" in data.files:
                self._prev = _Frame()
                self._set_data(self._prev, data["prev_image"],
                               data["prev_disparity"])

    def _set_data(self, frame: _Frame, image, disparity):
        """The frame's pyramid: one replay of the frame graph (graphed)."""
        frame.set_data(image, disparity, self._p.numPyramidLevels, self._p,
                       self.device, self._graphs)

    def _set_template(self, frame: _Frame):
        """The keyframe's templates: one replay of the template graph."""
        with profiling.annotate("vo.templates"):
            frame.set_template(self._cams, self._p, self._capacities,
                               self._graphs)

    def _estimate(self, T_init, **kw):
        """One pose estimate (one replay of its graph, graphed) and its
        one device read."""
        with profiling.annotate("vo.estimate"):
            return self._pose_estimator.estimate(
                self._ref.templates, self._cur.channels, self._cams, T_init,
                graphs=self._graphs, **kw)

    def add_frame(self, image, disparity) -> Result:
        """Estimate the motion of ``image`` wrt the current keyframe
        (reference vo.cc:125-197).  ``image`` and ``disparity`` are (rows,
        cols) arrays or tensors.

        Spans (``utils.profiling``): the root ``vo.add_frame`` over
        ``vo.upload`` (the host -> device copies), ``vo.frame`` (the
        pyramid), ``vo.estimate`` (its ``vo.read`` a wait), ``vo.keying``
        and, on a keyframe, ``vo.keyframe`` over ``vo.cloud`` (its
        ``vo.cloud_read`` a wait), ``vo.templates`` and, when the candidate
        becomes the keyframe, the re-estimate's ``vo.estimate``.  Counters:
        ``keyframes`` each keyframe after the first frame, of which
        ``keyframes_own`` those without a candidate (the frame becomes the
        keyframe from its own disparity)."""
        with profiling.annotate("vo.add_frame"):
            return self._add_frame(image, disparity)

    def _add_frame(self, image, disparity) -> Result:
        p = self._p
        if tuple(image.shape) != (self._rows, self._cols):
            raise ValueError(f"image size {tuple(image.shape)} != "
                             f"{(self._rows, self._cols)}")
        self._set_data(self._cur, image, disparity)

        if not self._ref.has_template:
            # first frame (vo.cc:133-139)
            self._ref, self._cur = self._cur, self._ref
            self._set_template(self._ref)
            self._trajectory.push(self._T_kf)
            return Result(pose=np.eye(4), covariance=np.eye(6),
                          is_keyframe=True,
                          keyframing_reason=KeyFramingReason.FIRST_FRAME,
                          optimizer_statistics=[])

        T_est, stats = self._estimate(self._T_kf,
                                      multistart_px=p.coarseInitOffsetPx)
        with profiling.annotate("vo.keying"):
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
            profiling.count("keyframes")
            with profiling.annotate("vo.keyframe"):
                # the cloud is read now, from the old keyframe, and built on
                # the host once the new template's build is queued: the
                # card builds the template while the host builds the cloud
                build_cloud = self._extract_point_cloud()
                if self._prev.empty:
                    profiling.count("keyframes_own")
                    # no candidate: the current frame becomes the keyframe
                    # (vo.cc:166-177)
                    self._ref, self._cur = self._cur, self._ref
                    self._set_template(self._ref)
                    pose = T_est @ np.linalg.inv(self._T_kf)
                    self._T_kf = np.eye(4, dtype=np.float32)
                else:
                    # the candidate becomes the keyframe and the pose is
                    # re-estimated against it (vo.cc:178-188), from
                    # keyframeReestimateStartLevel, warm-started by the
                    # measured candidate->current motion behind the cost
                    # gate
                    used_candidate = True
                    self._prev, self._ref = self._ref, self._prev
                    self._prev.clear()
                    self._set_template(self._ref)
                    if p.keyframeReestimateStartLevel >= 0:
                        start2 = min(max(p.keyframeReestimateStartLevel,
                                         p.maxTestLevel),
                                     len(self._cur.channels) - 1)
                        alt = (T_est @ np.linalg.inv(self._T_kf)).astype(
                            np.float32)
                    else:
                        start2, alt = -1, None
                    T_est, stats = self._estimate(np.eye(4, dtype=np.float32),
                                                  start_level=start2,
                                                  alt_init=alt)
                    pose = T_est
                    self._T_kf = T_est
                point_cloud = build_cloud()

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

    def _extract_point_cloud(self) -> Callable[[], Optional[PointCloud]]:
        """(reference vo.cc:260-281): the keyframe's template points at
        maxTestLevel, grey-coloured from its image, weighted by the last IRLS
        weights.  One device read (``_cloud_read``): the template's mask and
        points, the weights and, for an image on the device, its values at
        the points, else the points' pixel positions.  Returns the function
        that builds the cloud on the host from what was read; it holds what
        it needs, so the keyframe's buffers may change before it runs."""
        with profiling.annotate("vo.cloud"):
            return self._point_cloud()

    def _point_cloud(self) -> Callable[[], Optional[PointCloud]]:
        p = self._p
        if not self._ref.has_template:
            return lambda: None
        td = self._ref.templates[p.maxTestLevel]
        K = td.capacity
        scale = 1 << p.maxTestLevel
        ys = torch.clamp(td.rows * scale, 0, self._rows - 1)
        xs = torch.clamp(td.cols * scale, 0, self._cols - 1)
        w = self._pose_estimator.last_weights()
        has_w = w is not None and w.shape[1] == K
        image = self._ref.image
        on_device = (isinstance(image, torch.Tensor)
                     and image.device == td.valid.device)
        parts = ([td.valid, td.points] + ([w[0]] if has_w else [])
                 + ([image[ys, xs]] if on_device else [ys, xs]))
        host = self._cloud_read(parts)
        cam = self._cams[p.maxTestLevel]
        return lambda: self._cloud_from_host(host, K, cam, has_w, on_device,
                                             image)

    def _cloud_from_host(self, host, K, cam, has_w, on_device, image):
        """The cloud from ``_cloud_read``'s array: the valid points, their
        weights and grey colours."""
        valid = host[:K] != 0
        # the selection puts the valid points first (ops/selection.py): a
        # slice of that prefix, not a mask over all K slots, and no more
        # host passes than the cloud needs (at a dense level's K = 466616
        # masks and conversions took ~20 ms of host time a keyframe)
        n = int(np.count_nonzero(valid))
        if valid[:n].all():
            valid = slice(0, n)
        pts = np.array(host[K:4 * K].reshape(K, 3)[valid], np.float32)
        rest = host[4 * K:]
        if self._p.warpType == "DisparitySpace":
            # the template holds (x-cx, y-cy, d): back-project for the cloud
            xyd = torch.from_numpy(pts)
            pts = warp_mod.make_points(
                cam, xyd[:, 0] + cam.cx, xyd[:, 1] + cam.cy,
                torch.clamp(xyd[:, 2], min=1e-3)).numpy()
        if has_w:
            weights, rest = np.array(rest[:K][valid], np.float32), rest[K:]
        else:
            weights = np.ones(len(pts), np.float32)
        if on_device:
            c = rest[:K][valid].astype(np.uint8)
        else:
            ys = rest[:K][valid].astype(np.int64)
            xs = rest[K:2 * K][valid].astype(np.int64)
            c = _numpy(image)[ys, xs].astype(np.uint8)
        # rgba (c, c, c, 255): one little-endian uint32 a point
        colors = (c.astype("<u4") * np.uint32(0x010101)
                  + np.uint32(0xFF000000)).astype("<u4", copy=False).view(
            np.uint8).reshape(-1, 4)
        return PointCloud(points=pts, colors=colors, weights=weights)

    @staticmethod
    def _cloud_read(parts) -> np.ndarray:
        """The point cloud's one device -> host copy: ``parts`` flattened
        into float32, which holds each of their values exactly (the mask,
        the float32 points and weights, pixel indices below 2^24, a float32
        image's grey values)."""
        return profiling.device_read(
            "vo.cloud_read",
            torch.cat([t.reshape(-1).to(torch.float32) for t in parts]))
