"""VoApp: the end-to-end driver, loader -> VO -> trajectory, point-cloud
and timing files (counterpart of ``bpvo_tpu/apps/vo_app.py``; reference
``apps/vo_app.{h,cc}``).

Frames come from a ``DatasetLoaderThread`` that, on CUDA, also prefetches
them to the card (pinned host buffers, a copy stream of its own) and runs
a stereo dataset's matcher on that stream; ``threaded=False`` reads each
frame on the calling thread instead, just before its ``add_frame``.  The
output files are the JAX package's: ``<prefix>_path.txt``,
``_poses.txt``, ``_kitti.txt``, ``_time.txt``, ``_iterations.txt`` and a
``<points prefix>_NNNNN.ply`` per keyframe.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import List, Optional

import numpy as np

from bpvo_tpu_torch.config import AlgorithmParameters, ConfigFile
from bpvo_tpu_torch.data.dataset import Dataset
from bpvo_tpu_torch.data.loader import DatasetLoaderThread
from bpvo_tpu_torch.utils import debug
from bpvo_tpu_torch.vo.device_vo import resolve_device
from bpvo_tpu_torch.vo.odometry import VisualOdometry
from bpvo_tpu_torch.vo.point_cloud import write_ply

VIEWER_MISSING = ("the viewer (utils/viz) needs cv2 and is not ported yet "
                  "(ROADMAP A.3)")


@dataclasses.dataclass
class VoAppOptions:
    """(reference vo_app.h Options)"""
    trajectory_prefix: str = ""     # write <prefix>_path.txt / _kitti.txt
    points_prefix: str = ""         # write <prefix>_NNNNN.ply per keyframe
    data_buffer_size: int = 16
    max_num_frames: int = -1
    store_iteration_time: bool = True
    min_point_weight: float = 0.75  # conf 'minPointWeight'
    max_point_depth: float = 10.0   # conf 'maxDepth'
    viewer: bool = False            # not ported (VIEWER_MISSING)
    threaded: bool = True           # frames from the loader thread
    prefetch: bool = True           # the loader copies frames to the device


@dataclasses.dataclass
class VoAppResult:
    num_frames: int
    total_time_s: float
    frame_times_ms: List[float]     # add_frame alone, per frame
    frame_interval_ms: List[float]  # frame end to frame end, incl. loading
    iterations: List[int]
    vo: VisualOdometry

    @property
    def mean_hz(self) -> float:
        return self.num_frames / self.total_time_s if self.total_time_s else 0.0


class VoApp:
    def __init__(self, dataset: Dataset, params: AlgorithmParameters,
                 options: Optional[VoAppOptions] = None, device="cuda"):
        self._dataset = dataset
        self._options = options or VoAppOptions()
        if self._options.viewer:
            raise NotImplementedError(VIEWER_MISSING)
        self.device = resolve_device(device)
        calib = dataset.calibration
        self._vo = VisualOdometry(calib.K, calib.baseline, dataset.image_size,
                                  params, device=self.device)

    @classmethod
    def from_config(cls, conf_file: str, device="cuda",
                    **option_overrides) -> "VoApp":
        from bpvo_tpu_torch.data.dataset import create_dataset
        cf = ConfigFile(conf_file)
        params = AlgorithmParameters.from_config(cf)
        opts = VoAppOptions(
            min_point_weight=cf.get("minPointWeight", 0.75, float),
            max_point_depth=cf.get("maxDepth", 10.0, float),
            **option_overrides)
        return cls(create_dataset(cf, device=device), params, opts,
                   device=device)

    @property
    def vo(self) -> VisualOdometry:
        return self._vo

    def run(self, log_every: int = 25) -> VoAppResult:
        """(reference vo_app.cc:291-388 mainLoop)"""
        o = self._options
        frame_times: List[float] = []
        intervals: List[float] = []
        iterations: List[int] = []
        t_start = time.perf_counter()
        max_frames = o.max_num_frames if o.max_num_frames > 0 else None
        loader = DatasetLoaderThread(
            self._dataset, o.data_buffer_size, max_frames=max_frames,
            device=self.device if o.prefetch else None) if o.threaded else None
        try:
            self._loop(loader if loader is not None
                       else itertools.islice(self._dataset, max_frames),
                       frame_times, intervals, iterations, log_every)
        finally:
            if loader is not None:
                loader.stop()
        total = time.perf_counter() - t_start
        self._write_outputs(frame_times, iterations)
        return VoAppResult(num_frames=len(frame_times), total_time_s=total,
                           frame_times_ms=frame_times,
                           frame_interval_ms=intervals,
                           iterations=iterations, vo=self._vo)

    def _loop(self, frames, frame_times, intervals, iterations, log_every):
        o = self._options
        kf_index = 0
        t_last = time.perf_counter()
        for frame in frames:
            t0 = time.perf_counter()
            result = self._vo.add_frame(frame.image, frame.disparity)
            t1 = time.perf_counter()
            frame_times.append((t1 - t0) * 1000.0)
            intervals.append((t1 - t_last) * 1000.0)
            t_last = t1
            iterations.append(sum(
                s.num_iterations for s in result.optimizer_statistics))
            n = len(frame_times)

            if result.point_cloud is not None and o.points_prefix:
                pc = result.point_cloud.filtered(o.min_point_weight,
                                                 o.max_point_depth)
                if len(pc):
                    write_ply(f"{o.points_prefix}_{kf_index:05d}.ply", pc)
                    kf_index += 1

            if log_every and n % log_every == 0:
                hz = 1000.0 / max(np.mean(frame_times[-log_every:]), 1e-9)
                debug.info("frame %d @ %.1f Hz [iters %d]%s", n, hz,
                           iterations[-1],
                           " KF" if result.is_keyframe else "")

    def _write_outputs(self, frame_times, iterations):
        """(reference vo_app.cc:364-385)"""
        o = self._options
        if not o.trajectory_prefix:
            return
        traj = self._vo.trajectory
        traj.write_camera_path(o.trajectory_prefix + "_path.txt")
        traj.write(o.trajectory_prefix + "_poses.txt")
        traj.write_kitti_format(o.trajectory_prefix + "_kitti.txt")
        if o.store_iteration_time:
            np.savetxt(o.trajectory_prefix + "_time.txt",
                       np.asarray(frame_times))
            np.savetxt(o.trajectory_prefix + "_iterations.txt",
                       np.asarray(iterations, np.int32), fmt="%d")
