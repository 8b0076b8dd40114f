"""Trajectory accumulation and pose writers, in numpy on the host
(counterpart of ``bpvo_tpu/vo/trajectory.py``; reference trajectory.cc:42-97
and the KITTI 3x4 writer of apps/eval_kitti.cc:42-59).

``push(T_rel)`` appends ``last_world_pose @ inverse(T_rel)``: the
camera-to-world pose grows by the inverse of the measured warp.
"""
from __future__ import annotations

from typing import List

import numpy as np


def _invert_pose(T: np.ndarray) -> np.ndarray:
    R = T[:3, :3]
    t = T[:3, 3]
    out = np.eye(4, dtype=T.dtype)
    out[:3, :3] = R.T
    out[:3, 3] = -R.T @ t
    return out


class Trajectory:
    def __init__(self):
        self._poses: List[np.ndarray] = []

    def push(self, T_rel: np.ndarray) -> None:
        T_inv = _invert_pose(np.asarray(T_rel, np.float64))
        self._poses.append(self._poses[-1] @ T_inv if self._poses else T_inv)

    def __len__(self):
        return len(self._poses)

    def __getitem__(self, i) -> np.ndarray:
        return self._poses[i]

    @property
    def poses(self) -> List[np.ndarray]:
        return self._poses

    def back(self) -> np.ndarray:
        return self._poses[-1]

    def positions(self) -> np.ndarray:
        """(N, 3) camera-center path."""
        return (np.stack([p[:3, 3] for p in self._poses]) if self._poses
                else np.zeros((0, 3)))

    def write_camera_path(self, filename: str) -> None:
        """x y z per line (reference trajectory.cc:73-87)."""
        with open(filename, "w") as f:
            for p in self._poses:
                f.write(f"{p[0, 3]} {p[1, 3]} {p[2, 3]}\n")

    def write(self, filename: str) -> None:
        """Full 4x4 row-major per line (reference trajectory.cc:54-70)."""
        with open(filename, "w") as f:
            for p in self._poses:
                f.write(" ".join(str(v) for v in p.reshape(-1)) + "\n")

    def write_kitti_format(self, filename: str) -> None:
        """3x4 row-major per line, the KITTI odometry format."""
        with open(filename, "w") as f:
            for p in self._poses:
                f.write(" ".join(f"{v:.9e}" for v in p[:3, :4].reshape(-1))
                        + "\n")
