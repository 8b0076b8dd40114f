"""NewTsukuba trajectory evaluation (the port's numpy copy of
``bpvo_tpu/eval/tsukuba_eval.py``).

Counterpart of the reference's MATLAB-side Tsukuba evaluation
(matlab/eval/eval_tsukuba.m; the dataset ships ``groundtruth/camera_track.txt``
with one line per frame: X Y Z A B C — position in centimeters and Euler
angles in degrees for the *stereo head center*, left camera 5 cm to its left).
"""
from __future__ import annotations

from typing import List

import numpy as np

from bpvo_tpu_torch.eval.kitti_eval import ate_rmse


def load_camera_track(filename: str, left_camera: bool = True
                      ) -> List[np.ndarray]:
    """Ground-truth camera-to-world poses (meters) from camera_track.txt."""
    poses = []
    half_baseline = np.array([-0.05, 0.0, 0.0]) if left_camera else \
        np.array([0.05, 0.0, 0.0])
    with open(filename) as f:
        for line in f:
            vals = [float(v) for v in line.replace(",", " ").split()]
            if len(vals) < 6:
                continue
            x, y, z, a, b, c = vals[:6]
            ca, sa = np.cos(np.radians(a)), np.sin(np.radians(a))
            cb, sb = np.cos(np.radians(b)), np.sin(np.radians(b))
            cc, sc = np.cos(np.radians(c)), np.sin(np.radians(c))
            Rx = np.array([[1, 0, 0], [0, ca, -sa], [0, sa, ca]])
            Ry = np.array([[cb, 0, sb], [0, 1, 0], [-sb, 0, cb]])
            Rz = np.array([[cc, -sc, 0], [sc, cc, 0], [0, 0, 1]])
            R = Rz @ Ry @ Rx
            T = np.eye(4)
            T[:3, :3] = R
            T[:3, 3] = np.array([x, y, z]) / 100.0 + R @ half_baseline
            poses.append(T)
    return poses


def evaluate_trajectory(gt_track_file: str, est_poses: List[np.ndarray]):
    """ATE RMSE (m) + final-position drift of an estimated trajectory against
    the NewTsukuba ground truth."""
    gt = load_camera_track(gt_track_file)
    n = min(len(gt), len(est_poses))
    ate = ate_rmse(gt[:n], est_poses[:n])
    drift = float(np.linalg.norm(gt[n - 1][:3, 3] - est_poses[n - 1][:3, 3]))
    return {"ate_rmse_m": ate, "final_drift_m": drift, "frames": n}
