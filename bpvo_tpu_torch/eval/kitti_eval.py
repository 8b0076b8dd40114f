"""KITTI odometry devkit metrics: per-subsequence translational / rotational
errors over 100..800 m segments (the port's numpy copy of
``bpvo_tpu/eval/kitti_eval.py``).

Counterpart of the reference's ``utils/kitti_eval.{h,cc}`` (a port of the KITTI
devkit: trajectory distances at kitti_eval.cc:17-21, ``CalcSequenceErrors`` at
:113-150 — every 10th frame x lengths {100..800} m, error of the relative pose
T_err = inv(T_delta_est) @ T_delta_gt, r_err = acos((trace-1)/2)/len,
t_err = |t|/len — and speed/length binning at :152-235).
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

LENGTHS = [100.0, 200.0, 300.0, 400.0, 500.0, 600.0, 700.0, 800.0]
STEP_SIZE = 10  # evaluate every 10th frame (kitti_eval devkit convention)


@dataclasses.dataclass
class SegmentError:
    first_frame: int
    r_err: float      # rad per meter
    t_err: float      # fraction (meters per meter)
    length: float
    speed: float


def load_poses(filename: str) -> List[np.ndarray]:
    """Read KITTI-format 3x4 row-major poses into 4x4 matrices."""
    poses = []
    with open(filename) as f:
        for line in f:
            vals = [float(v) for v in line.split()]
            if len(vals) < 12:
                continue
            T = np.eye(4)
            T[:3, :4] = np.array(vals[:12]).reshape(3, 4)
            poses.append(T)
    return poses


def trajectory_distances(poses: Sequence[np.ndarray]) -> np.ndarray:
    """Cumulative path length at each frame (kitti_eval.cc:17-31)."""
    d = np.zeros(len(poses))
    for i in range(1, len(poses)):
        d[i] = d[i - 1] + np.linalg.norm(poses[i][:3, 3] - poses[i - 1][:3, 3])
    return d


def _last_frame_from_len(dist: np.ndarray, first: int, length: float) -> int:
    for i in range(first, len(dist)):
        if dist[i] > dist[first] + length:
            return i
    return -1


def calc_sequence_errors(poses_gt: Sequence[np.ndarray],
                         poses_est: Sequence[np.ndarray]) -> List[SegmentError]:
    """(kitti_eval.cc:113-150)"""
    n = min(len(poses_gt), len(poses_est))
    dist = trajectory_distances(poses_gt[:n])
    errors = []
    for first in range(0, n, STEP_SIZE):
        for length in LENGTHS:
            last = _last_frame_from_len(dist, first, length)
            if last < 0 or last >= n:
                continue
            d_gt = np.linalg.inv(poses_gt[first]) @ poses_gt[last]
            d_est = np.linalg.inv(poses_est[first]) @ poses_est[last]
            err = np.linalg.inv(d_est) @ d_gt
            r_err = np.arccos(np.clip((np.trace(err[:3, :3]) - 1.0) * 0.5,
                                      -1.0, 1.0)) / length
            t_err = np.linalg.norm(err[:3, 3]) / length
            n_frames = last - first + 1
            speed = length / (0.1 * n_frames)  # 10 Hz capture
            errors.append(SegmentError(first, float(r_err), float(t_err),
                                       length, float(speed)))
    return errors


@dataclasses.dataclass
class SequenceStats:
    t_err_percent: float   # average translational error, %
    r_err_deg_per_m: float  # average rotational error, deg/m
    num_segments: int


def summarize(errors: List[SegmentError]) -> SequenceStats:
    if not errors:
        return SequenceStats(float("nan"), float("nan"), 0)
    t = float(np.mean([e.t_err for e in errors])) * 100.0
    r = float(np.mean([e.r_err for e in errors])) * 180.0 / np.pi
    return SequenceStats(t_err_percent=t, r_err_deg_per_m=r,
                         num_segments=len(errors))


def ate_rmse(poses_gt: Sequence[np.ndarray],
             poses_est: Sequence[np.ndarray]) -> float:
    """Absolute trajectory error (RMSE of position differences) after aligning
    the first frames.  Not part of the KITTI devkit but the standard ATE
    metric referenced by BASELINE.md."""
    n = min(len(poses_gt), len(poses_est))
    if n == 0:
        return float("nan")
    align = poses_gt[0] @ np.linalg.inv(poses_est[0])
    diffs = []
    for g, e in zip(poses_gt[:n], poses_est[:n]):
        e_aligned = align @ e
        diffs.append(np.linalg.norm(g[:3, 3] - e_aligned[:3, 3]))
    return float(np.sqrt(np.mean(np.square(diffs))))


def save_error_plot_data(errors: List[SegmentError], output_prefix: str) -> None:
    """Write devkit plot-data files: ``<prefix>_tl/_rl.txt`` (mean t/r error
    per segment length) and ``<prefix>_ts/_rs.txt`` (per speed bin, 2..24 m/s
    in steps of 2).  Bins with <= 2 samples are skipped.  Counterpart of the
    reference's ``SaveErrorPlotData`` (utils/kitti_eval.cc:152-235)."""
    with open(f"{output_prefix}_tl.txt", "w") as fp_tl, \
            open(f"{output_prefix}_rl.txt", "w") as fp_rl:
        for length in LENGTHS:
            sel = [e for e in errors if abs(e.length - length) < 1.0]
            if len(sel) > 2:
                fp_tl.write(f"{length:f} {np.mean([e.t_err for e in sel]):f}\n")
                fp_rl.write(f"{length:f} {np.mean([e.r_err for e in sel]):f}\n")
    with open(f"{output_prefix}_ts.txt", "w") as fp_ts, \
            open(f"{output_prefix}_rs.txt", "w") as fp_rs:
        for speed in range(2, 25, 2):
            sel = [e for e in errors if abs(e.speed - speed) < 2.0]
            if len(sel) > 2:
                fp_ts.write(f"{speed:d} {np.mean([e.t_err for e in sel]):f}\n")
                fp_rs.write(f"{speed:d} {np.mean([e.r_err for e in sel]):f}\n")


def evaluate_sequence(gt_file: str, est_file: str) -> SequenceStats:
    """(reference RunKittiEvaluation, kitti_eval.cc:238-256, per sequence)"""
    return summarize(calc_sequence_errors(load_poses(gt_file),
                                          load_poses(est_file)))
