"""Minimal embedding example for the PyTorch/CUDA port (counterpart of
examples/synthetic_vo.py and of reference apps/vo_example.cc:44-90): run VO
on the synthetic plane dataset from raw arrays and print per-frame poses.

    PYTHONPATH=. python examples/synthetic_vo_torch.py [n_frames] \
        [--device cuda|cpu]

It runs on the card unless ``--device cpu`` is given.
"""
import argparse

import numpy as np

from bpvo_tpu_torch import AlgorithmParameters, VisualOdometry
from bpvo_tpu_torch.data.synthetic import SyntheticPlaneDataset


def main(n_frames: int = 10, device: str = "cuda"):
    ds = SyntheticPlaneDataset(rows=240, cols=320, n_frames=n_frames)
    calib = ds.calibration
    params = AlgorithmParameters(minSaliency=2.0, numPyramidLevels=3,
                                 functionTolerance=1e-4,
                                 parameterTolerance=1e-6)
    vo = VisualOdometry(calib.K, calib.baseline, ds.image_size, params,
                        device=device)

    for i, frame in enumerate(ds):
        result = vo.add_frame(frame.image, frame.disparity)
        t = result.pose[:3, 3]
        iters = sum(s.num_iterations for s in result.optimizer_statistics)
        print(f"frame {i:3d}  t = [{t[0]:+.4f} {t[1]:+.4f} {t[2]:+.4f}]  "
              f"iters = {iters:3d}  kf = {result.is_keyframe}")

    # ground-truth comparison
    est = vo.trajectory.back()
    gt = ds.gt_world_pose(n_frames - 1)
    err = np.linalg.norm(est[:3, 3] - gt[:3, 3])
    print(f"final position error vs ground truth: {err * 100:.2f} cm")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("n_frames", nargs="?", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda, or cpu for the plain versions")
    args = ap.parse_args()
    main(args.n_frames, args.device)
