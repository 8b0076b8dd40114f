"""eval_descriptors: VO with every descriptor type (and solver) over one
dataset, writing per-cell trajectory, timing and iteration files
(counterpart of ``bpvo_tpu/apps/eval_descriptors.py``; reference
apps/eval_descriptors.cc:126-154).

Usage: python -m bpvo_tpu_torch.apps.eval_descriptors --config conf/X.cfg
       [--out results/] [--numframes N]
       [--solvers GaussNewton,LevenbergMarquardt] [--device cuda|cpu]

Prints one JSON object: per cell the frames, the mean ms and iterations per
frame (the first 5 frames left out) and, where the dataset has ground truth,
the ATE RMSE.  A cell's tag, and the prefix of its files, is the
descriptor's name, or ``<descriptor>+<solver>`` when more than one solver
runs.  Gauss-Newton alone by default, so the default command writes the
cells and files of the JAX package's command; LM is opt-in
(``--solvers GaussNewton,LevenbergMarquardt``).
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from bpvo_tpu_torch.config import AlgorithmParameters, ConfigFile
from bpvo_tpu_torch.data.dataset import create_dataset
from bpvo_tpu_torch.types import DescriptorType
from bpvo_tpu_torch.utils import debug
from bpvo_tpu_torch.vo.odometry import VisualOdometry

DESCRIPTORS = [
    DescriptorType.INTENSITY,
    DescriptorType.BITPLANES,
    DescriptorType.INTENSITY_AND_GRADIENT,
    DescriptorType.DESCRIPTOR_FIELDS_FIRST_ORDER,
    DescriptorType.DESCRIPTOR_FIELDS_SECOND_ORDER,
    DescriptorType.CENTRAL_DIFFERENCE,
    DescriptorType.LAPLACIAN,
    DescriptorType.LATCH,
]
SOLVERS = ("GaussNewton", "LevenbergMarquardt")


def run(conf_file, out_dir: str = "", num_frames: int = -1,
        descriptors=None, solvers=("GaussNewton",), device="cuda",
        trajectories=None):
    """Run every descriptor x solver over the configured dataset on
    ``device``.  ``trajectories``, when a dict, receives each cell's world
    poses (n, 4, 4).  Returns {tag: {"frames", "mean_ms", "mean_iters"[,
    "ate_rmse_m"]}}."""
    cf = conf_file if isinstance(conf_file, ConfigFile) \
        else ConfigFile(conf_file)
    base = AlgorithmParameters.from_config(cf)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    results = {}
    for desc in (descriptors or DESCRIPTORS):
        for solver in solvers:
            params = base.replace(descriptor=desc, poseEstimator=solver)
            dataset = create_dataset(cf, device=device)
            calib = dataset.calibration
            vo = VisualOdometry(calib.K, calib.baseline, dataset.image_size,
                                params, device=device)
            times, iters = [], []
            n = 0
            for frame in dataset:
                if num_frames > 0 and n >= num_frames:
                    break
                t0 = time.perf_counter()
                res = vo.add_frame(frame.image, frame.disparity)
                times.append((time.perf_counter() - t0) * 1000.0)
                iters.append(sum(s.num_iterations
                                 for s in res.optimizer_statistics))
                n += 1
            steady = times[5:] if len(times) > 5 else times
            tag = desc.value if len(solvers) == 1 else f"{desc.value}+{solver}"
            cell = {"frames": n,
                    "mean_ms": float(np.mean(steady)) if steady else 0.0,
                    "mean_iters": (float(np.mean(iters[5:]))
                                   if len(iters) > 5 else 0.0)}
            est = vo.trajectory.poses
            if hasattr(dataset, "gt_world_pose"):
                from bpvo_tpu_torch.eval import kitti_eval
                gt = [dataset.gt_world_pose(i) for i in range(n)]
                m = min(len(gt), len(est))
                cell["ate_rmse_m"] = float(kitti_eval.ate_rmse(gt[:m],
                                                               est[:m]))
            results[tag] = cell
            if trajectories is not None:
                trajectories[tag] = np.stack(est)
            if out_dir:
                prefix = os.path.join(out_dir, tag)
                vo.trajectory.write_camera_path(prefix + "_path.txt")
                np.savetxt(prefix + "_time.txt", np.asarray(times))
                np.savetxt(prefix + "_iterations.txt",
                           np.asarray(iters, np.int32), fmt="%d")
            debug.info("%s: %.2f ms/frame, %.1f iters%s", tag,
                       cell["mean_ms"], cell["mean_iters"],
                       (f", ATE {cell['ate_rmse_m']:.4f} m"
                        if "ate_rmse_m" in cell else ""))
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", "-c", required=True)
    ap.add_argument("--out", "-o", default="")
    ap.add_argument("--numframes", "-n", type=int, default=-1)
    ap.add_argument("--solvers", default="GaussNewton",
                    help="comma-separated poseEstimator values (default "
                         "GaussNewton, as the JAX package's command; "
                         "GaussNewton,LevenbergMarquardt for both)")
    ap.add_argument("--device", default="cuda",
                    help="where the VO runs (cuda, or cpu for the plain "
                         "versions)")
    args = ap.parse_args(argv)
    results = run(args.config, args.out, args.numframes, None,
                  tuple(args.solvers.split(",")), args.device)
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
