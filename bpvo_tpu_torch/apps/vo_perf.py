"""vo_perf: synchronous benchmark loop over a dataset, writing _path /
_poses / _kitti / _iterations / _time files and a summary (counterpart of
``bpvo_tpu/apps/vo_perf.py``; reference ``apps/vo_perf.cc``).

Usage: python -m bpvo_tpu_torch.apps.vo_perf --config conf/file.cfg
       --output prefix [--numframes N] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from bpvo_tpu_torch.config import AlgorithmParameters, ConfigFile
from bpvo_tpu_torch.data.dataset import create_dataset
from bpvo_tpu_torch.utils import debug
from bpvo_tpu_torch.vo.odometry import VisualOdometry


def run_perf(conf_file: str, output_prefix: str = "", num_frames: int = -1,
             warmup: int = 5, device="cuda"):
    cf = ConfigFile(conf_file)
    params = AlgorithmParameters.from_config(cf)
    dataset = create_dataset(cf, device=device)
    calib = dataset.calibration
    vo = VisualOdometry(calib.K, calib.baseline, dataset.image_size, params,
                        device=device)

    times_ms, iters = [], []
    n = 0
    t_all = time.perf_counter()
    for frame in dataset:
        if num_frames > 0 and n >= num_frames:
            break
        t0 = time.perf_counter()
        result = vo.add_frame(frame.image, frame.disparity)
        dt = (time.perf_counter() - t0) * 1000.0
        times_ms.append(dt)
        iters.append(sum(s.num_iterations
                         for s in result.optimizer_statistics))
        n += 1
        if n % 50 == 0:
            debug.info("frame %d %.1f Hz", n,
                       1000.0 / max(np.mean(times_ms[-50:]), 1e-9))
    total_s = time.perf_counter() - t_all

    steady = times_ms[warmup:] if len(times_ms) > warmup else times_ms
    hz = 1000.0 / max(np.mean(steady), 1e-9)
    summary = {
        "frames": n,
        "mean_ms": float(np.mean(steady)),
        "median_ms": float(np.median(steady)),
        "hz": hz,
        "total_s": total_s,
        "mean_gn_iters": float(np.mean(iters[warmup:])) if iters else 0.0,
        "device": str(vo.device),
    }
    if output_prefix:
        vo.trajectory.write_camera_path(output_prefix + "_path.txt")
        vo.trajectory.write(output_prefix + "_poses.txt")
        vo.trajectory.write_kitti_format(output_prefix + "_kitti.txt")
        np.savetxt(output_prefix + "_time.txt", np.asarray(times_ms))
        np.savetxt(output_prefix + "_iterations.txt",
                   np.asarray(iters, np.int32), fmt="%d")
        with open(output_prefix + "_summary.json", "w") as f:
            json.dump(summary, f, indent=2)
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", "-c", required=True)
    ap.add_argument("--output", "-o", default="")
    ap.add_argument("--numframes", "-n", type=int, default=-1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    summary = run_perf(args.config, args.output, args.numframes,
                       device=args.device)
    print(json.dumps(summary, indent=2))


if __name__ == "__main__":
    main()
