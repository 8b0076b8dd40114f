"""eval_kitti: run VO on KITTI sequences and write KITTI-format
trajectories (``run``), or compute the devkit metrics against ground truth
(``eval``) (counterpart of ``bpvo_tpu/apps/eval_kitti.py``; reference
``apps/eval_kitti.cc`` and ``apps/run_kitti_eval.cc``).

Usage:
  python -m bpvo_tpu_torch.apps.eval_kitti run  --root ~/data/kitti/dataset \
      --out results/ [--seqs 0 1 2] [--descriptor Intensity] \
      [--stereo TpuSGM] [--device cuda|cpu]
  python -m bpvo_tpu_torch.apps.eval_kitti eval \
      --gt ~/data/kitti/dataset/poses --results results/
"""
from __future__ import annotations

import argparse
import json
import os

from bpvo_tpu_torch.config import ConfigFile
from bpvo_tpu_torch.eval import kitti_eval
from bpvo_tpu_torch.utils import debug


def make_kitti_config(root: str, sequence: int, descriptor: str = "Intensity",
                      stereo: str = "TpuSGM") -> ConfigFile:
    """Config analogous to the reference's generated one
    (eval_kitti.cc:17-40)."""
    cf = ConfigFile()
    cf.set("Dataset", "kitti")
    cf.set("DataSetRootDirectory", root)
    cf.set("SequenceNumber", sequence)
    cf.set("StereoAlgorithm", stereo)
    cf.set("numberOfDisparities", 128)
    cf.set("SADWindowSize", 9)
    cf.set("descriptor", descriptor)
    cf.set("numPyramidLevels", 4)
    cf.set("lossFunction", "Huber")
    cf.set("maxIterations", 100)
    cf.set("parameterTolerance", 1e-6)
    cf.set("functionTolerance", 1e-5)
    cf.set("minTranslationMagToKeyFrame", 0.0)
    cf.set("minRotationMagToKeyFrame", 2.0)
    cf.set("goodPointThreshold", 0.7)
    cf.set("maxFractionOfGoodPointsToKeyFrame", 0.5)
    cf.set("minSaliency", 1.5)
    return cf


def run_sequences(root: str, out_dir: str, seqs, descriptor="Intensity",
                  stereo="TpuSGM", num_frames=-1, device="cuda"):
    """VO over each sequence (its matcher and VO on ``device``), written
    to ``<out_dir>/<seq>.txt``."""
    from bpvo_tpu_torch.config import AlgorithmParameters
    from bpvo_tpu_torch.data.kitti import KittiDataset
    from bpvo_tpu_torch.vo.device_vo import resolve_device
    from bpvo_tpu_torch.vo.odometry import VisualOdometry

    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    for seq in seqs:
        cf = make_kitti_config(root, seq, descriptor, stereo)
        params = AlgorithmParameters.from_config(cf)
        ds = KittiDataset(cf, device=device)
        calib = ds.calibration
        vo = VisualOdometry(calib.K, calib.baseline, ds.image_size, params,
                            device=device)
        n = 0
        for frame in ds:
            if num_frames > 0 and n >= num_frames:
                break
            vo.add_frame(frame.image, frame.disparity)
            n += 1
        out = os.path.join(out_dir, f"{seq:02d}.txt")
        vo.trajectory.write_kitti_format(out)
        debug.info("sequence %02d: %d frames -> %s", seq, n, out)


def evaluate(gt_dir: str, results_dir: str, seqs, plot_prefix: str = ""):
    """(reference run_kitti_eval.cc, kitti_eval.cc:238-256; with
    ``plot_prefix`` also the devkit _tl/_rl/_ts/_rs plot files per
    sequence, kitti_eval.cc:152-235)"""
    out = {}
    for seq in seqs:
        gt = os.path.join(gt_dir, f"{seq:02d}.txt")
        est = os.path.join(results_dir, f"{seq:02d}.txt")
        if not (os.path.exists(gt) and os.path.exists(est)):
            continue
        gt_poses = kitti_eval.load_poses(gt)
        est_poses = kitti_eval.load_poses(est)
        errors = kitti_eval.calc_sequence_errors(gt_poses, est_poses)
        stats = kitti_eval.summarize(errors)
        if plot_prefix:
            kitti_eval.save_error_plot_data(errors, f"{plot_prefix}_{seq:02d}")
        out[f"{seq:02d}"] = {
            "t_err_percent": stats.t_err_percent,
            "r_err_deg_per_m": stats.r_err_deg_per_m,
            "segments": stats.num_segments,
            "ate_rmse_m": kitti_eval.ate_rmse(gt_poses, est_poses),
        }
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("--root", required=True)
    r.add_argument("--out", required=True)
    r.add_argument("--seqs", type=int, nargs="*", default=list(range(11)))
    r.add_argument("--descriptor", default="Intensity")
    r.add_argument("--stereo", default="TpuSGM")
    r.add_argument("--numframes", type=int, default=-1)
    r.add_argument("--device", default="cuda")
    e = sub.add_parser("eval")
    e.add_argument("--gt", required=True)
    e.add_argument("--results", required=True)
    e.add_argument("--seqs", type=int, nargs="*", default=list(range(11)))
    e.add_argument("--plot-prefix", default="",
                   help="also write devkit _tl/_rl/_ts/_rs plot-data files")
    args = ap.parse_args(argv)
    if args.cmd == "run":
        run_sequences(args.root, args.out, args.seqs, args.descriptor,
                      args.stereo, args.numframes, args.device)
    else:
        print(json.dumps(evaluate(args.gt, args.results, args.seqs,
                                  args.plot_prefix), indent=2))


if __name__ == "__main__":
    main()
