"""vo: the main command line (counterpart of ``bpvo_tpu/apps/vo.py``;
reference ``apps/vo.cc``): config, output prefix, frame count, loader
buffer, point clouds and timing files driving ``VoApp``.

Usage: python -m bpvo_tpu_torch.apps.vo --config conf/file.cfg
       [--output prefix] [--numframes N] [--buffersize B] [--points]
       [--dontstoretiming] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

from bpvo_tpu_torch.apps.vo_app import VIEWER_MISSING, VoApp
from bpvo_tpu_torch.utils import debug


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", "-c", default="../conf/tsukuba.cfg",
                    help="config file")
    ap.add_argument("--output", "-o", default="output",
                    help="trajectory/timing output prefix")
    ap.add_argument("--numframes", "-n", type=int, default=-1,
                    help="number of frames to process")
    ap.add_argument("--buffersize", "-b", type=int, default=16,
                    help="loader readahead buffer size")
    ap.add_argument("--points", action="store_true",
                    help="store point clouds (PLY) at keyframes")
    ap.add_argument("--dontstoretiming", action="store_true")
    ap.add_argument("--viewer", "-v", action="store_true",
                    help="display loop (not ported: raises)")
    ap.add_argument("--device", default="cuda",
                    help="where the VO and the stereo matcher run (cuda, "
                         "or cpu for the plain versions)")
    args = ap.parse_args(argv)
    if args.viewer:
        raise NotImplementedError(VIEWER_MISSING)

    app = VoApp.from_config(
        args.config, device=args.device,
        trajectory_prefix=args.output,
        points_prefix=args.output if args.points else "",
        data_buffer_size=args.buffersize,
        max_num_frames=args.numframes,
        store_iteration_time=not args.dontstoretiming)
    result = app.run()
    debug.info("done: %d frames @ %.2f Hz", result.num_frames, result.mean_hz)
    return result


if __name__ == "__main__":
    main()
