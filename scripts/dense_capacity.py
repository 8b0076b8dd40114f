"""Count the pixels a dense configuration selects, frame by frame and level
by level, on a benchmark cell's seeded sequences, against the template
capacities a ``pointCapacity`` gives: the smallest power of two at which no
frame loses a selected pixel at any level.

    python3 scripts/dense_capacity.py --workload kitti00_dense.online_stereo \
        --seeds 1,2,3 [--out build/capacity.json]

on the card (each seed renders the cell's pool and matches every frame with
the configuration's ``TpuSGM``, as the benchmark's online driver does).  A
selected pixel is one the port's selection admits before its capacity cut
(``ops.selection.select_pixels`` at the level's whole image: saliency,
disparity range, border, no non-maxima suppression where the level is below
``minNumPixelsForNonMaximaSuppression``).  Prints one JSON object.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    from bpvo_tpu_torch.ops import descriptors, imgproc, pyramid, selection
    from bpvo_tpu_torch.vo import device_vo
    from vobench import bench, program
    from vobench.drivers.base import Pool
    ap = argparse.ArgumentParser(prog="dense_capacity")
    ap.add_argument("--workload", default="kitti00_dense.online_stereo")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    cell = bench.Cell(a.workload)
    cfg = cell.config
    p = program.algorithm_parameters(cfg["params"])
    sgm = program.matcher(cfg)
    rows, cols = cfg["camera"]["rows"], cfg["camera"]["cols"]
    shapes = pyramid.level_shapes(rows, cols, p.numPyramidLevels)
    most = [0] * len(shapes)
    per_seed = {}
    for seed in (int(s) for s in a.seeds.split(",")):
        pool = Pool(cell, seed, dev)
        seed_most = [0] * len(shapes)
        for f in range(pool.n_frames):
            left = pool.images[0, f]
            disp = torch.as_tensor(sgm.run(left, pool.rights[0, f],
                                           device=dev)).to(dev)
            chans = device_vo._compute_channels_pyr(left, p,
                                                    p.numPyramidLevels)
            for level, ch in enumerate(chans):
                d = imgproc.disparity_at_level(disp, level)
                d = d[:ch.shape[1], :ch.shape[2]]
                H, W = ch.shape[1:]
                sel = selection.select_pixels(
                    descriptors.saliency(ch), d, H * W,
                    min_saliency=p.minSaliency, nms_radius=p.nonMaxSuppRadius,
                    use_nms=H * W >= p.minNumPixelsForNonMaximaSuppression,
                    min_disparity=p.minValidDisparity,
                    max_disparity=p.maxValidDisparity,
                    border=max(p.nonMaxSuppRadius, 3))
                seed_most[level] = max(seed_most[level], int(sel.num_valid))
        per_seed[seed] = seed_most
        most = [max(x, y) for x, y in zip(most, seed_most)]
        print(f"seed {seed}: most selected per level {seed_most}",
              file=sys.stderr, flush=True)
    caps = {}
    for e in range(14, 21):
        pc = 1 << e
        caps[pc] = [selection.capacity_for_level(p.replace(pointCapacity=pc),
                                                 r, c, l)
                    for l, (r, c) in enumerate(shapes)]
    smallest = min(pc for pc, cap in caps.items()
                   if all(k >= m for k, m in zip(cap, most)))
    out = {"workload": a.workload, "device": str(dev),
           "level_shapes": shapes, "frames": pool.n_frames,
           "most_selected": most, "per_seed": per_seed,
           "capacities": caps, "smallest_power_of_two": smallest,
           "configured": p.pointCapacity}
    text = json.dumps(out)
    print(text, flush=True)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
