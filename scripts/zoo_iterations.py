"""The port's iterations per frame against the JAX package's, cell by cell,
on the option zoo's corridor (conf/eval_corridor.cfg at 240x320 cut to
chip_smoke.ZOO_FRAMES frames, every descriptor with GN and LM), read
against ``tests/data/torch_port_zoo_ref.npz``.

Runs ``apps.eval_descriptors`` on ``--device`` (the card by default; cpu
runs the plain versions) and prints one line per cell (the iterations of
each frame, the port's and JAX's, and the largest world-pose difference),
then per solver how many frames have equal, more or fewer iterations than
JAX's and the sums of the cells' means over frames 5-8 (as
``eval_descriptors`` averages them).  Cells in chip_smoke.ZOO_JAX_LEVEL_ROUTE
are read against JAX's level route.  Last line: one JSON object.

    python scripts/zoo_iterations.py [--device cpu] [--out build/zoo_iters]
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "zoo_iters"))
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from bpvo_tpu_torch.apps import eval_descriptors

    cs = _chip_smoke()
    cfg = cs.write_zoo_configs(args.out, os.path.join(args.out, "unused"))[0]
    ref = dict(np.load(cs.REF_ZOO_NPZ))
    traj = {}
    eval_descriptors.run(cfg, os.path.join(args.out, "eval"), -1, None,
                         cs.ZOO_SOLVERS, device=args.device,
                         trajectories=traj)
    summary = {s: {"equal": 0, "more": 0, "fewer": 0, "port": 0.0,
                   "jax": 0.0} for s in cs.ZOO_SOLVERS}
    cells = {}
    for desc in cs.ZOO_DESCRIPTORS:
        for solver in cs.ZOO_SOLVERS:
            tag, key = f"{desc}+{solver}", f"{desc}_{solver}"
            if tag in cs.ZOO_JAX_LEVEL_ROUTE:
                key += "_level"
            got = np.loadtxt(os.path.join(args.out, "eval",
                                          f"{tag}_iterations.txt"),
                             dtype=np.int64)
            want = ref[f"{key}_iters"].astype(np.int64)
            err = float(np.abs(traj[tag] - ref[f"{key}_world"]).max())
            d = got[1:] - want[1:]
            row = summary[solver]
            row["equal"] += int((d == 0).sum())
            row["more"] += int((d > 0).sum())
            row["fewer"] += int((d < 0).sum())
            row["port"] += float(got[5:].mean())
            row["jax"] += float(want[5:].mean())
            cells[tag] = {"port": got.tolist(), "jax": want.tolist(),
                          "max_pose_diff": err}
            print(f"{tag:40s} port {got.tolist()}  JAX {want.tolist()}  "
                  f"max |pose - JAX| {err:.3e}")
    for solver, row in summary.items():
        print(f"{solver}: frames with equal / more / fewer iterations than "
              f"JAX's {row['equal']} / {row['more']} / {row['fewer']}; "
              f"iterations per frame summed over the cells {row['port']:.2f}"
              f" (JAX {row['jax']:.2f})")
    print(json.dumps({"device": args.device, "summary": summary,
                      "cells": cells}))


if __name__ == "__main__":
    main()
