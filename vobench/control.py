"""The control of the comparison: the plain reference put in the program's
place and computed in the next precision below the configuration's
(bfloat16 for float32: every tensor, and the host's pose arithmetic
rounded to it), which the check has to find not correct.

``ControlVO`` stands in for ``DeviceVO`` (``init``, ``add_frames``,
``state.templates``), ``ControlOdometry`` for ``VisualOdometry``
(``add_frame``) and ``ControlMatcher`` for ``TpuSGM`` (``run``); each
makes its own decisions and keeps its own state.

On the card, at a cell's own sizes, a dozen seeds or more in one process:

    python3 -m vobench.control --workload <cell> --seeds 1,2,3 \
        --seconds 1 [--program]

prints each seed's compared numbers; ``--program`` runs the program
instead (its sound readings, the lower ends of the limits).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from vobench import bench
from vobench.reference import geometry
from vobench.reference import sgm as ref_sgm
from vobench.reference import vo as ref_vo

CONTROL_DTYPE = torch.bfloat16


class _Store(ref_vo.Frames):
    """Frames by the order they arrive."""

    def __init__(self):
        super().__init__({}, {})

    def add(self, image, aux) -> int:
        i = len(self.images)
        self.images[i], self.auxs[i] = image, aux
        return i


def _reference(cell, store, stereo: bool, min_points: int):
    from vobench import check
    ref = check.reference(cell.config, None, None, stereo, min_points,
                          CONTROL_DTYPE)
    ref.frames = store
    return ref


class _Stepper:
    """The reference's own VO over arriving frames."""

    def __init__(self, ref):
        self.ref = ref
        self.store = ref.frames

    def first(self, image, aux):
        f = self.store.add(image, aux)
        self.st = (f, np.eye(4), False, None)
        self.world = np.eye(4)

    def next(self, image, aux):
        f = self.store.add(image, aux)
        kf_src, T_kf, has_prev, prev = self.st
        est = self.ref.front(f, kf_src, T_kf)
        reason = ref_vo.keyframe_reason(est.T, est.frac, self.ref.p)
        is_kf = reason != ref_vo.KF_NONE
        r = self.ref.step(f, kf_src, T_kf, has_prev, prev, is_kf,
                          (0.0, 0.0, 0.0), est)
        self.world = ref_vo.quantize(self.world @ geometry.inv_np(r.pose),
                                     CONTROL_DTYPE)
        self.st = ref_vo.advance(kf_src, T_kf, has_prev, prev, f, r.pose,
                                 is_kf)
        return r, is_kf, est


class ControlVO(_Stepper):
    """``DeviceVO``'s interface over the control."""

    def __init__(self, cell, stereo: bool):
        super().__init__(_reference(cell, _Store(), stereo, int(
            cell.config["params"]["minNumPixelsToWork"])))

    def init(self, image, aux):
        self.first(image, aux)

    def add_frames(self, images, auxs):
        rows = {k: [] for k in ("pose", "pose_world", "is_keyframe",
                                "reason", "frac_good", "iters")}
        for im, ax in zip(images, auxs):
            r, is_kf, est = self.next(im, ax)
            rows["pose"].append(torch.as_tensor(r.pose, dtype=torch.float32))
            rows["pose_world"].append(torch.as_tensor(self.world,
                                                      dtype=torch.float32))
            rows["is_keyframe"].append(torch.tensor(is_kf))
            rows["reason"].append(torch.tensor(r.reason))
            rows["frac_good"].append(torch.tensor(est.frac))
            rows["iters"].append(torch.tensor(est.iters))
        return SimpleNamespace(**{k: torch.stack(v) for k, v in rows.items()})

    @property
    def state(self):
        tms = self.ref.templates(self.st[0])
        return SimpleNamespace(templates=[SimpleNamespace(
            rows=t.rows, cols=t.cols, points=t.points,
            valid=torch.ones(t.n, dtype=torch.bool)) for t in tms])


class ControlOdometry(_Stepper):
    """``VisualOdometry``'s interface over the control (disparity in)."""

    def __init__(self, cell):
        super().__init__(_reference(cell, _Store(), False,
                                    ref_vo.MIN_POINTS_VISUAL_ODOMETRY))
        self._started = False

    def add_frame(self, image, disparity):
        d = torch.as_tensor(disparity).to(image.device)
        if not self._started:
            self._started = True
            self.first(image, d)
            return SimpleNamespace(pose=np.eye(4), is_keyframe=True)
        r, is_kf, _ = self.next(image, d)
        return SimpleNamespace(pose=r.pose, is_keyframe=is_kf)


class ControlMatcher:
    """``TpuSGM.run``'s interface over the reference matcher."""

    def __init__(self, cell):
        self.m = cell.config["matcher"]

    def run(self, left, right, device=None):
        return ref_sgm.sgm(left, right, self.m["num_disparities"],
                           self.m["p1"], self.m["p2"],
                           CONTROL_DTYPE).cpu().numpy()


def put_in_place(drv) -> None:
    """Replace the driver's program by the control (before its set-up)."""
    cell = drv.cell
    if cell.mix["driver"] == "reprocess":
        drv.vo = ControlVO(cell, drv.pool.stereo)
        drv.n_levels = int(cell.config["params"]["numPyramidLevels"])
    else:
        drv.vo, drv.sgm = ControlOdometry(cell), ControlMatcher(cell)
        drv._frame(None)     # the first frame


def main(argv=None) -> int:
    from vobench import run
    ap = argparse.ArgumentParser(prog="vobench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--program", action="store_true")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        bench.log("vobench.control: no CUDA device")
        return 2
    cell = bench.Cell(a.workload)
    for seed in (int(s) for s in a.seeds.split(",")):
        args = argparse.Namespace(workload=a.workload, seed=seed,
                                  seconds=a.seconds, trace=0)
        t0 = time.perf_counter()
        out = run.run_cell(args, cell=cell, setup=None if a.program
                           else put_in_place)
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "program": a.program, "correct": out["correct"],
                          "attempted": out["attempted"],
                          "checks": out["checks"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
