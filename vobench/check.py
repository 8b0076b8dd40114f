"""The comparison that decides ``correct``: the program's outputs from the
timed path, at the timed sizes, against the plain reference
(``vobench.reference``), which works out again from the rendered frames
what the program derived from them.

The reference follows the program step by step.  A VO step depends on
the state before it (the keyframe, the keyframe -> last frame pose, the
candidate); that state is a function of the program's own earlier outputs
(each step's pose and keyframe decision, ``reference.vo.advance``), so for
each sampled step the reference takes it from them and recomputes the
step: the frame's descriptor pyramid, the keyframe's template (its own
matcher's disparity with stereo input), the coarse-to-fine estimate, the
keyframe decision and, when the program made a keyframe, the re-estimate
against the candidate.  What that skips, the state update, is checked by
itself: each world pose against the product of the step poses, and, for
``DeviceVO``, the templates of the final state against the reference's
build for the keyframe the outputs name.

The numbers compared, each against its limit in ``limits/<cell>.json``:

- ``pose_err``: the largest |log(pose · pose_ref^-1)| over the sampled
  steps (the twist norm, radians and metres together);
- ``kf_mismatch``: sampled steps whose keyframe decision differs from the
  reference's, where the reference's stands clear of its thresholds by
  more than the limits' ``bands`` (a decision within them is a tie that
  rounding may flip, and is not counted);
- ``world_err``: the largest gap between a world pose and the product of
  the step poses before it, in one sequence run (``DeviceVO``);
- ``tmpl_mismatch``: the share of the final keyframe template's points,
  all levels, that are not the reference's selection (``DeviceVO``);
- ``depth_gap``: the largest relative depth gap of the points both
  select;
- ``disp_bad``: the share of pixels where the program's disparity and the
  reference matcher's differ by more than half a pixel or in validity, on
  the keyframes of the sampled steps (online stereo).
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from vobench.reference import geometry
from vobench.reference import vo as ref_vo

DISP_TOL_PX = 0.5


def reference(cfg: Dict, images, auxs, stereo: bool, min_points: int,
              dtype=torch.float32) -> ref_vo.Reference:
    c = cfg["camera"]
    cam = ref_vo.Camera(float(np.float32(c["fx"])), float(np.float32(c["fx"])),
                        c["cols"] / 2.0, c["rows"] / 2.0,
                        float(np.float32(c["baseline"])))
    return ref_vo.Reference(ref_vo.Params.from_config(cfg["params"]), cam,
                            ref_vo.Frames(images, auxs),
                            cfg["matcher"] if stereo else None,
                            min_points=min_points, dtype=dtype)


def steps_of(frames: List[int], poses, is_kf) -> List[Dict]:
    """The program's state before each step, from its outputs: ``frames``
    the frame of each position (the first initializes), ``poses`` and
    ``is_kf`` the outputs of the later ones."""
    kf_src, T_kf, has_prev, prev = frames[0], np.eye(4), False, None
    out = []
    for f, pose, kf in zip(frames[1:], poses, is_kf):
        out.append({"frame": f, "kf_src": kf_src, "T_kf": T_kf,
                    "has_prev": has_prev, "prev": prev,
                    "pose": np.asarray(pose, np.float64), "is_kf": bool(kf)})
        kf_src, T_kf, has_prev, prev = ref_vo.advance(
            kf_src, T_kf, has_prev, prev, f, pose, bool(kf))
    return out


def sample(rng, candidates: List[int], steps: List[Dict], n: int):
    """``n`` of the ``candidates`` (indices into ``steps``), drawn from
    ``rng``: keyframe steps and others half and half where both are
    there."""
    kf = [i for i in candidates if steps[i]["is_kf"]]
    other = [i for i in candidates if not steps[i]["is_kf"]]
    n_kf = min(len(kf), max(n // 2, n - len(other)))
    pick = list(rng.choice(kf, n_kf, replace=False)) if n_kf else []
    n_other = min(len(other), n - n_kf)
    pick += list(rng.choice(other, n_other, replace=False)) if n_other \
        else []
    return sorted(int(i) for i in pick)


def judge_steps(ref: ref_vo.Reference, steps: List[Dict], chosen: List[int],
                bands) -> Dict:
    pose_err, mismatch, n_clear, detail = 0.0, 0, 0, []
    for i in chosen:
        s = steps[i]
        r = ref.step(s["frame"], s["kf_src"], s["T_kf"], s["has_prev"],
                     s["prev"], s["is_kf"], bands)
        gap = geometry.pose_gap(s["pose"], r.pose) \
            if np.isfinite(s["pose"]).all() else math.inf
        pose_err = max(pose_err, gap)
        differ = (r.reason != ref_vo.KF_NONE) != s["is_kf"]
        if r.clear:
            n_clear += 1
            mismatch += int(differ)
        if differ:
            t, rot, frac = ref_vo.keyframe_quantities(r.T_est, r.frac, ref.p)
            detail.append({"step": i, "clear": r.clear, "program": s["is_kf"],
                           "t": t, "rot": rot, "frac": frac})
    return {"pose_err": pose_err, "kf_mismatch": mismatch,
            "kf_clear": n_clear, "sampled": len(chosen),
            "kf_differ": detail}


def gt_err(steps: List[Dict], gt_step: np.ndarray, forward) -> float:
    """The largest gap between a step's pose and the scene's true motion
    (``forward(i)``: the step moves forward along the sequence)."""
    inv = geometry.inv_np(gt_step)
    return max((geometry.pose_gap(s["pose"], gt_step if forward(i) else inv)
                for i, s in enumerate(steps)), default=0.0)


def world_err(run: Dict) -> float:
    W = np.eye(4)
    err = 0.0
    for pose, world in zip(run["pose"], run["pose_world"]):
        W = W @ geometry.inv_np(pose)
        err = max(err, geometry.pose_gap(world, W))
    return err


def template_gaps(ref: ref_vo.Reference, kf_src: int, prog: List[Dict],
                  cols_at) -> Dict:
    """The final state's templates against the reference's build of the
    keyframe ``kf_src``: selection share and depth gap, all levels."""
    tms = ref.templates(kf_src)
    miss, total, depth = 0, 0, 0.0
    for level, (tm, pt) in enumerate(zip(tms, prog)):
        W = cols_at(level)
        v = pt["valid"]
        p_idx = pt["rows"][v].astype(np.int64) * W + pt["cols"][v]
        r_idx = (tm.rows * W + tm.cols).cpu().numpy()
        r_Z = tm.points[:, 2].cpu().numpy().astype(np.float64)
        common, pi, ri = np.intersect1d(p_idx, r_idx, return_indices=True)
        miss += len(p_idx) + len(r_idx) - 2 * len(common)
        total += max(len(r_idx), 1)
        if len(common):
            Zp = pt["Z"][v][pi].astype(np.float64)
            depth = max(depth, float(np.max(np.abs(Zp - r_Z[ri])
                                            / r_Z[ri])))
    return {"tmpl_mismatch": miss / total, "depth_gap": depth}


def judge_reprocess(cell, pool, data: Dict, seed: int,
                    n_window_runs: int) -> Dict:
    cfg, limits = cell.config, cell.limits
    rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), 0x636B])
    min_points = int(cfg["params"]["minNumPixelsToWork"])
    runs = data["runs"]
    pick = int(rng.integers(n_window_runs))
    run = runs[pick]
    s = run["seq"]
    n = len(run["pose"])
    steps = steps_of(list(range(n + 1)), run["pose"], run["is_keyframe"])
    ref = reference(cfg, pool.images[s], pool.aux(s), pool.stereo,
                    min_points)
    chosen = sample(rng, list(range(n)), steps,
                    int(cell.mix["check_frames"]))
    out = judge_steps(ref, steps, chosen, limits.get("bands", (0, 0, 0)))
    out["world_err"] = world_err(run)
    out["gt_err"] = gt_err(steps, pool.gt_step(), lambda i: True)
    last = runs[-1]
    last_steps = steps_of(list(range(len(last["pose"]) + 1)), last["pose"],
                          last["is_keyframe"])
    st = last_steps[-1]
    kf_src = ref_vo.advance(st["kf_src"], st["T_kf"], st["has_prev"],
                            st["prev"], st["frame"], st["pose"],
                            st["is_kf"])[0]
    if last["seq"] != s:
        ref = reference(cfg, pool.images[last["seq"]],
                        pool.aux(last["seq"]), pool.stereo, min_points)
    cols = cfg["camera"]["cols"]
    out.update(template_gaps(ref, kf_src, data["templates"],
                             lambda l: -(-cols // (1 << l))))
    out["run"] = pick
    return out


def judge_online(cell, pool, data: Dict, seed: int) -> Dict:
    cfg, limits = cell.config, cell.limits
    rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), 0x636B])
    stream = data["stream"]
    frames = [x["frame"] for x in stream]
    steps = steps_of(frames, [x["pose"] for x in stream[1:]],
                     [x["is_kf"] for x in stream[1:]])
    lo, hi = data["window"]
    ref = reference(cfg, pool.images[0], pool.rights[0], True,
                    ref_vo.MIN_POINTS_VISUAL_ODOMETRY)
    chosen = sample(rng, list(range(lo - 1, hi - 1)), steps,
                    int(cell.mix["check_frames"]))
    out = judge_steps(ref, steps, chosen, limits.get("bands", (0, 0, 0)))
    last = pool.n_frames - 1
    out["gt_err"] = gt_err(steps, pool.gt_step(),
                           lambda i: 0 < (i + 1) % (2 * last) <= last)
    bad, total = 0, 0
    for f in sorted({steps[i]["kf_src"] for i in chosen}):
        d_ref = ref.disparity(f).cpu().numpy()
        d = np.asarray(data["disparities"][f])
        ok_r, ok_p = d_ref >= 0, d >= 0
        bad += int(np.sum((ok_r != ok_p)
                          | (ok_r & ok_p & (np.abs(d - d_ref) > DISP_TOL_PX))))
        total += d.size
    out["disp_bad"] = bad / max(total, 1)
    return out


def verdict(numbers: Dict, limits: Dict, failed: int):
    """(correct, {name: {"value", "limit"}}): every number that has a limit
    at or under it, ``pose_err`` among them, and no failed frame."""
    checks = {k: {"value": numbers[k], "limit": limits[k]}
              for k in ("pose_err", "kf_mismatch", "world_err",
                        "tmpl_mismatch", "depth_gap", "disp_bad")
              if k in numbers and k in limits}
    ok = ("pose_err" in checks and failed == 0
          and all(c["value"] <= c["limit"] for c in checks.values()))
    checks["failed_frames"] = {"value": failed, "limit": 0}
    return ok, checks
