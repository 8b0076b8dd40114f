"""Smoke run of the PyTorch/CUDA port (``bpvo_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the hand-written CUDA kernels from ``bpvo_tpu_torch/csrc`` (one
   nvcc per source, in parallel; ``-Xptxas -v`` output printed).
2. Intensity kernel phase: templates from frame 0 of the synthetic 376x1241
   KITTI-shape sequence, target frame 1; at each of the 4 bench pyramid
   levels (K = 16384/4096/1024/512) the ``level_gn`` CUDA kernel and its plain
   PyTorch version run on the same device tensors and must agree: after one
   iteration, sigma, H and g at rtol 1e-3 and the weights at atol 1e-3;
   converged, the pose at atol 1e-4, equal iterations and status, sigma and
   H at rtol 1e-2.  Both are timed with CUDA events.
3. Intensity VO phase: ``DeviceVO(device="cuda")`` over 1+30 frames with
   bench.py's intensity settings.  Every pose must be finite, within the
   ground-truth bound of the known per-frame motion, and within atol 5e-4 of
   the JAX package's poses (tests/data/torch_port_bench_ref.npz), with the
   same keyframes and per-level iterations within 1 of the reference's; the
   kernel's launch count must equal the number of level solves run.
4. Stereo kernel phase, on frame 0 of the stereo pair of the same scene:
   the ``census_planes`` kernel against its plain version at 376x1241 and
   the SGM aggregation kernel against its plain version on that pair's
   376x1241x128 census cost volume with conf/kitti_bitplanes.cfg's
   penalties, both bit for bit; the matcher's frame-0 disparity must have
   the JAX reference's valid count and mean |d - GT|; the share of census
   bits that flip between the card's Bit-Planes pyramid and the CPU's
   stays under FLIP_BOUND.
5. Bit-Planes kernel phase: ``level_gn`` at C=8 against its plain version at
   the 4 Bit-Planes level shapes, with the tolerances of phase 2.
6. Stereo Bit-Planes VO phase: ``DeviceVO(device="cuda",
   stereo_fn=TpuSGM(cf).as_fn())`` with conf/kitti_bitplanes.cfg's VO and
   matcher settings over 1+30 stereo pairs.  Poses finite, within the JAX
   run's own ground-truth error plus GT_MARGIN_STEREO, within
   T_ATOL_JAX_STEREO of the JAX reference
   (tests/data/torch_port_bitplanes_sgm_ref.npz), the same keyframe frames;
   launches: census = levels x frames + 2 per matcher call, sgm = one per
   matcher call, level_gn = the level solves.

Any failure exits non-zero.  The line before the last is a JSON object with
the kernels' launches (summed over the VO phases that run each), errors and
CUDA-event times (mean ms per call through the wrapper; for census, whose
wrapper costs more host time than the kernel device time, back-to-back
launches of its C entry point); the last line is {"ok": true, "device": {...}}.  Without a CUDA
device, or without the package beside this script, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REF_NPZ = os.path.join(HERE, "tests", "data", "torch_port_bench_ref.npz")
REF_STEREO_NPZ = os.path.join(HERE, "tests", "data",
                              "torch_port_bitplanes_sgm_ref.npz")
CONF = os.path.join(HERE, "conf", "kitti_bitplanes.cfg")
N_STEPS = 30
T_ATOL_KERNEL = 1e-4     # kernel vs plain version, same inputs, same device
CONV_RTOL = 1e-2         # converged sigma and H, kernel vs plain version
LIN_RTOL = 1e-3          # first linearization's sigma, H, g (one iteration)
LIN_W_ATOL = 1e-3        # and its IRLS weights
T_ATOL_JAX = 5e-4        # port vs JAX reference (bisection vs histogram median)
ITERS_TOL_JAX = 1        # per-level GN iterations, port vs JAX reference
GT_MARGIN = 5e-4         # ground-truth bound = JAX's own worst error + this
# stereo Bit-Planes vs the JAX CPU route (histogram median, other per-level
# iteration counts, ROADMAP C.2): the JAX package's own two routes differ by
# 3.2e-3 on the first step of the 120x160 stereo Bit-Planes run, while the
# port follows JAX's level-kernel route there to 6.3e-6
# (tests/test_torch_stereo.py); port vs the CPU route here: 2.3e-3
T_ATOL_JAX_STEREO = 5e-3
GT_MARGIN_STEREO = 1e-3
# frame-0 disparity vs the JAX reference: the same images and exact integer
# SGM, so equal up to census ties flipped by a 1-ulp difference in rendering
DISP_VALID_RTOL = 1e-4
DISP_ERR_RTOL = 1e-3
FLIP_BOUND = 2e-3        # census bits flipped, card vs CPU Bit-Planes pyramid
KERNEL_REPS, PLAIN_REPS = 50, 3
SGM_REPS, SGM_PLAIN_REPS = 10, 1


def _require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def _cuda_ms(fn, reps):
    """Mean ms per call of fn() by CUDA events, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _rel(a, b):
    """max |a - b| / max |b|."""
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _reset_counts():
    from bpvo_tpu_torch.ops import census, level_gn, sgm
    level_gn.launch_count = census.launch_count = sgm.launch_count = 0


def _counts():
    from bpvo_tpu_torch.ops import census, level_gn, sgm
    return {"level_gn": level_gn.launch_count,
            "census_planes": census.launch_count,
            "sgm_aggregate": sgm.launch_count}


def _first_linearization(args, level):
    """One iteration of kernel and plain version: the first linearization's
    sigma, weights (Tukey/Huber at level 0, Huber above) and normal
    equations must agree tightly, since a converged pose hides weighting
    errors."""
    import dataclasses
    from bpvo_tpu_torch.ops import level_gn as lg
    args = args[:-1] + (dataclasses.replace(args[-1], max_iterations=1),)
    _, sk, Hk, gk, wk, _ = lg.level_gn(*args)
    _, sp, Hp, gp, wp, _ = lg.level_gn_reference(*args)
    d_sigma = abs(sk[4].item() - sp[4].item()) / abs(sp[4].item())
    dH, dg = _rel(Hk, Hp), _rel(gk, gp)
    dw = float((wk - wp).abs().max())
    print(f"level {level} one iteration: rel|dsigma|={d_sigma:.3e} "
          f"rel|dH|={dH:.3e} rel|dg|={dg:.3e} max|dw|={dw:.3e}")
    _require(d_sigma <= LIN_RTOL and dH <= LIN_RTOL and dg <= LIN_RTOL
             and dw <= LIN_W_ATOL,
             f"level {level}: first linearization differs (sigma {d_sigma}, "
             f"H {dH}, g {dg}, w {dw})")


def kernel_phase(vo, init_pair, target, dev):
    """level_gn kernel vs plain version at the 4 level shapes of ``vo``:
    templates of ``init_pair`` (image, disparity or right image), channels
    of the ``target`` image."""
    import torch
    from bpvo_tpu_torch.ops import level_gn as lg
    from bpvo_tpu_torch.vo import device_vo

    vo.init(*init_pair)
    templates = vo.state.templates
    channels = device_vo._compute_channels_pyr(
        torch.as_tensor(target).to(dev), vo._p, vo._p.numPyramidLevels)
    T0 = torch.eye(4, dtype=torch.float32, device=dev)
    max_err, ms, plain_ms = 0.0, 0.0, 0.0
    for level, (td, ch) in enumerate(zip(templates, channels)):
        args = (vo._cams[level], td.points, td.valid, td.pixels,
                td.jacobians, ch, T0, 1.0, 1e10, td.norm_scale,
                td.norm_center, vo._opts[level])
        _first_linearization(args, level)
        Tk, sk, Hk, gk, wk, _ = lg.level_gn(*args)
        Tp, sp, Hp, gp, wp, _ = lg.level_gn_reference(*args)
        torch.cuda.synchronize()
        err = float((Tk - Tp).abs().max())
        dH = _rel(Hk, Hp)
        t_k = _cuda_ms(lambda: lg.level_gn(*args), KERNEL_REPS)
        t_p = _cuda_ms(lambda: lg.level_gn_reference(*args), PLAIN_REPS)
        sk, sp = sk.tolist(), sp.tolist()
        d_sigma = abs(sk[4] - sp[4]) / abs(sp[4])
        print(f"level {level} C={ch.shape[0]} {tuple(ch.shape[1:])} "
              f"K={td.points.shape[0]}: "
              f"max|dT|={err:.3e} iters {sk[0]:.0f}/{sp[0]:.0f} "
              f"status {sk[3]:.0f}/{sp[3]:.0f} sigma {sk[4]:.6g}/{sp[4]:.6g} "
              f"rel|dH|={dH:.3e} max|dw|={float((wk - wp).abs().max()):.3e} "
              f"kernel {t_k:.4f} ms plain {t_p:.4f} ms")
        _require(not any(map(math.isnan, sk)), f"level {level}: NaN stats")
        _require(err <= T_ATOL_KERNEL,
                 f"level {level}: kernel vs plain pose differs by {err}")
        _require(sk[0] == sp[0], f"level {level}: iters {sk[0]} vs {sp[0]}")
        _require(sk[3] == sp[3], f"level {level}: status {sk[3]} vs {sp[3]}")
        _require(d_sigma <= CONV_RTOL,
                 f"level {level}: sigma {sk[4]} vs {sp[4]}")
        _require(dH <= CONV_RTOL, f"level {level}: rel|dH| {dH}")
        max_err = max(max_err, err)
        ms += t_k
        plain_ms += t_p
    return max_err, ms, plain_ms


def _run_vo(vo, images, auxs):
    """One pass over the frames from a fresh state; returns the step
    outputs and the per-step host times (ms, each ending in a sync)."""
    import torch
    vo.state = None
    vo.add_frame(images[0], auxs[0])
    outs, t_frames = [], []
    for image, aux in zip(images[1:], auxs[1:]):
        t0 = time.perf_counter()
        outs.append(vo.add_frame(image, aux))
        torch.cuda.synchronize()
        t_frames.append((time.perf_counter() - t0) * 1e3)
    return outs, t_frames


def vo_phase(vo, frames, dev, ref, name, t_atol, gt_margin, check_iters):
    """DeviceVO over 1+N_STEPS frames ((image, aux) pairs), once to warm up,
    then the counted and timed run that is checked against ``ref``.
    Returns (launch counts of the counted run, outputs, frames/s, p50)."""
    import numpy as np
    import torch
    from bpvo_tpu_torch.core import se3
    from bpvo_tpu_torch.data import synthetic

    p = vo._p
    images = [torch.as_tensor(f[0]).to(dev) for f in frames]
    auxs = [torch.as_tensor(f[1]).to(dev) for f in frames]
    torch.cuda.synchronize()
    _run_vo(vo, images, auxs)       # warm-up: first-use costs of each op
    _reset_counts()
    outs, t_frames = _run_vo(vo, images, auxs)
    counts = _counts()

    poses = np.stack([o.pose.cpu().numpy() for o in outs])
    kf = np.array([bool(o.is_keyframe) for o in outs])
    iters = np.stack([o.iters.cpu().numpy() for o in outs])
    step_inv = torch.as_tensor(np.linalg.inv(synthetic.step_pose()),
                               dtype=torch.float32)
    gt_err = np.array([float(se3.log(torch.as_tensor(P) @ step_inv)
                             .abs().max()) for P in poses])
    jax_err = float(np.abs(poses - ref["poses"]).max())
    d_iters = int(np.abs(iters.astype(np.int64) - ref["iters"]).max())
    kf_same = np.array_equal(kf, ref["is_keyframe"])
    bound = float(ref["gt_err"].max()) + gt_margin
    levels_main = p.numPyramidLevels - p.maxTestLevel
    start2 = min(max(p.keyframeReestimateStartLevel, p.maxTestLevel),
                 p.numPyramidLevels - 1)
    solves = (len(outs) * levels_main
              + int(kf.sum()) * (start2 - p.maxTestLevel + 1))
    print(f"{name}: {len(outs)} steps, {int(kf.sum())} keyframes "
          f"(JAX {int(ref['is_keyframe'].sum())}, same frames: {kf_same}), "
          f"iters/frame {iters.sum(1).mean():.2f} "
          f"(JAX {ref['iters'].sum(1).mean():.2f}), max per-level "
          f"|iters - JAX iters| {d_iters}")
    print(f"{name}: max GT error {gt_err.max():.3e} (bound {bound:.3e}), "
          f"max |pose - JAX pose| {jax_err:.3e} (atol {t_atol})")
    print(f"{name}: per step |pose - JAX pose| " + " ".join(
        f"{e:.1e}" for e in np.abs(poses - ref["poses"]).max((1, 2))))
    print(f"{name}: launches {counts}, level solves {solves}")
    fps = len(outs) / (sum(t_frames) / 1e3)
    p50 = float(np.percentile(t_frames, 50))
    p90 = float(np.percentile(t_frames, 90))
    t_arr = np.array(t_frames)
    split = "".join(f"; {label} p50 {np.percentile(t_arr[sel], 50):.3f}"
                    for label, sel in (("keyframe steps", kf),
                                       ("others", ~kf)) if sel.any())
    print(f"{name}: {fps:.2f} frames/s, per-frame ms p50 {p50:.3f} "
          f"p90 {p90:.3f} max {t_arr.max():.3f}" + split)
    _require(np.all(np.isfinite(poses)), f"{name}: non-finite pose")
    _require(gt_err.max() <= bound, f"{name}: GT error {gt_err.max()} > "
                                    f"{bound}")
    _require(jax_err <= t_atol, f"{name}: poses differ from JAX by {jax_err}")
    _require(kf_same, f"{name}: keyframes {np.flatnonzero(kf)} vs JAX "
                      f"{np.flatnonzero(ref['is_keyframe'])}")
    if check_iters:
        _require(d_iters <= ITERS_TOL_JAX,
                 f"{name}: per-level iterations differ from JAX by {d_iters}")
    _require(counts["level_gn"] > 0 and counts["level_gn"] == solves,
             f"{name}: level_gn launched {counts['level_gn']} times for "
             f"{solves} level solves")
    return counts, kf, fps, p50


def census_phase(left, dev):
    """census kernel vs plain version on one 376x1241 frame, bit for bit."""
    import torch
    from bpvo_tpu_torch.ops import census
    x = torch.as_tensor(left).to(dev)
    got = census.census_planes(x)
    want = census.census_planes_reference(x)
    torch.cuda.synchronize()
    n_diff = int((got != want).sum())
    # the wrapper's Python work (~tens of us) exceeds the kernel's, so the
    # kernel is also timed by back-to-back launches of its C entry point
    import ctypes
    from bpvo_tpu_torch.ops import _build
    lib, ptr = _build.library(), ctypes.c_void_p
    out = torch.empty_like(got)
    stream = ptr(torch.cuda.current_stream(dev).cuda_stream)
    H, W = x.shape
    t_raw = _cuda_ms(lambda: lib.bpvo_census_planes(
        ptr(x.data_ptr()), ptr(out.data_ptr()), H, W, stream), KERNEL_REPS)
    t_k = _cuda_ms(lambda: census.census_planes(x), KERNEL_REPS)
    t_p = _cuda_ms(lambda: census.census_planes_reference(x), KERNEL_REPS)
    _require(torch.equal(out, got), "census: raw launches differ")
    print(f"census {tuple(x.shape)} -> {tuple(got.shape)}: {n_diff} bits "
          f"differ, kernel {t_raw:.4f} ms (through the wrapper {t_k:.4f} "
          f"ms) plain {t_p:.4f} ms")
    _require(n_diff == 0 and got.shape == (8,) + tuple(x.shape),
             f"census kernel differs from its plain version in {n_diff} bits")
    return float((got - want).abs().max()), t_raw, t_p


def sgm_phase(pair, matcher, dev, ref):
    """SGM aggregation kernel vs plain version on the pair's census cost
    volume, bit for bit, and the matcher's frame-0 disparity vs JAX's."""
    import numpy as np
    import torch
    from bpvo_tpu_torch.data import stereo
    from bpvo_tpu_torch.ops import census, sgm
    left, right, gt = (torch.as_tensor(a).to(dev) for a in pair)
    p1, p2, D = matcher.p1, matcher.p2, matcher.num_disparities
    codes = census.census(torch.stack([left, right]))
    cost = stereo.census_cost_volume(codes[0], codes[1], D)
    got = sgm.aggregate_4dir(cost, p1, p2)
    want = sgm.aggregate_4dir_reference(cost, p1, p2)
    one = sgm.aggregate_direction(cost, p1, p2)
    one_want = sgm.aggregate_direction_reference(cost, p1, p2)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    n_diff = int((got != want).sum()) + int((one != one_want).sum())
    t_k = _cuda_ms(lambda: sgm.aggregate_4dir(cost, p1, p2), SGM_REPS)
    t_p = _cuda_ms(lambda: sgm.aggregate_4dir_reference(cost, p1, p2),
                   SGM_PLAIN_REPS)
    print(f"sgm {tuple(cost.shape)} p1={p1} p2={p2}: {n_diff} values differ "
          f"(max |d| {err:.3e}), kernel {t_k:.4f} ms plain {t_p:.4f} ms")
    _require(n_diff == 0, f"sgm kernel differs from its plain version in "
                          f"{n_diff} values (max {err})")
    t_m = _cuda_ms(lambda: matcher.as_fn()(left, right), SGM_REPS)
    disp = matcher.as_fn()(left, right)
    valid = disp > 0
    n_valid = int(valid.sum())
    mae = float((disp - gt).abs()[valid].mean())
    want_n, want_mae = int(ref["disp0_valid"]), float(ref["disp0_mean_abs_err"])
    print(f"matcher frame 0: {n_valid} valid (JAX {want_n}), mean |d - GT| "
          f"{mae:.6f} (JAX {want_mae:.6f}), {t_m:.4f} ms per call")
    _require(abs(n_valid - want_n) <= DISP_VALID_RTOL * want_n,
             f"disparity valid count {n_valid} vs JAX {want_n}")
    _require(abs(mae - want_mae) <= DISP_ERR_RTOL * want_mae,
             f"disparity mean |d - GT| {mae} vs JAX {want_mae}")
    del cost, got, want, one, one_want
    return err, t_k, t_p


def flip_phase(vo, image, dev):
    """Share of census bits that differ between the Bit-Planes pyramid on
    the card and on the CPU (their pyr_down round differently)."""
    import torch
    from bpvo_tpu_torch.ops import census, imgproc
    p = vo._p
    gpu, cpu = torch.as_tensor(image).to(dev), torch.as_tensor(image)
    flips = total = 0
    for level in range(p.numPyramidLevels):
        a = census.census_planes(imgproc.imsmooth(
            gpu, p.sigmaPriorToCensusTransform, ksize=3)).cpu()
        b = census.census_planes(imgproc.imsmooth(
            cpu, p.sigmaPriorToCensusTransform, ksize=3))
        flips += int((a != b).sum())
        total += b.numel()
        gpu, cpu = imgproc.pyr_down(gpu), imgproc.pyr_down(cpu)
    print(f"census bits flipped, card vs CPU pyramid: {flips} of {total} "
          f"({flips / total:.3e}, bound {FLIP_BOUND})")
    _require(flips / total <= FLIP_BOUND, f"census flips {flips}/{total}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import numpy as np
    from bpvo_tpu_torch import AlgorithmParameters, ConfigFile, DescriptorType
    from bpvo_tpu_torch.data import stereo, synthetic
    from bpvo_tpu_torch.ops import _build
    from bpvo_tpu_torch.vo.device_vo import DeviceVO

    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    t0 = time.perf_counter()
    log = _build.compile_library()
    print(f"build {time.perf_counter() - t0:.1f} s -> {_build.library_path()}")
    print(log.strip() or "(library already built)")
    _build.library()

    dev = torch.device("cuda", 0)
    shape = (synthetic.ROWS, synthetic.COLS)

    # the bench sequence as stereo pairs; its left images and disparities
    # are synthesize_sequence's
    K, baseline, sframes = synthetic.synthesize_stereo_sequence(1 + N_STEPS)
    frames = [(left, disp) for left, _, disp in sframes]

    # intensity: the bench's main path
    ref = dict(np.load(REF_NPZ))
    params = AlgorithmParameters(          # bench.py _make_params("Intensity")
        minSaliency=2.0, numPyramidLevels=4,
        descriptor=DescriptorType.INTENSITY, functionTolerance=1e-4,
        parameterTolerance=1e-6, maxIterations=50)
    vo = DeviceVO(K, baseline, shape, params, device=dev)
    err_i, ms_i, plain_i = kernel_phase(vo, frames[0], frames[1][0], dev)
    counts_i, _, fps, p50 = vo_phase(vo, frames, dev, ref, "VO intensity",
                                     T_ATOL_JAX, GT_MARGIN, True)
    print(f"VO intensity: {fps:.2f} frames/s, per-frame p50 {p50:.3f} ms "
          f"on {smi}")
    del vo, frames

    # stereo Bit-Planes: conf/kitti_bitplanes.cfg
    ref_s = dict(np.load(REF_STEREO_NPZ))
    cf = ConfigFile(CONF)
    params_bp = AlgorithmParameters.from_config(cf)
    matcher = stereo.create_stereo_algorithm(cf)
    err_c, ms_c, plain_c = census_phase(sframes[0][0], dev)
    err_s, ms_s, plain_s = sgm_phase(sframes[0], matcher, dev, ref_s)
    vo_bp = DeviceVO(K, baseline, shape, params_bp, device=dev,
                     stereo_fn=matcher.as_fn())
    flip_phase(vo_bp, sframes[0][0], dev)
    err_b, ms_b, plain_b = kernel_phase(vo_bp, sframes[0][:2],
                                        sframes[1][0], dev)
    counts_s, kf, fps_s, p50_s = vo_phase(
        vo_bp, [f[:2] for f in sframes], dev, ref_s, "VO stereo Bit-Planes",
        T_ATOL_JAX_STEREO, GT_MARGIN_STEREO, False)
    calls = 1 + int(kf.sum())           # init + one per keyframe
    want = {"census_planes": params_bp.numPyramidLevels * len(sframes)
            + 2 * calls, "sgm_aggregate": calls}
    print(f"VO stereo Bit-Planes: {calls} matcher calls, expected launches "
          f"{want}; {fps_s:.2f} frames/s, per-frame p50 {p50_s:.3f} ms on "
          f"{smi}")
    for name, n in want.items():
        _require(counts_s[name] == n,
                 f"{name} launched {counts_s[name]} times, expected {n}")

    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": [
        {"name": "level_gn", "route": "cuda",
         "source": "bpvo_tpu_torch/csrc/level_gn.cu",
         "replaces": "bpvo_tpu/ops/pallas/level_gn_kernel.py:615",
         "launches": counts_i["level_gn"] + counts_s["level_gn"],
         "launches_by_path": {"intensity": counts_i["level_gn"],
                              "stereo_bitplanes": counts_s["level_gn"]},
         "max_abs_err": max(err_i, err_b), "ms": ms_i + ms_b,
         "plain_ms": plain_i + plain_b,
         "ms_by_path": {"intensity": ms_i, "stereo_bitplanes": ms_b}},
        {"name": "census_planes", "route": "cuda",
         "source": "bpvo_tpu_torch/csrc/census.cu",
         "replaces": "bpvo_tpu/ops/pallas/census_kernel.py:46",
         "launches": counts_s["census_planes"], "max_abs_err": err_c,
         "ms": ms_c, "plain_ms": plain_c},
        {"name": "sgm_aggregate", "route": "cuda",
         "source": "bpvo_tpu_torch/csrc/sgm.cu",
         "replaces": "bpvo_tpu/ops/pallas/sgm_kernel.py:51",
         "launches": counts_s["sgm_aggregate"], "max_abs_err": err_s,
         "ms": ms_s, "plain_ms": plain_s}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
