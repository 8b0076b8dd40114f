"""Smoke run of the PyTorch/CUDA port (``bpvo_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the hand-written CUDA kernels from ``bpvo_tpu_torch/csrc`` (one
   nvcc per source, in parallel; ``-Xptxas -v`` output printed).
2. Intensity kernel phase: templates from frame 0 of the synthetic 376x1241
   KITTI-shape sequence, target frame 1; at each of the 4 bench pyramid
   levels (K = 16384/4096/1024/512) the ``level_gn`` CUDA kernel and its plain
   PyTorch version run on the same device tensors and must agree: after one
   iteration, sigma bit for bit, H and g at rtol 1e-3 and the weights at
   atol 1e-3; converged, the pose at atol 1e-4, equal iterations and status,
   sigma and H at rtol 1e-2.  Both are timed with CUDA events (the kernel
   also as a CUDA-graph replay, its device time); each level prints the
   kernel's cluster size (CTAs), iterations and device us per iteration.
3. Intensity VO phase: ``DeviceVO(device="cuda")`` over 1+30 frames with
   bench.py's intensity settings, through ``add_frame`` (the graphed route:
   the step up to its keyframe decision replayed from a CUDA graph, the
   replays counted as their kernel launches).  Every pose must be finite,
   within the ground-truth bound of the known per-frame motion, and within
   atol 5e-4 of the JAX package's poses
   (tests/data/torch_port_bench_ref.npz), with the same keyframes and
   per-level iterations within 1 of the reference's; the kernel's launch
   count must equal the number of level solves run.
4. Stereo kernel phase, on frame 0 of the stereo pair of the same scene:
   the ``census_planes`` kernel against its plain version at 376x1241 and
   the SGM aggregation kernel (and each of its two passes, whose device
   times it prints) against its plain version on that pair's 376x1241x128
   census cost volume with conf/kitti_bitplanes.cfg's penalties, both bit
   for bit; the matcher's ms per call, whole and by stage (census, cost
   volume, aggregation, WTA); the matcher's frame-0 disparity must have
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
7. GN-kernel phase, on frame 0 -> 1 of dense VO at KITTI shape (bench.py's
   settings, NMS off, pointCapacity 131072): at the L0 (K = 131072) and L1
   (K = 32768) shapes, intensity (C=1) and Bit-Planes (C=8, and its
   channel-0 sigma pass), ``fused_linearize`` against its plain version
   (channel 0's residuals and the histogram sigma from them bit for bit,
   weights at GN_W_ATOL, H, g, f^2 within GN_RTOL of their largest entry),
   and ``irls_reduce_w`` / ``irls_reduce`` at M = K and 8K the same way
   (``irls_reduce``'s sums bit for bit those of ``irls_reduce_w``; each
   timed on its own, with its own bound); one wrapper call of each must run
   exactly one device kernel (the kernel nodes of a CUDA graph of the
   call, ``probes.timing.device_kernels``).
   Phases 2 and 5 add one line each: ``gauss_newton.run`` against
   ``level_gn`` at the bench L0 (K = 16384): both times and the pose
   difference.
8. Dense VO phases: first ``level_gn`` against its plain version at the
   dense L2 and L3 shapes (K = 8192/2048), C=1 and C=8, with the checks
   and prints of phase 2; then ``VisualOdometry(device="cuda")`` over 1+30
   frames of
   the sequence (given disparity) in that configuration, intensity and
   Bit-Planes: poses finite, within the JAX run's own ground-truth error
   plus the margin, within T_ATOL_JAX_DENSE of the JAX reference
   (tests/data/torch_port_dense_ref.npz) with the same keyframe frames;
   launches: fused_linearize = gauss_newton.run iterations (+ one sigma pass
   per sigma re-estimate at C=8), irls_reduce = sigma re-estimates at C=1,
   level_gn = the L2 and L3 solves, each > 0.
   ``VisualOdometry.add_frame`` replays each ``gauss_newton.run``
   iteration from a CUDA graph; the sigma re-estimates are counted in its
   host loop (``gauss_newton._loop``).
9. Graph phase: each of the four VO paths eager and graphed in this
   process over the first GRAPH_STEPS (15) steps (the graphed route is the
   entry point; the eager one is ``DeviceVO``'s step function, or
   ``VisualOdometry`` with its pose estimator's graphs withheld), each
   route once to warm up, once timed
   and once under torch.profiler: poses, iterations and keyframes must be
   bitwise equal; per route it prints p50/p90 ms of keyframe and other
   steps and the top-level host ops per step (a graph replay counted as
   one op), and one JSON line with those numbers.
10. Probe phase (``bpvo_tpu_torch.probes``, the GPU counterparts of the JAX
   package's Mosaic probe scripts): with its launch counts set to 0, the
   probe runner's four groups run once (its main path).  Its steps hold
   every probe kernel and variant against its plain version on the card
   (bitwise, or rtol 1e-5 for matmul_chain, atol 1e-6 for band_bilinear,
   v4 and v5; band_bilinear also on points over the whole image, which
   leave their band) and time each as a CUDA-graph replay and through its
   wrapper, beside its plain version and, where one PyTorch call computes
   the same function, that call.  No step or variant may fail or disagree,
   every probe kernel must launch, and the wide points must differ from
   unbanded sampling.

11. App phase (the host data layer and the apps): the stereo bench
   sequence written as a KITTI tree (8-bit PNGs, calib.txt P0/P1,
   poses/00.txt; the scene KITTI_SCALE times larger, so its 30 steps cover
   the devkit's 100 m segment) and a Tsukuba-layout tree (480x640, 1+10
   frames) under build/app_phase; the PNG decode time of a stereo frame;
   ``apps.eval_kitti run`` (Intensity, TpuSGM) with the counts at 0
   (census 2 and SGM 1 per frame read, level_gn > 0, the GN kernels 0)
   and ``eval``: t_err and ATE under KITTI_T_ERR_BOUND and
   KITTI_ATE_PER_M x path length; ``python -m bpvo_tpu_torch.apps.vo`` in
   a process of its own on that tree (JAX's output files, the same
   bounds); ``VoApp`` threaded and prefetched, threaded, and unthreaded
   (p50/p90 per frame; bitwise equal trajectories and iterations), on a
   dense config whose CUDA graphs are captured while the loader thread
   runs SGM, on ``synthetic_stereo`` at 376x1241 and the Tsukuba tree
   with ``TpuBlockMatching`` (D=128 / 96, 1+10 frames); TpuBlockMatching's
   ms per call at both sizes and its card-vs-CPU equal share (at least
   BM_SHARE_FLOOR).  One ``{"app_phase": ...}`` JSON line.
12. Zoo phase (the single-device options: the six other descriptors, LM,
   the multi-start, cubic sampling, the DisparitySpace warp), on
   conf/eval_corridor.cfg's corridor at 240x320: ``level_gn`` against its
   plain version at C = 3, 5, 10 and 48 (IntensityAndGradient,
   DescriptorFields1/2, CentralDifference) on the finest level (phase 2's
   checks and prints); ``fused_linearize`` at C = 3, 5 and 10 on a dense
   finest level (65536 points, NMS off) and ``irls_reduce_w`` /
   ``irls_reduce`` on the gather route (Bit-Planes, CUBIC_HERMITE, M = 8K)
   with phase 7's checks; LATCH's comparison bits card vs CPU (at most
   LATCH_FLIP_BOUND flipped); then, with the counts at 0,
   ``apps.eval_descriptors`` over 1+8 frames for all 8 descriptors with GN
   and LM (the main path: level_gn and irls_reduce must launch): poses
   finite, within ZOO_ATOL_C1 (C = 1) or ZOO_ATOL of the JAX package's
   (tests/data/torch_port_zoo_ref.npz; JAX's level route for the cells of
   ZOO_JAX_LEVEL_ROUTE), ATE within JAX's own plus ZOO_ATE_MARGIN,
   iterations per frame within ZOO_ITERS_CELL of JAX's per cell and within
   ZOO_ITERS_POOLED of JAX's summed over each solver's cells, ms and
   iterations per frame printed per cell; the gather
   route (Bit-Planes, CUBIC_HERMITE: irls_reduce inside gauss_newton.run's
   CUDA graphs) and dense DescriptorFields1 (fused_linearize at C = 5) over
   1+4 frames, counted, within ZOO_GT_BOUND of the ground truth; ``python -m
   bpvo_tpu_torch.apps.vo`` on conf/tsukuba.cfg over the app phase's
   NewTsukuba tree in a process of its own, within ZOO_ATOL_C1 of JAX's
   poses.  One ``{"zoo_phase": ...}`` JSON line.

13. Distributed phase (``bpvo_tpu_torch.parallel``): in this process a
   world-1 ``nccl`` group; the sharded GN at 376x1241 (K = 16384) bit for
   bit the same route with no reducer, at LINEAR and at CUBIC sampling
   (the gather route: no ``fused_linearize`` launch); the sharded VO, intensity and
   Bit-Planes, with the dry run's parameters over 1+4 frames in 2
   ``scan_fn`` chunks (counted: ``fused_linearize`` and ``irls_reduce``
   must launch, ``level_gn`` never; census for Bit-Planes): bit for bit the
   no-reducer route, within SHARDED_ATOL_JAX of JAX's sharded VO with its
   keyframe flags (tests/data/torch_port_sharded_ref.npz), intensity
   within SHARDED_ATOL_DEVICE_VO of ``DeviceVO`` on the card (Bit-Planes'
   gap is printed: open fault C.13); the rule witness: the step hooked
   with the sharded linearization at ``DeviceVO``'s own sigma rule bit for
   bit ``DeviceVO`` with ``gauss_newton.run`` at every level, its gaps to
   the sharded VO and to the default ``DeviceVO`` printed;
   ``fused_linearize`` against plain at its L0; then ``python -m
   bpvo_tpu_torch.parallel.dryrun``'s checks with 2 gloo ranks on cuda:0
   (host-staged); ``VisualOdometry.enable_bundle_adjustment(8)`` over
   1+30 frames (counted): every keyframe event's refined window within
   BA_ATOL_JAX of JAX's, the ms of each optimize, ``irls_reduce``
   launched 2(M-1) times an iteration, checked against plain at the edge
   shape; ``ba_solve_with_depth`` at M = 4, K = 16384 (counted) within
   BA_DEPTH_ATOL of the CPU's plain run; the collective calls and bytes
   per step beside JAX's count; ``apps.scaling_bench`` at world 1 (nccl)
   and world 2 (gloo, host-staged).  One ``{"distributed_phase": ...}``
   JSON line.

Any failure exits non-zero.  The line before the last is a JSON object with
the kernels' launches (summed over the VO phases that run each; for the
probes, the probe groups' run), errors, CUDA-event times (mean ms per call
through the wrapper; SGM also ``ms_by_pass``, ``structure_bound_ms`` (the
two-pass structure's bytes over 3.35 TB/s) and the matcher's ms, whole
and ``matcher_ms_by_stage``; for census, whose wrapper costs more host
time than the kernel device time, back-to-back launches of its C entry
point; for fused_linearize and irls_reduce also the device time of the call
replayed from a CUDA graph of 10 calls, per shape (``replayed_ms_by_shape``:
per call of a 10-call graph; earlier versions of this script replayed one
call per graph, which also timed the host's graph launches, so their
readings do not compare), the device kernels one
call runs (``kernels_per_call``; the zoo phase's shapes are keyed "zoo ...")
and, for irls_reduce, the call without
the weight store (``no_weights_*``); for the probes "ms" is the replayed
device time), the least time the card could take for the same work (``bound_ms``:
the larger of the bytes moved over 3.35 TB/s and the f32 operations over
67 TFLOP/s, H100 SXM; an image that a kernel gathers from counts only the
distinct pixels this run's points read; ``level_gn`` counts the median
search only on the iterations that re-estimate sigma, as its plain version
runs them) and the library call's time where there is one (``level_gn``'s
"ms", "plain_ms" and "bound_ms" sum the 8 bench level shapes; its
``*_by_path`` and ``*_by_level`` keys add the dense L2 and L3 and the
zoo's corridor L0 at C = 3, 5, 10, 48, ``launches_by_path`` the zoo's
three counted runs); the
last line is {"ok": true, "device": {...}}.  Without a CUDA device, or without
the package beside this script, it exits non-zero and prints no result.
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
REF_DENSE_NPZ = os.path.join(HERE, "tests", "data",
                             "torch_port_dense_ref.npz")
CONF = os.path.join(HERE, "conf", "kitti_bitplanes.cfg")
N_STEPS = 30
T_ATOL_KERNEL = 1e-4     # kernel vs plain version, same inputs, same device
CONV_RTOL = 1e-2         # converged sigma and H, kernel vs plain version
LIN_RTOL = 1e-3          # first linearization's H, g (one iteration; its
                         # sigma must be equal)
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
# per-iteration GN kernels vs their plain versions, same inputs and device:
# the sums run in another order (H, g, f^2), the weights divide the same
# residuals by the same sigma
GN_RTOL, GN_W_ATOL = 1e-4, 1e-6
GN_PER_GRAPH = 10        # calls per CUDA graph when the GN kernels are replayed
STEP_LABEL = "vo_step_"  # the profiler label of a step in the graph phase
# steps of the graph phase (30 before the app phase came; cut to keep the
# script's wall near its earlier ~190 s)
GRAPH_STEPS = 15
# dense VO: bench.py's settings, NMS off (as conf/tunnel.cfg), and a point
# capacity every level fills: 131072/32768/8192/2048 points
BENCH = dict(minSaliency=2.0, numPyramidLevels=4, functionTolerance=1e-4,
             parameterTolerance=1e-6, maxIterations=50)
DENSE = dict(minNumPixelsForNonMaximaSuppression=20000000,
             pointCapacity=131072)
# port vs the JAX CPU route: L0 and L1 take the same route (histogram
# median), L2 and L3 the level kernel (bisection median) against JAX's
# gn.run.  The port's plain versions on the CPU over the same 30 steps:
# 3.4e-5 (intensity) and 2.5e-4 (Bit-Planes), the same keyframes
T_ATOL_JAX_DENSE = {"intensity": 5e-4, "bitplanes": 2e-3}
GT_MARGIN_DENSE = {"intensity": GT_MARGIN, "bitplanes": GT_MARGIN_STEREO}
SGM_REPS, SGM_PLAIN_REPS = 10, 1
# app phase: eval_kitti's KITTI tree is the bench scene 125 times larger, so
# its 30 steps (0.0307 m each) cover 115 m and the devkit's 100 m segment;
# the bounds are twice the JAX package's own t_err (3.88%) and ATE per
# metre of path (2.81 m over 122.6 m) in tests/test_torch_apps.py's CPU
# parity run of the same camera at 120x320
KITTI_SCALE = 125.0
KITTI_T_ERR_BOUND = 8.0          # percent
KITTI_ATE_PER_M = 0.046
APP_SHORT_FRAMES = 11            # synthetic_stereo and Tsukuba: 1+10 frames
# TpuBlockMatching, card against CPU: at these sizes the float32 prefix sums
# pass 2^24 and the card's scan rounds them otherwise, which flips near-tie
# argmins (accepted delta g; 0.912 of the pixels equal at 376x1241x128 in
# the first chip run)
BM_SHARE_FLOOR = 0.85
# zoo phase: conf/eval_corridor.cfg (240x320) cut to 1+8 frames per cell,
# every descriptor with GN and LM, against tests/data/torch_port_zoo_ref.npz
# (scripts/make_torch_port_ref.py zoo); conf/tsukuba.cfg on the app phase's
# NewTsukuba tree
REF_ZOO_NPZ = os.path.join(HERE, "tests", "data", "torch_port_zoo_ref.npz")
ZOO_FRAMES = 9
ZOO_DESCRIPTORS = ("Intensity", "BitPlanes", "IntensityAndGradient",
                   "DescriptorFields1", "DescriptorFields2",
                   "CentralDifference", "Laplacian", "Latch")
ZOO_SOLVERS = ("GaussNewton", "LevenbergMarquardt")
# poses against the JAX CPU route: the card runs the level kernel
# (bisection median) at every GN level where JAX runs gauss_newton.run
# (histogram median), and LM's sums in the kernel's order
ZOO_ATOL_C1, ZOO_ATOL = 5e-4, 2e-3
ZOO_ATE_MARGIN = 1e-3
# cells held to JAX's level route (its level kernel forced, interpret mode
# on the CPU: the ``_level_`` keys of the reference) where JAX's CPU route
# parts from it: Laplacian with GN on the corridor, from frame 2 on (1.65e-2
# in pose; the port's plain versions on the CPU are 4.1e-4 from JAX's level
# route, delta j)
ZOO_JAX_LEVEL_ROUTE = ("Laplacian+GaussNewton",)
# iterations per frame (frames 5-8, as eval_descriptors averages them)
# against JAX's: LM stops only on an accepted step, and at the noise floor
# one package may accept where the other runs on to maxIterations (100;
# delta i), which moves a cell's mean by up to 25 per level solve; so a
# cell is held within 2 such solves, and each solver's sum over the 8
# cells within 25% of JAX's sum
ZOO_ITERS_CELL = 50.0
ZOO_ITERS_POOLED = 0.25
ZOO_GT_BOUND = 0.05      # zoo_gather / zoo_dense: 1+4 frames, world pose
LATCH_FLIP_BOUND = 1e-3  # LATCH comparison bits flipped, card vs CPU
# H100 SXM peaks (NVIDIA's data sheet, 700 W): HBM3 bandwidth and the f32
# rate outside the tensor cores; bound_ms is the larger of bytes / the one
# and operations / the other
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# f32 operations per element, counted from each kernel's arithmetic: a
# level_gn iteration projects each point (~20), and per point and channel
# samples, weighs and adds to H, g, f (~71); an iteration that re-estimates
# sigma also runs the 16-step median bisection (~32 a point: what the
# function needs; the kernel's 4 rounds compare each point with 15
# midpoints, 60 compares, to save barriers); fused_linearize the same
# without the bisection; irls_reduce per term weighs and adds (~64); census
# compares 8 neighbours; SGM ~8 per cost per direction
OPS_LEVEL_POINT, OPS_LEVEL_CHANNEL, OPS_MEDIAN_POINT = 20, 71, 32
OPS_LIN_POINT, OPS_LIN_CHANNEL = 20, 71
OPS_IRLS_TERM, OPS_CENSUS_PIXEL, OPS_SGM_COST = 64, 8, 32


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if hasattr(t, "element_size"))


def _bound(nbytes, ops):
    """(least ms the card could take for ``nbytes`` moved and ``ops`` f32
    operations, "bytes" or "operations": whichever sets it)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _taps(u, v, ok, rows, cols):
    """Flat indices of the pixels that bilinear sampling at the points
    (u, v) where ``ok`` reads: each point's 2x2 footprint, clipped to the
    image."""
    import torch
    xi = torch.floor(u[ok]).long().clamp(0, cols - 2)
    yi = torch.floor(v[ok]).long().clamp(0, rows - 2)
    return torch.cat([(yi + dy) * cols + xi + dx
                      for dy in (0, 1) for dx in (0, 1)])


def _tap_bytes(ch, taps):
    """Bytes of the distinct pixels ``taps`` of every channel of ``ch``: what
    a gather from the (C, H, W) stack must read, each value once."""
    import torch
    return torch.unique(taps).numel() * ch.shape[0] * ch.element_size()


def write_kitti_tree(root, frames, K, baseline, scale, seq=0):
    """Write stereo ``frames`` [(left, right, ...)] of the bench scene
    (``synthetic.synthesize_stereo_sequence``) in the KITTI odometry
    layout: ``sequences/<seq>/image_0|image_1/%06d.png`` (8-bit grey),
    ``calib.txt`` with P0/P1 and ``poses/<seq>.txt`` (ground-truth
    camera-to-world 3x4 rows).  The scene is taken ``scale`` times larger:
    baseline and translations scale, the images do not, so a short
    sequence can cover the devkit's 100 m segments.  Returns the
    dataset root."""
    import numpy as np
    from bpvo_tpu_torch.data import imageio, synthetic
    seq_dir = os.path.join(root, "sequences", f"{seq:02d}")
    for cam in ("image_0", "image_1"):
        os.makedirs(os.path.join(seq_dir, cam), exist_ok=True)
    os.makedirs(os.path.join(root, "poses"), exist_ok=True)
    for i, (left, right, *_) in enumerate(frames):
        for cam, img in (("image_0", left), ("image_1", right)):
            imageio.imwrite(os.path.join(seq_dir, cam, f"{i:06d}.png"),
                            np.clip(np.round(img), 0, 255).astype(np.uint8))
    P0 = np.zeros((3, 4))
    P0[:, :3] = K
    P1 = P0.copy()
    P1[0, 3] = -K[0, 0] * baseline * scale
    with open(os.path.join(seq_dir, "calib.txt"), "w") as f:
        for name, P in (("P0", P0), ("P1", P1)):
            f.write(f"{name}: " + " ".join(f"{v:.12e}" for v in P.ravel())
                    + "\n")
    step, T, rows = synthetic.step_pose(), np.eye(4), []
    for _ in frames:
        world = np.linalg.inv(T)
        world[:3, 3] *= scale
        rows.append(" ".join(f"{v:.12e}" for v in world[:3].ravel()))
        T = step @ T
    with open(os.path.join(root, "poses", f"{seq:02d}.txt"), "w") as f:
        f.write("\n".join(rows) + "\n")
    return root


def write_tsukuba_tree(root, n_frames, rows=480, cols=640, z0=3.0):
    """Write ``n_frames`` stereo pairs of a noise-textured plane in the
    NewTsukuba layout (``illumination/fluorescent/left|right/
    tsukuba_fluorescent_L|R_%05d.png`` from 1, and the ground-truth
    disparity rounded into ``groundtruth/disparity_maps/left``), rendered
    with the fixed NewTsukuba rig (fx 615, cx 320, cy 240, baseline
    0.1).  Returns the dataset root."""
    import numpy as np
    from bpvo_tpu_torch.data import imageio
    from bpvo_tpu_torch.data.synthetic import SyntheticPlaneDataset
    ds = SyntheticPlaneDataset(rows=rows, cols=cols, n_frames=n_frames,
                               fx=615.0, baseline=0.1, z0=z0,
                               texture="noise")
    ill = os.path.join(root, "illumination", "fluorescent")
    gt = os.path.join(root, "groundtruth", "disparity_maps", "left")
    for d in (os.path.join(ill, "left"), os.path.join(ill, "right"), gt):
        os.makedirs(d, exist_ok=True)

    def u8(img):
        return np.clip(np.round(img), 0, 255).astype(np.uint8)

    for i in range(n_frames):
        frame = ds.get_frame(i)
        imageio.imwrite(os.path.join(
            ill, "left", f"tsukuba_fluorescent_L_{i + 1:05d}.png"),
            u8(frame.image))
        imageio.imwrite(os.path.join(
            ill, "right", f"tsukuba_fluorescent_R_{i + 1:05d}.png"),
            u8(ds.right_image(i)))
        imageio.imwrite(os.path.join(
            gt, f"tsukuba_disparity_L_{i + 1:05d}.png"), u8(frame.disparity))
    return root


def write_zoo_configs(root, tsukuba_root):
    """The zoo phase's two configs under ``root``: conf/eval_corridor.cfg
    with ZOO_FRAMES frames, and conf/tsukuba.cfg reading the NewTsukuba
    tree at ``tsukuba_root``.  Returns their paths."""
    os.makedirs(root, exist_ok=True)
    out = []
    for name, edit in (
            ("eval_corridor.cfg", {"SyntheticNumFrames": ZOO_FRAMES}),
            ("tsukuba.cfg", {"DataSetRootDirectory": tsukuba_root})):
        path = os.path.join(root, name)
        with open(os.path.join(HERE, "conf", name)) as src, \
                open(path, "w") as f:
            for line in src:
                if line.split("=")[0].strip() not in edit:
                    f.write(line)
            for key, value in edit.items():
                f.write(f"{key} = {value}\n")
        out.append(path)
    return tuple(out)


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
    from bpvo_tpu_torch.ops import census, fused_linearize, irls, level_gn, sgm
    for mod in (census, fused_linearize, irls, level_gn, sgm):
        mod.launch_count = 0


def _counts():
    from bpvo_tpu_torch.ops import census, fused_linearize, irls, level_gn, sgm
    return {"level_gn": level_gn.launch_count,
            "census_planes": census.launch_count,
            "sgm_aggregate": sgm.launch_count,
            "fused_linearize": fused_linearize.launch_count,
            "irls_reduce": irls.launch_count}


def _first_linearization(args, level):
    """One iteration of kernel and plain version: the first linearization's
    sigma must be equal (bit for bit: integer counts and the plain
    version's rounding of the residuals), its weights (Tukey/Huber at level
    0, Huber above) and normal equations agree tightly, since a converged
    pose hides weighting errors."""
    import dataclasses
    from bpvo_tpu_torch.ops import level_gn as lg
    args = args[:-1] + (dataclasses.replace(args[-1], max_iterations=1),)
    _, sk, Hk, gk, wk, _ = lg.level_gn(*args)
    _, sp, Hp, gp, wp, _ = lg.level_gn_reference(*args)
    s_k, s_p = sk[4].item(), sp[4].item()
    dH, dg = _rel(Hk, Hp), _rel(gk, gp)
    dw = float((wk - wp).abs().max())
    print(f"level {level} one iteration: sigma {s_k!r} vs plain {s_p!r} "
          f"(equal: {s_k == s_p}) rel|dH|={dH:.3e} rel|dg|={dg:.3e} "
          f"max|dw|={dw:.3e}")
    _require(s_k == s_p and dH <= LIN_RTOL and dg <= LIN_RTOL
             and dw <= LIN_W_ATOL,
             f"level {level}: first linearization differs (sigma {s_k} vs "
             f"{s_p}, H {dH}, g {dg}, w {dw})")


def _plain_and_estimates(args):
    """The plain version's outputs, and how many of its iterations
    re-estimated sigma (the rest skip the median search)."""
    from bpvo_tpu_torch.ops import level_gn as lg
    n, estimate = [0], lg.estimate_scale

    def counted(*a):
        n[0] += 1
        return estimate(*a)

    lg.estimate_scale = counted
    try:
        out = lg.level_gn_reference(*args)
    finally:
        lg.estimate_scale = estimate
    return out, n[0]


def kernel_phase(vo, init_pair, target, dev, levels=None):
    """level_gn kernel vs plain version at the level shapes of ``vo`` (all,
    or the indices in ``levels``): templates of ``init_pair`` (image,
    disparity or right image), channels of the ``target`` image.  Returns
    (max pose error, kernel ms, plain ms, (bound ms, bound by), {"L<l>":
    {"ms", "replayed_ms", "n_ctas", "iterations", "us_per_iteration",
    "sigma_estimates", "bound_ms"}})."""
    import torch
    from bpvo_tpu_torch.ops import interp
    from bpvo_tpu_torch.ops import level_gn as lg
    from bpvo_tpu_torch.probes import timing
    from bpvo_tpu_torch.vo import device_vo, warp

    vo.init(*init_pair)
    templates = vo.state.templates
    channels = device_vo._compute_channels_pyr(
        torch.as_tensor(target).to(dev), vo._p, vo._p.numPyramidLevels)
    T0 = torch.eye(4, dtype=torch.float32, device=dev)
    max_err, ms, plain_ms, bound_ms, by = 0.0, 0.0, 0.0, 0.0, set()
    out = {}
    for level, (td, ch) in enumerate(zip(templates, channels)):
        if levels is not None and level not in levels:
            continue
        args = (vo._cams[level], td.points, td.valid, td.pixels,
                td.jacobians, ch, T0, 1.0, 1e10, td.norm_scale,
                td.norm_center, vo._opts[level])
        _first_linearization(args, level)
        Tk, sk, Hk, gk, wk, _ = lg.level_gn(*args)
        (Tp, sp, Hp, gp, wp, _), n_est = _plain_and_estimates(args)
        torch.cuda.synchronize()
        C, K = td.pixels.shape
        # the image stack counts only the pixels that the projections at the
        # first and the converged pose read (the kernel gathers taps)
        cam, opts = vo._cams[level], vo._opts[level]
        taps = []
        for T in (T0, Tk):
            u, v, Z = warp.project(cam, T, td.points)
            ok = td.valid & (Z > 1e-6) & interp.valid_mask(
                u, v, ch.shape[1], ch.shape[2], opts.interp)
            taps.append(_taps(u, v, ok, ch.shape[1], ch.shape[2]))
        nbytes = (_nbytes(*(a for a in args if a is not ch), Tk, sk, Hk, gk,
                          wk) + _tap_bytes(ch, torch.cat(taps)))
        b_ms, b_by = _bound(nbytes, K * (
            float(sk[0]) * (OPS_LEVEL_POINT + C * OPS_LEVEL_CHANNEL)
            + n_est * OPS_MEDIAN_POINT))
        bound_ms += b_ms
        by.add(b_by)
        err = float((Tk - Tp).abs().max())
        dH = _rel(Hk, Hp)
        t_k = _cuda_ms(lambda: lg.level_gn(*args), KERNEL_REPS)
        d_k = timing.graph_ms(lambda: lg.level_gn(*args), KERNEL_REPS,
                              per_graph=1)
        t_p = _cuda_ms(lambda: lg.level_gn_reference(*args), PLAIN_REPS)
        sk, sp = sk.tolist(), sp.tolist()
        d_sigma = abs(sk[4] - sp[4]) / abs(sp[4])
        n_ctas = lg.n_ctas(K)
        out[f"L{level}"] = {"ms": t_k, "replayed_ms": d_k, "n_ctas": n_ctas,
                            "iterations": int(sk[0]),
                            "us_per_iteration": d_k * 1e3 / max(sk[0], 1),
                            "sigma_estimates": n_est, "bound_ms": b_ms}
        print(f"level {level} C={ch.shape[0]} {tuple(ch.shape[1:])} "
              f"K={td.points.shape[0]}: cluster of {n_ctas} CTAs, "
              f"{d_k * 1e3 / max(sk[0], 1):.2f} us per iteration "
              f"(replayed {d_k:.4f} ms); "
              f"max|dT|={err:.3e} iters {sk[0]:.0f}/{sp[0]:.0f} "
              f"status {sk[3]:.0f}/{sp[3]:.0f} sigma {sk[4]:.6g}/{sp[4]:.6g} "
              f"({n_est} estimates) "
              f"rel|dH|={dH:.3e} max|dw|={float((wk - wp).abs().max()):.3e} "
              f"kernel {t_k:.4f} ms plain {t_p:.4f} ms bound {b_ms:.5f} ms "
              f"({b_by})")
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
        if level == 0:
            _route_line(vo, td, ch, T0)
    return max_err, ms, plain_ms, (bound_ms, "/".join(sorted(by))), out


def _host_ms(fn, reps=3):
    """Mean host ms per call of fn() ending in a sync, after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def _route_line(vo, td, ch, T0):
    """gauss_newton.run against level_gn on one bench level: both times
    (host clock, each call ends in a sync) and the pose difference.  It
    informs where the routing bound should sit; it checks nothing."""
    from bpvo_tpu_torch.solver import gauss_newton as gn
    args = (td, ch, vo._cams[0], T0, vo._opts[0])
    st_r, st_l = gn.run(*args), gn.run_level(*args)
    t_r = _host_ms(lambda: gn.run(*args))
    t_l = _host_ms(lambda: gn.run_level(*args))
    print(f"bench L0 C={ch.shape[0]} K={td.points.shape[0]}: "
          f"gauss_newton.run {t_r:.3f} ms ({int(st_r.num_iters)} iterations)"
          f" vs level_gn {t_l:.3f} ms ({int(st_l.num_iters)} iterations), "
          f"max |dT| {float((st_r.T - st_l.T).abs().max()):.3e}")


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


def _dense_params(descriptor):
    from bpvo_tpu_torch import AlgorithmParameters
    return AlgorithmParameters(**BENCH, **DENSE, descriptor=descriptor)


def _gn_check(label, got, want):
    """Kernel vs plain outputs (H, g, f_sq, [r0,] w): the weights at
    GN_W_ATOL, the sums within GN_RTOL of their largest entry.  Returns the
    largest absolute weight difference."""
    dw = float((got[-1] - want[-1]).abs().max())
    rel = [_rel(a, b) for a, b in zip(got[:3], want[:3])]
    print(f"  {label}: max|dw| {dw:.3e}, rel|dH| {rel[0]:.3e} "
          f"rel|dg| {rel[1]:.3e} rel|df2| {rel[2]:.3e}")
    _require(dw <= GN_W_ATOL and max(rel) <= GN_RTOL,
             f"{label}: kernel differs from its plain version (w {dw}, "
             f"H/g/f2 {rel})")
    return dw


def gn_kernel_phase(K, baseline, frames, dev):
    """fused_linearize and irls_reduce(_w) against their plain versions
    at the dense L0 and L1 shapes, C=1 and C=8.  Returns {kernel: (max
    error, {shape: (ms, plain ms, replayed ms, plain replayed ms)},
    {shape: (bound ms, bound by)}, {shape: device kernels per call})};
    irls_reduce's tuples also carry the call without weights: (ms,
    replayed ms) and (bound ms, bound by) after the others."""
    import torch
    from bpvo_tpu_torch import DescriptorType
    from bpvo_tpu_torch.ops import fused_linearize as fl
    from bpvo_tpu_torch.ops import interp, irls
    from bpvo_tpu_torch.probes import timing
    from bpvo_tpu_torch.solver import mestimator
    from bpvo_tpu_torch.vo import device_vo, template_data, warp
    err = {"fused_linearize": 0.0, "irls_reduce": 0.0}
    ms = {"fused_linearize": {}, "irls_reduce": {}}
    bounds = {"fused_linearize": {}, "irls_reduce": {}}
    per_call = {"fused_linearize": {}, "irls_reduce": {}}
    for name, desc in (("intensity", DescriptorType.INTENSITY),
                       ("bitplanes", DescriptorType.BITPLANES)):
        vo = device_vo.DeviceVO(K, baseline, (frames[0][0].shape),
                                _dense_params(desc), device=dev)
        vo.init(*(torch.as_tensor(a).to(dev) for a in frames[0]))
        pyr = device_vo._compute_channels_pyr(
            torch.as_tensor(frames[1][0]).to(dev), vo._p, 4)
        T0 = torch.eye(4, dtype=torch.float32, device=dev)
        for level in (0, 1):
            td, ch = vo.state.templates[level], pyr[level]
            cam, opts = vo._cams[level], vo._opts[level]
            C, Kl = td.pixels.shape
            u, v, Z = warp.project(cam, T0, td.points)
            ok = td.valid & (Z > 1e-6) & interp.valid_mask(
                u, v, ch.shape[1], ch.shape[2], opts.interp)
            r, _ = template_data.compute_residuals(td, ch, cam, T0,
                                                   opts.interp)
            sigma = mestimator.estimate_scale(r[0], ok)
            print(f"L{level} C={C} {tuple(ch.shape[1:])} K={Kl}: "
                  f"{int(ok.sum())} points in view, sigma {float(sigma):.6g}")
            for n in sorted({1, C}):
                a = (u, v, ok, ch[:n], td.pixels[:n], td.jacobians[:n],
                     sigma, opts.loss, opts.interp)
                got = fl.fused_linearize(*a)
                want = fl.fused_linearize_reference(*a)
                torch.cuda.synchronize()
                r0_same = torch.equal(got[3].view(torch.int32),
                                      want[3].view(torch.int32))
                s_same = torch.equal(mestimator.estimate_scale(got[3], ok),
                                     mestimator.estimate_scale(want[3], ok))
                t_k = _cuda_ms(lambda: fl.fused_linearize(*a), KERNEL_REPS)
                t_p = _cuda_ms(lambda: fl.fused_linearize_reference(*a),
                               PLAIN_REPS)
                d_k = timing.graph_ms(lambda: fl.fused_linearize(*a),
                                      KERNEL_REPS, GN_PER_GRAPH)
                d_p = timing.graph_ms(
                    lambda: fl.fused_linearize_reference(*a), KERNEL_REPS,
                    GN_PER_GRAPH)
                n_k = len(timing.device_kernels(
                    lambda: fl.fused_linearize(*a)))
                shape = (f"{name} L{level} C={n}"
                         + (" sigma pass" if n < C else ""))
                label = f"fused_linearize {shape}"
                print(f"  {label}: r0 bitwise {r0_same}, sigma bitwise "
                      f"{s_same}; kernel {t_k:.4f} ms through the wrapper, "
                      f"{d_k:.4f} ms replayed, {n_k} device kernel(s) per "
                      f"call; plain {t_p:.4f} ms, {d_p:.4f} ms replayed")
                _require(r0_same and s_same, f"{label}: r0 or its sigma "
                                             f"differs from the plain version")
                _require(n_k == 1, f"{label}: {n_k} device kernels per call")
                per_call["fused_linearize"][shape] = n_k
                dw = _gn_check(label, got, want)
                err["fused_linearize"] = max(err["fused_linearize"], dw)
                ms["fused_linearize"][shape] = (t_k, t_p, d_k, d_p)
                bounds["fused_linearize"][shape] = _bound(
                    _nbytes(*a[:3], *a[4:7], *got) + _tap_bytes(
                        ch[:n], _taps(u, v, ok, ch.shape[1], ch.shape[2])),
                    Kl * (OPS_LIN_POINT + n * OPS_LIN_CHANNEL))
                for m in sorted({1, C}) if n == C else ():
                    J = td.jacobians[:m].reshape(-1, 6)
                    b = (J, r[:m].reshape(-1), ok.expand(m, -1).reshape(-1),
                         sigma, opts.loss)
                    got = irls.irls_reduce_w(*b)
                    got3 = irls.irls_reduce(*b)
                    want = irls.irls_reduce_reference(*b)
                    torch.cuda.synchronize()
                    shape = f"{name} L{level} M={m}K"
                    label = f"irls_reduce {shape}"
                    _require(all(torch.equal(x, y)
                                 for x, y in zip(got3, got[:3])),
                             f"{label}: irls_reduce and irls_reduce_w differ")
                    t_k = _cuda_ms(lambda: irls.irls_reduce_w(*b),
                                   KERNEL_REPS)
                    t_p = _cuda_ms(lambda: irls.irls_reduce_reference(*b),
                                   PLAIN_REPS)
                    d_k = timing.graph_ms(lambda: irls.irls_reduce_w(*b),
                                          KERNEL_REPS, GN_PER_GRAPH)
                    d_p = timing.graph_ms(
                        lambda: irls.irls_reduce_reference(*b), KERNEL_REPS,
                        GN_PER_GRAPH)
                    t_3 = _cuda_ms(lambda: irls.irls_reduce(*b), KERNEL_REPS)
                    d_3 = timing.graph_ms(lambda: irls.irls_reduce(*b),
                                          KERNEL_REPS, GN_PER_GRAPH)
                    n_k = max(len(timing.device_kernels(fn)) for fn in (
                        lambda: irls.irls_reduce_w(*b),
                        lambda: irls.irls_reduce(*b)))
                    print(f"  {label}: irls_reduce_w {t_k:.4f} ms through the "
                          f"wrapper, {d_k:.4f} ms replayed; irls_reduce "
                          f"{t_3:.4f} / {d_3:.4f} ms; {n_k} device kernel(s) "
                          f"per call; plain {t_p:.4f} ms, {d_p:.4f} ms "
                          f"replayed")
                    _require(n_k == 1,
                             f"{label}: {n_k} device kernels per call")
                    err["irls_reduce"] = max(err["irls_reduce"],
                                             _gn_check(label, got, want))
                    ms["irls_reduce"][shape] = (t_k, t_p, d_k, d_p, t_3, d_3)
                    ops = m * Kl * OPS_IRLS_TERM
                    bounds["irls_reduce"][shape] = (
                        _bound(_nbytes(*b[:4], *got), ops)
                        + _bound(_nbytes(*b[:4], *got3), ops))
                    per_call["irls_reduce"][shape] = n_k
        del vo, pyr
    return {k: (err[k], ms[k], bounds[k], per_call[k]) for k in err}


def dense_vo_phase(K, baseline, frames, dev, ref, name, descriptor):
    """VisualOdometry over 1+N_STEPS frames of dense VO, once to warm up,
    then the counted and timed run that is checked against the JAX
    reference.  Returns the launch counts of the counted run."""
    import numpy as np
    import torch
    from bpvo_tpu_torch import VisualOdometry
    from bpvo_tpu_torch.core import se3
    from bpvo_tpu_torch.data import synthetic
    from bpvo_tpu_torch.solver import gauss_newton as gn

    images = [torch.as_tensor(f[0]).to(dev) for f in frames]
    disps = [torch.as_tensor(f[1]).to(dev) for f in frames]
    params = _dense_params(descriptor)

    def one_pass():
        vo = VisualOdometry(K, baseline, tuple(images[0].shape), params,
                            device=dev)
        vo.add_frame(images[0], disps[0])
        res, t_ms = [], []
        for image, disp in zip(images[1:], disps[1:]):
            t0 = time.perf_counter()
            res.append(vo.add_frame(image, disp))
            torch.cuda.synchronize()
            t_ms.append((time.perf_counter() - t0) * 1e3)
        return vo, res, np.array(t_ms)

    torch.cuda.synchronize()
    one_pass()                          # warm-up: first-use costs of each op
    # what the launch counts must equal: gauss_newton.run's iterations
    # (device scalars, summed after the run) and its sigma re-estimates
    # (the iterations its host loop runs with sigma still moving, replayed
    # or not)
    run_iters, n_est = [], [0]
    run, loop = gn.run, gn._loop

    def counted_run(*a, **k):
        st = run(*a, **k)
        run_iters.append(st.num_iters)
        return st

    def counted_loop(advance, opts):
        def counted(it, do_est):
            n_est[0] += bool(do_est)
            return advance(it, do_est)
        return loop(counted, opts)

    gn.run, gn._loop = counted_run, counted_loop
    try:
        _reset_counts()
        vo, res, t_ms = one_pass()
        counts = _counts()
    finally:
        gn.run, gn._loop = run, loop
    iters_run = int(torch.stack(run_iters).sum())

    poses = np.stack([r.pose for r in res]).astype(np.float32)
    kf = np.array([r.is_keyframe for r in res])
    iters = np.array([[s.num_iterations for s in r.optimizer_statistics]
                      for r in res])
    step_inv = torch.as_tensor(np.linalg.inv(synthetic.step_pose()),
                               dtype=torch.float32)
    gt_err = np.array([float(se3.log(torch.as_tensor(P) @ step_inv)
                             .abs().max()) for P in poses])
    d_pose = np.abs(poses - ref[f"{name}_poses"]).max((1, 2))
    ref_kf = ref[f"{name}_is_keyframe"]
    bound = float(ref[f"{name}_gt_err"].max()) + GT_MARGIN_DENSE[name]
    C = vo._ref.templates[0].pixels.shape[0]
    want = {"fused_linearize": iters_run + (n_est[0] if C > 1 else 0),
            "irls_reduce": n_est[0] if C == 1 else 0,
            "level_gn": 2 * len(res)}      # L3 and L2 of each first estimate
    label = f"VO dense {name}"
    print(f"{label}: points per level "
          f"{[vo.num_points_at_level(l) for l in range(4)]}, {len(res)} "
          f"steps, {int(kf.sum())} keyframes (JAX {int(ref_kf.sum())}, same "
          f"frames: {np.array_equal(kf, ref_kf)}), iters/frame "
          f"{iters.sum(1).mean():.2f} (JAX "
          f"{ref[f'{name}_iters'].sum(1).mean():.2f})")
    print(f"{label}: max GT error {gt_err.max():.3e} (bound {bound:.3e}), "
          f"max |pose - JAX pose| {d_pose.max():.3e} (atol "
          f"{T_ATOL_JAX_DENSE[name]})")
    print(f"{label}: per step |pose - JAX pose| "
          + " ".join(f"{e:.1e}" for e in d_pose))
    print(f"{label}: launches {counts}; gauss_newton.run {iters_run} "
          f"iterations, {n_est[0]} sigma re-estimates; expected {want}")
    split = "".join(f"; {lab} p50 {np.percentile(t_ms[sel], 50):.3f}"
                    for lab, sel in (("keyframe steps", kf), ("others", ~kf))
                    if sel.any())
    print(f"{label}: {len(res) / (t_ms.sum() / 1e3):.2f} frames/s, per-frame "
          f"ms p50 {np.percentile(t_ms, 50):.3f} p90 "
          f"{np.percentile(t_ms, 90):.3f} max {t_ms.max():.3f}{split}")
    _require(np.all(np.isfinite(poses)), f"{label}: non-finite pose")
    _require(gt_err.max() <= bound, f"{label}: GT error {gt_err.max()} > "
                                    f"{bound}")
    _require(d_pose.max() <= T_ATOL_JAX_DENSE[name],
             f"{label}: poses differ from JAX by {d_pose.max()}")
    _require(np.array_equal(kf, ref_kf),
             f"{label}: keyframes {np.flatnonzero(kf)} vs JAX "
             f"{np.flatnonzero(ref_kf)}")
    for kernel, n in want.items():
        _require(counts[kernel] == n and (n > 0 or kernel == "irls_reduce"),
                 f"{label}: {kernel} launched {counts[kernel]} times, "
                 f"expected {n}")
    return counts, len(res) / (t_ms.sum() / 1e3), float(
        np.percentile(t_ms, 50)), float(np.percentile(t_ms, 90))


def _host_ops(run_step, n):
    """Top-level host ops of each of ``n`` steps (``run_step(i)``), counted
    as scripts/profile_torch_vo.py counts them: the ops torch.profiler
    records directly under the step's label, plus one for each CUDA-graph
    replay in the step (a replay is no PyTorch op)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from bpvo_tpu_torch.utils import graphs
    replays = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(n):
            r0 = graphs.replay_count
            with record_function(f"{STEP_LABEL}{i}"):
                run_step(i)
            replays.append(graphs.replay_count - r0)
    steps = {e.name: e for e in prof.events()
             if e.name.startswith(STEP_LABEL)}
    return [len(steps[f"{STEP_LABEL}{i}"].cpu_children) + replays[i]
            for i in range(n)]


def graph_phase(name, make_vo, frames, dev, smi):
    """One VO path, eager and graphed, in this process: each route once to
    warm up (the graphs' captures), once timed (host clock, each step
    ending in a sync) and once under torch.profiler for its host ops per
    step.  The graphed route is
    the entry point (``add_frame``); the eager one is ``DeviceVO``'s step
    function, or ``VisualOdometry`` with its pose estimator's graphs
    withheld.  Poses, iterations and keyframes must be equal bit for bit.
    Returns {route: {"p50_ms", "p90_ms", "kf_p50_ms", "kf_p90_ms",
    "other_p50_ms", "other_p90_ms", "host_ops_other", "host_ops_kf"}}."""
    import numpy as np
    import torch
    from bpvo_tpu_torch import VisualOdometry

    images = [torch.as_tensor(f[0]).to(dev) for f in frames]
    auxs = [torch.as_tensor(f[1]).to(dev) for f in frames]
    n = len(images) - 1

    def summary(out):
        """(poses, iterations, keyframe flag) of a step's output."""
        if isinstance(out, tuple):      # a VOStepOutput
            return (torch.cat([out.pose.reshape(-1),
                               out.pose_world.reshape(-1),
                               out.f_norm]).cpu().numpy(),
                    out.iters.cpu().numpy(), bool(out.is_keyframe))
        return (np.asarray(out.pose), np.array(
            [st.num_iterations for st in out.optimizer_statistics]),
            bool(out.is_keyframe))

    def route(graphed):
        vo = make_vo()
        if isinstance(vo, VisualOdometry):
            holder = [vo]

            def reset():
                # a new VisualOdometry (it has no reset) that takes over
                # the run graphs its predecessor captured, as one object
                # running on would hold them
                run_graphs = holder[0]._pose_estimator._run_graphs
                holder[0] = make_vo()
                if graphed:
                    holder[0]._pose_estimator._run_graphs = run_graphs
                else:
                    holder[0]._pose_estimator._level_graphs = (
                        lambda channels_pyr: None)
                holder[0].add_frame(images[0], auxs[0])

            def step(i):
                return holder[0].add_frame(images[i + 1], auxs[i + 1])
        else:
            state = [None]

            def reset():
                vo.state = None
                vo.add_frame(images[0], auxs[0])
                state[0] = vo.state

            def step(i):
                if graphed:
                    return vo.add_frame(images[i + 1], auxs[i + 1])
                state[0], out = vo._step(state[0], images[i + 1],
                                         auxs[i + 1])
                return out
        runs = []
        for _ in range(2):              # warm-up, then the timed pass
            reset()
            torch.cuda.synchronize()
            outs, t_ms = [], []
            for i in range(n):
                t0 = time.perf_counter()
                outs.append(step(i))
                torch.cuda.synchronize()
                t_ms.append((time.perf_counter() - t0) * 1e3)
            runs.append(([summary(o) for o in outs], np.array(t_ms)))
        reset()
        torch.cuda.synchronize()
        ops = np.array(_host_ops(step, n))
        return runs[1], ops

    (res_e, t_e), ops_e = route(False)
    (res_g, t_g), ops_g = route(True)
    kf = np.array([r[2] for r in res_e])
    same = all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
               and a[2] == b[2] for a, b in zip(res_e, res_g))
    out = {}
    for label, t_ms, ops in (("eager", t_e, ops_e), ("graphed", t_g, ops_g)):
        r = {"p50_ms": float(np.percentile(t_ms, 50)),
             "p90_ms": float(np.percentile(t_ms, 90))}
        for part, sel in (("kf", kf), ("other", ~kf)):
            if sel.any():
                r[f"{part}_p50_ms"] = float(np.percentile(t_ms[sel], 50))
                r[f"{part}_p90_ms"] = float(np.percentile(t_ms[sel], 90))
                r[f"host_ops_{part}"] = float(np.median(ops[sel]))
        out[label] = r
        print(f"graph phase {name} {label}: per-frame ms p50 "
              f"{r['p50_ms']:.3f} p90 {r['p90_ms']:.3f}; keyframe steps p50 "
              f"{r.get('kf_p50_ms', math.nan):.3f} p90 "
              f"{r.get('kf_p90_ms', math.nan):.3f}; others p50 "
              f"{r.get('other_p50_ms', math.nan):.3f} p90 "
              f"{r.get('other_p90_ms', math.nan):.3f}; top-level host ops "
              f"per other step {r.get('host_ops_other', math.nan):.0f}, per "
              f"keyframe step {r.get('host_ops_kf', math.nan):.0f} on {smi}")
    print(f"graph phase {name}: {n} steps, {int(kf.sum())} keyframes; "
          f"graphed and eager poses, iterations and keyframes bitwise equal: "
          f"{same}")
    _require(same, f"graph phase {name}: the graphed route differs from the "
                   f"eager one")
    _require(kf.any() and not kf.all(),
             f"graph phase {name}: {int(kf.sum())} keyframes in {n} steps")
    return out


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
    bound = _bound(_nbytes(x, got), OPS_CENSUS_PIXEL * x.numel())
    return float((got - want).abs().max()), t_raw, t_p, bound


def sgm_phase(pair, matcher, dev, ref, smi):
    """SGM aggregation kernel vs plain version on the pair's census cost
    volume, bit for bit; each pass's device time (back-to-back launches of
    its C entry point); the matcher's ms per call by stage; the matcher's
    frame-0 disparity vs JAX's."""
    import torch
    from bpvo_tpu_torch.data import stereo
    from bpvo_tpu_torch.ops import _build, census, sgm
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
    # the two passes alone, from their C entry points
    out, launches = sgm.pass_launches(cost, p1, p2)
    _require(all(launch() == 0 for launch in launches.values()),
             "sgm passes failed to launch")
    by_pass = {k: _cuda_ms(launch, SGM_REPS) for k, launch in launches.items()}
    _require(torch.equal(out, got), "sgm: the passes' output differs")
    bound = _bound(_nbytes(cost, got), OPS_SGM_COST * cost.numel())
    # bytes of the two-pass structure: the cost read 5 times, the carries
    # written and read, the output written
    H, W, _ = cost.shape
    scratch = _build.library().bpvo_sgm_scratch_floats(H, W, D) * 4
    structure = _bound(5 * _nbytes(cost) + 2 * scratch + _nbytes(got), 0)[0]
    print(f"sgm passes, device ms: carry {by_pass['carry']:.4f}, tile "
          f"{by_pass['tile']:.4f}; through the wrapper {t_k:.4f}; bound "
          f"{bound[0]:.4f} ({bound[1]}), the two-pass structure's bytes "
          f"{structure:.4f}; on {smi}")
    fn = matcher.as_fn()
    t_m = _cuda_ms(lambda: fn(left, right), SGM_REPS)
    stages = {
        "census": _cuda_ms(lambda: census.census(torch.stack([left, right])),
                           SGM_REPS),
        "cost_volume": _cuda_ms(
            lambda: stereo.census_cost_volume(codes[0], codes[1], D),
            SGM_REPS),
        "aggregation": t_k,
        "wta": _cuda_ms(lambda: stereo._wta_subpixel(got, D), SGM_REPS)}
    disp = fn(left, right)
    valid = disp > 0
    n_valid = int(valid.sum())
    mae = float((disp - gt).abs()[valid].mean())
    want_n, want_mae = int(ref["disp0_valid"]), float(ref["disp0_mean_abs_err"])
    print(f"matcher frame 0: {n_valid} valid (JAX {want_n}), mean |d - GT| "
          f"{mae:.6f} (JAX {want_mae:.6f}), {t_m:.4f} ms per call; by stage "
          + ", ".join(f"{k} {v:.4f}" for k, v in stages.items())
          + f" ms; on {smi}")
    _require(abs(n_valid - want_n) <= DISP_VALID_RTOL * want_n,
             f"disparity valid count {n_valid} vs JAX {want_n}")
    _require(abs(mae - want_mae) <= DISP_ERR_RTOL * want_mae,
             f"disparity mean |d - GT| {mae} vs JAX {want_mae}")
    del cost, got, want, one, one_want, out, launches
    return err, t_k, t_p, bound, {"ms_by_pass": by_pass,
                                  "structure_bound_ms": structure,
                                  "matcher_ms": t_m,
                                  "matcher_ms_by_stage": stages}


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


def _lap(t_start, name):
    print(f"{name} done at {time.perf_counter() - t_start:.1f} s")


def _pcts(ms):
    """{"p50_ms", "p90_ms"} of per-frame times, the first frame left out
    (it builds the first keyframe and warms the caches)."""
    import numpy as np
    ms = np.asarray(ms[1:])
    return {"p50_ms": float(np.percentile(ms, 50)),
            "p90_ms": float(np.percentile(ms, 90))}


def _app_runs(cfg, dev, label, modes, smi, prefix=None):
    """Run ``VoApp`` over ``cfg`` once per (threaded, prefetch) of
    ``modes``; every run's trajectory and iterations must equal the first
    run's bit for bit.  With ``prefix`` the first run writes its output
    files there, which must be JAX's set.  The first run starts with the
    launch counts at 0.  Returns ({mode: timings}, the first run's
    launches)."""
    import numpy as np
    from bpvo_tpu_torch.apps.vo_app import VoApp

    out, first = {}, None
    if prefix:
        os.makedirs(os.path.dirname(prefix), exist_ok=True)
    for k, (threaded, prefetch) in enumerate(modes):
        files = dict(trajectory_prefix=prefix, points_prefix=prefix) if (
            prefix and k == 0) else {}
        if k == 0:
            _reset_counts()
        res = VoApp.from_config(cfg, device=dev, threaded=threaded,
                                prefetch=prefetch, **files).run(log_every=0)
        if k == 0:
            launches = _counts()
        got = (np.stack(res.vo.trajectory.poses), res.iterations)
        _require(np.isfinite(got[0]).all(), f"{label}: non-finite poses")
        if first is None:
            first = got
        else:
            _require(np.array_equal(got[0], first[0]) and got[1] == first[1],
                     f"{label}: threaded={threaded} prefetch={prefetch} "
                     "differs from the first run")
        name = ("threaded_prefetch" if prefetch else "threaded") \
            if threaded else "unthreaded"
        out[name] = {"frames": res.num_frames,
                     "interval": _pcts(res.frame_interval_ms),
                     "add_frame": _pcts(res.frame_times_ms)}
        print(f"{label} {name}: {res.num_frames} frames, per frame "
              f"(end to end) p50 {out[name]['interval']['p50_ms']:.3f} / "
              f"p90 {out[name]['interval']['p90_ms']:.3f} ms, add_frame p50 "
              f"{out[name]['add_frame']['p50_ms']:.3f} ms on {smi}")
    if prefix:
        for suffix in ("_path.txt", "_poses.txt", "_kitti.txt", "_time.txt",
                       "_iterations.txt", "_00000.ply"):
            _require(os.path.exists(prefix + suffix),
                     f"{label}: {prefix + suffix} was not written")
    return out, launches


def app_phase(sframes, K, baseline, dev, smi):
    """The host data layer and the apps on the card: KITTI- and
    Tsukuba-layout trees written under build/app_phase, ``eval_kitti run``
    (counted), ``eval`` against the bounds, ``python -m
    bpvo_tpu_torch.apps.vo`` in a process of its own, VoApp threaded /
    prefetched / unthreaded (bitwise; with CUDA graphs on a dense config;
    TpuBlockMatching on synthetic_stereo and Tsukuba), the PNG decode and
    TpuBlockMatching times.  Returns the ``app_phase`` JSON object."""
    import shutil

    import numpy as np
    import torch
    from bpvo_tpu_torch.apps import eval_kitti
    from bpvo_tpu_torch.data import imageio, stereo
    from bpvo_tpu_torch.eval import kitti_eval

    t0 = time.perf_counter()
    root = os.path.join(HERE, "build", "app_phase")
    shutil.rmtree(root, ignore_errors=True)
    kitti = write_kitti_tree(os.path.join(root, "kitti"), sframes, K,
                             baseline, KITTI_SCALE)
    tsukuba = write_tsukuba_tree(os.path.join(root, "tsukuba"),
                                 APP_SHORT_FRAMES)
    tsukuba_pair = [imageio.imread(os.path.join(
        tsukuba, "illumination", "fluorescent", side,
        f"tsukuba_fluorescent_{side[0].upper()}_00001.png"))
        for side in ("left", "right")]
    rows, cols = sframes[0][0].shape
    gt_dir = os.path.join(kitti, "poses")
    path_m = float(kitti_eval.trajectory_distances(kitti_eval.load_poses(
        os.path.join(gt_dir, "00.txt")))[-1])
    print(f"app phase: trees written in {time.perf_counter() - t0:.1f} s")

    # the PNG decode of a stereo frame's two images (Paeth rows, the slow
    # path) on the host
    pngs = [os.path.join(kitti, "sequences", "00", cam, "000001.png")
            for cam in ("image_0", "image_1")]
    decode = []
    for _ in range(5):
        t = time.perf_counter()
        for p in pngs:
            imageio.imread(p)
        decode.append((time.perf_counter() - t) * 1e3)
    decode_ms = float(np.median(decode))
    print(f"PNG decode per stereo frame (2 x {rows}x{cols}, 8-bit, Paeth): "
          f"{decode_ms:.2f} ms (host)")

    def bounds(metrics, label):
        _require(metrics["segments"] >= 1, f"{label}: no 100 m segment")
        _require(metrics["t_err_percent"] <= KITTI_T_ERR_BOUND,
                 f"{label}: t_err {metrics['t_err_percent']:.3f}% > "
                 f"{KITTI_T_ERR_BOUND}%")
        _require(metrics["ate_rmse_m"] <= KITTI_ATE_PER_M * path_m,
                 f"{label}: ATE {metrics['ate_rmse_m']:.3f} m > "
                 f"{KITTI_ATE_PER_M * path_m:.3f} m")
        print(f"{label}: t_err {metrics['t_err_percent']:.4f}% (bound "
              f"{KITTI_T_ERR_BOUND}), r_err {metrics['r_err_deg_per_m']:.6f} "
              f"deg/m, ATE {metrics['ate_rmse_m']:.4f} m over {path_m:.1f} m "
              f"(bound {KITTI_ATE_PER_M * path_m:.3f})")

    # eval_kitti run (Intensity, TpuSGM: census and SGM every frame, level_gn
    # every level), with the counts at 0, then eval
    n = len(sframes)
    out = os.path.join(root, "eval_kitti")
    _reset_counts()
    eval_kitti.main(["run", "--root", kitti, "--out", out, "--seqs", "0",
                     "--device", str(dev)])
    counts = _counts()
    want = {"census_planes": 2 * (n + 1), "sgm_aggregate": n + 1,
            "fused_linearize": 0, "irls_reduce": 0}
    for name, k in want.items():
        _require(counts[name] == k, f"eval_kitti run: {name} launched "
                 f"{counts[name]} times, expected {k}")
    _require(counts["level_gn"] > 0, "eval_kitti run: level_gn never ran")
    print(f"eval_kitti run: {n} frames, launches {counts}")
    metrics = eval_kitti.evaluate(gt_dir, out, [0])["00"]
    bounds(metrics, "eval_kitti eval")

    # the command line, in a process of its own, on the same tree
    # (maxDepth: the scene is KITTI_SCALE times larger, and a keyframe's
    # PLY keeps the points nearer than maxDepth)
    cfg = os.path.join(root, "kitti.cfg")
    eval_kitti.make_kitti_config(kitti, 0).set("maxDepth", 1e6).save(cfg)
    cli = os.path.join(root, "cli", "00")
    os.makedirs(os.path.dirname(cli))
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "bpvo_tpu_torch.apps.vo", "--config", cfg,
         "--output", cli, "--points", "--device", str(dev)], cwd=HERE,
        capture_output=True, text=True, timeout=600)
    _require(proc.returncode == 0, "python -m bpvo_tpu_torch.apps.vo failed:"
             f"\n{proc.stderr[-3000:]}")
    print(f"python -m bpvo_tpu_torch.apps.vo: {time.perf_counter() - t:.1f} s"
          f"; {(proc.stderr.strip().splitlines() or [''])[-1]}")
    for suffix in ("_path.txt", "_poses.txt", "_kitti.txt", "_time.txt",
                   "_iterations.txt", "_00000.ply"):
        _require(os.path.exists(cli + suffix), f"apps.vo wrote no {suffix}")
    shutil.copy(cli + "_kitti.txt", os.path.join(os.path.dirname(cli),
                                                 "00.txt"))
    cli_metrics = eval_kitti.evaluate(gt_dir, os.path.dirname(cli), [0])["00"]
    bounds(cli_metrics, "apps.vo + eval_kitti eval")

    # VoApp threaded and prefetched / threaded / unthreaded: bitwise, timed;
    # the first run counted (census and SGM from the loader thread)
    modes = ((True, True), (True, False), (False, False))
    kitti_runs, app_counts = _app_runs(
        cfg, dev, f"VoApp kitti {rows}x{cols} TpuSGM", modes, smi,
        os.path.join(root, "app", "00"))
    _require(app_counts == counts, f"VoApp threaded: launches {app_counts},"
             f" eval_kitti run's {counts}")
    # dense (NMS off, capacity 131072): L0 and L1 replay CUDA graphs that
    # are captured while the loader thread runs SGM
    dense_cfg = os.path.join(root, "kitti_dense.cfg")
    cf = eval_kitti.make_kitti_config(kitti, 0).set("maxDepth", 1e6)
    for key, value in DENSE.items():
        cf.set(key, value)
    cf.save(dense_cfg)
    from bpvo_tpu_torch.utils import graphs
    replays = graphs.replay_count
    dense_runs, _ = _app_runs(dense_cfg, dev,
                              f"VoApp kitti dense {rows}x{cols}", modes[::2],
                              smi)
    _require(graphs.replay_count > replays, "dense VoApp replayed no graph")

    # TpuBlockMatching through the synthetic_stereo and Tsukuba datasets
    syn_cfg = os.path.join(root, "synthetic_stereo.cfg")
    with open(syn_cfg, "w") as f:
        f.write(f"Dataset = synthetic_stereo\nSyntheticRows = {rows}"
                f"\nSyntheticCols = {cols}\nSyntheticNumFrames = "
                f"{APP_SHORT_FRAMES}\nStereoAlgorithm = TpuBlockMatching\n"
                "numberOfDisparities = 128\nminSaliency = 2.0\n"
                "numPyramidLevels = 4\nfunctionTolerance = 1e-4\n"
                "parameterTolerance = 1e-6\n")
    syn_runs, _ = _app_runs(syn_cfg, dev,
                            f"VoApp synthetic_stereo {rows}x{cols} "
                            "TpuBlockMatching D=128", modes[::2], smi,
                            os.path.join(root, "synthetic", "out"))
    tsu_cfg = os.path.join(root, "tsukuba_stereo.cfg")
    with open(os.path.join(HERE, "conf", "tsukuba_stereo.cfg")) as src, \
            open(tsu_cfg, "w") as f:
        for line in src:
            key = line.split("=")[0].strip()
            if key not in ("DataSetRootDirectory", "StereoAlgorithm"):
                f.write(line)
        f.write(f"DataSetRootDirectory = {tsukuba}\n"
                "StereoAlgorithm = TpuBlockMatching\n")
    tsu_runs, _ = _app_runs(tsu_cfg, dev, "VoApp tsukuba_stereo {}x{} "
                            "TpuBlockMatching D=96".format(
                                *tsukuba_pair[0].shape), modes[::2], smi,
                            os.path.join(root, "tsukuba_out", "out"))

    # TpuBlockMatching per call (CUDA events), and the card against the CPU
    bm_ms, bm_share = {}, {}
    for (L, R), D in (
            ([np.clip(np.round(x), 0, 255).astype(np.uint8)
              for x in sframes[0][:2]], 128),
            (tsukuba_pair, 96)):
        label = "{}x{}x{}".format(*L.shape, D)
        bm = stereo.TpuBlockMatching(num_disparities=D)
        Lt, Rt = (torch.as_tensor(x).to(dev, torch.float32) for x in (L, R))
        fn = bm.as_fn()
        bm_ms[label] = _cuda_ms(lambda: fn(Lt, Rt), 10)
        cpu = bm.run(L, R, device="cpu")
        gpu = bm.run(L, R, device=dev)
        bm_share[label] = float(np.mean(cpu.view(np.int32)
                                        == gpu.view(np.int32)))
        _require(bm_share[label] >= BM_SHARE_FLOOR,
                 f"TpuBlockMatching {label}: card and CPU equal on "
                 f"{bm_share[label]:.6f} of the pixels")
        print(f"TpuBlockMatching {label}: {bm_ms[label]:.3f} ms per call on "
              f"{smi}; card vs CPU bitwise on {bm_share[label]:.6f} of the "
              "pixels")
    print(f"app phase: {time.perf_counter() - t0:.1f} s")
    return {"device": smi, "frames": n, "eval_kitti": metrics,
            "apps_vo_cli": cli_metrics, "path_m": path_m,
            "launches": counts, "png_decode_ms_per_frame": decode_ms,
            "kitti": kitti_runs, "kitti_dense": dense_runs,
            "synthetic_stereo": syn_runs, "tsukuba_stereo": tsu_runs,
            "block_matching_ms": bm_ms,
            "block_matching_card_cpu_equal_share": bm_share}


def _fused_zoo_check(label, td, ch, cam, opts):
    """fused_linearize against its plain version on one template level at
    the identity pose (phase 7's checks).  Returns (max |dw|, (ms, plain
    ms, replayed ms, plain replayed ms), (bound ms, bound by), device
    kernels per call)."""
    import torch
    from bpvo_tpu_torch.ops import fused_linearize as fl
    from bpvo_tpu_torch.ops import interp
    from bpvo_tpu_torch.probes import timing
    from bpvo_tpu_torch.solver import mestimator
    from bpvo_tpu_torch.vo import template_data, warp
    T0 = torch.eye(4, dtype=torch.float32, device=ch.device)
    C, K = td.pixels.shape
    u, v, Z = warp.project(cam, T0, td.points)
    ok = td.valid & (Z > 1e-6) & interp.valid_mask(
        u, v, ch.shape[1], ch.shape[2], opts.interp)
    r, _ = template_data.compute_residuals(td, ch, cam, T0, opts.interp)
    sigma = mestimator.estimate_scale(r[0], ok)
    a = (u, v, ok, ch, td.pixels, td.jacobians, sigma, opts.loss,
         opts.interp)
    got = fl.fused_linearize(*a)
    want = fl.fused_linearize_reference(*a)
    torch.cuda.synchronize()
    r0_same = torch.equal(got[3].view(torch.int32), want[3].view(torch.int32))
    t_k = _cuda_ms(lambda: fl.fused_linearize(*a), KERNEL_REPS)
    t_p = _cuda_ms(lambda: fl.fused_linearize_reference(*a), PLAIN_REPS)
    d_k = timing.graph_ms(lambda: fl.fused_linearize(*a), KERNEL_REPS,
                          GN_PER_GRAPH)
    d_p = timing.graph_ms(lambda: fl.fused_linearize_reference(*a),
                          KERNEL_REPS, GN_PER_GRAPH)
    n_k = len(timing.device_kernels(lambda: fl.fused_linearize(*a)))
    print(f"  {label}: K={K}, {int(ok.sum())} points in view, r0 bitwise "
          f"{r0_same}; kernel {t_k:.4f} ms through the wrapper, {d_k:.4f} "
          f"ms replayed, {n_k} device kernel(s) per call; plain {t_p:.4f} "
          f"ms, {d_p:.4f} ms replayed")
    _require(r0_same, f"{label}: r0 differs from the plain version")
    _require(n_k == 1, f"{label}: {n_k} device kernels per call")
    dw = _gn_check(label, got, want)
    bound = _bound(_nbytes(*a[:3], *a[4:7], *got) + _tap_bytes(
        ch, _taps(u, v, ok, ch.shape[1], ch.shape[2])),
        K * (OPS_LIN_POINT + C * OPS_LIN_CHANNEL))
    return dw, (t_k, t_p, d_k, d_p), bound, n_k


def _irls_zoo_check(label, td, ch, cam, opts):
    """irls_reduce_w (and irls_reduce) against the plain version on the
    gather route: the template's residuals sampled by ``opts.interp`` at
    the identity pose, sigma from channel 0.  Returns (max |dw|, (ms,
    plain ms, replayed ms, plain replayed ms, no-weights ms, no-weights
    replayed ms), (bound ms, by, no-weights bound ms, by), device kernels
    per call)."""
    import torch
    from bpvo_tpu_torch.ops import irls
    from bpvo_tpu_torch.probes import timing
    from bpvo_tpu_torch.solver import mestimator
    from bpvo_tpu_torch.vo import template_data
    T0 = torch.eye(4, dtype=torch.float32, device=ch.device)
    C, K = td.pixels.shape
    r, ok = template_data.compute_residuals(td, ch, cam, T0, opts.interp,
                                            warp=opts.warp)
    sigma = mestimator.estimate_scale(r[0], ok)
    b = (td.jacobians.reshape(-1, 6), r.reshape(-1),
         ok.expand(C, K).reshape(-1), sigma, opts.loss)
    got = irls.irls_reduce_w(*b)
    got3 = irls.irls_reduce(*b)
    want = irls.irls_reduce_reference(*b)
    torch.cuda.synchronize()
    _require(all(torch.equal(x, y) for x, y in zip(got3, got[:3])),
             f"{label}: irls_reduce and irls_reduce_w differ")
    t_k = _cuda_ms(lambda: irls.irls_reduce_w(*b), KERNEL_REPS)
    t_p = _cuda_ms(lambda: irls.irls_reduce_reference(*b), PLAIN_REPS)
    d_k = timing.graph_ms(lambda: irls.irls_reduce_w(*b), KERNEL_REPS,
                          GN_PER_GRAPH)
    d_p = timing.graph_ms(lambda: irls.irls_reduce_reference(*b),
                          KERNEL_REPS, GN_PER_GRAPH)
    t_3 = _cuda_ms(lambda: irls.irls_reduce(*b), KERNEL_REPS)
    d_3 = timing.graph_ms(lambda: irls.irls_reduce(*b), KERNEL_REPS,
                          GN_PER_GRAPH)
    n_k = max(len(timing.device_kernels(fn)) for fn in (
        lambda: irls.irls_reduce_w(*b), lambda: irls.irls_reduce(*b)))
    print(f"  {label}: M={C * K}, {int(ok.sum())} points in view; "
          f"irls_reduce_w {t_k:.4f} ms through the wrapper, {d_k:.4f} ms "
          f"replayed; irls_reduce {t_3:.4f} / {d_3:.4f} ms; {n_k} device "
          f"kernel(s) per call; plain {t_p:.4f} ms, {d_p:.4f} ms replayed")
    _require(n_k == 1, f"{label}: {n_k} device kernels per call")
    dw = _gn_check(label, got, want)
    ops = C * K * OPS_IRLS_TERM
    bound = (_bound(_nbytes(*b[:4], *got), ops)
             + _bound(_nbytes(*b[:4], *got3), ops))
    return dw, (t_k, t_p, d_k, d_p, t_3, d_3), bound, n_k


def _world_of(run):
    """World poses (n, 4, 4) of a KITTI-format trajectory file."""
    import numpy as np
    rows = np.loadtxt(run, ndmin=2).reshape(-1, 3, 4)
    bottom = np.broadcast_to([0.0, 0.0, 0.0, 1.0], (len(rows), 1, 4))
    return np.concatenate([rows, bottom], axis=1)


def _zoo_corridor(dev, root):
    """(corridor config path, its parameters, dataset, K, baseline, image
    size) of the zoo phase, its configs written under ``root``."""
    from bpvo_tpu_torch import AlgorithmParameters, ConfigFile
    from bpvo_tpu_torch.data.dataset import create_dataset
    corridor_cfg = write_zoo_configs(root, os.path.join(
        HERE, "build", "app_phase", "tsukuba"))[0]
    ds = create_dataset(ConfigFile(corridor_cfg), device=dev)
    return (corridor_cfg, AlgorithmParameters.from_config(
        ConfigFile(corridor_cfg)), ds, ds.calibration.K,
        ds.calibration.baseline, ds.image_size)


def zoo_kernel_phase(dev):
    """The option zoo's kernel checks on the corridor at 240x320 (see the
    module docstring, phase 12): level_gn at C = 3, 5, 10, 48;
    fused_linearize at C = 3, 5, 10 above 16384 points; irls_reduce_w on
    the gather route; LATCH's bits card vs CPU.  Returns ({"C=<n>":
    kernel_phase result}, {shape: fused check}, {shape: irls check},
    (flipped bits, bits))."""
    import torch
    from bpvo_tpu_torch import DescriptorType, InterpolationType
    from bpvo_tpu_torch.ops import descriptors
    from bpvo_tpu_torch.vo import device_vo

    t0 = time.perf_counter()
    _, base, ds, K, b, shape = _zoo_corridor(
        dev, os.path.join(HERE, "build", "zoo_phase"))
    f0, f1 = ds.get_frame(0), ds.get_frame(1)

    def params(desc, **kw):
        return base.replace(descriptor=DescriptorType(desc), **kw)

    # level_gn at C = 3, 5, 10, 48 on the corridor's finest level
    lg_zoo = {}
    for desc in ("IntensityAndGradient", "DescriptorFields1",
                 "DescriptorFields2", "CentralDifference"):
        p = params(desc)
        C = descriptors.num_channels(p.descriptor, p)
        print(f"zoo level_gn {desc} C={C}:")
        vo = device_vo.DeviceVO(K, b, shape, p, device=dev)
        lg_zoo[f"C={C}"] = kernel_phase(vo, (f0.image, f0.disparity),
                                        f1.image, dev, levels=(0,))
        del vo

    # fused_linearize at C = 3, 5, 10 above 16384 points (NMS off): the
    # finest level of a dense corridor template
    fused, irls_ = {}, {}
    for desc in ("IntensityAndGradient", "DescriptorFields1",
                 "DescriptorFields2"):
        p = params(desc, pointCapacity=65536,
                   minNumPixelsForNonMaximaSuppression=10 ** 9)
        vo = device_vo.DeviceVO(K, b, shape, p, device=dev)
        vo.init(f0.image, f0.disparity)
        ch = device_vo._compute_channels_pyr(
            torch.as_tensor(f1.image).to(dev), p, p.numPyramidLevels)[0]
        C = ch.shape[0]
        fused[f"zoo dense L0 C={C}"] = _fused_zoo_check(
            f"fused_linearize zoo dense L0 C={C}", vo.state.templates[0], ch,
            vo._cams[0], vo._opts[0])
        del vo

    # irls_reduce_w on the gather route: Bit-Planes (C = 8) under
    # CUBIC_HERMITE at the corridor's finest level
    p = params("BitPlanes", interp=InterpolationType.CUBIC_HERMITE)
    vo = device_vo.DeviceVO(K, b, shape, p, device=dev)
    vo.init(f0.image, f0.disparity)
    ch = device_vo._compute_channels_pyr(
        torch.as_tensor(f1.image).to(dev), p, p.numPyramidLevels)[0]
    irls_["zoo gather L0 M=8K"] = _irls_zoo_check(
        "irls_reduce zoo gather (Bit-Planes, CUBIC_HERMITE) L0 M=8K",
        vo.state.templates[0], ch, vo._cams[0], vo._opts[0])
    del vo

    # LATCH's comparison bits, card against CPU, on corridor frame 0
    img = torch.as_tensor(f0.image, dtype=torch.float32)
    bits_gpu = descriptors.latch(img.to(dev), base.latchNumBytes,
                                 base.latchHalfSsdSize, sigma_post=0.0).cpu()
    bits_cpu = descriptors.latch(img, base.latchNumBytes,
                                 base.latchHalfSsdSize, sigma_post=0.0)
    flips = int((bits_gpu != bits_cpu).sum())
    print(f"LATCH bits card vs CPU: {flips} of {bits_cpu.numel()} flipped")
    _require(flips <= LATCH_FLIP_BOUND * bits_cpu.numel(),
             f"LATCH: {flips} bits flipped between card and CPU")
    _lap(t0, "zoo kernel checks")
    return lg_zoo, fused, irls_, (flips, bits_cpu.numel())


def zoo_phase(dev, smi, tsukuba_root, latch_bits):
    """The option zoo's VO runs on the card (see the module docstring,
    phase 12): eval_descriptors against the JAX reference (the main path,
    counted), the gather and dense zoo routes, conf/tsukuba.cfg through
    apps.vo on the NewTsukuba tree at ``tsukuba_root``.  ``latch_bits``:
    zoo_kernel_phase's (flipped, bits).  Returns (the ``zoo_phase`` JSON
    object, {path: launch counts})."""
    import shutil

    import numpy as np
    from bpvo_tpu_torch import (DescriptorType, InterpolationType,
                                VisualOdometry)
    from bpvo_tpu_torch.apps import eval_descriptors
    from bpvo_tpu_torch.ops import descriptors
    from bpvo_tpu_torch.utils import graphs

    t0 = time.perf_counter()
    ref = dict(np.load(REF_ZOO_NPZ))
    _require(int(ref["frames"]) == ZOO_FRAMES,
             f"{REF_ZOO_NPZ} holds {int(ref['frames'])} frames per cell, "
             f"this script runs {ZOO_FRAMES}")
    root = os.path.join(HERE, "build", "zoo_phase")
    shutil.rmtree(root, ignore_errors=True)
    corridor_cfg, base, ds, K, b, shape = _zoo_corridor(dev, root)
    tsukuba_cfg = write_zoo_configs(root, tsukuba_root)[1]

    def params(desc, **kw):
        return base.replace(descriptor=DescriptorType(desc), **kw)

    # the main path: apps.eval_descriptors, all 8 descriptors with GN and
    # LM, with the counts at 0
    launches = {}
    traj = {}
    _reset_counts()
    t = time.perf_counter()
    cells = eval_descriptors.run(corridor_cfg, os.path.join(root, "eval"),
                                 -1, None, ZOO_SOLVERS, device=dev,
                                 trajectories=traj)
    wall = time.perf_counter() - t
    launches["zoo_eval_descriptors"] = _counts()
    print(f"eval_descriptors: {len(cells)} cells x {ZOO_FRAMES} frames in "
          f"{wall:.1f} s, launches {launches['zoo_eval_descriptors']}")
    _require(launches["zoo_eval_descriptors"]["level_gn"] > 0,
             "eval_descriptors: level_gn never ran")
    _require(launches["zoo_eval_descriptors"]["irls_reduce"] > 0,
             "eval_descriptors: irls_reduce never ran (LM at C > 1)")
    table = {}
    pooled = {solver: [0.0, 0.0] for solver in ZOO_SOLVERS}
    for desc in ZOO_DESCRIPTORS:
        p = params(desc)
        C = descriptors.num_channels(p.descriptor, p)
        for solver in ZOO_SOLVERS:
            tag, key = f"{desc}+{solver}", f"{desc}_{solver}"
            if tag in ZOO_JAX_LEVEL_ROUTE:
                key += "_level"
            atol = ZOO_ATOL_C1 if C == 1 else ZOO_ATOL
            got, want = traj[tag], ref[f"{key}_world"]
            err = float(np.abs(got - want).max())
            cell = dict(cells[tag], max_pose_diff=err,
                        jax_ate_rmse_m=float(ref[f"{key}_ate"]),
                        jax_mean_iters=float(np.mean(
                            ref[f"{key}_iters"][5:])),
                        jax_route="level" if key.endswith("_level")
                        else "cpu")
            table[tag] = cell
            pooled[solver][0] += cell["mean_iters"]
            pooled[solver][1] += cell["jax_mean_iters"]
            print(f"  {tag:40s} C={C:2d}: {cell['mean_ms']:8.3f} ms/frame, "
                  f"{cell['mean_iters']:6.1f} iterations/frame (JAX "
                  f"{cell['jax_mean_iters']:.1f}, {cell['jax_route']} "
                  f"route), ATE {cell['ate_rmse_m']:.5f} m (JAX "
                  f"{cell['jax_ate_rmse_m']:.5f}), max |pose - JAX| "
                  f"{err:.3e} on {smi}")
            _require(np.isfinite(got).all() and got.shape == want.shape,
                     f"eval_descriptors {tag}: poses not finite or "
                     f"{got.shape} frames")
            _require(err <= atol, f"eval_descriptors {tag}: pose differs "
                     f"from JAX's by {err} > {atol}")
            _require(cell["ate_rmse_m"] <= cell["jax_ate_rmse_m"]
                     + ZOO_ATE_MARGIN, f"eval_descriptors {tag}: ATE "
                     f"{cell['ate_rmse_m']} > JAX's + {ZOO_ATE_MARGIN}")
            _require(abs(cell["mean_iters"] - cell["jax_mean_iters"])
                     <= ZOO_ITERS_CELL, f"eval_descriptors {tag}: "
                     f"{cell['mean_iters']} iterations/frame, JAX "
                     f"{cell['jax_mean_iters']}")
    for solver, (n_port, n_jax) in pooled.items():
        print(f"  {solver}: {n_port:.2f} iterations/frame summed over the "
              f"{len(ZOO_DESCRIPTORS)} descriptors (JAX {n_jax:.2f})")
        _require(abs(n_port - n_jax) <= ZOO_ITERS_POOLED * n_jax,
                 f"eval_descriptors {solver}: {n_port} iterations/frame "
                 f"summed over the cells, JAX {n_jax}")
    _lap(t0, "zoo eval_descriptors")

    # the gather route (Bit-Planes, CUBIC_HERMITE: every level on
    # gauss_newton.run, irls_reduce_w inside its CUDA graphs) and dense
    # DescriptorFields1 (C = 5 on fused_linearize at L0 and L1), 1+4
    # frames each, with the counts at 0
    frames = [ds.get_frame(i) for i in range(5)]
    for name, p in (
            ("zoo_gather", params("BitPlanes",
                                  interp=InterpolationType.CUBIC_HERMITE)),
            ("zoo_dense", params("DescriptorFields1", pointCapacity=65536,
                                 minNumPixelsForNonMaximaSuppression=10 ** 9))):
        vo = VisualOdometry(K, b, shape, p, device=dev)
        _reset_counts()
        replays = graphs.replay_count
        poses = [vo.add_frame(f.image, f.disparity).pose for f in frames]
        launches[name] = dict(_counts(),
                              graph_replays=graphs.replay_count - replays)
        gt = np.stack([ds.gt_world_pose(i) for i in range(5)])
        err = float(np.abs(np.stack(vo.trajectory.poses) - gt).max())
        print(f"{name}: launches {launches[name]} over {len(frames) - 1} "
              f"frames, max |world pose - ground truth| {err:.3e}")
        _require(np.isfinite(np.stack(poses)).all(), f"{name}: poses")
        _require(err <= ZOO_GT_BOUND, f"{name}: {err} from ground truth")
        kernel = "irls_reduce" if name == "zoo_gather" else "fused_linearize"
        _require(launches[name][kernel] > 0, f"{name}: {kernel} never ran")
        _require(launches[name]["graph_replays"] > 0,
                 f"{name}: no CUDA graph replayed")
        del vo

    # conf/tsukuba.cfg (CD5, CUBIC_HERMITE) through the command line in a
    # process of its own, on the app phase's NewTsukuba tree
    out = os.path.join(root, "tsukuba", "out")
    os.makedirs(os.path.dirname(out))
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "bpvo_tpu_torch.apps.vo", "--config",
         tsukuba_cfg, "--output", out, "--device", str(dev)], cwd=HERE,
        capture_output=True, text=True, timeout=600)
    _require(proc.returncode == 0, "apps.vo --config tsukuba.cfg failed:\n"
             f"{proc.stderr[-3000:]}")
    world = _world_of(out + "_kitti.txt")
    want = ref["tsukuba_world"]
    err = float(np.abs(world - want).max()) if world.shape == want.shape \
        else math.inf
    print(f"apps.vo --config conf/tsukuba.cfg: {len(world)} frames in "
          f"{time.perf_counter() - t:.1f} s, max |pose - JAX| {err:.3e}; "
          f"{(proc.stderr.strip().splitlines() or [''])[-1]}")
    _require(np.isfinite(world).all() and err <= ZOO_ATOL_C1,
             f"apps.vo tsukuba: poses differ from JAX's by {err}")
    _lap(t0, "zoo phase")
    return ({"device": smi, "frames": ZOO_FRAMES, "cells": table,
             "eval_descriptors_s": wall, "launches": launches,
             "latch_flipped_bits": latch_bits[0],
             "latch_bits": latch_bits[1], "tsukuba_max_pose_diff": err},
            launches)


def _probe_entry(smi, name, source, replaces, launches, step, var, shape):
    """One probe kernel's entry of the kernels line, from the probe runner's
    result: ``var`` holds the kernel's check against its plain version and
    its times (CUDA-graph replay, through the wrapper), ``step`` the plain
    version's and the library call's times and the work the bound counts."""
    bound, by = _bound(step["bytes"], step["ops"])
    lib = step.get("library_ms")
    lib_text = (f"; library {lib * 1e3:.3f} us replayed, "
                f"{step['library_wrapper_ms'] * 1e3:.3f} us" if lib is not None
                else "; no library call")
    print(f"probe {name} {shape}: max|d| {var['max_abs_err']:.3e} "
          f"({'agrees' if var['ok'] else 'DIFFERS'}); kernel "
          f"{var['ms'] * 1e3:.3f} us replayed, {var['wrapper_ms'] * 1e3:.3f} "
          f"us through the wrapper; plain {step['plain_ms'] * 1e3:.3f} us "
          f"replayed, {step['plain_wrapper_ms'] * 1e3:.3f} us{lib_text}; "
          f"bound {bound * 1e3:.4f} us ({by}); {launches} launches on the "
          f"runner run; on {smi}")
    _require(var["ok"], f"probe {name} {shape}: kernel differs from its "
                        f"plain version (max |d| {var['max_abs_err']})")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": var["max_abs_err"], "ms": var["ms"],
            "wrapper_ms": var["wrapper_ms"], "plain_ms": step["plain_ms"],
            "plain_wrapper_ms": step["plain_wrapper_ms"], "bound_ms": bound,
            "bound_by": by, "library_ms": lib,
            "library_wrapper_ms": step.get("library_wrapper_ms"),
            "shape": shape}


def probe_phase(dev, smi):
    """The probe microbenchmarks: the runner's four groups once with the
    launch counts at 0 (the probes' main path).  Its steps hold every probe
    kernel and variant against its plain version and time it, the plain
    version and the library call; this phase requires every check to hold
    and every probe kernel to have launched, and turns the results into
    entries of the kernels line."""
    from bpvo_tpu_torch import probes
    from bpvo_tpu_torch.probes import band, gather
    from bpvo_tpu_torch.probes import kernel_features as kf

    t0 = time.perf_counter()
    probes.reset_launch_counts()
    report = probes.run(tuple(probes.GROUPS), dev)
    counts = probes.launch_counts()
    res = report["results"]
    print(f"probe runner ({time.perf_counter() - t0:.1f} s): launches "
          f"{counts}")
    print(f"probe runner results: {json.dumps(res)}")
    fails = [f"{g}.{k}" for g, steps in res.items()
             for k, v in steps.items() if "FAIL" in json.dumps(v)]
    _require(not fails, f"probe runner steps failed: {fails}")
    _require(all(n > 0 for n in counts.values()),
             f"probe kernels not launched by the runner: {counts}")
    feat, gat = res["features"], res["gather"]

    loop = feat["while_loop"]
    variants = [kf.variant_name(b, c) for b, c in kf.WHILE_VARIANTS]
    print("per-iteration barrier cost, us (1024 - 7 iterations): " + ", ".join(
        f"{n} {loop[n]['us_per_iter']:.4f}" for n in variants)
        + f"; grid of {loop.get('grid_ctas')} CTAs; on {smi}")
    entries = []
    src = "bpvo_tpu_torch/csrc/probe_features.cu"
    fscript = "scripts/probe_kernel_features.py"
    for barrier in kf.BARRIERS:
        names = [kf.variant_name(b, c) for b, c in kf.WHILE_VARIANTS
                 if b == barrier]
        by_variant = {n: _probe_entry(
            smi, n, src, fscript + ":37 (pallas_call :76)",
            counts[f"while_loop_{barrier}"], loop, loop[n],
            "(8, 128), 7 iterations") for n in names}
        # the entry: the last variant (a cluster of 16 for "cluster")
        entries.append(dict(
            by_variant[names[-1]], name=f"while_loop_{barrier}",
            max_abs_err=max(v["max_abs_err"] for v in by_variant.values()),
            ms_by_variant={k: v["ms"] for k, v in by_variant.items()},
            us_per_iter_by_variant={k: loop[k]["us_per_iter"]
                                    for k in names}))
    for name, line, shape in (
            ("scalar_chain", ":52 (pallas_call :82)", "(3,)"),
            ("matmul_chain", ":63 (pallas_call :89)",
             "(8, 128) @ (128, 128) x 5")):
        entries.append(_probe_entry(smi, name, src, fscript + line,
                                    counts[name], feat[name], feat[name],
                                    shape))

    # the lane gather: the script's three row lengths, and tpu_kernel_probe's
    # L0 image; the entry of each placement is the L0 image where it fits,
    # else its largest row
    gsrc = "bpvo_tpu_torch/csrc/probe_gather.cu"
    grep = ("scripts/probe_gather_variants.py:99 (pallas_call :110), "
            "scripts/tpu_kernel_probe.py:76 (pallas_call :88)")
    lane_steps = dict(zip(gather.LANES, (gat["taa_1k"], gat["taa_16k"],
                                         gat["taa_flat"])))
    lane_steps[gather.KITTI_H * gather.KITTI_W] = (
        res["kernel"]["pallas_gather"])
    for lanes, r in lane_steps.items():
        print(f"gather (8, {lanes}), us: " + ", ".join(
            f"{p} {r[p]['ms'] * 1e3:.3f}" if isinstance(r[p], dict)
            else f"{p} n/a" for p in gather.PLACEMENTS)
            + f", plain {r['plain_ms'] * 1e3:.3f}, take_along_dim "
              f"{r['library_ms'] * 1e3:.3f}; resident dsmem clusters "
              f"{r.get('dsmem_max_active_clusters')}; on {smi}")
    for placement in gather.PLACEMENTS:
        by_lanes = {lanes: _probe_entry(
            smi, f"take_along_lanes_{placement}", gsrc, grep,
            counts[f"take_along_lanes_{placement}"], r, r[placement],
            f"(8, {lanes}) lanes, {gather.N} indices")
            for lanes, r in lane_steps.items()
            if gather.fits(lanes, placement)}
        kitti = gather.KITTI_H * gather.KITTI_W
        e = dict(by_lanes[kitti if kitti in by_lanes else max(by_lanes)])
        e["max_abs_err"] = max(v["max_abs_err"] for v in by_lanes.values())
        for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
            e[f"{key}_by_lanes"] = {k: v[key] for k, v in by_lanes.items()}
        entries.append(e)

    # band bilinear, staged and straight from device memory, on the script's
    # points and on points that leave their band (the clipping)
    bsrc = "bpvo_tpu_torch/csrc/probe_band.cu"
    wide = gat["band_wide"]
    _require(wide["maxerr_vs_unbanded"] > 0,
             "band_bilinear: no point of the wide run left its band")
    for variant in ("staged", "global"):
        name = "band_bilinear" + ("" if variant == "staged" else "_global")
        replaces = "scripts/probe_gather_variants.py:133 (pallas_call :171)"
        shape = (f"N={gather.N} points, {band.H}x{band.W}, band {band.BAND}")
        e = _probe_entry(smi, name, bsrc, replaces, counts[name], gat["band"],
                         gat["band"][variant], shape + ", the script's points")
        w = _probe_entry(smi, name, bsrc, replaces, counts[name], wide,
                         wide[variant], shape + ", points over the whole "
                                                "image")
        e["max_abs_err"] = max(e["max_abs_err"], w["max_abs_err"])
        e["wide_points"] = {k: w[k] for k in ("max_abs_err", "ms", "plain_ms",
                                              "library_ms", "bound_ms")}
        entries.append(e)
    print(f"band_bilinear: max |banded - unbanded| "
          f"{gat['band']['maxerr_vs_unbanded']:.3e} on the script's points, "
          f"{wide['maxerr_vs_unbanded']:.3e} on points over the whole image")

    # v1-v5
    bis = "scripts/probe_band_bisect.py"
    lines = {"v1_static_slice": ":50", "v2_dyn_slice": ":56",
             "v3_onehot": ":64", "v4_onehot_matmul": ":75",
             "v5_rowweight": ":88"}
    for name, *_ in band.PARTS:
        r = res["band"][name]
        entries.append(_probe_entry(
            smi, f"band_{name}", bsrc, f"{bis}{lines[name]} (pallas_call :30)",
            counts[f"band_{name}"], r, r, "(8, 128) out"))
    print(f"probe phase: {time.perf_counter() - t0:.1f} s")
    return entries


REF_SHARDED_NPZ = os.path.join(HERE, "tests", "data",
                               "torch_port_sharded_ref.npz")
# sharded VO vs DeviceVO on the card: JAX's dry run's bound, gated for
# intensity; Bit-Planes misses it (open fault C.13: the sharded sigma rule,
# shown by the rule witness) and is bounded by SHARDED_ATOL_JAX instead
SHARDED_ATOL_DEVICE_VO = 1e-3
SHARDED_ATOL_JAX = 5e-4        # sharded VO vs JAX's sharded VO
BA_ATOL_JAX = 5e-4             # BA keyframe windows vs JAX's
BA_DEPTH_ATOL = 1e-3           # ba_solve_with_depth, card vs CPU
BA_DEPTH_M, BA_DEPTH_ITERS = 4, 4
# JAX's 8-device dry run: all-reduces in the compiled per-frame step (its
# while-loop bodies counted once each) and their bytes (MULTICHIP_r05.json)
JAX_STEP_ALL_REDUCES, JAX_STEP_ALL_REDUCE_BYTES = 19, 25468


def distributed_phase(dev, smi):
    """Phase 13 (see the module docstring): the distributed layer on the
    card.  Returns (the ``distributed_phase`` JSON object, {path: launch
    counts}, {shape: fused_linearize check}, {shape: irls_reduce
    check})."""
    import dataclasses

    import numpy as np
    import torch
    from bpvo_tpu_torch import AlgorithmParameters, DescriptorType
    from bpvo_tpu_torch import VisualOdometry
    from bpvo_tpu_torch.apps import scaling_bench
    from bpvo_tpu_torch.data import synthetic
    from bpvo_tpu_torch.ops import fused_linearize
    from bpvo_tpu_torch.parallel import bundle_adjustment as ba
    from bpvo_tpu_torch.parallel import dryrun, multihost, sharded
    from bpvo_tpu_torch.parallel import sharded_vo
    from bpvo_tpu_torch.solver import gauss_newton as gn
    from bpvo_tpu_torch.types import InterpolationType
    from bpvo_tpu_torch.vo import device_vo

    t0 = time.perf_counter()
    ref = dict(np.load(REF_SHARDED_NPZ))
    shape = (synthetic.ROWS, synthetic.COLS)
    out, launches, fused_x, irls_x = {}, {}, {}, {}
    K, baseline, frames = synthetic.synthesize_sequence(
        dryrun.CHUNKS[-1][1])
    images = [torch.as_tensor(f[0]).to(dev) for f in frames]
    disps = [torch.as_tensor(f[1]).to(dev) for f in frames]
    reducer = multihost.initialize(
        "nccl", 1, 0, f"tcp://127.0.0.1:{multihost.free_port()}",
        device=dev)
    try:
        # 1. world 1, nccl, in this process: the sharded GN
        tdata, ch, cam, _ = dryrun.synthetic_problem(*shape, 16384,
                                                     device=dev)
        opts = gn.GNOptions(function_tolerance=1e-4,
                            parameter_tolerance=1e-6)
        T0 = torch.eye(4, dtype=torch.float32, device=dev)
        reducer.reset()
        st = sharded.make_sharded_gn(reducer, opts)(tdata, ch, cam, T0)
        gn_stats = reducer.stats()     # one solve's
        st_none = sharded.make_sharded_gn(None, opts)(tdata, ch, cam, T0)
        st_run = gn.run(tdata, ch, cam, T0, opts)
        same = all(torch.equal(a, b) for a, b in zip(st, st_none))
        d_run = float((st.T - st_run.T).abs().max())
        gn_ms = _host_ms(lambda: sharded.make_sharded_gn(reducer, opts)(
            tdata, ch, cam, T0))
        gn_ms_none = _host_ms(lambda: sharded.make_sharded_gn(None, opts)(
            tdata, ch, cam, T0))
        out["sharded_gn"] = {"iterations": int(st.num_iters),
                             "ms": gn_ms, "ms_no_reducer": gn_ms_none,
                             "nccl_equals_no_reducer": same,
                             "max_abs_vs_gauss_newton_run": d_run,
                             "collectives_per_solve": gn_stats}
        print(f"sharded GN 376x1241 K=16384 (nccl, world 1): "
              f"{int(st.num_iters)} iterations, {gn_ms:.3f} ms a solve "
              f"({gn_ms_none:.3f} with no reducer) on {smi}; bitwise the "
              f"no-reducer route: {same}; max |T - "
              f"gauss_newton.run T| {d_run:.3e}; collectives per solve "
              f"{gn_stats}")
        _require(same, "sharded GN: world-1 nccl differs from no reducer")
        _require(bool(torch.isfinite(st.T).all()), "sharded GN: non-finite")
        # CUBIC sampling: the gather route, no fused_linearize launch
        cubic = dataclasses.replace(opts, interp=InterpolationType.CUBIC)
        n_fused = fused_linearize.launch_count
        st_c = sharded.make_sharded_gn(reducer, cubic)(tdata, ch, cam, T0)
        st_c_none = sharded.make_sharded_gn(None, cubic)(tdata, ch, cam, T0)
        same_c = all(torch.equal(a, b) for a, b in zip(st_c, st_c_none))
        d_lin = float((st_c.T - st.T).abs().max())
        out["sharded_gn_cubic"] = {
            "iterations": int(st_c.num_iters),
            "nccl_equals_no_reducer": same_c,
            "fused_linearize_launches": fused_linearize.launch_count
            - n_fused, "max_abs_vs_linear": d_lin}
        print(f"sharded GN CUBIC (gather route, nccl, world 1): "
              f"{int(st_c.num_iters)} iterations; bitwise the no-reducer "
              f"route: {same_c}; max |T - LINEAR T| {d_lin:.3e}")
        _require(same_c and fused_linearize.launch_count == n_fused
                 and bool(torch.isfinite(st_c.T).all()),
                 f"sharded GN CUBIC: {out['sharded_gn_cubic']}")

        # the sharded VO, intensity and Bit-Planes, 1+4 frames, 2 chunks
        for name, desc in (("sharded_vo", DescriptorType.INTENSITY),
                           ("sharded_vo_bitplanes",
                            DescriptorType.BITPLANES)):
            c1 = desc == DescriptorType.INTENSITY
            key = "intensity" if c1 else "bitplanes"
            p = AlgorithmParameters(**dryrun.DRYRUN_PARAMS, descriptor=desc)

            def run_sharded(red):
                init_fn, _, scan_fn = sharded_vo.make_sharded_vo(
                    red, K, baseline, shape, p, device=dev)
                state = init_fn(images[0], disps[0])
                if red is not None:
                    red.reset()
                outs, ms = [], []
                for lo, hi in dryrun.CHUNKS:
                    t = time.perf_counter()
                    state, o = scan_fn(state, images[lo:hi], disps[lo:hi])
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t) * 1e3 / (hi - lo))
                    outs.append(o)
                return (torch.cat([o.pose_world for o in outs]),
                        torch.cat([o.is_keyframe for o in outs]), ms,
                        state)

            run_sharded(reducer)                   # warm-up
            _reset_counts()
            world, kf, ms, state = run_sharded(reducer)
            launches[name] = _counts()
            stats = reducer.stats()
            world_none, kf_none, _, _ = run_sharded(None)
            single = device_vo.DeviceVO(K, baseline, shape, p, device=dev)
            want = single.add_frames(images, disps).pose_world
            # the rule witness: DeviceVO with gauss_newton.run at every
            # level, and the step hooked with the sharded linearization at
            # DeviceVO's own sigma rule (scale_tolerance_rel kept)
            saved = gn.MAX_LEVEL_KERNEL_POINTS
            gn.MAX_LEVEL_KERNEL_POINTS = 0
            try:
                want_run = device_vo.DeviceVO(
                    K, baseline, shape, p,
                    device=dev).add_frames(images, disps).pose_world
            finally:
                gn.MAX_LEVEL_KERNEL_POINTS = saved
            hooked = device_vo.make_vo_step(
                single._p, single._cams, single._capacities, single._opts,
                hooks=device_vo.StepHooks(
                    linearize_factory=lambda _l, td, c, cam, o:
                    sharded.linearize_sharded(td, c, cam, o, None)))
            h_state = sharded_vo.make_sharded_vo(
                None, K, baseline, shape, p, device=dev)[0](images[0],
                                                            disps[0])
            h_world = []
            for image, disp in zip(images[1:], disps[1:]):
                h_state, h_out = hooked(h_state, image, disp)
                h_world.append(h_out.pose_world)
            h_world = torch.stack(h_world)
            del h_state
            world_np = world.cpu().numpy()
            n_steps = len(world_np)
            res = {
                "keyframes": kf.cpu().numpy().astype(int).tolist(),
                "ms_per_step_by_chunk": ms,
                "nccl_equals_no_reducer": bool(
                    torch.equal(world, world_none)
                    and torch.equal(kf, kf_none)),
                "max_abs_vs_device_vo": float(
                    (world - want).abs().max()),
                "rule_witness": {
                    "equals_device_vo_gn_run": bool(
                        torch.equal(h_world, want_run)),
                    "max_abs_sharded_vs_device_vo_gn_run": float(
                        (world - want_run).abs().max()),
                    "max_abs_device_vo_gn_run_vs_default": float(
                        (want_run - want).abs().max())},
                "max_abs_vs_jax": float(np.abs(
                    world_np - ref[f"sharded_{key}_world"]).max()),
                "keyframes_as_jax": bool(np.array_equal(
                    kf.cpu().numpy(), ref[f"sharded_{key}_keyframe"])),
                "collective_calls_per_step": stats["calls"] / n_steps,
                "collective_bytes_per_step": stats["bytes"] / n_steps,
                "launches": launches[name]}
            out[name] = res
            print(f"{name} 376x1241 (nccl, world 1): keyframes "
                  f"{res['keyframes']}, ms per step by chunk "
                  f"{[round(m, 3) for m in ms]} on {smi}; bitwise the "
                  f"no-reducer route: {res['nccl_equals_no_reducer']}; max "
                  f"|pose - DeviceVO| {res['max_abs_vs_device_vo']:.3e} "
                  f"(atol {SHARDED_ATOL_DEVICE_VO}"
                  f"{'' if c1 else ', not gated: open fault C.13'}), max "
                  f"|pose - JAX sharded| {res['max_abs_vs_jax']:.3e} (atol "
                  f"{SHARDED_ATOL_JAX}); collectives per step "
                  f"{res['collective_calls_per_step']:.2f} calls, "
                  f"{res['collective_bytes_per_step']:.0f} B; launches "
                  f"{launches[name]}")
            w = res["rule_witness"]
            print(f"{name} rule witness: hooked at DeviceVO's sigma rule "
                  f"bitwise DeviceVO on gauss_newton.run "
                  f"{w['equals_device_vo_gn_run']}; max |sharded - DeviceVO"
                  f" on gauss_newton.run| "
                  f"{w['max_abs_sharded_vs_device_vo_gn_run']:.3e}, max "
                  f"|DeviceVO on gauss_newton.run - DeviceVO| "
                  f"{w['max_abs_device_vo_gn_run_vs_default']:.3e}")
            _require(res["nccl_equals_no_reducer"],
                     f"{name}: world-1 nccl differs from no reducer")
            _require(bool(kf.any()), f"{name}: no keyframe event")
            _require(not c1 or res["max_abs_vs_device_vo"]
                     <= SHARDED_ATOL_DEVICE_VO,
                     f"{name}: {res['max_abs_vs_device_vo']} from DeviceVO")
            _require(w["equals_device_vo_gn_run"],
                     f"{name}: the step hooked with the sharded "
                     f"linearization at DeviceVO's sigma rule differs from "
                     f"DeviceVO on gauss_newton.run")
            _require(res["max_abs_vs_jax"] <= SHARDED_ATOL_JAX
                     and res["keyframes_as_jax"],
                     f"{name}: {res['max_abs_vs_jax']} from JAX's sharded "
                     f"VO, keyframes {res['keyframes']}")
            # a custom linearization takes fused_linearize, never level_gn;
            # at C = 1 irls_reduce_w re-weighs at each new sigma, at C > 1
            # a channel-0 fused_linearize pass gives sigma's residuals
            c = launches[name]
            _require(c["fused_linearize"] > 0 and c["level_gn"] == 0
                     and (c["irls_reduce"] > 0) == c1
                     and (c["census_planes"] > 0) != c1,
                     f"{name}: launches {c}")
            # the kernels at this path's finest shapes, against plain
            ch1 = device_vo._compute_channels_pyr(images[1], p, 1)[0]
            o0 = gn.GNOptions.from_params(p, coarse=False)
            fused_x[f"{name} L0"] = _fused_zoo_check(
                f"fused_linearize {name} L0", state.templates[0], ch1,
                single._cams[0], o0)
            del single, state
        _lap(t0, "distributed: world 1")
    finally:
        multihost.shutdown()

    # 2. world 2, gloo, two processes on cuda:0 (host-staged)
    res2 = dryrun.run(2, "gloo", "cuda", *shape)
    _require(res2["ok"], f"dryrun world 2 gloo: {res2}")
    out["dryrun_gloo_world2"] = res2
    print(f"dryrun 2 ranks gloo on cuda:0 (host-staged, not a collective on "
          f"the card): ranks bitwise equal {res2['ranks_bitwise_equal']}, "
          f"{res2['keyframe_events']} keyframe events, max |pose - DeviceVO|"
          f" {res2['max_abs_vs_device_vo']:.3e}; ms per step by rank "
          f"{[round(m, 1) for m in res2['vo_ms_per_step']]}; collectives "
          f"per step {res2['collectives_per_step']} on {smi}")
    _lap(t0, "distributed: world 2")

    # 3. BA: VisualOdometry with enable_bundle_adjustment(8), 1+30 frames
    K, baseline, frames = synthetic.synthesize_sequence(1 + N_STEPS)
    params = AlgorithmParameters(**BENCH, descriptor=DescriptorType.INTENSITY)
    vo = VisualOdometry(K, baseline, shape, params, device=dev)
    window = int(ref["ba_window"])
    vo.enable_bundle_adjustment(window)
    win = vo._ba_window
    opt_ms, sizes = [], []
    optimize = win.optimize

    def timed_optimize():
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = optimize()
        opt_ms.append((time.perf_counter() - t) * 1e3)
        sizes.append(len(r))
        return r
    win.optimize = timed_optimize
    ref_windows = np.split(ref["ba_windows"],
                           np.cumsum(ref["ba_window_sizes"])[:-1])
    _reset_counts()
    got, at = [], []
    for i, (image, disp) in enumerate(frames):
        if vo.add_frame(image, disp).is_keyframe and i > 0:
            got.append(vo.refined_keyframe_poses())
            at.append(i)
    launches["ba"] = _counts()
    _require(at == ref["ba_frames"].tolist(),
             f"BA: keyframe events at {at}, JAX's at "
             f"{ref['ba_frames'].tolist()}")
    ba_err = max(float(np.abs(g - w).max()) for g, w in zip(got, ref_windows))
    opts_ba = ba.BAOptions()
    want_irls = sum(opts_ba.max_iterations * 2 * (m - 1) for m in sizes)
    out["ba"] = {"keyframe_events": at, "window_sizes": sizes,
                 "optimize_ms": opt_ms, "max_abs_vs_jax": ba_err,
                 "irls_reduce_per_optimize_iteration": [2 * (m - 1)
                                                        for m in sizes],
                 "launches": launches["ba"]}
    print(f"BA (VisualOdometry, window {window}, 1+{N_STEPS} frames): "
          f"keyframe events {at}, windows {sizes}, ms per optimize "
          f"{[round(m, 2) for m in opt_ms]} on {smi}; max |refined - JAX| "
          f"{ba_err:.3e} (atol {BA_ATOL_JAX}); irls_reduce launches "
          f"{launches['ba']['irls_reduce']} (expected {want_irls}: 2(M-1) "
          f"an iteration)")
    _require(ba_err <= BA_ATOL_JAX, f"BA: {ba_err} from JAX's windows")
    _require(launches["ba"]["irls_reduce"] == want_irls,
             f"BA: irls_reduce launched {launches['ba']['irls_reduce']} "
             f"times, expected {want_irls}")
    # the edge reduction at its shape (K = 16384, C = 1), against plain
    irls_x["ba edge M=16384"] = _irls_zoo_check(
        "irls_reduce ba edge", win._templates[0], win._channels[1],
        vo._cams[0], gn.GNOptions())

    # ba_solve_with_depth at M = 4, K = 16384: card vs the CPU's plain run
    M = BA_DEPTH_M
    stacked = ba.stack_templates(win._templates[:M])
    chans = torch.stack(win._channels[:M])
    poses0 = torch.from_numpy(np.stack(win._poses[:M])).to(dev)
    d_opts = ba.BAOptions(max_iterations=BA_DEPTH_ITERS, refine_depth=True)
    _reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    pd, td_d, cost_d = ba.ba_solve_with_depth(stacked, chans, vo._cams[0],
                                              poses0, d_opts)
    torch.cuda.synchronize()
    depth_ms = (time.perf_counter() - t) * 1e3
    launches["ba_depth"] = _counts()
    cpu = [ba.TemplateData(*(x.cpu() for x in stacked)), chans.cpu()]
    pc, _, cost_c = ba.ba_solve_with_depth(cpu[0], cpu[1], vo._cams[0],
                                           poses0.cpu(), d_opts)
    d_err = float((pd.cpu() - pc).abs().max())
    want_d = BA_DEPTH_ITERS * 2 * (M - 1)
    out["ba_depth"] = {"M": M, "K": int(stacked.points.shape[1]),
                       "iterations": BA_DEPTH_ITERS, "ms": depth_ms,
                       "max_abs_vs_cpu": d_err, "cost": float(cost_d),
                       "launches": launches["ba_depth"]}
    print(f"ba_solve_with_depth M={M} K={stacked.points.shape[1]} "
          f"{BA_DEPTH_ITERS} iterations: {depth_ms:.2f} ms on {smi}; max "
          f"|poses - CPU plain run| {d_err:.3e} (atol {BA_DEPTH_ATOL}); "
          f"cost {float(cost_d):.6g} (CPU {float(cost_c):.6g}); launches "
          f"{launches['ba_depth']}")
    _require(d_err <= BA_DEPTH_ATOL and bool(torch.isfinite(pd).all()),
             f"ba_solve_with_depth: {d_err} from the CPU run")
    _require(launches["ba_depth"]["irls_reduce"] == want_d,
             f"ba_solve_with_depth: irls_reduce launched "
             f"{launches['ba_depth']['irls_reduce']}, expected {want_d}")
    del vo, win, stacked, chans
    _lap(t0, "distributed: BA")

    # 4. collectives against JAX's count; the scaling bench
    sc = {"world1_nccl": scaling_bench.run_scaling(
        (1,), backend="nccl", device="cuda", reps=10),
        "world2_gloo": scaling_bench.run_scaling(
        (1, 2), backend="gloo", device="cuda", reps=10)}
    out["scaling_bench"] = sc
    for name in ("sharded_vo", "sharded_vo_bitplanes"):
        print(f"collectives per step, {name}: "
              f"{out[name]['collective_calls_per_step']:.2f} all-reduces, "
              f"{out[name]['collective_bytes_per_step']:.0f} B (world 1, "
              f"every iteration counted); JAX 8 devices: "
              f"{JAX_STEP_ALL_REDUCES} all-reduces, "
              f"{JAX_STEP_ALL_REDUCE_BYTES} B in the compiled step "
              f"(MULTICHIP_r05.json)")
    for name, r in sc.items():
        print(f"scaling_bench {name} ({r['points']} points, "
              f"{'host-staged' if r['staged'] else 'on the card'}): " + ", ".join(
                  f"world {n}: {v['ms_per_solve']:.3f} ms a solve, "
                  f"efficiency {v['efficiency']:.3f}"
                  for n, v in r["by_world"].items()) + f" on {smi}")
    out["jax_compiled_step"] = {"all_reduces": JAX_STEP_ALL_REDUCES,
                                "bytes": JAX_STEP_ALL_REDUCE_BYTES,
                                "devices": 8}
    out["seconds"] = time.perf_counter() - t0
    _lap(t0, "distributed phase")
    return out, launches, fused_x, irls_x


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
    err_i, ms_i, plain_i, bound_i, levels_i = kernel_phase(
        vo, frames[0], frames[1][0], dev)
    counts_i, _, fps, p50 = vo_phase(vo, frames, dev, ref, "VO intensity",
                                     T_ATOL_JAX, GT_MARGIN, True)
    print(f"VO intensity: {fps:.2f} frames/s, per-frame p50 {p50:.3f} ms "
          f"on {smi}")
    del vo, frames
    _lap(t_start, "intensity phases")

    # stereo Bit-Planes: conf/kitti_bitplanes.cfg
    ref_s = dict(np.load(REF_STEREO_NPZ))
    cf = ConfigFile(CONF)
    params_bp = AlgorithmParameters.from_config(cf)
    matcher = stereo.create_stereo_algorithm(cf)
    err_c, ms_c, plain_c, bound_c = census_phase(sframes[0][0], dev)
    err_s, ms_s, plain_s, bound_s, sgm_extra = sgm_phase(
        sframes[0], matcher, dev, ref_s, smi)
    vo_bp = DeviceVO(K, baseline, shape, params_bp, device=dev,
                     stereo_fn=matcher.as_fn())
    flip_phase(vo_bp, sframes[0][0], dev)
    err_b, ms_b, plain_b, bound_b, levels_b = kernel_phase(
        vo_bp, sframes[0][:2], sframes[1][0], dev)
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

    del vo_bp
    _lap(t_start, "stereo phases")

    # dense VO at KITTI shape: L0 and L1 through gauss_newton.run, L2 and L3
    # (K = 8192/2048) through level_gn, checked here at C=1 and C=8
    ref_d = dict(np.load(REF_DENSE_NPZ))
    lg_dense = {}
    for name, desc in (("intensity", DescriptorType.INTENSITY),
                       ("bitplanes", DescriptorType.BITPLANES)):
        vo_d = DeviceVO(K, baseline, shape, _dense_params(desc), device=dev)
        lg_dense[name] = kernel_phase(vo_d, sframes[0][0::2], sframes[1][0],
                                      dev, levels=(2, 3))
        del vo_d
    gnk = gn_kernel_phase(K, baseline, [f[0::2] for f in sframes[:2]], dev)
    dense = {}
    for name, desc in (("intensity", DescriptorType.INTENSITY),
                       ("bitplanes", DescriptorType.BITPLANES)):
        counts, fps_d, p50_d, p90_d = dense_vo_phase(
            K, baseline, [f[0::2] for f in sframes], dev, ref_d, name, desc)
        dense[name] = counts
        print(f"VO dense {name}: {fps_d:.2f} frames/s, per-frame p50 "
              f"{p50_d:.3f} ms p90 {p90_d:.3f} ms on {smi}")
    _require(dense["intensity"]["irls_reduce"] > 0,
             "irls_reduce never launched on the dense intensity path")
    _lap(t_start, "dense phases")

    # the compiled step: each VO path eager and graphed, bitwise equal, over
    # the first GRAPH_STEPS steps
    from bpvo_tpu_torch import VisualOdometry
    gframes = sframes[:1 + GRAPH_STEPS]
    dframes = [f[0::2] for f in gframes]
    graph_res = {
        "intensity": graph_phase(
            "intensity", lambda: DeviceVO(K, baseline, shape, params,
                                          device=dev), dframes, dev, smi),
        "stereo_bitplanes": graph_phase(
            "stereo Bit-Planes", lambda: DeviceVO(
                K, baseline, shape, params_bp, device=dev,
                stereo_fn=matcher.as_fn()), [f[:2] for f in gframes], dev,
            smi)}
    for name, desc in (("intensity", DescriptorType.INTENSITY),
                       ("bitplanes", DescriptorType.BITPLANES)):
        graph_res[f"dense_{name}"] = graph_phase(
            f"dense {name}", lambda desc=desc: VisualOdometry(
                K, baseline, shape, _dense_params(desc), device=dev),
            dframes, dev, smi)
    print(json.dumps({"graph_phase": graph_res}))
    _lap(t_start, "graph phase")

    probe_entries = probe_phase(dev, smi)

    # the host data layer and the apps, on the bench scene's stereo pairs
    print(json.dumps({"app_phase": app_phase(sframes, K, baseline, dev,
                                             smi)}))

    # the option zoo: its kernel checks, eval_descriptors over the
    # corridor, the gather and dense zoo routes, conf/tsukuba.cfg on the
    # app phase's tree
    lg_zoo, fused_zoo, irls_zoo, latch_bits = zoo_kernel_phase(dev)
    zoo_json, zoo_counts = zoo_phase(
        dev, smi, os.path.join(HERE, "build", "app_phase", "tsukuba"),
        latch_bits)
    print(json.dumps({"zoo_phase": zoo_json}))
    for kernel, extra in (("fused_linearize", fused_zoo),
                          ("irls_reduce", irls_zoo)):
        err, times, bounds, per_call = gnk[kernel]
        for shape, (dw, t, bnd, n_k) in extra.items():
            times[shape], bounds[shape], per_call[shape] = t, bnd, n_k
        gnk[kernel] = (max([err] + [v[0] for v in extra.values()]), times,
                       bounds, per_call)

    _lap(t_start, "the phases through the zoo phase")

    # the distributed layer: sharded GN and VO (world 1 nccl, world 2 gloo),
    # BA through VisualOdometry, the depth Schur complement, collectives
    dist_json, dist_counts, dist_fused, dist_irls = distributed_phase(dev,
                                                                      smi)
    print(json.dumps({"distributed_phase": dist_json}))
    for kernel, extra in (("fused_linearize", dist_fused),
                          ("irls_reduce", dist_irls)):
        err, times, bounds, per_call = gnk[kernel]
        for shape, (dw, t, bnd, n_k) in extra.items():
            times[shape], bounds[shape], per_call[shape] = t, bnd, n_k
        gnk[kernel] = (max([err] + [v[0] for v in extra.values()]), times,
                       bounds, per_call)

    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")

    def by_path(kernel):
        return {"intensity": counts_i[kernel],
                "stereo_bitplanes": counts_s[kernel],
                "dense_intensity": dense["intensity"][kernel],
                "dense_bitplanes": dense["bitplanes"][kernel],
                **{path: c[kernel] for path, c in zoo_counts.items()},
                **{path: c[kernel] for path, c in dist_counts.items()}}

    def gn_entry(kernel, source, replaces, shape):
        err, times, bounds, per_call = gnk[kernel]
        extra = {} if kernel != "irls_reduce" else {
            "no_weights_ms_by_shape": {k: v[4] for k, v in times.items()},
            "no_weights_replayed_ms_by_shape": {k: v[5]
                                                for k, v in times.items()},
            "no_weights_bound_ms_by_shape": {k: v[2]
                                             for k, v in bounds.items()}}
        return {"name": kernel, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": sum(by_path(kernel).values()),
                "launches_by_path": by_path(kernel), "max_abs_err": err,
                "ms": times[shape][0], "plain_ms": times[shape][1],
                "bound_ms": bounds[shape][0], "bound_by": bounds[shape][1],
                "library_ms": None, "shape": shape,
                "bound_ms_by_shape": {k: v[0] for k, v in bounds.items()},
                "ms_by_shape": {k: v[0] for k, v in times.items()},
                "plain_ms_by_shape": {k: v[1] for k, v in times.items()},
                "replayed_ms_by_shape": {k: v[2] for k, v in times.items()},
                "plain_replayed_ms_by_shape": {k: v[3]
                                               for k, v in times.items()},
                "kernels_per_call": max(per_call.values()),
                "kernels_per_call_by_shape": per_call, **extra}

    # level_gn by path: (max error, ms, plain ms, (bound ms, by), levels)
    lg_paths = {"intensity": (err_i, ms_i, plain_i, bound_i, levels_i),
                "stereo_bitplanes": (err_b, ms_b, plain_b, bound_b, levels_b),
                "dense_intensity": lg_dense["intensity"],
                "dense_bitplanes": lg_dense["bitplanes"],
                **{f"zoo_corridor_{c}": r for c, r in lg_zoo.items()}}

    def by_level(key):
        return {path: {lvl: v[key] for lvl, v in r[4].items()}
                for path, r in lg_paths.items()}

    print(json.dumps({"kernels": [
        {"name": "level_gn", "route": "cuda",
         "source": "bpvo_tpu_torch/csrc/level_gn.cu",
         "replaces": "bpvo_tpu/ops/pallas/level_gn_kernel.py:615",
         "launches": sum(by_path("level_gn").values()),
         "launches_by_path": by_path("level_gn"),
         "max_abs_err": max(r[0] for r in lg_paths.values()),
         "ms": ms_i + ms_b, "plain_ms": plain_i + plain_b,
         "bound_ms": bound_i[0] + bound_b[0],
         "bound_by": "/".join(sorted({bound_i[1], bound_b[1]})),
         "library_ms": None,
         "ms_by_path": {k: r[1] for k, r in lg_paths.items()},
         "plain_ms_by_path": {k: r[2] for k, r in lg_paths.items()},
         "bound_ms_by_path": {k: r[3][0] for k, r in lg_paths.items()},
         "ms_by_level": by_level("ms"),
         "replayed_ms_by_level": by_level("replayed_ms"),
         "bound_ms_by_level": by_level("bound_ms"),
         "n_ctas_by_level": by_level("n_ctas"),
         "sigma_estimates_by_level": by_level("sigma_estimates")},
        {"name": "census_planes", "route": "cuda",
         "source": "bpvo_tpu_torch/csrc/census.cu",
         "replaces": "bpvo_tpu/ops/pallas/census_kernel.py:46",
         "launches": sum(by_path("census_planes").values()),
         "launches_by_path": by_path("census_planes"), "max_abs_err": err_c,
         "ms": ms_c, "plain_ms": plain_c, "bound_ms": bound_c[0],
         "bound_by": bound_c[1], "library_ms": None},
        {"name": "sgm_aggregate", "route": "cuda",
         "source": "bpvo_tpu_torch/csrc/sgm.cu",
         "replaces": "bpvo_tpu/ops/pallas/sgm_kernel.py:51",
         "launches": counts_s["sgm_aggregate"], "max_abs_err": err_s,
         "ms": ms_s, "plain_ms": plain_s, "bound_ms": bound_s[0],
         "bound_by": bound_s[1], "library_ms": None, **sgm_extra},
        gn_entry("fused_linearize", "bpvo_tpu_torch/csrc/fused_linearize.cu",
                 "bpvo_tpu/ops/pallas/gn_kernel.py:181 and :433",
                 "intensity L0 C=1"),
        gn_entry("irls_reduce", "bpvo_tpu_torch/csrc/irls_reduce.cu",
                 "bpvo_tpu/ops/pallas/irls_kernel.py:119 and :163",
                 "intensity L0 M=1K")] + probe_entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
