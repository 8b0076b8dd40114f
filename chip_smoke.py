"""Smoke run of the PyTorch/CUDA port (``bpvo_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the hand-written CUDA kernels from ``bpvo_tpu_torch/csrc`` (one
   nvcc per source, in parallel; ``-Xptxas -v`` output printed).
1a. Tools phase (first after the build, so that its trace is the
   process's first profiler session), on frames of the synthetic 376x1241
   sequence: the C API (``bpvo_tpu_torch/capi``, built with g++ and bound
   by ctypes) in this process on the card over 30 frames with
   conf/perf_intensity.cfg, with the launch counts at 0 (the ``capi``
   path: level_gn must launch): poses and keyframes bit for bit
   ``VisualOdometry`` on the same frames and device, the translation
   within the intensity path's ground-truth bound of the known step,
   add_frame p50/p90 against ``VisualOdometry``'s; a second handle with
   conf/perf_bitplanes.cfg over 10 frames (``capi_bitplanes``: census and
   level_gn must launch); the standalone C host (its own interpreter) on
   the card; examples/synthetic_vo_torch.py as a script on the card (its
   add_frame ms by a wrapper); ``utils.profiling.trace`` of 5 warmed
   ``DeviceVO`` steps, each an ``annotate`` region, which must hold every
   region and a CUDA kernel event named level_gn for each level_gn launch
   the wrappers count (the kernel events, the
   device-busy share of the annotated window, the traced and untraced ms
   a step); a headless ``Viewer`` dump of a ``TpuSGM`` disparity read back
   through ``data/imageio``, equal to its render.  One ``{"tools_phase":
   ...}`` JSON line.
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
   the whole step replayed from one CUDA graph, its keyframe branch an IF
   node, the replays counted as their kernel launches and the taken IF
   bodies' launches settled from the graph's device counters).  Every pose must be finite,
   within the ground-truth bound of the known per-frame motion, and within
   atol 5e-4 of the JAX package's poses
   (tests/data/torch_port_bench_ref.npz), with the same keyframes and
   per-level iterations within 1 of the reference's; the kernel's launch
   count must equal the number of level solves run.
4. Stereo kernel phase, on frame 0 of the stereo pair of the same scene:
   the ``census_planes`` kernel against its plain version at 376x1241, the
   ``census_cost`` kernel against its plain version on that pair's codes
   (both times and the kernel's bound printed), and the SGM aggregation
   kernel (and each of its two passes, whose device times it prints)
   against its plain version on that pair's 376x1241x128 census cost
   volume with conf/kitti_bitplanes.cfg's penalties, all bit for bit; the
   matcher's ms per call, whole and by stage (census, cost
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
   launches: census = levels x frames + 2 per matcher call, census_cost
   and sgm = one per matcher call, level_gn = the level solves.
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
   call, ``probes.timing.device_kernels``).  At L0 also ``gn_step`` (the
   step of a ``gauss_newton.run`` iteration after its linearization)
   against its plain version on the inputs of the level solve's first two
   iterations: every field of the new state bit for bit but |dp| (within
   ``ops.gn_step.DP_NORM_RTOL``) and the pose (within ``T_ATOL``); both
   timed on
   the second iteration's inputs with the tolerances at 0 (every call
   solves and updates), one device kernel per call.
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
   per sigma re-estimate at C=8), gn_step = gauss_newton.run iterations,
   irls_reduce = sigma re-estimates at C=1, level_gn = the L2 and L3
   solves, each > 0.
   ``VisualOdometry.add_frame`` replays its frame, template and estimate
   graphs (each ``gauss_newton.run`` level a WHILE node of the
   estimate's); the run is first made eager (``_graphs = None``),
   counting the iterations and the sigma re-estimates (the calls of its
   sigma function), and the graphed run must equal it bit for bit with the
   same launches.
9. Graph phase: each VO path eager and graphed in this process (the two
   ``DeviceVO`` paths and three ``VisualOdometry`` cells over all N_STEPS
   (30) steps: bench.py's intensity settings, conf/perf_bitplanes.cfg
   with the disparity given, and the intensity settings with the
   multi-start (``coarseInitOffsetPx`` VO_MULTISTART_PX); the dense
   ``VisualOdometry`` paths over the first GRAPH_STEPS (15); the graphed
   route is the entry point; the eager one is ``DeviceVO``'s step
   function, or ``VisualOdometry`` with ``_graphs = None``), each route
   once to warm up, once timed and once under torch.profiler: poses,
   iterations and keyframes (and a ``VisualOdometry``'s covariances and
   statuses) must be bitwise equal, with equal launches; per route it
   prints p50/p90 ms of keyframe and other steps, the top-level host ops
   per step (a graph replay counted as one op), the replays and device
   reads (calls that synchronize, torch's sync debug mode) per step, and
   for ``VisualOdometry`` the first call (warm-up and capture) of each
   graph key.  The ``DeviceVO`` paths add a third route, ``add_frames`` in
   CHUNKS chunks of 10 with each chunk on the card first and its replays
   under ``torch.cuda.set_sync_debug_mode("error")`` (a read of the device
   fails the run): bitwise equal to the eager route, the same launch
   counts once settled, chunk frames/s, each chunk's span on the stream
   (CUDA events), host ops per step, and its first chunk traced in a
   fresh process (``trace_chunk``, ``python3 chip_smoke.py --trace-chunk
   <path>``): the device busy share, its kernel time over the same
   chunk's untraced span (tracing adds host time between launches), and a
   kernel event for every launch of level_gn and census the counts show
   (fused_linearize and irls_reduce: at most their launches, as the
   profiler records a WHILE body once a replay).  The same for three more ``DeviceVO`` paths
   (``while_paths``): (a) dense intensity and Bit-Planes (L0 and L1 on
   ``gauss_newton.run``, each a WHILE node in the step graph) over
   GRAPH_STEPS steps, (b) Bit-Planes Levenberg-Marquardt with the
   disparity given (every level an LM WHILE node, ``irls_reduce`` in its
   body) over LM_GRAPH_STEPS, each also held to JAX's ``DeviceVO``
   (tests/data/torch_port_while_ref.npz, the same frames: poses within
   T_ATOL_JAX_DENSE, LM within ZOO_ATOL, the same keyframes); a graphed ``DeviceVO`` step's timed pass runs
   under ``set_sync_debug_mode("error")`` too.  One JSON line holds those
   numbers (after the second trace below, ``graph_phase_while_paths``).
   (c) Level solves alone: ``gauss_newton.run`` at the
   dense L0/L1 (C = 1 and 8) and LM at L0 (C = 8), eager and through
   ``GraphCache.jit`` (the template held, as the sharded GN's): ms
   per solve, one replay a solve under ``set_sync_debug_mode("error")``,
   bitwise, the same launches (a ``level_solve_phase`` JSON line).
   Between the two ``DeviceVO`` paths and the ``VisualOdometry`` cells,
   after those paths' CPU-only profiler sessions and before any over
   WHILE-node replays, a second ``profiling.trace`` of 2 warmed
   ``DeviceVO`` steps with the tools phase's checks.
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
   (census 2, census_cost 1 and SGM 1 per frame read, level_gn > 0, the
   GN kernels 0)
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
   iterations per frame printed per cell; the LM cells again eager
   (``VisualOdometry._graphs = None``): each graphed LM cell's
   trajectory and per-frame iterations bit for bit the eager cell's; the gather
   route (Bit-Planes, CUBIC_HERMITE: irls_reduce inside gauss_newton.run's
   CUDA graphs) and dense DescriptorFields1 (fused_linearize at C = 5) over
   1+4 frames, counted, within ZOO_GT_BOUND of the ground truth; ``python -m
   bpvo_tpu_torch.apps.vo`` on conf/tsukuba.cfg over the app phase's
   NewTsukuba tree in a process of its own, within ZOO_ATOL_C1 of JAX's
   poses.  One ``{"zoo_phase": ...}`` JSON line.

13. Distributed phase (``bpvo_tpu_torch.parallel``): in this process a
   world-1 ``nccl`` group.  Every graphed path (one CUDA-graph replay a
   call, the all-reduces captured) is held bit for bit to its eager route
   (``cache=False``; outputs, launches and collectives), its replay run
   under ``set_sync_debug_mode("error")`` (no read), with the graphed and
   eager ms alternated in one call and the node types of its graphs (in
   IF and WHILE bodies apart) printed: the sharded GN, the sharded VO's
   ``scan_fn`` chunks and ``step_fn`` steps (and host ops a step), the
   last BA window's ``ba_solve``, ``make_sharded_ba`` and
   ``make_sharded_ba_2d``, ``ba_solve_with_depth`` and the pose graph (a
   chain of POSE_GRAPH_N nodes with a loop closure).  The sharded GN at
   376x1241 (K = 16384) bit for
   bit the same route with no reducer, at LINEAR and at CUBIC sampling
   (the gather route: no ``fused_linearize`` launch); the sharded VO, intensity and
   Bit-Planes, with the dry run's parameters over 1+4 frames in 2
   ``scan_fn`` chunks (counted: ``fused_linearize`` and ``irls_reduce``
   must launch, ``level_gn`` never; census for Bit-Planes): bit for bit the
   no-reducer route, within SHARDED_ATOL_JAX of JAX's sharded VO with its
   keyframe flags (tests/data/torch_port_sharded_ref.npz), intensity
   within SHARDED_ATOL_DEVICE_VO of ``DeviceVO`` on the card, Bit-Planes
   within JAX's own gap between its sharded VO and its ``DeviceVO`` on the
   level route (from the same file) plus SHARDED_ROUTE_ATOL; the rule
   witness: the step hooked
   with the sharded linearization at ``DeviceVO``'s own sigma rule bit for
   bit ``DeviceVO`` with ``gauss_newton.run`` at every level, its gaps to
   the sharded VO and to the default ``DeviceVO`` printed;
   ``fused_linearize`` against plain at its L0; then ``python -m
   bpvo_tpu_torch.parallel.dryrun``'s checks with 2 gloo ranks on cuda:0
   (host-staged); ``VisualOdometry.enable_bundle_adjustment(8)`` (its
   ms: the capture of every window size) over 1+30 frames (counted):
   every keyframe event's refined window within BA_ATOL_JAX of JAX's, the
   ms of each optimize, ``irls_reduce`` launched 2(M-1) times an
   iteration, checked against plain at the edge shape; the keyframe
   steps' p50/p90 with the sizes captured at enable against captured in
   the frame loop, alternated (``_ba_capture_arms``), the refined windows
   bitwise equal; ``ba_solve_with_depth`` at M = 4, K = 16384 (counted) within
   BA_DEPTH_ATOL of the CPU's plain run; the collective calls and bytes
   per step beside JAX's count; ``apps.scaling_bench`` at world 1 (nccl)
   and world 2 (gloo, host-staged, eager); every multi-process run under
   a wall timeout of DIST_TIMEOUT_S.  With 2 or more cards
   (``multicard_phase``) also the dry run with nccl ranks on min(count, 4)
   cards, whose groups reduce through ``peer_reduce`` and take the
   graphed route: every path (the sharded VO's ``scan_fn`` and ``step_fn``,
   intensity and Bit-Planes, the sharded GN, ``ba_solve``,
   ``make_sharded_ba(_2d)``, ``ba_solve_with_depth``) graphed bit for bit
   its eager route on every rank with one replay a call under
   ``set_sync_debug_mode("error")``, only kernel, memcpy and memset nodes
   in its IF and WHILE bodies, the ranks bitwise equal, within JAX's
   tolerances, ``peer_reduce`` launched by every path on every rank (its
   count set to 0 before the paths and read after them), and the kernel
   bit for bit ``peer.plain_all_reduce`` across the cards at every
   reduced size, eagerly and replayed; on one card it prints that it was
   not run, and ``peer_reduce``'s count over the world-1 paths must be 0.  On a machine with four cards the peer
   route runs alone with ``python -m bpvo_tpu_torch.parallel.dryrun
   --procs 4 --backend nccl --device cuda --ref
   tests/data/torch_port_sharded_ref.npz`` and ``python -m
   bpvo_tpu_torch.apps.scaling_bench --sizes 1,2,4 --backend nccl``.
   One ``{"distributed_phase": ...}`` JSON line.
14. Peer phase (after the probe phase): ``peer_reduce``
   (``csrc/peer_reduce.cu``, the layer's all-reduce over NVLink peer
   memory) through its loopback launch on one card (W CTAs of one
   launch, CTA r playing rank r) at W = 2, 4, 8 and every size and op the
   layer reduces (``dryrun.COLLECTIVE_SIZES``): bit for bit
   ``peer.plain_fold`` eagerly and over PEER_REPLAYS replays of a graph of
   PEER_GRAPH_CALLS calls on fresh inputs, each rank's device epoch equal
   to the launches made, one device kernel a call, a buffer over the slot
   capacity refused; µs a call through the wrapper and replayed, the plain
   version's and ``sum``/``amax`` over the rank axis (the library call).
   Its kernels-line entry takes ``launches`` from the multi-card dry run's
   paths (rank 0's count); on one card from the world-1 paths, where it is
   0 (world-1 nccl groups keep NCCL's route).  The loopback's launches are
   comparisons, ``loopback_launches``.

Any failure exits non-zero.  The line before the last is a JSON object with
the kernels' launches (summed over the VO phases that run each; for the
probes, the probe groups' run), errors, CUDA-event times (mean ms per call
through the wrapper; SGM also ``ms_by_pass``, ``structure_bound_ms`` (the
two-pass structure's bytes over 3.35 TB/s) and the matcher's ms, whole
and ``matcher_ms_by_stage``; for census, whose wrapper costs more host
time than the kernel device time, back-to-back launches of its C entry
point; for fused_linearize, irls_reduce and gn_step also the device time
of the call replayed from a CUDA graph of 10 calls, per shape (``replayed_ms_by_shape``:
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
three counted runs and the tools phase's ``capi`` and ``capi_bitplanes``); the
last line is {"ok": true, "device": {...}}.  Without a CUDA device, or without
the package beside this script, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REF_NPZ = os.path.join(HERE, "tests", "data", "torch_port_bench_ref.npz")
REF_STEREO_NPZ = os.path.join(HERE, "tests", "data",
                              "torch_port_bitplanes_sgm_ref.npz")
REF_WHILE_NPZ = os.path.join(HERE, "tests", "data",
                             "torch_port_while_ref.npz")
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
VO_MULTISTART_PX = 2.0   # the graph phase's multi-start VisualOdometry cell
LM_GRAPH_STEPS = 10      # the Bit-Planes LM DeviceVO path's steps
TRACE_CHUNK_TIMEOUT_S = 240  # a chunk path's trace in a process of its own
LEVEL_SOLVE_REPS = 5     # timed solves a route in level_solve_phase
CHUNKS = 3               # add_frames chunks of the DeviceVO paths' 30 steps
CHUNK_LABEL = "vo_chunk"  # the traced chunk's annotation
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
# gn_step: the jittered 6x6 Cholesky and its two substitutions (~180),
# the residual check (~80), exp and the three 4x4 products (~450)
OPS_GN_STEP = 710


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
    from bpvo_tpu_torch.ops import (census, census_cost, fused_linearize,
                                    gn_step, irls, level_gn, sgm)
    from bpvo_tpu_torch.utils import graphs
    graphs.settle()     # launches of IF bodies taken so far count before 0
    for mod in (census, census_cost, fused_linearize, gn_step, irls,
                level_gn, sgm, sgm.winner_count):
        mod.launch_count = 0


def _counts():
    """The kernels' launch counts, with the taken IF bodies' settled, and
    the SGM calls whose tile pass took the winner."""
    from bpvo_tpu_torch.ops import (census, census_cost, fused_linearize,
                                    gn_step, irls, level_gn, sgm)
    from bpvo_tpu_torch.utils import graphs
    graphs.settle()
    return {"level_gn": level_gn.launch_count,
            "census_planes": census.launch_count,
            "census_cost": census_cost.launch_count,
            "sgm_aggregate": sgm.launch_count,
            "sgm_winner": sgm.winner_count.launch_count,
            "fused_linearize": fused_linearize.launch_count,
            "gn_step": gn_step.launch_count,
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
    at the dense L0 and L1 shapes, C=1 and C=8, and gn_step at L0
    (``_gn_step_check``).  Returns {kernel: (max error, {shape: (ms, plain
    ms, replayed ms, plain replayed ms)}, {shape: (bound ms, bound by)},
    {shape: device kernels per call})}; irls_reduce's tuples also carry
    the call without weights: (ms, replayed ms) and (bound ms, bound by)
    after the others; gn_step's error is the largest |T - T plain|."""
    import torch
    from bpvo_tpu_torch import DescriptorType
    from bpvo_tpu_torch.ops import fused_linearize as fl
    from bpvo_tpu_torch.ops import interp, irls
    from bpvo_tpu_torch.probes import timing
    from bpvo_tpu_torch.solver import mestimator
    from bpvo_tpu_torch.vo import device_vo, template_data, warp
    err = {"fused_linearize": 0.0, "irls_reduce": 0.0, "gn_step": 0.0}
    ms = {"fused_linearize": {}, "irls_reduce": {}, "gn_step": {}}
    bounds = {"fused_linearize": {}, "irls_reduce": {}, "gn_step": {}}
    per_call = {"fused_linearize": {}, "irls_reduce": {}, "gn_step": {}}
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
            if level == 0:
                shape = f"{name} L0 C={C}"
                dT, t, bnd, n_k = _gn_step_check(f"gn_step {shape}", td, ch,
                                                 cam, opts)
                err["gn_step"] = max(err["gn_step"], dT)
                ms["gn_step"][shape], bounds["gn_step"][shape] = t, bnd
                per_call["gn_step"][shape] = n_k
        del vo, pyr
    return {k: (err[k], ms[k], bounds[k], per_call[k]) for k in err}


def _gn_step_check(label, td, ch, cam, opts):
    """``ops.gn_step`` against ``gn_step_reference`` on the inputs of the
    first two iterations of the level solve of ``td`` on ``ch`` from the
    identity (the second at the plain version's new state): every field bit
    for bit but dp_norm_prev, within ``gn_step.DP_NORM_RTOL``, and T,
    within ``gn_step.T_ATOL``.  Then kernel and plain version timed on the second
    iteration's inputs with every tolerance at 0 (each call solves and
    updates), through the wrapper and replayed GN_PER_GRAPH calls a graph.
    Returns (max |T - T plain|, (ms, plain ms, replayed ms, plain replayed
    ms), (bound ms, bound by), device kernels per call)."""
    import dataclasses
    import torch
    from bpvo_tpu_torch.ops import gn_step as gs
    from bpvo_tpu_torch.probes import timing
    from bpvo_tpu_torch.solver import gauss_newton as gn

    def bits(x):
        return x.view(torch.int32) if x.dtype == torch.float32 else x

    C, Kl = td.pixels.shape
    dev = ch.device
    s, c = td.norm_scale, td.norm_center
    lin = gn._default_linearize_fn(td, ch, cam, opts)
    st = gn._initial_state(torch.eye(4, device=dev), C, Kl, dev)
    dT = 0.0
    for first in (True, False):
        a = (*lin(st.T, st.scale, st.delta_scale, True), s, c, opts, first)
        want = gs.gn_step_reference(st, *a)
        got = gs.gn_step(gs.LoopState(*(x.clone() for x in st)), *a)
        torch.cuda.synchronize()
        for f in gs.LoopState._fields:
            x, y = getattr(got[0], f), getattr(want[0], f)
            if f == "T":
                dT = max(dT, float((x - y).abs().max()))
            elif f == "dp_norm_prev":
                _require(abs(float(x) - float(y))
                         <= gs.DP_NORM_RTOL * float(y),
                         f"{label}: |dp| {float(x)!r} vs plain {float(y)!r}")
            else:
                _require(torch.equal(bits(x), bits(y)),
                         f"{label}: {f} differs from the plain version")
        _require(all(torch.equal(bits(x), bits(y))
                     for x, y in zip(got[1:], want[1:])),
                 f"{label}: dp_new or g_norm differs from the plain version")
        st = want[0]
    _require(dT <= gs.T_ATOL, f"{label}: |T - T plain| {dT} > {gs.T_ATOL}")
    free = dataclasses.replace(opts, function_tolerance=0.0,
                               parameter_tolerance=0.0, gradient_tolerance=0.0,
                               max_iterations=2 ** 30)
    st.g_tol.zero_()
    ks, ps = (gs.LoopState(*(x.clone() for x in st)) for _ in "kp")
    a = a[:-2] + (free, False)

    def kernel():
        gs.gn_step(ks, *a)

    def plain():
        gs.gn_step_reference(ps, *a)
    t_k, t_p = _cuda_ms(kernel, KERNEL_REPS), _cuda_ms(plain, PLAIN_REPS)
    d_k = timing.graph_ms(kernel, KERNEL_REPS, GN_PER_GRAPH)
    d_p = timing.graph_ms(plain, KERNEL_REPS, GN_PER_GRAPH)
    n_k = len(timing.device_kernels(kernel))
    torch.cuda.synchronize()
    _require(bool(ks.ok) and not bool(ks.conv),
             f"{label}: the timed calls did not solve and update")
    _require(n_k == 1, f"{label}: {n_k} device kernels per call")
    state = [x for f, x in zip(gs.LoopState._fields, st) if f != "w"]
    bound = _bound(_nbytes(*a[:5], *a[6:8], *state) + _nbytes(*state)
                   + 7 * 4, OPS_GN_STEP)
    print(f"  {label}: every field bit for bit but |dp| (within "
          f"{gs.DP_NORM_RTOL:.3g}, relative) and T (|dT| {dT:.3e}, T_ATOL {gs.T_ATOL}); kernel {t_k:.4f} ms "
          f"through the wrapper, {d_k:.4f} ms replayed, {n_k} device "
          f"kernel(s) per call; plain {t_p:.4f} ms, {d_p:.4f} ms replayed")
    return dT, (t_k, t_p, d_k, d_p), bound, n_k


def dense_vo_phase(K, baseline, frames, dev, ref, name, descriptor):
    """VisualOdometry over 1+N_STEPS frames of dense VO, once eager
    (``_graphs = None``), counting what the launches must be, then the
    graphed, counted and timed run (the frame, template and estimate
    graphs; each ``run`` level a WHILE node of the estimate's) that must
    equal the eager one bit for bit and is checked against the JAX
    reference.  Returns the launch counts of the counted
    run."""
    import numpy as np
    import torch
    from bpvo_tpu_torch import VisualOdometry
    from bpvo_tpu_torch.core import se3
    from bpvo_tpu_torch.data import synthetic
    from bpvo_tpu_torch.solver import gauss_newton as gn

    images = [torch.as_tensor(f[0]).to(dev) for f in frames]
    disps = [torch.as_tensor(f[1]).to(dev) for f in frames]
    params = _dense_params(descriptor)

    def one_pass(graphed):
        vo = VisualOdometry(K, baseline, tuple(images[0].shape), params,
                            device=dev)
        if not graphed:
            vo._graphs = None
        vo.add_frame(images[0], disps[0])
        res, t_ms = [], []
        for image, disp in zip(images[1:], disps[1:]):
            t0 = time.perf_counter()
            res.append(vo.add_frame(image, disp))
            torch.cuda.synchronize()
            t_ms.append((time.perf_counter() - t0) * 1e3)
        return vo, res, np.array(t_ms)

    torch.cuda.synchronize()
    # the eager pass (also the warm-up of each op's first use): what the
    # launch counts must equal, gauss_newton.run's iterations (device
    # scalars, summed after the run) and its sigma re-estimates (the calls
    # of its sigma function, made only where the re-estimate is taken)
    run_iters, n_est = [], [0]
    run, sigma_fn = gn.run, gn._sigma_fn

    def counted_run(*a, **k):
        st = run(*a, **k)
        run_iters.append(st.num_iters)
        return st

    def counted_sigma_fn(opts):
        fn = sigma_fn(opts)

        def counted(r0, valid):
            n_est[0] += 1
            return fn(r0, valid)
        return counted

    gn.run, gn._sigma_fn = counted_run, counted_sigma_fn
    try:
        _reset_counts()
        _, res_e, t_e = one_pass(graphed=False)
        counts_e = _counts()
    finally:
        gn.run, gn._sigma_fn = run, sigma_fn
    iters_run = int(torch.stack(run_iters).sum())
    _reset_counts()
    vo, res, t_ms = one_pass(graphed=True)
    counts = _counts()
    same = all(np.array_equal(a.pose, b.pose) and a.is_keyframe
               == b.is_keyframe and a.optimizer_statistics
               == b.optimizer_statistics for a, b in zip(res, res_e))
    _require(same and len(res) == len(res_e),
             f"VO dense {name}: the graphed run differs from the eager one")
    _require(counts == counts_e, f"VO dense {name}: launches graphed "
                                 f"{counts}, eager {counts_e}")

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
            "gn_step": iters_run,
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
          f"iterations, {n_est[0]} sigma re-estimates; expected {want}; "
          f"bitwise equal to the eager run (eager per-frame ms p50 "
          f"{np.percentile(t_e, 50):.3f})")
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


@contextlib.contextmanager
def _sync_errors(on=True):
    """With ``on``: a device-to-host read in the block raises
    (``torch.cuda.set_sync_debug_mode("error")``)."""
    import torch
    if not on:
        yield
        return
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def level_solve_phase(K, baseline, frames, dev, smi):
    """Path (c), a level solve of ``VisualOdometry``'s pose estimator on
    its own: at the dense L0 and L1 (K = 131072 / 32768; C = 1 and 8)
    ``gauss_newton.run`` and at L0 ``levenberg_marquardt.run`` (C = 8),
    eager and through ``GraphCache.jit`` (a cache of its own, the
    template held, as ``make_sharded_gn``'s solve): ms
    per solve (host clock to a sync, mean of LEVEL_SOLVE_REPS after the
    first call), the cache's replays per solve, bitwise equal to the
    eager solve, the same launches.  The graphed solves after the first
    run under set_sync_debug_mode("error"), so a device read there fails
    (torch's sync debug mode sees the reads it knows; none is counted).
    Returns the JSON object."""
    import dataclasses

    import numpy as np
    import torch
    from bpvo_tpu_torch import DescriptorType
    from bpvo_tpu_torch.solver import gauss_newton as gn
    from bpvo_tpu_torch.solver import levenberg_marquardt as lm
    from bpvo_tpu_torch.utils import graphs
    from bpvo_tpu_torch.vo.device_vo import DeviceVO, _compute_channels_pyr

    out = {}
    for cname, desc in (("C1", DescriptorType.INTENSITY),
                        ("C8", DescriptorType.BITPLANES)):
        vo = DeviceVO(K, baseline, tuple(frames[0][0].shape),
                      _dense_params(desc), device=dev)
        vo.init(*frames[0])
        ch = _compute_channels_pyr(torch.as_tensor(frames[1][0]).to(dev),
                                   vo._p, vo._p.numPyramidLevels)
        cases = [("gauss_newton.run", gn.run, level, vo._opts[level])
                 for level in (0, 1)]
        if cname == "C8":
            cases.append(("levenberg_marquardt.run", lm.run, 0,
                          dataclasses.replace(vo._opts[0],
                                              max_iterations=20)))
        for solver, solve, level, opts in cases:
            args = (vo.state.templates[level], ch[level], vo._cams[level],
                    torch.eye(4, device=dev), opts)
            cache = graphs.GraphCache(dev)

            def replayed(td, ch_l, cam, T0, opts):
                return cache.jit(
                    ("level_solve", solve, opts, cam), (td, ch_l, T0),
                    lambda b: solve(b[0], b[1], cam, b[2], opts), held=(0,))

            def timed(graphed):
                t, res = [], None
                for _ in range(1 + LEVEL_SOLVE_REPS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    with _sync_errors(graphed and res is not None):
                        res = (replayed if graphed else solve)(*args)
                    torch.cuda.synchronize()
                    t.append((time.perf_counter() - t0) * 1e3)
                return res, float(np.mean(t[1:]))
            _reset_counts()
            want, ms_e = timed(False)
            n_e = _counts()
            _reset_counts()
            replays = graphs.replay_count
            got, ms_g = timed(True)
            n_g = _counts()
            n_replays = graphs.replay_count - replays
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            key = f"{solver} {cname} L{level}"
            out[key] = {"K": int(args[0].pixels.shape[1]),
                        "iterations": int(want.num_iters),
                        "eager_ms": ms_e, "graphed_ms": ms_g,
                        "replays_per_solve": n_replays / LEVEL_SOLVE_REPS,
                        "device_reads": "none allowed: the graphed solves "
                                        "ran under set_sync_debug_mode("
                                        "'error'); not counted",
                        "bitwise_eager": same,
                        "launches_eager": n_e, "launches_graphed": n_g}
            print(f"level solve {key} (K = {out[key]['K']}): "
                  f"{out[key]['iterations']} iterations, eager {ms_e:.3f} "
                  f"ms, graphed {ms_g:.3f} ms per solve ({n_replays} "
                  f"replays for {LEVEL_SOLVE_REPS} solves after the "
                  f"capture, under set_sync_debug_mode('error')); bitwise "
                  f"{same}; launches "
                  f"eager {n_e}, graphed {n_g} on {smi}")
            _require(same, f"level solve {key}: graphed differs from eager")
            _require(n_e == n_g, f"level solve {key}: launches {n_g}, "
                                 f"eager {n_e}")
            _require(n_replays == LEVEL_SOLVE_REPS,
                     f"level solve {key}: {n_replays} replays")
        del vo
    return out


@contextlib.contextmanager
def _sync_count():
    """Counts the calls in the block that synchronize with the card
    (``torch.cuda.set_sync_debug_mode("warn")``'s warnings: a device ->
    host read, an item, or a blocking copy from pageable host memory);
    yields a one-item list that holds the count after the block."""
    import warnings
    import torch
    n = [0]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield n
        finally:
            torch.cuda.set_sync_debug_mode(0)
    n[0] = sum("synchroniz" in str(w.message) for w in caught)


def _host_ops(run_step, n):
    """Top-level host ops of each of ``n`` steps (``run_step(i)``), counted
    as scripts/profile_torch_vo.py counts them: the ops torch.profiler
    records directly under the step's label, plus one for each CUDA-graph
    replay in the step (a replay is no PyTorch op).  Returns (host ops,
    replays, device reads) a step, the reads counted by ``_sync_count``
    (the steps' frames are on the card, so a synchronizing call is a
    read)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from bpvo_tpu_torch.utils import graphs
    replays, reads = [], []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(n):
            r0 = graphs.replay_count
            with _sync_count() as syncs, record_function(f"{STEP_LABEL}{i}"):
                run_step(i)
            replays.append(graphs.replay_count - r0)
            reads.append(syncs[0])
    steps = {e.name: e for e in prof.events()
             if e.name.startswith(STEP_LABEL)}
    return ([len(steps[f"{STEP_LABEL}{i}"].cpu_children) + replays[i]
             for i in range(n)], replays, reads)


def _key_label(key):
    """A ``VisualOdometry`` graph key (``GraphCache.jit``'s) as a short
    label: the graph's name and, for an estimate, its start level,
    alternative start and multi-start offset."""
    name = key[0][0]
    if name == "estimate":
        start, alt, ms = key[0][-3:]
        return f"estimate start={start} alt={alt} multistart={ms}"
    return name


def _timed_first_calls(cache, out):
    """Time each first call (warm-up and capture) of ``cache``'s keys into
    ``out`` ({label: ms}, host clock between syncs)."""
    import torch
    first_call = cache._first_call

    def timed(key, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        result = first_call(key, fn)
        torch.cuda.synchronize()
        out[_key_label(key)] = (time.perf_counter() - t) * 1e3
        return result
    cache._first_call = timed


def graph_phase(name, make_vo, frames, dev, smi, chunked=False,
                jax_ref=None):
    """One VO path, eager and graphed, in this process: each route once to
    warm up (the graphs' captures), once timed (host clock, each step
    ending in a sync) and once under torch.profiler for its host ops,
    replays and device reads per step.  The graphed route is the entry
    point (``add_frame``); the eager one is ``DeviceVO``'s step function,
    or ``VisualOdometry`` with ``_graphs = None``.  A graphed
    ``VisualOdometry`` pass takes over its predecessor's cache (its keys
    captured, as one object running on holds them), and the first call of
    each key (warm-up and capture) is timed.  ``chunked`` (a ``DeviceVO``)
    adds ``chunk_route``.  Poses, iterations and keyframes (for
    ``VisualOdometry`` also covariances and statuses) must be equal bit for
    bit, and the timed passes' launch counts equal.  ``jax_ref`` ((the JAX
    reference, its key prefix, atol), a ``DeviceVO``): the steps' poses
    within atol of JAX's ``DeviceVO`` on the same frames, the same
    keyframes.  Returns {route: {"p50_ms", "p90_ms", "kf_p50_ms",
    "kf_p90_ms", "other_p50_ms", "other_p90_ms", "host_ops_other",
    "host_ops_kf", "replays_other", "replays_kf", "reads_other",
    "reads_kf"}, and for ``VisualOdometry`` "first_call_ms"}."""
    import numpy as np
    import torch
    from bpvo_tpu_torch import VisualOdometry

    images = [torch.as_tensor(f[0]).to(dev) for f in frames]
    auxs = [torch.as_tensor(f[1]).to(dev) for f in frames]
    n = len(images) - 1
    first_call_ms = {}

    def route(graphed):
        vo = make_vo()
        if isinstance(vo, VisualOdometry):
            holder = [vo]
            if graphed:
                _timed_first_calls(vo._graphs, first_call_ms)

            def reset():
                # a new VisualOdometry (it has no reset) that takes over
                # the cache its predecessor captured into
                cache = holder[0]._graphs
                holder[0] = make_vo()
                holder[0]._graphs = cache if graphed else None
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
        # a graphed DeviceVO step reads nothing from the card: its timed
        # steps run under set_sync_debug_mode("error")
        no_reads = graphed and not isinstance(vo, VisualOdometry)
        runs = []
        for timed in (False, True):     # warm-up, then the timed pass
            reset()
            torch.cuda.synchronize()
            counts = _counts()
            outs, t_ms = [], []
            for i in range(n):
                t0 = time.perf_counter()
                with _sync_errors(timed and no_reads):
                    outs.append(step(i))
                torch.cuda.synchronize()
                t_ms.append((time.perf_counter() - t0) * 1e3)
            counts = {k: v - counts[k] for k, v in _counts().items()}
            runs.append(([_summary(o) for o in outs], np.array(t_ms), counts))
        reset()
        torch.cuda.synchronize()
        return runs[1], _host_ops(step, n)

    (res_e, t_e, n_e), prof_e = route(False)
    (res_g, t_g, n_g), prof_g = route(True)
    kf = np.array([r[2] for r in res_e])
    same = _same(res_e, res_g)
    out = {}
    for label, t_ms, (ops, replays, reads) in (("eager", t_e, prof_e),
                                               ("graphed", t_g, prof_g)):
        r = {"p50_ms": float(np.percentile(t_ms, 50)),
             "p90_ms": float(np.percentile(t_ms, 90))}
        for part, sel in (("kf", kf), ("other", ~kf)):
            if sel.any():
                r[f"{part}_p50_ms"] = float(np.percentile(t_ms[sel], 50))
                r[f"{part}_p90_ms"] = float(np.percentile(t_ms[sel], 90))
                r[f"host_ops_{part}"] = float(np.median(np.array(ops)[sel]))
                r[f"replays_{part}"] = float(np.median(
                    np.array(replays)[sel]))
                r[f"reads_{part}"] = float(np.median(np.array(reads)[sel]))
        out[label] = r
        print(f"graph phase {name} {label}: per-frame ms p50 "
              f"{r['p50_ms']:.3f} p90 {r['p90_ms']:.3f}; keyframe steps p50 "
              f"{r.get('kf_p50_ms', math.nan):.3f} p90 "
              f"{r.get('kf_p90_ms', math.nan):.3f}; others p50 "
              f"{r.get('other_p50_ms', math.nan):.3f} p90 "
              f"{r.get('other_p90_ms', math.nan):.3f}; top-level host ops "
              f"per other step {r.get('host_ops_other', math.nan):.0f}, per "
              f"keyframe step {r.get('host_ops_kf', math.nan):.0f}; replays "
              f"and device reads per other step "
              f"{r.get('replays_other', math.nan):.0f} / "
              f"{r.get('reads_other', math.nan):.0f}, per keyframe step "
              f"{r.get('replays_kf', math.nan):.0f} / "
              f"{r.get('reads_kf', math.nan):.0f} (median) on {smi}")
    if first_call_ms:
        out["graphed"]["first_call_ms"] = first_call_ms
        print(f"graph phase {name}: first call of each key (warm-up and "
              f"capture, once a key) ms "
              + ", ".join(f"{k} {v:.1f}" for k, v in first_call_ms.items()))
    print(f"graph phase {name}: {n} steps, {int(kf.sum())} keyframes; "
          f"graphed and eager poses, iterations and keyframes bitwise equal: "
          f"{same}; launches eager {n_e}, graphed {n_g}")
    _require(same, f"graph phase {name}: the graphed route differs from the "
                   f"eager one")
    _require(n_e == n_g, f"graph phase {name}: launches eager {n_e}, "
                         f"graphed {n_g}")
    _require(kf.any() and not kf.all(),
             f"graph phase {name}: {int(kf.sum())} keyframes in {n} steps")
    if jax_ref is not None:
        out["jax"] = _jax_check(name, res_g, *jax_ref)
    if chunked:
        out["chunks"] = chunk_route(name, make_vo, images, auxs, res_e, n_e,
                                    dev, smi)
    return out


def _jax_check(name, res, ref, prefix, atol):
    """``DeviceVO`` steps' summaries (``_summary``) against the JAX
    ``DeviceVO``'s run in ``ref`` (keys ``prefix`` + ``_poses``,
    ``_is_keyframe``, ``_iters``): each step's pose within ``atol``, the
    same keyframes.  Returns the JSON object."""
    import numpy as np
    poses = np.stack([r[0][:16].reshape(4, 4) for r in res])
    kf = np.array([r[2] for r in res])
    want, want_kf = ref[f"{prefix}_poses"], ref[f"{prefix}_is_keyframe"]
    d_pose = np.abs(poses - want).max((1, 2))
    iters = int(sum(r[1].sum() for r in res))
    want_iters = int(ref[f"{prefix}_iters"].sum())
    same_kf = bool(np.array_equal(kf, want_kf))
    print(f"graph phase {name}: max |pose - JAX DeviceVO pose| "
          f"{d_pose.max():.3e} (atol {atol}); keyframes "
          f"{np.flatnonzero(kf).tolist()} (JAX "
          f"{np.flatnonzero(want_kf).tolist()}); iterations {iters} (JAX "
          f"{want_iters}); per step "
          + " ".join(f"{e:.1e}" for e in d_pose))
    _require(len(res) == len(want), f"graph phase {name}: {len(res)} steps, "
                                    f"JAX {len(want)}")
    _require(bool(np.all(np.isfinite(poses))) and d_pose.max() <= atol,
             f"graph phase {name}: poses differ from JAX's DeviceVO by "
             f"{d_pose.max()}")
    _require(same_kf, f"graph phase {name}: keyframes differ from JAX's")
    return {"max_abs_pose_diff": float(d_pose.max()), "atol": atol,
            "keyframes_equal": same_kf, "iterations": iters,
            "jax_iterations": want_iters}


def while_paths(K, baseline, shape, dev):
    """The graph phase's WHILE paths: {name: (label, make_vo, steps, JAX
    atol)}: (a) dense ``DeviceVO`` intensity and Bit-Planes (L0 and L1 on
    ``gauss_newton.run``, each a WHILE node in the step graph), (b)
    Bit-Planes Levenberg-Marquardt with the disparity given (every level
    an LM WHILE node, ``irls_reduce`` in its body)."""
    from bpvo_tpu_torch import AlgorithmParameters, DescriptorType
    from bpvo_tpu_torch.vo.device_vo import DeviceVO

    def make(params):
        return lambda: DeviceVO(K, baseline, shape, params, device=dev)
    lm = AlgorithmParameters(**BENCH, descriptor=DescriptorType.BITPLANES,
                             poseEstimator="LevenbergMarquardt")
    return {
        "device_vo_dense_intensity": (
            "DeviceVO dense intensity",
            make(_dense_params(DescriptorType.INTENSITY)), GRAPH_STEPS,
            T_ATOL_JAX_DENSE["intensity"]),
        "device_vo_dense_bitplanes": (
            "DeviceVO dense bitplanes",
            make(_dense_params(DescriptorType.BITPLANES)), GRAPH_STEPS,
            T_ATOL_JAX_DENSE["bitplanes"]),
        "device_vo_lm_bitplanes": (
            "DeviceVO Bit-Planes LM", make(lm), LM_GRAPH_STEPS, ZOO_ATOL)}


def trace_chunk_subprocess(path):
    """``python3 chip_smoke.py --trace-chunk <path>`` (``trace_chunk_main``):
    a chunk path's first chunk traced in a fresh process; its lines are
    printed here, its JSON object returned.  Fails with the process."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--trace-chunk", path], capture_output=True,
                          text=True, timeout=TRACE_CHUNK_TIMEOUT_S)
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        print(f"  [trace {path}] {line}")
    _require(proc.returncode == 0 and bool(lines),
             f"trace of {path} in a fresh process: rc {proc.returncode}, "
             f"{proc.stderr[-4000:]}")
    return {**json.loads(lines[-1]), "traced_in": "a fresh process"}


def trace_chunk_main(path):
    """The body of ``--trace-chunk <path>``: the path's ``DeviceVO`` (the
    bench ``intensity``, ``stereo_bitplanes`` or one of ``while_paths``)
    over the first of the graph phase's CHUNKS chunks of its steps, as
    ``trace_chunk`` takes it, after one ``add_frames`` over it (the
    warm-up and the capture).  Prints the JSON object last."""
    import torch
    from bpvo_tpu_torch import AlgorithmParameters, ConfigFile, DescriptorType
    from bpvo_tpu_torch.data import stereo, synthetic
    from bpvo_tpu_torch.vo.device_vo import DeviceVO

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    shape = (synthetic.ROWS, synthetic.COLS)
    K, baseline, sframes = synthetic.synthesize_stereo_sequence(
        1 + -(-N_STEPS // CHUNKS))
    frames = [f[0::2] for f in sframes]
    if path == "intensity":
        label, n = "intensity", N_STEPS
        params = AlgorithmParameters(**BENCH,
                                     descriptor=DescriptorType.INTENSITY)

        def make_vo():
            return DeviceVO(K, baseline, shape, params, device=dev)
    elif path == "stereo_bitplanes":
        label, n, frames = "stereo Bit-Planes", N_STEPS, [
            f[:2] for f in sframes]
        cf = ConfigFile(CONF)
        params, matcher = (AlgorithmParameters.from_config(cf),
                           stereo.create_stereo_algorithm(cf))

        def make_vo():
            return DeviceVO(K, baseline, shape, params, device=dev,
                            stereo_fn=matcher.as_fn())
    else:
        label, make_vo, n, _ = while_paths(K, baseline, shape, dev)[path]
    size = -(-n // CHUNKS)
    images, auxs = ([torch.as_tensor(f[i]).to(dev) for f in frames[:1 + size]]
                    for i in (0, 1))
    chunk = torch.stack(images[1:]), torch.stack(auxs[1:])
    vo = make_vo()

    def reset():
        vo.state = None
        vo.add_frame(images[0], auxs[0])
        torch.cuda.synchronize()
    reset()
    vo.add_frames(*chunk)
    torch.cuda.synchronize()
    print(json.dumps(trace_chunk(label, vo, chunk, reset, smi)))
    return 0


def _summary(out):
    """(poses, iterations, keyframe flag) of a step's output; for a
    ``Result`` the pose and the covariance, and the iterations and
    statuses."""
    import numpy as np
    import torch
    if isinstance(out, tuple):      # a VOStepOutput
        return (torch.cat([out.pose.reshape(-1),
                           out.pose_world.reshape(-1),
                           out.f_norm]).cpu().numpy(),
                out.iters.cpu().numpy(), bool(out.is_keyframe))
    return (np.concatenate([np.ravel(out.pose), np.ravel(out.covariance)]),
            np.array([(st.num_iterations, st.status.value)
                      for st in out.optimizer_statistics]),
            bool(out.is_keyframe))


def _same(res_a, res_b):
    import numpy as np
    return len(res_a) == len(res_b) and all(
        np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
        and a[2] == b[2] for a, b in zip(res_a, res_b))


def chunk_route(name, make_vo, images, auxs, res_e, n_e, dev, smi):
    """``DeviceVO.add_frames`` over the steps in CHUNKS chunks, each chunk
    on the card before its replays run under
    ``torch.cuda.set_sync_debug_mode("error")``: once to warm up (the
    capture), once timed (host clock from the first replay to a sync after
    the last chunk; each chunk's span by CUDA events) and counted, and
    once under torch.profiler (top-level host ops a step); its first chunk
    is traced in a fresh process (``trace_chunk_subprocess``).  Its poses,
    iterations and keyframes must equal the eager route's ``res_e`` bit for bit, its
    settled launch counts ``n_e``."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from bpvo_tpu_torch.utils import graphs
    from bpvo_tpu_torch.vo.device_vo import VOStepOutput

    vo = make_vo()
    n = len(images) - 1
    size = -(-n // CHUNKS)
    chunks = [(torch.stack(images[lo:lo + size]),
               torch.stack(auxs[lo:lo + size]))
              for lo in range(1, n + 1, size)]

    def reset():
        vo.state = None
        vo.add_frame(images[0], auxs[0])
        torch.cuda.synchronize()

    def run(sub=None, debug="error", events=()):
        outs = []
        torch.cuda.set_sync_debug_mode(debug)
        try:
            for i, (im, ax) in enumerate(sub or chunks):
                if events:
                    events[i][0].record()
                if sub is None:
                    outs.append(vo.add_frames(im, ax))
                else:
                    with record_function(f"{STEP_LABEL}{i}"):
                        outs.append(vo.add_frames(im, ax))
                if events:
                    events[i][1].record()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        return outs

    reset()
    run(debug=0)                        # warm-up: the capture reads
    reset()
    _reset_counts()
    # each chunk's span on the stream's clock (CUDA events, no sync)
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in chunks]
    t0 = time.perf_counter()
    outs = run(events=events)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    span_ms = [a.elapsed_time(b) for a, b in events]
    counts = _counts()
    res = [_summary(VOStepOutput(*(f[i] for f in o)))
           for o in outs for i in range(o.pose.shape[0])]
    same = _same(res_e, res)
    # host ops: every top-level op and replay under a chunk's label
    reset()
    replays = graphs.replay_count
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run(sub=chunks)
    n_replays = graphs.replay_count - replays
    ops = sum(len(e.cpu_children) for e in prof.events()
              if e.name.startswith(STEP_LABEL))
    r = {"chunks": len(chunks), "frames_per_s": n / (wall_ms / 1e3),
         "wall_ms": wall_ms, "host_ops_per_step": (ops + n_replays) / n,
         "chunk_span_ms": span_ms, "launches": counts, "bitwise_eager": same}
    print(f"graph phase {name} chunks: {len(chunks)} add_frames chunks of "
          f"{size} under set_sync_debug_mode('error'): "
          f"{r['frames_per_s']:.1f} frames/s ({wall_ms:.3f} ms for {n} "
          f"steps), top-level host ops per step "
          f"{r['host_ops_per_step']:.2f}; chunk spans {span_ms}; "
          f"launches {counts} (eager {n_e}); bitwise equal to the eager "
          f"route: {same} on {smi}")
    _require(same, f"graph phase {name}: the chunk route differs from the "
                   f"eager one")
    _require(counts == n_e, f"graph phase {name}: chunk launches {counts}, "
                            f"eager {n_e}")
    return r


# the kernels whose trace events trace_chunk holds to their launches, by
# the name of their launch count; those of LOOP_KERNELS also launch in
# WHILE bodies
TRACED_KERNELS = {"level_gn": "level_gn_kernel",
                  "fused_linearize": "fused_linearize_kernel",
                  "irls_reduce": "irls_reduce_kernel",
                  "census_planes": "census_kernel",
                  "census_cost": "census_cost_kernel",
                  "gn_step": "gn_step_kernel"}
LOOP_KERNELS = ("fused_linearize", "irls_reduce", "gn_step")


def trace_chunk(name, vo, chunk, reset, smi):
    """``chunk`` (``vo.add_frames``, its graph captured) run untraced,
    its span on the stream by CUDA events, then traced (``profiling.trace``,
    annotated through its sync): the device busy share of the annotated
    window, the kernel time over the untraced span, the top kernels by
    device time, and the kernel events of each of TRACED_KERNELS, which
    must equal the launches the wrappers counted for the chunk, settled.
    LOOP_KERNELS are held to fewer: torch.profiler records a WHILE body's
    kernels once a replay, not once an iteration (scripts/
    profiler_records.py, ``while_body_iterations``), so each must have
    events if it launched, at most its launches, and the trace's kernel
    time and busy share then undercount.  Run it in a fresh process
    (``trace_chunk_main``): in one that ran chip_smoke's earlier phases,
    the profiler gave the bench chunks' kernels other names (6 events
    named fused_linearize and 6 census in an intensity chunk, which
    launches neither; 40 level_gn events for 46 launches in a stereo
    one).  Both runs are under ``set_sync_debug_mode("error")``.
    Returns the JSON object."""
    import torch
    from bpvo_tpu_torch.utils import profiling

    im, ax = chunk

    def one():
        torch.cuda.set_sync_debug_mode("error")
        try:
            vo.add_frames(im, ax)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    reset()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    one()
    b.record()
    torch.cuda.synchronize()
    span_ms = a.elapsed_time(b)
    reset()
    log_dir = os.path.join(HERE, "build", "graph_phase_trace")
    shutil.rmtree(log_dir, ignore_errors=True)
    _reset_counts()
    with profiling.trace(log_dir, device=vo.device):
        with profiling.annotate(CHUNK_LABEL):
            one()
            torch.cuda.synchronize()
    launches = _counts()
    kernels, names, found, busy = _trace_read(log_dir, [CHUNK_LABEL])
    by_name = {}
    for k in kernels:
        by_name[k["name"][:60]] = by_name.get(k["name"][:60], 0) + k["dur"]
    total_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    traced = {k: sum(kname in n for n in names)
              for k, kname in TRACED_KERNELS.items()}
    counted = {k: launches[k] for k in TRACED_KERNELS}
    uncorrelated = sum(not k["args"].get("correlation") for k in kernels)
    missing = {k: counted[k] - traced[k] for k in LOOP_KERNELS}
    r = {"trace_complete": not any(missing.values()),
         "device_busy_share": busy, "traced_chunk_kernels": len(kernels),
         "traced_chunk_kernel_us": total_us, "untraced_span_ms": span_ms,
         "kernel_share_of_untraced_span": total_us / 1e3 / span_ms,
         "traced_chunk_steps": im.shape[0], "top_kernels_us": top,
         "traced_kernel_events": traced, "traced_launches": counted,
         "uncorrelated_kernel_events": uncorrelated}
    print(f"graph phase {name} traced chunk ({im.shape[0]} steps): device "
          f"busy share {busy:.4f} ({len(kernels)} kernel events, "
          f"{uncorrelated} with no correlation, {total_us:.1f} us of "
          f"kernels, {r['kernel_share_of_untraced_span']:.4f} of the same "
          f"chunk's untraced span {span_ms:.3f} ms); kernel events "
          f"{traced} for launches {counted}"
          + (f" (WHILE-body launches with no event: {missing}; the kernel "
             f"time and busy share undercount)" if not
             r["trace_complete"] else "")
          + f"; top by device time {top} on {smi}")
    _require(found == [CHUNK_LABEL] and len(kernels) > 0,
             f"graph phase {name}: the traced chunk has no kernels")
    _require(all(traced[k] == counted[k] if k not in LOOP_KERNELS
                 else traced[k] <= counted[k]
                 and (traced[k] > 0) == (counted[k] > 0)
                 for k in TRACED_KERNELS) and sum(counted.values()) > 0,
             f"graph phase {name} trace: kernel events {traced} for "
             f"launches {counted}")
    return r


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
    """The census cost volume's kernel vs its plain version on the pair's
    codes, bit for bit, with both times and the kernel's bound; the SGM
    aggregation kernel vs plain version on that volume, bit for bit; the
    matcher's route (``disparity_4dir``, the tile pass taking the winner)
    vs the unfused chain (the aggregation, then the plain winner), bit for
    bit, with its time, bound and counts; each pass's device time
    (back-to-back launches of its C entry point); the matcher's ms per
    call by stage; the matcher's frame-0 disparity vs JAX's.  Returns the
    SGM kernel's figures and the cost volume kernel's entry of the kernels
    line (without its launches)."""
    import torch
    from bpvo_tpu_torch.data import stereo
    from bpvo_tpu_torch.ops import _build, census, census_cost, sgm
    left, right, gt = (torch.as_tensor(a).to(dev) for a in pair)
    p1, p2, D = matcher.p1, matcher.p2, matcher.num_disparities
    codes = census.census(torch.stack([left, right]))
    cost = census_cost.census_cost_volume(codes[0], codes[1], D)
    cost_want = census_cost.census_cost_volume_reference(codes[0], codes[1],
                                                         D)
    torch.cuda.synchronize()
    n_cost = int((cost != cost_want).sum())
    err_cost = float((cost - cost_want).abs().max())
    del cost_want
    t_cv = _cuda_ms(lambda: census_cost.census_cost_volume(
        codes[0], codes[1], D), SGM_REPS)
    t_cv_plain = _cuda_ms(lambda: census_cost.census_cost_volume_reference(
        codes[0], codes[1], D), SGM_REPS)
    cv_bound = _bound(_nbytes(codes[0], codes[1], cost), 0)
    print(f"census_cost {tuple(cost.shape)}: {n_cost} values differ, kernel "
          f"{t_cv:.4f} ms plain {t_cv_plain:.4f} ms, bound {cv_bound[0]:.4f} "
          f"ms ({cv_bound[1]}, {100 * cv_bound[0] / t_cv:.1f}%); on {smi}")
    _require(n_cost == 0, f"census_cost kernel differs from its plain "
                          f"version in {n_cost} values")
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
    # the matcher's route: the tile pass takes the winner, the sum is never
    # written; against the aggregation followed by the plain winner
    n0, w0 = sgm.launch_count, sgm.winner_count.launch_count
    fused = sgm.disparity_4dir(cost, p1, p2)
    chain = stereo._wta_subpixel(got, D)
    torch.cuda.synchronize()
    n_fused = int((fused != chain).sum())
    counted = (sgm.launch_count - n0, sgm.winner_count.launch_count - w0)
    t_f = _cuda_ms(lambda: sgm.disparity_4dir(cost, p1, p2), SGM_REPS)
    t_wta = _cuda_ms(lambda: stereo._wta_subpixel(got, D), SGM_REPS)
    f_bound = _bound(_nbytes(cost, fused), OPS_SGM_COST * cost.numel())
    print(f"sgm disparity_4dir {tuple(fused.shape)}: {n_fused} values "
          f"differ from the unfused chain, launch sets and winners counted "
          f"{counted}; {t_f:.4f} ms against aggregate {t_k:.4f} + plain "
          f"winner {t_wta:.4f} ms; bound {f_bound[0]:.4f} ({f_bound[1]}); "
          f"on {smi}")
    _require(n_fused == 0 and torch.equal(fused, chain),
             f"sgm disparity_4dir differs from the unfused chain in "
             f"{n_fused} values")
    _require(counted == (1, 1), f"sgm disparity_4dir counted {counted} "
                                f"launch sets and winners, expected (1, 1)")
    # the passes alone, from their C entry points (the tile pass storing
    # the sum, and taking the winner)
    out, launches = sgm.pass_launches(cost, p1, p2)
    disp, wta_launches = sgm.pass_launches(cost, p1, p2, winner=True)
    _require(all(launch() == 0 for launch in wta_launches.values()),
             "sgm passes failed to launch")
    launches["tile_winner"] = wta_launches["tile"]    # on its carries
    _require(all(launch() == 0 for launch in launches.values()),
             "sgm passes failed to launch")
    by_pass = {k: _cuda_ms(launch, SGM_REPS) for k, launch in launches.items()}
    _require(torch.equal(out, got), "sgm: the passes' output differs")
    _require(torch.equal(disp, fused), "sgm: the winner pass differs")
    bound = _bound(_nbytes(cost, got), OPS_SGM_COST * cost.numel())
    # bytes of the two-pass structure: the cost read 5 times, the carries
    # written and read, the output written
    H, W, _ = cost.shape
    scratch = _build.library().bpvo_sgm_scratch_floats(H, W, D) * 4
    structure = _bound(5 * _nbytes(cost) + 2 * scratch + _nbytes(got), 0)[0]
    print(f"sgm passes, device ms: carry {by_pass['carry']:.4f}, tile "
          f"{by_pass['tile']:.4f}, tile taking the winner "
          f"{by_pass['tile_winner']:.4f}; through the wrapper {t_k:.4f}; "
          f"bound {bound[0]:.4f} ({bound[1]}), the two-pass structure's bytes "
          f"{structure:.4f}; on {smi}")
    fn = matcher.as_fn()
    t_m = _cuda_ms(lambda: fn(left, right), SGM_REPS)
    stages = {
        "census": _cuda_ms(lambda: census.census(torch.stack([left, right])),
                           SGM_REPS),
        "cost_volume": t_cv,
        "aggregation_and_wta": t_f}
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
    del cost, got, want, one, one_want, out, launches, fused, chain, disp
    return err, t_k, t_p, bound, {"ms_by_pass": by_pass,
                                  "structure_bound_ms": structure,
                                  "disparity_ms": t_f,
                                  "disparity_bound_ms": f_bound[0],
                                  "unfused_wta_ms": t_wta,
                                  "matcher_ms": t_m,
                                  "matcher_ms_by_stage": stages}, {
        "max_abs_err": err_cost, "ms": t_cv, "plain_ms": t_cv_plain,
        "bound_ms": cv_bound[0], "bound_by": cv_bound[1],
        "shape": [H, W, D]}


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
    want = {"census_planes": 2 * (n + 1), "census_cost": n + 1,
            "sgm_aggregate": n + 1, "sgm_winner": n + 1,
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

    # the LM cells again on VisualOdometry's eager route (``_graphs =
    # None``: the eager host loops): each graphed cell (every estimate one
    # replay of its graph, every LM level a WHILE node in it) must give
    # the eager cell's trajectory and per-frame iterations bit for bit
    from bpvo_tpu_torch.vo import odometry
    init = odometry.VisualOdometry.__init__

    def eager_init(self, *a, **k):
        init(self, *a, **k)
        self._graphs = None
    odometry.VisualOdometry.__init__ = eager_init
    traj_e = {}
    try:
        t = time.perf_counter()
        cells_e = eval_descriptors.run(
            corridor_cfg, os.path.join(root, "eval_lm_eager"), -1, None,
            ("LevenbergMarquardt",), device=dev, trajectories=traj_e)
        wall_e = time.perf_counter() - t
    finally:
        odometry.VisualOdometry.__init__ = init
    lm_eager = {}
    for desc in ZOO_DESCRIPTORS:
        tag = f"{desc}+LevenbergMarquardt"
        it_g, it_e = (np.loadtxt(os.path.join(root, d, f"{t}_iterations.txt"))
                      for d, t in (("eval", tag), ("eval_lm_eager", desc)))
        same = (np.array_equal(traj[tag], traj_e[desc])
                and np.array_equal(it_g, it_e))
        lm_eager[tag] = {"graphed_ms": table[tag]["mean_ms"],
                         "eager_ms": cells_e[desc]["mean_ms"],
                         "iterations": float(it_g.sum()),
                         "bitwise_eager": same}
        print(f"  {tag:40s} graphed {table[tag]['mean_ms']:8.3f} ms/frame, "
              f"eager {cells_e[desc]['mean_ms']:8.3f} ms/frame, "
              f"{int(it_g.sum())} iterations (eager {int(it_e.sum())}); "
              f"trajectory and iterations bitwise the eager run: {same}")
        _require(same, f"eval_descriptors {tag}: the graphed LM cell "
                       f"differs from the eager one")
    print(f"eval_descriptors LM cells eager: {wall_e:.1f} s")
    _lap(t0, "zoo LM eager")

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
             "eval_descriptors_s": wall, "lm_eager": lm_eager,
             "lm_eager_s": wall_e, "launches": launches,
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
# sharded VO vs DeviceVO on the card.  Intensity: JAX's dry run's bound.
# Bit-Planes (delta (r)): the port keeps JAX's sharded sigma rule (delta
# (m)), which parts from DeviceVO's in JAX too, so its gap is held to JAX's
# own gap between its sharded VO and its DeviceVO on the level route (the
# reference's sharded_bitplanes_device_vo_level_world) plus the route
# tolerance the card holds the Bit-Planes DeviceVO to (delta (e))
SHARDED_ATOL_DEVICE_VO = 1e-3
SHARDED_ROUTE_ATOL = 2.3e-3
SHARDED_ATOL_JAX = 5e-4        # sharded VO vs JAX's sharded VO
BA_ATOL_JAX = 5e-4             # BA keyframe windows vs JAX's
BA_DEPTH_ATOL = 1e-3           # ba_solve_with_depth, card vs CPU
BA_DEPTH_M, BA_DEPTH_ITERS = 4, 4
# JAX's 8-device dry run: all-reduces in the compiled per-frame step (its
# while-loop bodies counted once each) and their bytes (MULTICHIP_r05.json)
JAX_STEP_ALL_REDUCES, JAX_STEP_ALL_REDUCE_BYTES = 19, 25468


DIST_TIMEOUT_S = 300           # each multi-process run's wall timeout
DIST_ROUNDS = 3                # alternated eager/graphed timing rounds
POSE_GRAPH_N = 8               # the pose graph: a chain and a loop closure


def _bitwise(a, b):
    """Two structures of tensors equal bit for bit, leaf by leaf."""
    import torch
    from bpvo_tpu_torch.utils import graphs
    la, lb = graphs._leaves(a), graphs._leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _alternated_ms(eager, graphed, rounds=DIST_ROUNDS, setup=None):
    """Host ms of ``eager()`` and ``graphed()`` (each ending in a sync), in
    turns eager, graphed, graphed, eager for ``rounds`` rounds (host time
    varies ~2x between calls, so only times taken together compare).  With
    ``setup``, each is timed as ``fn(setup(fn))``, the setup untimed.
    Returns (eager ms, graphed ms): the mean of each."""
    import torch
    ms = {"eager": [], "graphed": []}
    for _ in range(rounds):
        for name, fn in (("eager", eager), ("graphed", graphed),
                         ("graphed", graphed), ("eager", eager)):
            arg = () if setup is None else (setup(fn),)
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn(*arg)
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t) * 1e3)
    return (sum(ms["eager"]) / len(ms["eager"]),
            sum(ms["graphed"]) / len(ms["graphed"]))


def _graphed_vs_eager(label, fn, smi, reducer=None):
    """``fn(cache)`` on its eager route (``cache=False``) and its graphed
    one (a cache of its own: the first call captures, later calls are one
    replay each with no device read): bitwise, the same launches and
    collectives, ms alternated.  Returns the record; fails on a
    difference."""
    import torch
    from bpvo_tpu_torch.utils import graphs
    cache = graphs.GraphCache(torch.device("cuda",
                                           torch.cuda.current_device()))

    def stats():
        return reducer.stats() if reducer is not None else {}
    _reset_counts()
    s0 = stats()
    want = fn(False)
    n_e, c_e = _counts(), _stat_delta(s0, stats())
    first = fn(cache)
    _reset_counts()
    s0, r0 = stats(), graphs.replay_count
    with _sync_errors():
        got = fn(cache)
    replays = graphs.replay_count - r0
    n_g, c_g = _counts(), _stat_delta(s0, stats())
    same = (_bitwise(got, want) and _bitwise(first, want) and n_g == n_e
            and c_g == c_e)
    ms_e, ms_g = _alternated_ms(lambda: fn(False), lambda: fn(cache))
    rec = {"graphed_equals_eager": same, "replays": replays,
           "reads": 0, "ms": ms_g, "ms_eager": ms_e, "launches": n_g,
           "collectives": c_g, "node_types": cache.node_types()}
    print(f"{label} graphed vs eager: {ms_g:.3f} vs {ms_e:.3f} ms a call "
          f"(alternated) on {smi}; {replays} replay, no read; bitwise "
          f"(outputs, launches, collectives): {same}; launches {n_g}, "
          f"collectives {c_g}; node types {rec['node_types']}")
    _require(same, f"{label}: graphed differs from eager ({n_g} vs {n_e}, "
                   f"{c_g} vs {c_e})")
    _require(replays == 1, f"{label}: {replays} replays a call")
    return rec


def _stat_delta(before, after):
    return {k: after[k] - before[k] for k in after}


def _ba_capture_arms(K, baseline, shape, params, frames, window, want,
                     dev, smi):
    """BA through ``VisualOdometry`` with its window sizes captured at
    ``enable_bundle_adjustment`` ("after") against captured in the frame
    loop at each size's first optimize ("before": a ``KeyframeWindow`` on
    a fresh cache, no capture ahead), alternated before, after, after,
    before in this call.  Every arm's frames run on one warm
    ``VisualOdometry`` cache (its frame, template and estimate keys
    captured by an untimed run), so the keyframe steps differ only by BA.
    Each add_frame is timed (host clock to a sync); every arm's refined
    windows must equal ``want`` (the checked run's) bit for bit.  Returns
    the JSON object: keyframe-step p50/p90 per run, and the enable ms of
    the "after" runs."""
    import numpy as np
    import torch
    from bpvo_tpu_torch import VisualOdometry
    from bpvo_tpu_torch.parallel import bundle_adjustment as ba
    from bpvo_tpu_torch.utils import graphs

    images = [torch.as_tensor(f[0]).to(dev) for f in frames]
    disps = [torch.as_tensor(f[1]).to(dev) for f in frames]
    warm = VisualOdometry(K, baseline, shape, params, device=dev)
    for image, disp in zip(images, disps):
        warm.add_frame(image, disp)

    def run(after):
        vo = VisualOdometry(K, baseline, shape, params, device=dev)
        enable_ms = None
        if after:       # the sizes' graphs in a fresh cache of the window's
            vo._graphs = graphs.GraphCache(dev)
            torch.cuda.synchronize()
            t = time.perf_counter()
            vo.enable_bundle_adjustment(window)
            torch.cuda.synchronize()
            enable_ms = (time.perf_counter() - t) * 1e3
        else:
            vo._ba_window = ba.KeyframeWindow(
                window, vo._cams[vo._p.maxTestLevel], ba.BAOptions(),
                device=dev, cache=graphs.GraphCache(dev))
        vo._graphs = warm._graphs
        kf_ms, refined = [], []
        for i, (image, disp) in enumerate(zip(images, disps)):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = vo.add_frame(image, disp)
            torch.cuda.synchronize()
            if res.is_keyframe and i > 0:
                kf_ms.append((time.perf_counter() - t) * 1e3)
                refined.append(vo.refined_keyframe_poses())
        same = len(refined) == len(want) and all(
            np.array_equal(a, b) for a, b in zip(refined, want))
        return {"arm": "after" if after else "before",
                "kf_p50_ms": float(np.percentile(kf_ms, 50)),
                "kf_p90_ms": float(np.percentile(kf_ms, 90)),
                "kf_max_ms": float(max(kf_ms)), "enable_ms": enable_ms,
                "refined_bitwise_checked_run": bool(same)}
    runs = [run(after) for after in (False, True, True, False)]
    for r in runs:
        print(f"BA capture arms: {r['arm']:6s} keyframe steps p50 "
              f"{r['kf_p50_ms']:.3f} p90 {r['kf_p90_ms']:.3f} max "
              f"{r['kf_max_ms']:.3f} ms"
              + (f"; enable_bundle_adjustment {r['enable_ms']:.1f} ms"
                 if r["enable_ms"] is not None else "")
              + f"; refined windows bitwise the checked run's: "
                f"{r['refined_bitwise_checked_run']} on {smi}")
        _require(r["refined_bitwise_checked_run"],
                 f"BA capture arm {r['arm']}: refined windows differ")
    return runs


def multicard_phase(shape, smi):
    """The dry run with nccl ranks over min(count, 4) cards of this host
    (the peer route, graphed) when the machine has 2 or more: every path
    graphed against eager on every rank, no read a replay, kernel, memcpy
    and memset nodes only in the IF and WHILE bodies, the ranks bitwise
    equal, JAX's tolerances (tests/data/torch_port_sharded_ref.npz), every
    path reducing through ``peer_reduce`` on every rank, and the kernel bit
    for bit its plain version across the cards at every reduced size.
    Returns (the dry run's summary, rank 0's peer_reduce launches in the
    dry run's paths), (None, None) on one card."""
    import torch
    from bpvo_tpu_torch.parallel import dryrun
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        print(f"dryrun with nccl ranks across cards: not run ({n_cards} "
              f"card); the peer route needs 2 or more")
        return None, None
    w = min(n_cards, 4)
    res = dryrun.run(w, "nccl", "cuda", *shape, timeout_s=DIST_TIMEOUT_S,
                     ref=REF_SHARDED_NPZ)
    _require(res["ok"] and res["route"] == "peer" and res["graphed"],
             f"dryrun {w} nccl ranks: {json.dumps(res)[:6000]}")
    _require(min(min(v) for v in res["peer_launches_by_path"].values()) > 0
             and res["collectives_bitwise_plain"],
             f"dryrun {w} nccl ranks: peer_reduce launches by path "
             f"{res['peer_launches_by_path']}, bitwise its plain version "
             f"across cards {res['collectives_bitwise_plain']}")
    print(f"dryrun {w} nccl ranks on {w} cards (route {res['route']}: "
          f"{res['peer_rule']}): graphed, ranks bitwise equal "
          f"{res['ranks_bitwise_equal']}, graphed bitwise eager on every "
          f"rank {res['graphed_equals_eager_on_every_rank']}, bodies "
          f"kernel/memcpy/memset only "
          f"{res['bodies_kernel_memcpy_memset_only']}; checks "
          f"{res['checks']}; peer_reduce launches in the paths by rank "
          f"{res['peer_launches']}, by path {res['peer_launches_by_path']}; "
          f"bitwise its plain version across cards "
          f"{res['collectives_bitwise_plain']}; collective us "
          f"{res['collective_us']} on {smi}")
    return res, res["peer_launches"][0]


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
    from bpvo_tpu_torch.parallel import dryrun, multihost, peer, sharded
    from bpvo_tpu_torch.parallel import sharded_vo
    from bpvo_tpu_torch.solver import gauss_newton as gn
    from bpvo_tpu_torch.types import InterpolationType
    from bpvo_tpu_torch.utils import graphs
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
        # peer_reduce's count over the world-1 paths: a one-rank nccl group
        # keeps NCCL's route (peer.attach's static rule), so it stays 0
        graphs.settle()
        peer.launch_count = 0
        # 1. world 1, nccl, in this process: the sharded GN
        tdata, ch, cam, _ = dryrun.synthetic_problem(*shape, 16384,
                                                     device=dev)
        opts = gn.GNOptions(function_tolerance=1e-4,
                            parameter_tolerance=1e-6)
        T0 = torch.eye(4, dtype=torch.float32, device=dev)
        # the eager route (cache=False) and the graphed one (one replay a
        # solve, the all-reduces captured), each with its counts
        run_e = sharded.make_sharded_gn(reducer, opts, cache=False)
        gn_cache = graphs.GraphCache(dev)
        run_g = sharded.make_sharded_gn(reducer, opts, cache=gn_cache)
        # the counts settled (_counts) before the collectives are read
        _reset_counts()
        reducer.reset()
        st_e = run_e(tdata, ch, cam, T0)
        n_e, gn_stats = _counts(), reducer.stats()     # one solve's
        st_first = run_g(tdata, ch, cam, T0)           # warm-up, capture
        _reset_counts()
        reducer.reset()
        r0 = graphs.replay_count
        with _sync_errors():
            st = run_g(tdata, ch, cam, T0)             # one replay, no read
        replays = graphs.replay_count - r0
        n_g, stats_g = _counts(), reducer.stats()
        graphed_same = (_bitwise(st, st_e) and _bitwise(st_first, st_e)
                        and stats_g == gn_stats and n_g == n_e)
        st_none = sharded.make_sharded_gn(None, opts)(tdata, ch, cam, T0)
        st_run = gn.run(tdata, ch, cam, T0, opts)
        same = _bitwise(st, st_none)
        d_run = float((st.T - st_run.T).abs().max())
        gn_ms_e, gn_ms = _alternated_ms(
            lambda: run_e(tdata, ch, cam, T0),
            lambda: run_g(tdata, ch, cam, T0))
        run_none = sharded.make_sharded_gn(None, opts)
        gn_ms_none = _host_ms(lambda: run_none(tdata, ch, cam, T0))
        types = gn_cache.node_types()
        out["sharded_gn"] = {"iterations": int(st.num_iters),
                             "ms": gn_ms, "ms_eager": gn_ms_e,
                             "ms_no_reducer": gn_ms_none,
                             "replays_per_solve": replays,
                             "reads_per_solve": 0,
                             "graphed_equals_eager": graphed_same,
                             "nccl_equals_no_reducer": same,
                             "max_abs_vs_gauss_newton_run": d_run,
                             "collectives_per_solve": gn_stats,
                             "collectives_per_solve_graphed": stats_g,
                             "launches_per_solve": n_g,
                             "node_types": types}
        print(f"sharded GN 376x1241 K=16384 (nccl, world 1): "
              f"{int(st.num_iters)} iterations; graphed {gn_ms:.3f} ms a "
              f"solve ({replays} replay, no read), eager {gn_ms_e:.3f} ms, "
              f"alternated; graphed with no reducer {gn_ms_none:.3f} ms; on "
              f"{smi}; graphed bitwise eager (state, collectives, launches): "
              f"{graphed_same}; bitwise the no-reducer route: {same}; max "
              f"|T - gauss_newton.run T| {d_run:.3e}; collectives per solve "
              f"{gn_stats} (graphed {stats_g}); launches {n_g}; node types "
              f"{types}")
        _require(graphed_same, f"sharded GN: graphed differs from eager "
                               f"({stats_g} vs {gn_stats}, {n_g} vs {n_e})")
        _require(replays == 1, f"sharded GN: {replays} replays a solve")
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

            def make(red, cache=None):
                return (red, cache, sharded_vo.make_sharded_vo(
                    red, K, baseline, shape, p, device=dev, cache=cache))

            def run_sharded(route, steps=False, no_reads=True):
                """Init, then the frames in dryrun.CHUNKS chunks through
                ``scan_fn`` (graphed and ``no_reads``: under the sync debug
                mode, so a read raises; not on the call that captures), or
                one by one through ``step_fn`` (``steps``)."""
                red, cache, (init_fn, step_fn, scan_fn) = route
                state = init_fn(images[0], disps[0])
                if red is not None:
                    red.reset()
                outs, ms = [], []
                for lo, hi in dryrun.CHUNKS:
                    t = time.perf_counter()
                    if steps:
                        for i in range(lo, hi):
                            state, o = step_fn(state, images[i], disps[i])
                            outs.append(device_vo.VOStepOutput(
                                *(x[None] for x in o)))
                    else:
                        with _sync_errors(no_reads and cache is not False):
                            state, o = scan_fn(state, images[lo:hi],
                                               disps[lo:hi])
                        outs.append(o)
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t) * 1e3 / (hi - lo))
                stacked = device_vo.VOStepOutput(
                    *(torch.cat(f) for f in zip(*outs)))
                return (stacked.pose_world, stacked.is_keyframe, ms, state,
                        stacked)

            vo_cache = graphs.GraphCache(dev)
            graphed, eager = make(reducer, vo_cache), make(reducer, False)
            run_sharded(graphed, no_reads=False)   # warm-up and capture
            _reset_counts()
            r0 = graphs.replay_count
            world, kf, ms, state, g_out = run_sharded(graphed)
            replays = graphs.replay_count - r0
            launches[name] = _counts()
            stats = reducer.stats()
            # the eager route (cache=False) and the graphed step_fn
            _reset_counts()
            *_, e_out = run_sharded(eager)
            e_launches, e_stats = _counts(), reducer.stats()
            *_, s_out = run_sharded(graphed, steps=True)
            graphed_same = (_bitwise(g_out, e_out) and _bitwise(s_out, e_out)
                            and e_stats == stats
                            and e_launches == launches[name])
            n_steps = int(e_out.pose.shape[0])
            inits = {}

            def steps_of(route):
                """The steps through ``step_fn``, timed from an untimed
                ``init_fn`` state."""
                init_fn, step_fn, _ = route[2]

                def steps(state):
                    for i in range(1, n_steps + 1):
                        state, _ = step_fn(state, images[i], disps[i])
                inits[steps] = init_fn
                return steps
            seq_e, seq_g = _alternated_ms(
                steps_of(eager), steps_of(graphed),
                setup=lambda fn: inits[fn](images[0], disps[0]))
            host_ops = {}
            for label, (_, _, (init_fn, step_fn, _)) in (
                    ("eager", eager), ("graphed", graphed)):
                held = [init_fn(images[0], disps[0])]

                def one(i, step_fn=step_fn, held=held):
                    held[0], _ = step_fn(held[0], images[1 + i],
                                         disps[1 + i])
                host_ops[label] = _host_ops(one, n_steps)[0]
            world_none, kf_none, _, _, _ = run_sharded(make(None),
                                                       no_reads=False)
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
            jax_gap = float(np.abs(
                ref[f"sharded_{key}_world"]
                - ref[f"sharded_{key}_device_vo_level_world"]).max())
            atol_dvo = (SHARDED_ATOL_DEVICE_VO if c1
                        else jax_gap + SHARDED_ROUTE_ATOL)
            res = {
                "keyframes": kf.cpu().numpy().astype(int).tolist(),
                "ms_per_step_by_chunk": ms,
                "graphed_equals_eager": graphed_same,
                "replays_per_step": replays / n_steps,
                "reads_per_chunk": 0,
                "ms_per_step_eager": seq_e / n_steps,
                "ms_per_step_graphed": seq_g / n_steps,
                "host_ops_per_step": host_ops,
                "node_types": vo_cache.node_types(),
                "nccl_equals_no_reducer": bool(
                    torch.equal(world, world_none)
                    and torch.equal(kf, kf_none)),
                "max_abs_vs_device_vo": float(
                    (world - want).abs().max()),
                "atol_vs_device_vo": atol_dvo,
                "jax_max_abs_sharded_vs_device_vo_level_route": jax_gap,
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
            why = "" if c1 else (
                f" = JAX's sharded VO vs its DeviceVO on the level route "
                f"{jax_gap:.4e} + {SHARDED_ROUTE_ATOL}")
            print(f"{name} 376x1241 (nccl, world 1): keyframes "
                  f"{res['keyframes']}, ms per step by chunk "
                  f"{[round(m, 3) for m in ms]} on {smi}; bitwise the "
                  f"no-reducer route: {res['nccl_equals_no_reducer']}; max "
                  f"|pose - DeviceVO| {res['max_abs_vs_device_vo']:.3e} "
                  f"(atol {atol_dvo:.4e}{why}), max "
                  f"|pose - JAX sharded| {res['max_abs_vs_jax']:.3e} (atol "
                  f"{SHARDED_ATOL_JAX}); collectives per step "
                  f"{res['collective_calls_per_step']:.2f} calls, "
                  f"{res['collective_bytes_per_step']:.0f} B; launches "
                  f"{launches[name]}")
            print(f"{name} graphed (one replay a step, chunks read-free) "
                  f"vs eager, alternated: {res['ms_per_step_graphed']:.3f} "
                  f"vs {res['ms_per_step_eager']:.3f} ms a step ("
                  f"{n_steps} steps through step_fn) on {smi}; host ops a "
                  f"step {host_ops}; bitwise eager (poses, iterations, "
                  f"keyframes, collectives, launches): {graphed_same}; "
                  f"replays a step {res['replays_per_step']:.2f}; node "
                  f"types {res['node_types']}")
            _require(graphed_same, f"{name}: graphed differs from eager "
                                   f"({stats} vs {e_stats}, "
                                   f"{launches[name]} vs {e_launches})")
            _require(replays == n_steps, f"{name}: {replays} replays for "
                                         f"{n_steps} steps")
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
            _require(res["max_abs_vs_device_vo"] <= atol_dvo,
                     f"{name}: {res['max_abs_vs_device_vo']} from DeviceVO "
                     f"(atol {atol_dvo})")
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
        graphs.settle()
        out["peer_launches_world1"] = peer.launch_count
        _require(peer.launch_count == 0,
                 f"world 1 nccl: {peer.launch_count} peer_reduce launches "
                 f"(route {reducer.route}: {reducer.peer_rule})")
        _lap(t0, "distributed: world 1")
    finally:
        multihost.shutdown()

    # 2. world 2, gloo, two processes on cuda:0 (host-staged)
    res2 = dryrun.run(2, "gloo", "cuda", *shape, timeout_s=DIST_TIMEOUT_S,
                      descriptors=("intensity",), rounds=1)
    _require(res2["ok"], f"dryrun world 2 gloo: {res2}")
    out["dryrun_gloo_world2"] = res2
    print(f"dryrun 2 ranks gloo on cuda:0 (host-staged, not a collective on "
          f"the card): ranks bitwise equal {res2['ranks_bitwise_equal']}, "
          f"{res2['keyframe_events']} keyframe events, max |pose - DeviceVO|"
          f" {res2['max_abs_vs_device_vo']:.3e}; ms per step by rank "
          f"{[round(m, 1) for m in res2['vo_ms_per_step']]}; collectives "
          f"per step {res2['collectives_per_step']} on {smi}")
    _lap(t0, "distributed: world 2")

    # 2b. nccl over the cards of one host (the peer route), when the
    # machine has several cards
    out["dryrun_nccl_cards"], out["peer_launches"] = multicard_phase(shape,
                                                                     smi)

    # 3. BA: VisualOdometry with enable_bundle_adjustment(8), 1+30 frames
    K, baseline, frames = synthetic.synthesize_sequence(1 + N_STEPS)
    params = AlgorithmParameters(**BENCH, descriptor=DescriptorType.INTENSITY)
    vo = VisualOdometry(K, baseline, shape, params, device=dev)
    window = int(ref["ba_window"])
    torch.cuda.synchronize()
    t = time.perf_counter()
    vo.enable_bundle_adjustment(window)     # captures sizes 2..window
    torch.cuda.synchronize()
    enable_ms = (time.perf_counter() - t) * 1e3
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
                 "optimize_ms": opt_ms, "enable_ms": enable_ms,
                 "max_abs_vs_jax": ba_err,
                 "irls_reduce_per_optimize_iteration": [2 * (m - 1)
                                                        for m in sizes],
                 "launches": launches["ba"]}
    print(f"BA (VisualOdometry, window {window}, 1+{N_STEPS} frames): "
          f"keyframe events {at}, windows {sizes}, ms per optimize "
          f"{[round(m, 2) for m in opt_ms]} (enable_bundle_adjustment, its "
          f"captures of sizes 2..{window}: {enable_ms:.1f} ms) on {smi}; "
          f"max |refined - JAX| "
          f"{ba_err:.3e} (atol {BA_ATOL_JAX}); irls_reduce launches "
          f"{launches['ba']['irls_reduce']} (expected {want_irls}: 2(M-1) "
          f"an iteration)")
    _require(ba_err <= BA_ATOL_JAX, f"BA: {ba_err} from JAX's windows")
    _require(launches["ba"]["irls_reduce"] == want_irls,
             f"BA: irls_reduce launched {launches['ba']['irls_reduce']} "
             f"times, expected {want_irls}")
    out["ba_capture"] = _ba_capture_arms(K, baseline, shape, params, frames,
                                         window, got, dev, smi)
    # the edge reduction at its shape (K = 16384, C = 1), against plain
    irls_x["ba edge M=16384"] = _irls_zoo_check(
        "irls_reduce ba edge", win._templates[0], win._channels[1],
        vo._cams[0], gn.GNOptions())

    # the last window's BA graphed (one replay, as optimize ran it) and
    # eager, bitwise, ms alternated; make_sharded_ba(_2d) on the nccl group
    M_last = len(win._templates)
    stacked = ba.stack_templates(win._templates)
    chans = torch.stack(win._channels)
    poses0 = torch.from_numpy(np.stack(win._poses)).to(dev)
    cam0 = vo._cams[vo._p.maxTestLevel]
    reducer = multihost.initialize(
        "nccl", 1, 0, f"tcp://127.0.0.1:{multihost.free_port()}",
        device=dev)
    try:
        layout = multihost.RankLayout(1, 1)
        cases = {
            "ba_solve": lambda c: ba.ba_solve(stacked, chans, cam0, poses0,
                                              opts_ba, cache=c),
            "make_sharded_ba": lambda c: ba.make_sharded_ba(
                reducer, opts_ba, M_last, cache=c)(stacked, chans, cam0,
                                                   poses0),
            "make_sharded_ba_2d": lambda c: ba.make_sharded_ba_2d(
                reducer, opts_ba, M_last, layout, cache=c)(stacked, chans,
                                                           cam0, poses0)}
        out["ba_graphed"] = {"M": M_last}
        for label, fn in cases.items():
            out["ba_graphed"][label] = _graphed_vs_eager(label, fn, smi,
                                                         reducer)
    finally:
        multihost.shutdown()

    # ba_solve_with_depth at M = 4, K = 16384: card vs the CPU's plain run
    M = BA_DEPTH_M
    stacked = ba.stack_templates(win._templates[:M])
    chans = torch.stack(win._channels[:M])
    poses0 = torch.from_numpy(np.stack(win._poses[:M])).to(dev)
    d_opts = ba.BAOptions(max_iterations=BA_DEPTH_ITERS, refine_depth=True)
    _reset_counts()
    pd, td_d, cost_d = ba.ba_solve_with_depth(stacked, chans, vo._cams[0],
                                              poses0, d_opts)
    launches["ba_depth"] = _counts()          # the graph's first call
    out["ba_depth_graphed"] = _graphed_vs_eager(
        "ba_solve_with_depth", lambda c: ba.ba_solve_with_depth(
            stacked, chans, vo._cams[0], poses0, d_opts, cache=c), smi)
    depth_ms = out["ba_depth_graphed"]["ms"]
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

    # the pose graph: a chain of POSE_GRAPH_N noisy odometry poses and a
    # loop closure, graphed against eager
    from bpvo_tpu_torch.core import se3
    from bpvo_tpu_torch.parallel import pose_graph
    g = torch.Generator().manual_seed(0)
    n = POSE_GRAPH_N
    truth = se3.exp(torch.cat([0.02 * torch.randn(n, 3, generator=g),
                               0.3 * torch.randn(n, 3, generator=g)], 1))
    edges = np.concatenate([pose_graph.sequential_edges(n), [[0, n - 1]]])
    meas = truth[edges[:, 0]] @ se3.inverse(truth[edges[:, 1]])
    noisy = truth @ se3.exp(0.01 * torch.randn(n, 6, generator=g))
    args = [x.to(dev) for x in (noisy, torch.from_numpy(edges), meas,
                                torch.eye(6).expand(len(edges), 6, 6))]
    out["pose_graph"] = _graphed_vs_eager(
        "pose_graph", lambda c: pose_graph.optimize(*args, device=dev,
                                                    cache=c), smi)
    _lap(t0, "distributed: BA")

    # 4. collectives against JAX's count; the scaling bench
    sc = {"world1_nccl": scaling_bench.run_scaling(
        (1,), backend="nccl", device="cuda", reps=10,
        timeout_s=DIST_TIMEOUT_S),
        "world2_gloo": scaling_bench.run_scaling(
        (1, 2), backend="gloo", device="cuda", reps=10,
        timeout_s=DIST_TIMEOUT_S)}
    _require(all(v["graphed"] for v in sc["world1_nccl"]["by_world"].values())
             and not any(v["graphed"] for v in
                         sc["world2_gloo"]["by_world"].values()),
             f"scaling_bench: nccl graphed, gloo eager: {sc}")
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
              f"{'host-staged, eager' if r['staged'] else 'on the card, graphed'}): " + ", ".join(
                  f"world {n}: {v['ms_per_solve']:.3f} ms a solve, "
                  f"efficiency {v['efficiency']:.3f}"
                  for n, v in r["by_world"].items()) + f" on {smi}")
    out["jax_compiled_step"] = {"all_reduces": JAX_STEP_ALL_REDUCES,
                                "bytes": JAX_STEP_ALL_REDUCE_BYTES,
                                "devices": 8}
    out["seconds"] = time.perf_counter() - t0
    _lap(t0, "distributed phase")
    return out, launches, fused_x, irls_x


PEER_WORLDS = (2, 4, 8)         # loopback ranks (CTAs) of peer_reduce
PEER_GRAPH_CALLS, PEER_REPLAYS = 10, 3
PEER_REPS = 200
PEER_SHAPE = (4, "gn_H_g_fsq")  # the kernels line's main shape


def peer_phase(dev, smi):
    """``peer_reduce`` on one card through its loopback launch (W CTAs of
    one launch, CTA r playing rank r): at W = 2, 4, 8 and every size and op
    the distributed layer reduces (``dryrun.COLLECTIVE_SIZES``), bit for
    bit its plain version (``peer.plain_fold`` on the same device) eagerly
    and in a CUDA graph of PEER_GRAPH_CALLS calls replayed PEER_REPLAYS
    times on fresh inputs, every buffer's device epoch equal to the
    launches made (it advances on the device, replays included); one
    device kernel a call; a buffer over the slot capacity raises.  Times:
    through the wrapper and replayed from a graph, the plain version and
    the library call (``sum``/``amax`` over the rank axis).  Returns the
    kernels line's entry without ``launches`` (the main path's, set by the
    caller)."""
    import torch
    from bpvo_tpu_torch.parallel import dryrun, peer
    from bpvo_tpu_torch.probes import timing
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(0)

    def inputs(shape, dtype):
        if dtype == torch.float32:
            return (torch.randn(shape, generator=gen) * 100).to(dev)
        return torch.randint(-2 ** 20, 2 ** 20, shape, generator=gen,
                             dtype=dtype).to(dev)

    def epochs(arena):
        """Each loopback rank's device epoch (csrc kEpochOffset)."""
        torch.cuda.synchronize()
        return arena.arena.view(arena.world, -1)[:, 128:132].contiguous(
        ).view(torch.int32).view(-1).tolist()

    by_shape, per_call = {}, set()
    n0 = peer.launch_count
    for W in PEER_WORLDS:
        arena = peer.Loopback(W, dev)
        for name, (n, dtype, op) in dryrun.COLLECTIVE_SIZES.items():
            base = epochs(arena)
            x = inputs((W, n), dtype)
            got = peer.loopback_reduce(x, op, arena)
            want = peer.plain_fold(x.unbind(0), op)[None].expand_as(x)
            same = torch.equal(got, want)
            xs = inputs((PEER_GRAPH_CALLS, W, n), dtype)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                outs = [peer.loopback_reduce(xs[k], op, arena)
                        for k in range(PEER_GRAPH_CALLS)]
            for _ in range(PEER_REPLAYS):
                xs.copy_(inputs(tuple(xs.shape), dtype))
                graph.replay()
                same = same and all(torch.equal(
                    outs[k], peer.plain_fold(xs[k].unbind(0), op)[None]
                    .expand_as(outs[k])) for k in range(PEER_GRAPH_CALLS))
            del graph, outs
            made = [e + 1 + PEER_GRAPH_CALLS * PEER_REPLAYS for e in base]
            after = epochs(arena)
            _require(same, f"peer_reduce W={W} {name}: the loopback launch "
                           f"differs from the plain version")
            _require(after == made and len(set(after)) == 1,
                     f"peer_reduce W={W} {name}: device epochs {after}, "
                     f"expected {made}")
            ms = timing.events_ms(lambda: peer.loopback_reduce(x, op, arena),
                                  PEER_REPS)
            replayed = timing.graph_ms(
                lambda: peer.loopback_reduce(x, op, arena), 20,
                PEER_GRAPH_CALLS)
            kernels = timing.device_kernels(
                lambda: peer.loopback_reduce(x, op, arena))
            per_call.add(len(kernels))
            plain = timing.events_ms(
                lambda: peer.plain_fold(x.unbind(0), op), PEER_REPS)
            library = timing.events_ms(
                (lambda: x.sum(0)) if op == "sum" else (lambda: x.amax(0)),
                PEER_REPS)
            nbytes = 2 * x.numel() * x.element_size()
            bound = _bound(nbytes, (W - 1) * n)
            by_shape[f"W={W} {name}"] = {
                "elements": n, "dtype": str(dtype).split(".")[-1], "op": op,
                "ms": ms, "replayed_ms": replayed, "plain_ms": plain,
                "library_ms": library, "bound_ms": bound[0],
                "bound_by": bound[1], "kernels_per_call": len(kernels),
                "nvlink_bound_ms": W * n * x.element_size() / 450e9 * 1e3}
            print(f"peer_reduce loopback W={W} {name} ({n} {dtype} {op}): "
                  f"bitwise plain eager and over {PEER_REPLAYS} replays of "
                  f"{PEER_GRAPH_CALLS} calls: {same}; {ms * 1e3:.2f} us a "
                  f"call, {replayed * 1e3:.2f} replayed, plain "
                  f"{plain * 1e3:.2f}, {op} over ranks {library * 1e3:.2f}, "
                  f"bound {bound[0] * 1e3:.4f} us ({bound[1]}); {kernels} "
                  f"on {smi}")
        del arena
    over = peer.Loopback(2, dev)
    try:
        peer.loopback_reduce(torch.zeros(2, peer.SLOT_BYTES // 4 + 1,
                                         device=dev), "sum", over)
        raised = False
    except ValueError:
        raised = True
    _require(raised, "peer_reduce: a buffer over the slot capacity did not "
                     "raise")
    _require(per_call == {1}, f"peer_reduce: {per_call} kernels a call")
    main = by_shape[f"W={PEER_SHAPE[0]} {PEER_SHAPE[1]}"]
    print(f"peer phase: {time.perf_counter() - t0:.1f} s")
    return {"name": "peer_reduce", "route": "cuda",
            "source": "bpvo_tpu_torch/csrc/peer_reduce.cu",
            "replaces": "bpvo_tpu/parallel/sharded.py:108 (psum in "
                        "shard_map; also :91, :94, sharded_vo.py:127, "
                        "bundle_adjustment.py:139-335; XLA's collective, "
                        "no pallas_call)",
            "max_abs_err": 0.0, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "shape": f"loopback W={PEER_SHAPE[0]} {PEER_SHAPE[1]}",
            "loopback_launches": peer.launch_count - n0,
            "kernels_per_call": max(per_call),
            **{f"{k}_by_shape": {s: v[k] for s, v in by_shape.items()}
               for k in ("ms", "replayed_ms", "plain_ms", "library_ms",
                         "bound_ms", "nvlink_bound_ms")}}


TOOLS_DIR = os.path.join(HERE, "build", "tools_phase")
CONF_INTENSITY = os.path.join(HERE, "conf", "perf_intensity.cfg")
CONF_BITPLANES = os.path.join(HERE, "conf", "perf_bitplanes.cfg")
TOOLS_BP_FRAMES = 10           # the Bit-Planes C API handle's frames
TOOLS_WARM_STEPS = 4           # DeviceVO steps before the traced ones
TOOLS_TRACE_STEPS = 5
TOOLS_STEP_LABEL = "tools_vo_step_"
EXAMPLE_FRAMES = 10


def _capi_run(lib, frames, config, cam):
    """``frames`` through one C API handle (``bpvo_vo_create``: the CUDA
    device) on ``config`` with the camera ``cam`` = (K, baseline): (float32
    poses, keyframe flags, ms per add_frame, trajectory size)."""
    import ctypes

    import numpy as np
    import torch
    f32p = ctypes.POINTER(ctypes.c_float)
    K9 = np.ascontiguousarray(cam[0], np.float32).reshape(-1)
    rows, cols = frames[0][0].shape
    h = lib.bpvo_vo_create(K9.ctypes.data_as(f32p), cam[1], rows, cols,
                           config.encode())
    _require(h, f"C API create: {lib.bpvo_vo_last_error()}")
    poses, kfs, ms = [], [], []
    try:
        for image, disp in frames:
            image = np.ascontiguousarray(image, np.float32)
            disp = np.ascontiguousarray(disp, np.float32)
            pose = np.zeros(16, np.float32)
            kf = ctypes.c_int(-1)
            t0 = time.perf_counter()
            rc = lib.bpvo_vo_add_frame(
                h, image.ctypes.data_as(f32p), disp.ctypes.data_as(f32p),
                pose.ctypes.data_as(f32p), ctypes.byref(kf))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            _require(rc == 0, f"C API add_frame: {lib.bpvo_vo_last_error()}")
            poses.append(pose.reshape(4, 4))
            kfs.append(kf.value)
        n = lib.bpvo_vo_trajectory_size(h)
    finally:
        lib.bpvo_vo_destroy(h)
    return np.stack(poses), kfs, ms, n


def _trace_read(log_dir, labels):
    """The newest Chrome trace under ``log_dir``: (kernel events, their
    names, the annotate ranges named in ``labels`` found, the share of the
    annotated window in which some kernel ran)."""
    import glob
    path = max(glob.glob(os.path.join(log_dir, "*.json")),
               key=os.path.getmtime)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    spans = [e for e in events if e.get("name") in labels
             and e.get("ph") == "X"]
    found = sorted({e["name"] for e in spans})
    busy = math.nan
    if spans and kernels:
        lo = min(e["ts"] for e in spans)
        hi = max(e["ts"] + e["dur"] for e in spans)
        covered, end = 0.0, lo
        for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels):
            a, b = max(a, end), min(b, hi)
            if b > a:
                covered += b - a
                end = b
        busy = covered / (hi - lo)
    return kernels, [e["name"] for e in kernels], found, busy


def trace_steps(frames, K, baseline, dev, smi, name, n_steps, untraced):
    """A ``profiling.trace`` of ``n_steps`` ``DeviceVO`` steps (bench
    intensity settings, after TOOLS_WARM_STEPS warm steps that capture the
    graphs), each an ``annotate`` region: every region must be in the
    trace, and a kernel event named level_gn for every level_gn launch the
    wrappers counted.  With ``untraced`` the same steps run untraced
    first, for the poses (equal) and the ms a step.  Returns the
    ``trace`` JSON object."""
    import numpy as np
    import torch
    from bpvo_tpu_torch import AlgorithmParameters
    from bpvo_tpu_torch.utils import profiling
    from bpvo_tpu_torch.vo.device_vo import DeviceVO

    params = AlgorithmParameters(**BENCH)
    shape = frames[0][0].shape
    images = [torch.as_tensor(f[0]).to(dev) for f in frames]
    disps = [torch.as_tensor(f[1]).to(dev) for f in frames]
    steps = range(1 + TOOLS_WARM_STEPS, 1 + TOOLS_WARM_STEPS + n_steps)
    labels = [f"{TOOLS_STEP_LABEL}{i}" for i in steps]
    log_dir = os.path.join(TOOLS_DIR, "trace")
    shutil.rmtree(log_dir, ignore_errors=True)
    runs = {}
    for traced in (False, True) if untraced else (True,):
        dvo = DeviceVO(K, baseline, shape, params, device=dev)
        for i in range(steps[0]):               # init, graphs captured
            dvo.add_frame(images[i], disps[i])
        torch.cuda.synchronize()
        _reset_counts()
        ctx = (profiling.trace(log_dir, device=dev) if traced
               else contextlib.nullcontext())
        outs_t, step_ms = [], []
        t_session = time.perf_counter()
        with ctx:
            for i, label in zip(steps, labels):
                t = time.perf_counter()
                with profiling.annotate(label):
                    outs_t.append(dvo.add_frame(images[i], disps[i]))
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t) * 1e3)
        runs[traced] = (float(np.mean(step_ms)),
                        torch.stack([o.pose for o in outs_t]),
                        _counts()["level_gn"],
                        (time.perf_counter() - t_session) * 1e3,
                        [bool(o.is_keyframe) for o in outs_t])
        del dvo
    kernels, names, found, busy = _trace_read(log_dir, labels)
    n_lg = sum("level_gn" in k for k in names)
    by_name = {}
    for k in names:
        by_name[k] = by_name.get(k, 0) + 1
    res = {"steps": n_steps, "kernel_events": len(kernels),
           "level_gn_events": n_lg, "level_gn_launches": runs[True][2],
           "annotations_found": found, "device_busy_share": busy,
           "keyframes": runs[True][4],
           "ms_per_step_traced": runs[True][0],
           "session_ms_with_export": runs[True][3],
           "top_kernels": sorted(by_name.items(), key=lambda kv: -kv[1])[:8]}
    if untraced:
        res["ms_per_step_untraced"] = runs[False][0]
        res["poses_equal_untraced"] = bool(torch.equal(runs[True][1],
                                                       runs[False][1]))
    print(f"{name}: profiling.trace of {n_steps} DeviceVO steps (bench "
          f"intensity, after {TOOLS_WARM_STEPS} warm steps): "
          f"{len(kernels)} kernel events, {n_lg} named level_gn "
          f"({runs[True][2]} level_gn launches counted), annotations "
          f"{found}, device busy {busy:.4f} of the annotated window; "
          f"{runs[True][0]:.3f} ms a step traced"
          + (f" vs {res['ms_per_step_untraced']:.3f} untraced" if untraced
             else "")
          + f", the session with its export {runs[True][3]:.1f} ms, on "
          f"{smi}; keyframes {runs[True][4]}; top kernels "
          f"{res['top_kernels']}")
    _require(n_lg > 0 and n_lg == runs[True][2],
             f"{name} trace: {n_lg} kernel events named level_gn for "
             f"{runs[True][2]} launches")
    _require(found == sorted(labels), f"{name} trace: annotations {found}")
    _require(any(runs[True][4]), f"{name} trace: no keyframe among the "
                                 f"traced steps, so no IF body ran")
    _require(not untraced or res["poses_equal_untraced"],
             f"{name} trace: the traced steps' poses differ from the "
             f"untraced ones")
    return res


def tools_phase(frames, stereo_pair, K, baseline, dev, smi):
    """Phase 1a (see the module docstring): the C API, the standalone C
    host, the example, a profiling trace and the viewer on the card.
    Returns (the ``tools_phase`` JSON object, {path: launch counts})."""
    import numpy as np
    import torch
    from bpvo_tpu_torch import AlgorithmParameters, ConfigFile
    from bpvo_tpu_torch import VisualOdometry
    from bpvo_tpu_torch.capi import build as capi_build
    from bpvo_tpu_torch.data import imageio, stereo, synthetic
    from bpvo_tpu_torch.utils import viz

    t0 = time.perf_counter()
    out, launches = {}, {}
    os.makedirs(TOOLS_DIR, exist_ok=True)
    shape = frames[0][0].shape
    lib_path, host = capi_build.build()
    lib = capi_build.load(lib_path)
    cam = (K, float(np.float32(baseline)))

    # 1. the C API in this process, on the card: conf/perf_intensity.cfg
    # over the frames, bit for bit VisualOdometry on the same frames
    _reset_counts()
    poses, kfs, capi_ms, n = _capi_run(lib, frames, CONF_INTENSITY, cam)
    launches["capi"] = _counts()
    params = AlgorithmParameters.from_config(ConfigFile(CONF_INTENSITY))
    vo = VisualOdometry(K, cam[1], shape, params, device=dev)
    want, want_kf, vo_ms = [], [], []
    for image, disp in frames:
        t = time.perf_counter()
        r = vo.add_frame(image, disp)
        torch.cuda.synchronize()
        vo_ms.append((time.perf_counter() - t) * 1e3)
        want.append(np.asarray(r.pose, np.float32))
        want_kf.append(int(r.is_keyframe))
    del vo
    step = synthetic.step_pose()
    t_err = float(np.abs(poses[1:, :3, 3] - step[:3, 3]).max())
    ref = np.load(REF_NPZ)
    t_bound = float(ref["gt_err"].max()) + GT_MARGIN
    same = bool(np.array_equal(poses, np.stack(want)) and kfs == want_kf)
    out["capi"] = {"frames": len(frames), "config": "conf/perf_intensity.cfg",
                   "bitwise_visual_odometry": same, "trajectory_size": n,
                   "keyframes": int(sum(kfs)),
                   "max_abs_t_vs_step": t_err, "t_bound": t_bound,
                   "add_frame_ms": _pcts(capi_ms),
                   "visual_odometry_ms": _pcts(vo_ms),
                   "launches": launches["capi"]}
    print(f"tools: C API (in process, cuda, conf/perf_intensity.cfg, "
          f"{len(frames)} frames at {shape[0]}x{shape[1]}): bitwise "
          f"VisualOdometry {same}, trajectory {n}, {sum(kfs)} keyframes, "
          f"max |t - known step| {t_err:.3e} (bound {t_bound:.3e}); "
          f"add_frame p50 {out['capi']['add_frame_ms']['p50_ms']:.3f} ms "
          f"p90 {out['capi']['add_frame_ms']['p90_ms']:.3f} vs "
          f"VisualOdometry p50 "
          f"{out['capi']['visual_odometry_ms']['p50_ms']:.3f} p90 "
          f"{out['capi']['visual_odometry_ms']['p90_ms']:.3f} on {smi}; "
          f"launches {launches['capi']}")
    _require(same, "C API: poses or keyframes differ from VisualOdometry")
    _require(n == len(frames), f"C API: trajectory of {n}")
    _require(t_err <= t_bound, f"C API: {t_err} from the known step")
    _require(launches["capi"]["level_gn"] > 0, "C API: no level_gn launch")

    # a Bit-Planes handle (conf/perf_bitplanes.cfg, the given disparity)
    _reset_counts()
    bp, bp_kfs, bp_ms, n_bp = _capi_run(lib, frames[:TOOLS_BP_FRAMES],
                                        CONF_BITPLANES, cam)
    launches["capi_bitplanes"] = _counts()
    out["capi_bitplanes"] = {"frames": TOOLS_BP_FRAMES,
                             "add_frame_ms": _pcts(bp_ms),
                             "max_abs_t_vs_step": float(np.abs(
                                 bp[1:, :3, 3] - step[:3, 3]).max()),
                             "launches": launches["capi_bitplanes"]}
    print(f"tools: C API Bit-Planes (conf/perf_bitplanes.cfg, "
          f"{TOOLS_BP_FRAMES} frames): max |t - known step| "
          f"{out['capi_bitplanes']['max_abs_t_vs_step']:.3e}, add_frame p50 "
          f"{out['capi_bitplanes']['add_frame_ms']['p50_ms']:.3f} ms on "
          f"{smi}; launches {launches['capi_bitplanes']}")
    _require(n_bp == TOOLS_BP_FRAMES and bool(np.isfinite(bp).all()),
             f"C API Bit-Planes: trajectory {n_bp}")
    _require(launches["capi_bitplanes"]["census_planes"] > 0
             and launches["capi_bitplanes"]["level_gn"] > 0,
             f"C API Bit-Planes: launches {launches['capi_bitplanes']}")
    _lap(t0, "tools: C API")

    # 2. the standalone C host, its own interpreter, on the card
    t = time.perf_counter()
    p = subprocess.run([str(host)], capture_output=True, text=True,
                       env=capi_build.host_env(), timeout=300)
    out["c_host"] = {"rc": p.returncode,
                     "s": time.perf_counter() - t}
    print(f"tools: standalone C host (cuda): rc {p.returncode}, "
          f"{out['c_host']['s']:.1f} s\n{p.stdout.strip()}")
    _require(p.returncode == 0 and "C-API example (cuda): OK" in p.stdout,
             f"standalone C host: {p.stdout}{p.stderr[-3000:]}")

    # 3. the example as a script on the card, add_frame timed by a wrapper
    example = os.path.join(HERE, "examples", "synthetic_vo_torch.py")
    code = ("import json, runpy, sys, time\n"
            "from bpvo_tpu_torch.vo.odometry import VisualOdometry as V\n"
            "add, ms = V.add_frame, []\n"
            "def timed(self, *a):\n"
            "    t = time.perf_counter()\n"
            "    r = add(self, *a)\n"
            "    ms.append((time.perf_counter() - t) * 1e3)\n"
            "    return r\n"
            "V.add_frame = timed\n"
            f"sys.argv = [{example!r}, '{EXAMPLE_FRAMES}']\n"
            f"runpy.run_path({example!r}, run_name='__main__')\n"
            "print(json.dumps(ms), file=sys.stderr)\n")
    t = time.perf_counter()
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=dict(os.environ, PYTHONPATH=HERE),
                       timeout=300, cwd=HERE)
    _require(p.returncode == 0 and "final position error" in p.stdout,
             f"example: {p.stdout}{p.stderr[-3000:]}")
    ex_ms = json.loads(p.stderr.strip().splitlines()[-1])
    out["example"] = {"frames": EXAMPLE_FRAMES, "s": time.perf_counter() - t,
                      "add_frame_ms": ex_ms, **_pcts(ex_ms)}
    print(f"tools: examples/synthetic_vo_torch.py {EXAMPLE_FRAMES} (cuda, "
          f"240x320): {out['example']['s']:.1f} s in all; add_frame ms "
          f"{[round(m, 2) for m in ex_ms]} (p50 after the first "
          f"{out['example']['p50_ms']:.3f}) on {smi}\n"
          f"{p.stdout.strip().splitlines()[-1]}")
    _lap(t0, "tools: C host and example")

    # 4. a profiling trace of DeviceVO steps, before any CPU-only profiler
    # session in this process; the same steps untraced for the overhead
    out["trace"] = trace_steps(frames, K, baseline, dev, smi, "tools",
                               TOOLS_TRACE_STEPS, untraced=True)

    # 5. the viewer: a TpuSGM disparity dumped headless, read back
    matcher = stereo.create_stereo_algorithm(ConfigFile(CONF))
    left, right = stereo_pair
    disp = matcher.run(left, right, device=dev)
    dump = os.path.join(TOOLS_DIR, "viewer")
    viewer = viz.Viewer(dump_dir=dump, dump_every=1)
    saved_display = os.environ.pop("DISPLAY", None)
    try:
        _require(viewer.show(left, disp, hz=12.5, is_keyframe=True),
                 "viewer: quit")
    finally:
        if saved_display is not None:
            os.environ["DISPLAY"] = saved_display
    back = imageio.imread(os.path.join(dump, "frame_00000.png"))
    expect = viz.overlay_disparity(left, disp)
    viz.draw_hud(expect, f"#0  {12.5:5.1f} Hz  KF")
    valid = float((disp > 0).mean())
    out["viewer"] = {"shape": list(back.shape), "equal_render": bool(
        np.array_equal(back, expect)), "valid_disparity_share": valid}
    print(f"tools: viewer dump of a TpuSGM disparity ({shape[0]}x{shape[1]},"
          f" {valid:.4f} valid): read back {back.shape} {back.dtype}, equal "
          f"to the render {out['viewer']['equal_render']}")
    _require(out["viewer"]["equal_render"], "viewer: the PNG differs")
    out["seconds"] = time.perf_counter() - t0
    _lap(t0, "tools phase")
    return out, launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    if sys.argv[1:2] == ["--trace-chunk"]:
        return trace_chunk_main(sys.argv[2])
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

    # the tools: the C API, the C host, the example, a profiling trace (the
    # first profiler session of this process) and the viewer
    tools_json, tools_counts = tools_phase(frames[:N_STEPS], sframes[0][:2],
                                           K, baseline, dev, smi)
    print(json.dumps({"tools_phase": tools_json}))
    _lap(t_start, "tools phase")

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
    err_s, ms_s, plain_s, bound_s, sgm_extra, cost_entry = sgm_phase(
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
            + 2 * calls, "census_cost": calls, "sgm_aggregate": calls,
            "sgm_winner": calls}
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
                                          device=dev),
            [f[0::2] for f in sframes], dev, smi, chunked=True),
        "stereo_bitplanes": graph_phase(
            "stereo Bit-Planes", lambda: DeviceVO(
                K, baseline, shape, params_bp, device=dev,
                stereo_fn=matcher.as_fn()), [f[:2] for f in sframes], dev,
            smi, chunked=True)}
    for path in graph_res:      # see trace_chunk
        graph_res[path]["chunks"].update(trace_chunk_subprocess(path))
    # the profiler after the DeviceVO paths' CPU-only sessions, where device
    # records once went missing; before the VisualOdometry cells, whose
    # dense estimates replay WHILE nodes (see the WHILE paths below)
    print(json.dumps({"trace_after_graph_phase": trace_steps(
        dframes, K, baseline, dev, smi, "after the graph phase", 2,
        untraced=False)}))
    # VisualOdometry's three graphs (frame, templates, estimate): bench.py's
    # intensity settings, conf/perf_bitplanes.cfg with the disparity given,
    # and the intensity settings with the multi-start, over 1+N_STEPS
    # frames; then the dense paths over 1+GRAPH_STEPS
    params_pbp = AlgorithmParameters.from_config(ConfigFile(CONF_BITPLANES))
    for name, p in (("intensity", params), ("bitplanes", params_pbp),
                    ("multistart", params.replace(
                        coarseInitOffsetPx=VO_MULTISTART_PX))):
        graph_res[f"vo_{name}"] = graph_phase(
            f"VisualOdometry {name}", lambda p=p: VisualOdometry(
                K, baseline, shape, p, device=dev),
            [f[0::2] for f in sframes], dev, smi)
    for name, desc in (("intensity", DescriptorType.INTENSITY),
                       ("bitplanes", DescriptorType.BITPLANES)):
        graph_res[f"dense_{name}"] = graph_phase(
            f"dense {name}", lambda desc=desc: VisualOdometry(
                K, baseline, shape, _dense_params(desc), device=dev),
            dframes, dev, smi)
    print(json.dumps({"graph_phase": graph_res}))
    _lap(t_start, "graph phase")
    # the WHILE paths: each eager, graphed and chunked here, held to JAX's
    # DeviceVO, its first chunk traced in a fresh process; after the trace
    # above: once this process has run CPU-only profiler sessions over a
    # DeviceVO's WHILE-node replays, torch.profiler reports IF bodies'
    # kernels with no correlation and drops some level_gn events (scripts/
    # profiler_records.py, the if_body_* cases; the cause is not known)
    ref_w = dict(np.load(REF_WHILE_NPZ))
    while_res = {}
    for path, (label, make_vo, n, atol) in while_paths(
            K, baseline, shape, dev).items():
        while_res[path] = graph_phase(
            label, make_vo, dframes[:1 + n], dev, smi, chunked=True,
            jax_ref=(ref_w, path.removeprefix("device_vo_"), atol))
        while_res[path]["chunks"].update(trace_chunk_subprocess(path))
    print(json.dumps({"graph_phase_while_paths": while_res}))
    # path (c): a level solve alone, through GraphCache.jit
    print(json.dumps({"level_solve_phase": level_solve_phase(
        K, baseline, dframes[:2], dev, smi)}))
    graph_res.update(while_res)
    _lap(t_start, "graph phase's WHILE paths")

    probe_entries = probe_phase(dev, smi)
    peer_entry = peer_phase(dev, smi)

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

    # peer_reduce's main path is the layer across cards (the dry run above,
    # rank 0's count over its paths); on one card that run is not made and
    # the count is the world-1 paths' (0: world-1 nccl keeps NCCL's route)
    multi = dist_json["peer_launches"]
    peer_entry["launches"] = (dist_json["peer_launches_world1"]
                              if multi is None else multi)
    peer_entry["launches_by_path"] = {
        "world1_nccl": dist_json["peer_launches_world1"],
        "dryrun_nccl_cards": multi,
        **({} if dist_json["dryrun_nccl_cards"] is None else {
            f"dryrun_nccl_cards {name}": v[0] for name, v in dist_json[
                "dryrun_nccl_cards"]["peer_launches_by_path"].items()})}
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")

    def by_path(kernel):
        return {"intensity": counts_i[kernel],
                "stereo_bitplanes": counts_s[kernel],
                **{f"{path}_chunks": graph_res[path]["chunks"]["launches"][
                    kernel] for path in ("intensity", "stereo_bitplanes",
                                         "device_vo_dense_intensity",
                                         "device_vo_dense_bitplanes",
                                         "device_vo_lm_bitplanes")},
                "dense_intensity": dense["intensity"][kernel],
                "dense_bitplanes": dense["bitplanes"][kernel],
                **{path: c[kernel] for path, c in zoo_counts.items()},
                **{path: c[kernel] for path, c in tools_counts.items()},
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
         "launches": sum(by_path("sgm_aggregate").values()),
         "launches_by_path": by_path("sgm_aggregate"), "max_abs_err": err_s,
         "ms": ms_s, "plain_ms": plain_s, "bound_ms": bound_s[0],
         "bound_by": bound_s[1], "library_ms": None,
         "winner_launches_by_path": {"intensity": counts_i["sgm_winner"],
                                     "stereo_bitplanes":
                                         counts_s["sgm_winner"]},
         **sgm_extra},
        {"name": "census_cost", "route": "cuda",
         "source": "bpvo_tpu_torch/csrc/census_cost.cu",
         "replaces": "none: XLA fuses bpvo_tpu/data/stereo.py:212-218",
         "launches": sum(by_path("census_cost").values()),
         "launches_by_path": by_path("census_cost"), "library_ms": None,
         **cost_entry},
        gn_entry("fused_linearize", "bpvo_tpu_torch/csrc/fused_linearize.cu",
                 "bpvo_tpu/ops/pallas/gn_kernel.py:181 and :433",
                 "intensity L0 C=1"),
        gn_entry("irls_reduce", "bpvo_tpu_torch/csrc/irls_reduce.cu",
                 "bpvo_tpu/ops/pallas/irls_kernel.py:119 and :163",
                 "intensity L0 M=1K"),
        gn_entry("gn_step", "bpvo_tpu_torch/csrc/gn_step.cu",
                 "none: plain torch in JAX's lax.while_loop body "
                 "(bpvo_tpu/solver/gauss_newton.py:457-487)",
                 "intensity L0 C=1")] + probe_entries + [peer_entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
