"""The graphed routes' plumbing on the CPU, where no CUDA graph can run:
``utils/graphs.GraphCache``'s launch-count bookkeeping with a fake op
module, and the buffers, copies and alternating graphs of a level solve
through ``GraphCache.jit``, ``DeviceVO``'s step and ``VisualOdometry``'s
estimate graph driven through ``ReplayStandIn``, a cache whose "replay" runs the captured
function again and copies its results into the same output tensors (the
static outputs a CUDA graph overwrites on every replay).  Each route is held
bit for bit to the eager code as it was before the step and the loop were
factored (``_parent_run``, ``_parent_make_vo_step``, verbatim copies), and
``DeviceVO.point_cloud`` to JAX's on the same carried state.  The graphs
themselves run in tests/test_torch_graphs_gpu.py on the card."""
import types

import numpy as np
import pytest
import torch

from bpvo_tpu import AlgorithmParameters as JParams
from bpvo_tpu.vo.device_vo import DeviceVO as JDeviceVO
from bpvo_tpu_torch import AlgorithmParameters, DescriptorType, VisualOdometry
from bpvo_tpu_torch.data import synthetic
from bpvo_tpu_torch.ops import gn_step
from bpvo_tpu_torch.solver import gauss_newton as gn
from bpvo_tpu_torch.solver import linear_system
from bpvo_tpu_torch.types import InterpolationType, LossFunctionType
from bpvo_tpu_torch.utils import graphs
from bpvo_tpu_torch.utils.convert import (camera_from_numpy,
                                          state_from_numpy,
                                          template_from_numpy)
from bpvo_tpu_torch.vo import device_vo as dv
from bpvo_tpu_torch.vo import pose_estimator as pe
from bpvo_tpu_torch.vo import warp as warp_mod
from test_gn import H_IMG, W_IMG, make_cam
from test_odometry import make_sequence
from test_torch_device_vo import KW, STEP, _jax_state_to_numpy
from test_torch_gauss_newton import _gn_problem, _np_template

N_FRAMES = 11                  # the initial frame and 10 steps


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Whole-frame runs of small ops: one torch thread keeps the suite's
    workers from waiting on each other's spinning thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for item in x for t in _leaves(item)]


class ReplayStandIn(graphs.RerunCache):
    """``GraphCache`` on the CPU: the warm-up runs the function, the
    "capture" records it without running it (as a capture runs no
    kernel), a replay reruns it into static outputs with the launch counts
    held (``graphs.RerunCache`` with ``hold_counts``)."""
    hold_counts = True


def jit_solve(cache, solve, tdata, channels, cam, T_init, opts, **static):
    """A level solve (``gauss_newton.run`` or ``levenberg_marquardt.run``)
    through ``cache.jit``: a graph per solver, options, camera, static
    arguments and shapes, the template copied in only when another
    template object arrives, the channels and the start on every call."""
    return cache.jit((solve, opts, cam, *sorted(static.items())),
                     (tdata, channels, T_init),
                     lambda b: solve(b[0], b[1], cam, b[2], opts, **static),
                     held=(0,))


# ---------------------------------------------------------------------------
# GraphCache's launch-count bookkeeping
# ---------------------------------------------------------------------------

class _CaptureRunsPython(graphs.GraphCache):
    """A capture runs the function's Python (so the wrappers count) and
    its replay returns the captured outputs without entering Python, as a
    CUDA graph does."""

    def _warm_up(self, fn):
        return fn()

    def _capture(self, fn):
        out = fn()
        return types.SimpleNamespace(replay=lambda: out)


def _fake_op_module():
    mod = types.SimpleNamespace(launch_count=0)

    def op(x):
        mod.launch_count += 1
        return x + 1
    return mod, op


def test_graph_cache_counts_replays_as_their_launches():
    """The first call counts through the wrappers (the warm-up is the
    call's own run), the capture leaves the counts as they were, and each
    replay adds what the capture counted; other modules stay untouched."""
    mod, op = _fake_op_module()
    idle = types.SimpleNamespace(launch_count=7)
    cache = _CaptureRunsPython("cpu", modules=(mod, idle))
    x = torch.zeros(3)

    def fn():
        return op(op(x))

    replays = graphs.replay_count
    assert torch.equal(cache("a", fn), x + 2) and mod.launch_count == 2
    for n in range(3):
        assert torch.equal(cache("a", fn), x + 2)
        assert mod.launch_count == 2 + 2 * (n + 1)
    assert graphs.replay_count == replays + 3 and idle.launch_count == 7
    # another key is another graph, counted on its own
    cache("b", lambda: op(x))
    cache("b", lambda: op(x))
    assert mod.launch_count == 8 + 2 and len(cache) == 2 and "b" in cache


def test_graph_cache_keeps_launches_counted_by_other_threads():
    """A loader thread counts launches (under ``ops._build.count_lock``, as
    the wrappers do) while this thread captures: none of its counts is
    taken for the graph's or lost when the capture puts the counts back.
    The capture is slowed and the switch interval shortened so the threads
    interleave."""
    import sys
    import threading
    import time

    from bpvo_tpu_torch.ops import _build

    mod, op = _fake_op_module()

    class Slow(_CaptureRunsPython):
        def _capture(self, fn):
            time.sleep(0.05)
            return super()._capture(fn)

    cache = Slow("cpu", modules=(mod,))
    stop = threading.Event()
    other = [0]

    def loader():
        while not stop.is_set():
            with _build.count_lock:
                mod.launch_count += 1
            other[0] += 1

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    thread = threading.Thread(target=loader)
    try:
        thread.start()
        for k in range(20):
            for _ in range(3):      # warm-up and capture, then 2 replays
                cache(k, lambda: op(op(torch.zeros(1))))
    finally:
        stop.set()
        thread.join(timeout=10)
        sys.setswitchinterval(interval)
    assert not thread.is_alive()
    assert other[0] > 0
    # per key: 2 counted by the warm-up, 2 added by each replay
    assert mod.launch_count == 20 * 6 + other[0]


def test_graph_cache_failed_capture_raises_and_keeps_counts():
    """A capture that fails raises; the counts are put back and the key
    holds no graph, so the next call tries to capture again."""
    mod, op = _fake_op_module()

    class Failing(_CaptureRunsPython):
        def _capture(self, fn):
            fn()
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")

    cache = Failing("cpu", modules=(mod,))
    with pytest.raises(RuntimeError, match="capturing"):
        cache("k", lambda: op(torch.zeros(1)))
    assert mod.launch_count == 1 and "k" not in cache
    with pytest.raises(RuntimeError):
        cache("k", lambda: op(torch.zeros(1)))
    assert mod.launch_count == 2


# ---------------------------------------------------------------------------
# gauss_newton.run: the factored loop and its iteration graphs
# ---------------------------------------------------------------------------

def _parent_run(tdata, channels, cam, T_init, opts, linearize_fn=None):
    """``gauss_newton.run`` as it was before its loop body was factored
    out (``_iteration``): the reference the factored loop is held to."""
    f32 = torch.float32
    dev = channels.device
    C, K = tdata.pixels.shape
    s, c = tdata.norm_scale, tdata.norm_center
    if linearize_fn is None:
        if opts.warp == "RigidBody" and opts.interp in (
                InterpolationType.LINEAR, InterpolationType.COSINE):
            linearize_fn = gn._fused_linearize_fn(tdata, channels.contiguous(),
                                               cam, opts)
        else:
            def linearize_fn(T, scale, delta_scale, do_est):
                return gn._linearize(tdata, channels, cam, T, scale, delta_scale,
                                  do_est, opts)

    def scalar(x, dtype=f32):   # filled on the device: no host copy
        return torch.full((), x, dtype=dtype, device=dev)

    T = T_init.to(device=dev, dtype=f32)
    T_best = T
    dp = torch.zeros(6, dtype=f32, device=dev)
    f_norm, dp_norm_prev, g_tol = scalar(0.0), scalar(0.0), scalar(0.0)
    f_best = scalar(float("inf"))
    scale, delta_scale = scalar(1.0), scalar(1e10)
    g = torch.zeros(6, dtype=f32, device=dev)
    w = torch.zeros(C, K, dtype=f32, device=dev)
    H = torch.eye(6, dtype=f32, device=dev)
    status = scalar(gn.STATUS_MAX_ITERATIONS, torch.int32)
    conv, ok = scalar(False, torch.bool), scalar(True, torch.bool)
    it, converged, solver_ok = 0, False, True
    do_est = 1e10 > max(opts.scale_tolerance, opts.scale_tolerance_rel)
    while not converged and solver_ok and it < opts.max_iterations:
        H, g, f_new, sigma, delta_scale, w = linearize_fn(T, scale,
                                                          delta_scale, do_est)
        g_norm = torch.max(torch.abs(g))
        dp_norm = torch.linalg.norm(dp)
        if it == 0:
            # first-order-optimality threshold fixed from the first gradient
            # (pose_estimator_base.h:341-343); only that test applies now
            g_tol = opts.gradient_tolerance * torch.clamp(
                g_norm, min=gn_step.SQRT_EPS)
            conv = g_norm < g_tol
            status = torch.where(conv, gn.STATUS_GRADIENT_TOL,
                                 gn.STATUS_MAX_ITERATIONS).to(torch.int32)
        else:
            conv, status = gn_step.convergence(dp_norm, dp_norm_prev, g_norm,
                                               f_new, f_norm, g_tol, opts)
        dp_new, ok = linear_system.solve(H, g)
        do_update = ~conv & ok
        better = f_new < f_best
        T_best = torch.where(better, T, T_best)
        f_best = torch.where(better, f_new, f_best)
        T = torch.where(do_update, T @ warp_mod.params_to_pose(-dp_new, s, c),
                        T)
        dp = torch.where(do_update, dp_new, dp)
        status = torch.where(ok, status, gn.STATUS_SOLVER_ERROR).to(torch.int32)
        f_norm, dp_norm_prev, scale = f_new, dp_norm, sigma
        # the loop's one read of the device per iteration
        flags = torch.stack([conv, ok, gn_step.sigma_unstable(
            delta_scale, scale, opts)]).tolist()
        converged, solver_ok, do_est = flags
        if opts.verbose:
            f_, g_, dp_, s_ = torch.stack([
                f_new, g_norm, torch.linalg.norm(dp_new), sigma]).tolist()
            print(f"  it {it}  |F|={f_:.6g}  |G|={g_:.4g}  |dp|={dp_:.4g}  "
                  f"sigma={s_:.4g}")
        it += 1
    if not converged:
        T = torch.where(f_best < f_norm, T_best, T)
    return gn.GNState(T=T, f_norm=f_norm, g=g, scale=scale, weights=w, H=H,
                   num_iters=scalar(it, torch.int32), status=status,
                   converged=conv, solver_ok=ok,
                   band_overflow=scalar(0, torch.int32))


def _assert_states_equal(a, b):
    for name, x, y in zip(gn.GNState._fields, a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), name


@pytest.mark.parametrize("C,loss", [(1, LossFunctionType.TUKEY),
                                    (1, LossFunctionType.HUBER),
                                    (3, LossFunctionType.TUKEY)])
def test_run_factored_loop_bitwise(C, loss):
    """``gauss_newton.run`` (its loop body ``_iteration``, iteration 0 on
    its own and the rest through ``graphs.while_loop``'s host loop) and
    the solve through ``GraphCache.jit`` on the stand-in give the GNState
    of the unfactored loop bit for bit, from two starts, over two
    templates (the second run on the same graph copies the template in)."""
    td, ch, cam, _ = _gn_problem(C)
    ttd = template_from_numpy(_np_template(td), "cpu")
    td2 = ttd._replace(pixels=ttd.pixels * 1.01)
    channels = torch.as_tensor(np.array(ch))
    tcam = camera_from_numpy(cam)
    opts = gn.GNOptions(function_tolerance=1e-4, parameter_tolerance=1e-6,
                        loss=loss)
    cache = ReplayStandIn("cpu")
    starts = [torch.eye(4), warp_mod.params_to_pose(
        torch.tensor([0.001, 0.0, -0.001, 0.002, 0.001, 0.0]),
        ttd.norm_scale, ttd.norm_center)]
    runs = 0
    for tdata in (ttd, td2):
        for T0 in starts:
            want = _parent_run(tdata, channels, tcam, T0, opts)
            _assert_states_equal(gn.run(tdata, channels, tcam, T0, opts),
                                 want)
            got = jit_solve(cache, gn.run, tdata, channels, tcam, T0, opts)
            _assert_states_equal(got, want)
            assert int(want.num_iters) >= 3
            runs += int(want.num_iters)
    # one graph for the level (its options and camera): every solve of it
    # one replay
    assert len(cache) == 1 and runs > 4


def test_run_graphs_static_routes(monkeypatch):
    """A level solve through ``GraphCache.jit``: with ``max_iterations ==
    0`` its replays equal the eager solve bit for bit (the captured
    function fills the initial state on the device); a verbose level
    takes the eager route (``graphs.route`` gives no cache); the template
    is copied into the key's buffers only when another template object
    arrives, the channels and the start on every call."""
    td, ch, cam, _ = _gn_problem(1)
    ttd = template_from_numpy(_np_template(td), "cpu")
    td2 = ttd._replace(pixels=ttd.pixels * 1.01)
    channels = torch.as_tensor(np.array(ch))
    tcam = camera_from_numpy(cam)
    T0 = warp_mod.params_to_pose(
        torch.tensor([0.001, 0.0, -0.001, 0.002, 0.001, 0.0]),
        ttd.norm_scale, ttd.norm_center)
    zero = gn.GNOptions(max_iterations=0)
    want = gn.run(ttd, channels, tcam, T0, zero)
    assert int(want.num_iters) == 0 and torch.equal(want.T, T0)
    cache = ReplayStandIn("cpu")
    for _ in range(3):          # the warm-up, then replays
        _assert_states_equal(
            jit_solve(cache, gn.run, ttd, channels, tcam, T0, zero), want)
    assert len(cache) == 1

    verbose = gn.GNOptions(verbose=True)
    assert graphs.route(cache, "cpu", None, None, (zero, verbose)) is None
    assert graphs.route(cache, "cpu", None, None, (zero,)) is cache

    copied = []
    copy_into = graphs.copy_into

    def spy(dst, src):
        copied.extend(id(t) for t in _leaves(dst))
        copy_into(dst, src)
    monkeypatch.setattr(graphs, "copy_into", spy)
    cache, opts = ReplayStandIn("cpu"), gn.GNOptions()
    # (template, whether the call copies it in): the first call clones
    for i, (tdata, fresh) in enumerate(((ttd, False), (ttd, False),
                                        (td2, True), (td2, False),
                                        (ttd, True))):
        copied.clear()
        _assert_states_equal(
            jit_solve(cache, gn.run, tdata, channels, tcam, T0, opts),
            gn.run(tdata, channels, tcam, T0, opts))
        (bufs, _), = cache._inputs.values()
        assert any(id(t) in copied for t in _leaves(bufs[0])) == fresh
        assert all(id(t) in copied for t in bufs[1:]) == (i > 0)
    assert len(cache) == 1


# ---------------------------------------------------------------------------
# DeviceVO: the split step and the graphed route
# ---------------------------------------------------------------------------

def _parent_make_vo_step(p, cams, capacities, opts_per_level, stereo_fn=None):
    """``device_vo.make_vo_step`` as it was before the step was split into
    ``_make_front`` and ``_make_commit``."""
    n_levels = p.numPyramidLevels
    cams = tuple(cams)
    capacities = tuple(capacities)

    def step(state, image, aux):
        dev = image.device
        image = image.to(torch.float32)
        channels = dv._compute_channels_pyr(image, p, n_levels)
        # the candidate store: the disparity, or the stereo pair
        store = (aux.to(torch.float32) if stereo_fn is None
                 else torch.stack([image, aux.to(torch.float32)]))
        T_init = (pe._gated_warm_start(state.templates, channels, cams,
                                       state.T_delta @ state.T_kf, state.T_kf,
                                       opts_per_level[n_levels - 1])
                  if p.withMotionModel else state.T_kf)
        T_est, iters, fs, frac, H, w_fine, boverflow = dv._estimate(
            state.templates, channels, cams, T_init, opts_per_level,
            p.maxTestLevel, p.goodPointThreshold, p.minNumPixelsToWork)
        reason = dv._keyframe_reason(T_est, frac, p)
        is_kf = reason != dv.KF_NONE
        pose_kf = T_est @ dv._rigid_inverse(state.T_kf)

        if not bool(is_kf):
            new_state = state._replace(
                prev_channels=channels, prev_disparity=store,
                has_prev=True, T_kf=T_est, T_delta=pose_kf,
                last_weights=w_fine)
            pose, it_out, fs_out = pose_kf, iters, fs
        else:
            # keyframe source: the candidate when one exists, else the
            # current frame
            if state.has_prev:
                src_channels, src_store = state.prev_channels, state.prev_disparity
            else:
                src_channels, src_store = channels, store
            # stereo in the loop: the matcher runs here, on the pair of the
            # frame becoming the keyframe
            src_disp = (src_store if stereo_fn is None
                        else stereo_fn(src_store[0], src_store[1]))
            templates = dv._build_templates(src_channels, src_disp, cams, p,
                                         capacities)
            # re-estimate against the new keyframe.  When the keyframe IS the
            # current frame this converges to ~identity and only its weights
            # are kept.  It solves single-frame motion, so with
            # keyframeReestimateStartLevel >= 0 it skips the coarse levels and
            # warm-starts from the measured candidate->current motion behind
            # the coarse-cost gate (identity fallback).
            eye = dv._eye4(dev)
            if p.keyframeReestimateStartLevel >= 0:
                start2 = min(max(p.keyframeReestimateStartLevel,
                                 p.maxTestLevel), n_levels - 1)
                T2_init = pe._gated_warm_start(templates, channels, cams,
                                               pose_kf, eye,
                                               opts_per_level[start2],
                                               level=start2)
            else:
                start2 = n_levels - 1
                T2_init = (pe._gated_warm_start(templates, channels, cams,
                                                state.T_delta, eye,
                                                opts_per_level[n_levels - 1])
                           if p.withMotionModel else eye)
            T2, it2, fs2, _frac2, _H2, w2_fine, _bo2 = dv._estimate(
                templates, channels, cams, T2_init, opts_per_level,
                p.maxTestLevel, p.goodPointThreshold, p.minNumPixelsToWork,
                start_level=start2)
            if state.has_prev:
                pose, T_kf_new, it_out, fs_out = T2, T2, it2, fs2
            else:
                pose, T_kf_new, it_out, fs_out = pose_kf, eye, iters, fs
            new_state = dv.VOState(
                templates=templates, prev_channels=channels,
                prev_disparity=store, has_prev=False, T_kf=T_kf_new,
                pose_world=state.pose_world, T_delta=pose,
                last_weights=w2_fine)

        pose_world = new_state.pose_world @ dv._rigid_inverse(pose)
        new_state = new_state._replace(pose_world=pose_world)
        out = dv.VOStepOutput(pose=pose, pose_world=pose_world,
                           is_keyframe=is_kf, reason=reason, iters=it_out,
                           f_norm=fs_out, frac_good=frac, H=H,
                           band_overflow=boverflow)
        return new_state, out

    return step


def _assert_outputs_equal(a, b):
    for name, x, y in zip(dv.VOStepOutput._fields, a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), name


def _vo_case(descriptor):
    """(K, baseline, frames as (image, aux) pairs, params, stereo_fn):
    intensity with the disparity given; Bit-Planes with the stereo pair,
    the matcher looking the left image's disparity up."""
    if descriptor == "intensity":
        cam = make_cam()
        frames = make_sequence(STEP, N_FRAMES)
        return (np.asarray(cam.K()), float(cam.baseline), frames,
                AlgorithmParameters(**KW), None)
    K, b, sframes = synthetic.synthesize_stereo_sequence(N_FRAMES, H_IMG,
                                                         W_IMG)
    lookup = [(torch.as_tensor(left), torch.as_tensor(d))
              for left, _, d in sframes]

    def stereo_fn(left, right):
        return next(d for l, d in lookup if torch.equal(l, left))

    params = AlgorithmParameters(**dict(
        KW, descriptor=DescriptorType.BITPLANES,
        minTranslationMagToKeyFrame=0.08))
    return K, b, [(l, r) for l, r, _ in sframes], params, stereo_fn


@pytest.mark.parametrize("descriptor", ["intensity", "bitplanes"])
def test_split_step_bitwise(descriptor):
    """Over 10 steps with keyframes, the eager ``DeviceVO`` (front, the
    host read, commit) and its graphed route through the stand-in (one
    step graph over static buffers, the keyframe branch an IF body) give
    the VOStepOutputs of the unsplit step bit for bit; an ``init`` re-run
    on the same object refills the buffers."""
    K, b, frames, params, stereo_fn = _vo_case(descriptor)
    eager = dv.DeviceVO(K, b, (H_IMG, W_IMG), params, device="cpu",
                        stereo_fn=stereo_fn)
    graphed = dv.DeviceVO(K, b, (H_IMG, W_IMG), params, device="cpu",
                          stereo_fn=stereo_fn)
    graphed._graphs = ReplayStandIn("cpu")
    parent = _parent_make_vo_step(eager._p, eager._cams, eager._capacities,
                                  eager._opts, stereo_fn)
    for rerun in range(2):
        graphed.state = None
        eager.add_frame(*frames[0])
        graphed.add_frame(*frames[0])
        state = eager.state
        n_kf = n_cand = 0
        for image, aux in frames[1:]:
            has_prev = state.has_prev
            state, want = parent(state, torch.as_tensor(image),
                                 torch.as_tensor(aux))
            _assert_outputs_equal(eager.add_frame(image, aux), want)
            _assert_outputs_equal(graphed.add_frame(image, aux), want)
            assert torch.equal(graphed.state.last_weights, state.last_weights)
            n_kf += int(want.is_keyframe)
            n_cand += int(bool(want.is_keyframe) and has_prev)
        assert n_kf >= 2 and n_cand >= 1 and n_kf < len(frames) - 1
        eager.state = None
    assert len(graphed._graphs) == 1


def test_graphed_step_outputs_own_their_tensors():
    """``add_frames`` stacks the steps' outputs: none of them may alias a
    buffer that a later replay overwrites."""
    K, b, frames, params, _ = _vo_case("intensity")
    images = np.stack([f[0] for f in frames])
    disps = np.stack([f[1] for f in frames])
    eager = dv.DeviceVO(K, b, (H_IMG, W_IMG), params, device="cpu")
    graphed = dv.DeviceVO(K, b, (H_IMG, W_IMG), params, device="cpu")
    graphed._graphs = ReplayStandIn("cpu")
    _assert_outputs_equal(graphed.add_frames(images, disps),
                          eager.add_frames(images, disps))


def test_graphed_step_matches_jax_level_kernel_route(monkeypatch):
    """The graphed route (stand-in) against JAX's ``DeviceVO`` on its
    level-kernel route, at the tolerances of
    test_torch_device_vo.py::test_device_vo_matches_jax_level_kernel_route."""
    monkeypatch.setenv("BPVO_LEVEL_KERNEL", "force")
    K, b, frames, _, _ = _vo_case("intensity")
    jvo = JDeviceVO(K, b, (H_IMG, W_IMG), JParams(**KW))
    tvo = dv.DeviceVO(K, b, (H_IMG, W_IMG), AlgorithmParameters(**KW),
                      device="cpu")
    tvo._graphs = ReplayStandIn("cpu")
    for I, D in frames[:7]:
        oj, ot = jvo.add_frame(I, D), tvo.add_frame(I, D)
        if oj is None:
            continue
        assert bool(ot.is_keyframe) == bool(oj.is_keyframe)
        np.testing.assert_allclose(ot.pose.numpy(), np.asarray(oj.pose),
                                   atol=1e-4)
        np.testing.assert_allclose(ot.pose_world.numpy(),
                                   np.asarray(oj.pose_world), atol=1e-4)
        assert np.abs(ot.iters.numpy() - np.asarray(oj.iters)).max() <= 1


def test_step_with_run_levels_bitwise(monkeypatch):
    """A ``DeviceVO`` whose finest level goes to ``gauss_newton.run`` takes
    the one-graph step (here through the stand-in: that level's loop a
    ``while_loop`` inside the step function), and its eager step is the
    unsplit step: both bit for bit."""
    monkeypatch.setattr(gn, "MAX_LEVEL_KERNEL_POINTS", 1024)
    K, b, frames, params, _ = _vo_case("intensity")
    vo = dv.DeviceVO(K, b, (H_IMG, W_IMG), params, device="cpu")
    vo._graphs = ReplayStandIn("cpu")
    assert vo._capacities[0] > 1024 >= vo._capacities[1]
    parent = _parent_make_vo_step(vo._p, vo._cams, vo._capacities, vo._opts)
    vo.add_frame(*frames[0])
    state = want_state = vo.state
    for image, aux in frames[1:7]:
        image, aux = torch.as_tensor(image), torch.as_tensor(aux)
        want_state, want = parent(want_state, image, aux)
        state, got = vo._step(state, image, aux)
        _assert_outputs_equal(got, want)
        _assert_outputs_equal(vo.add_frame(image, aux), want)
    assert len(vo._graphs) == 1


def test_visual_odometry_run_levels_bitwise(monkeypatch):
    """``VisualOdometry`` with its finest level on ``gauss_newton.run``:
    the estimate graph (stand-in; that level's loop a ``while_loop``
    inside the whole estimate, one replay an estimate) against the eager
    chain, every Result field bit for bit."""
    monkeypatch.setattr(gn, "MAX_LEVEL_KERNEL_POINTS", 1024)
    K, b, frames, params, _ = _vo_case("intensity")
    eager = VisualOdometry(K, b, (H_IMG, W_IMG), params, device="cpu")
    graphed = VisualOdometry(K, b, (H_IMG, W_IMG), params, device="cpu")
    assert eager._graphs is None
    graphed._graphs = ReplayStandIn("cpu")
    n_kf = 0
    for image, disp in frames[:7]:
        re, rg = eager.add_frame(image, disp), graphed.add_frame(image, disp)
        assert np.array_equal(re.pose, rg.pose)
        assert np.array_equal(re.covariance, rg.covariance)
        assert re.is_keyframe == rg.is_keyframe
        assert re.optimizer_statistics == rg.optimizer_statistics
        n_kf += int(re.is_keyframe)
    assert n_kf >= 3
    assert not hasattr(graphed._pose_estimator, "_run_graphs")
    kinds = sorted(key[0][0] for key in graphed._graphs._entries)
    assert kinds.count("frame") == kinds.count("templates") == 1
    assert 1 <= kinds.count("estimate") <= 2


# ---------------------------------------------------------------------------
# DeviceVO.point_cloud
# ---------------------------------------------------------------------------

def test_point_cloud_matches_jax():
    """``point_cloud`` on a state carried from JAX's ``DeviceVO`` equals
    JAX's cloud of that state; the graphed route's cloud equals the eager
    route's."""
    K, b, frames, params, _ = _vo_case("intensity")
    jvo = JDeviceVO(K, b, (H_IMG, W_IMG), JParams(**KW))
    for I, D in frames[:4]:
        jvo.add_frame(I, D)
    tvo = dv.DeviceVO(K, b, (H_IMG, W_IMG), params, device="cpu")
    assert tvo.point_cloud() is None
    tvo.state = state_from_numpy(_jax_state_to_numpy(jvo.state), "cpu")
    cj, ct = jvo.point_cloud(), tvo.point_cloud()
    assert len(ct) == len(cj) > 100
    for field in ("points", "colors", "weights"):
        got, want = getattr(ct, field), getattr(cj, field)
        assert got.dtype == want.dtype and np.array_equal(got, want), field
    eager = dv.DeviceVO(K, b, (H_IMG, W_IMG), params, device="cpu")
    graphed = dv.DeviceVO(K, b, (H_IMG, W_IMG), params, device="cpu")
    graphed._graphs = ReplayStandIn("cpu")
    for image, disp in frames[:6]:
        eager.add_frame(image, disp)
        graphed.add_frame(image, disp)
    ce, cg = eager.point_cloud(), graphed.point_cloud()
    assert len(ce) > 100 and not np.all(ce.weights == 1.0)
    for field in ("points", "colors", "weights"):
        assert np.array_equal(getattr(ce, field), getattr(cg, field)), field
