"""The graphed routes on the card against the eager ones: ``DeviceVO``'s step
graph (its keyframe branch an IF node, its ``gauss_newton.run`` and LM
level solves WHILE nodes; ``add_frame`` and read-free ``add_frames``
chunks) on the bench, dense and Bit-Planes LM paths, a level solve
through ``GraphCache.jit`` for GN and for LM (one replay, no read per
level solve),
``VisualOdometry``'s frame, template and estimate graphs (two replays and
one read an other step) bit for bit, with equal launch counts once
settled, IF and WHILE nodes alone, a WHILE body that frees a tensor from
before the loop, and captures that fail raising.  Marked ``gpu``: without a
CUDA device they skip (the decision is made in a fixture).  On a machine
with an NVIDIA GPU (no JAX needed):

    python -m pytest --noconftest -o "markers=gpu: needs a CUDA device" \\
        -m gpu tests/test_torch_graphs_gpu.py
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from bpvo_tpu_torch import (AlgorithmParameters, ConfigFile, DescriptorType,
                            VisualOdometry)
from bpvo_tpu_torch.data import stereo, synthetic
from bpvo_tpu_torch.ops import sgm
from bpvo_tpu_torch.solver import gauss_newton as gn
from bpvo_tpu_torch.utils import graphs
from bpvo_tpu_torch.vo import device_vo

HERE = os.path.dirname(os.path.abspath(__file__))
CONF = os.path.join(HERE, "..", "conf", "kitti_bitplanes.cfg")
BENCH_PARAMS = dict(minSaliency=2.0, numPyramidLevels=4,
                    descriptor=DescriptorType.INTENSITY,
                    functionTolerance=1e-4, parameterTolerance=1e-6,
                    maxIterations=50)
DENSE = dict(BENCH_PARAMS, minNumPixelsForNonMaximaSuppression=20000000,
             pointCapacity=131072)
N_STEPS = 12


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the kernels run "
                    "only on the GPU")
    return torch.device("cuda", 0)


def _counts():
    """The ops modules' launch counts and the SGM tile pass's winners,
    settled."""
    graphs.settle()
    counts = {m.__name__.rsplit(".", 1)[-1]: m.launch_count
              for m in graphs.op_modules()}
    counts["sgm_winner"] = sgm.winner_count.launch_count
    return counts


def _delta(before):
    return {k: v - before[k] for k, v in _counts().items()}


def _equal(a, b, fields):
    for name, x, y in zip(fields, a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), name


def _vo_case(path, rows, cols):
    K, b, frames = synthetic.synthesize_stereo_sequence(1 + N_STEPS, rows,
                                                        cols)
    given = [(f[0], f[2]) for f in frames]
    if path == "intensity":
        return K, b, given, AlgorithmParameters(**BENCH_PARAMS), None
    if path == "dense":          # L0 (and L1 at 240x320) on gauss_newton.run
        return K, b, given, AlgorithmParameters(**DENSE), None
    if path == "lm_bitplanes":
        return K, b, given, AlgorithmParameters(**dict(
            BENCH_PARAMS, descriptor=DescriptorType.BITPLANES,
            poseEstimator="LevenbergMarquardt")), None
    cf = ConfigFile(CONF)
    return (K, b, [f[:2] for f in frames], AlgorithmParameters.from_config(cf),
            stereo.create_stereo_algorithm(cf).as_fn())


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(120, 160), (240, 320)])
@pytest.mark.parametrize("path", ["intensity", "stereo_bitplanes", "dense",
                                  "lm_bitplanes"])
def test_device_vo_graphed_equals_eager(cuda, path, shape):
    """Over 12 steps with keyframes, twice on the same objects (``init``
    re-run), the graphed ``add_frame`` (one step graph, the keyframe
    branch an IF node, a ``gauss_newton.run`` or LM level a WHILE node)
    gives the eager step's outputs bit for bit (poses, world poses,
    iterations, keyframes, f_norm, ...), and the kernels' launch counts,
    replays and the conditional bodies' runs counted, are the eager
    ones."""
    K, b, frames, params, stereo_fn = _vo_case(path, *shape)
    vo = device_vo.DeviceVO(K, b, shape, params, device=cuda,
                            stereo_fn=stereo_fn)
    ref = device_vo.DeviceVO(K, b, shape, params, device=cuda,
                             stereo_fn=stereo_fn)
    assert vo._graphs is not None
    kernel = {"dense": "fused_linearize",
              "lm_bitplanes": "irls"}.get(path, "level_gn")
    fields = device_vo.VOStepOutput._fields
    for rerun in range(2):
        vo.state = ref.state = None
        vo.add_frame(*frames[0])
        ref.add_frame(*frames[0])
        before = _counts()
        got = [vo.add_frame(*f) for f in frames[1:]]
        n_graphed = _delta(before)
        before = _counts()
        state, want = ref.state, []
        for image, aux in frames[1:]:
            state, out = ref._step(state, ref._as_tensor(image),
                                   ref._as_tensor(aux))
            want.append(out)
        assert _delta(before) == n_graphed and n_graphed[kernel] > 0
        for g, w in zip(got, want):
            _equal(g, w, fields)
        assert sum(bool(w.is_keyframe) for w in want) >= 2
    assert len(vo._graphs) == 1 and graphs.replay_count > 0


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["intensity", "stereo_bitplanes", "dense",
                                  "lm_bitplanes"])
def test_device_vo_chunks_read_free(cuda, path):
    """``add_frames`` in chunks of 1, 3 and 7 (the chunk on the card
    first) replays the step graph with no device-to-host read
    (``set_sync_debug_mode("error")`` raises on one) and equals the eager
    step bit for bit, with the eager launch counts once settled."""
    shape = (240, 320)
    K, b, frames, params, stereo_fn = _vo_case(path, *shape)
    vo = device_vo.DeviceVO(K, b, shape, params, device=cuda,
                            stereo_fn=stereo_fn)
    images = torch.stack([torch.as_tensor(f[0]) for f in frames]).to(cuda)
    auxs = torch.stack([torch.as_tensor(f[1]) for f in frames]).to(cuda)
    vo.add_frames(images[:3], auxs[:3])      # warm-up and capture
    vo.state = None
    vo.add_frame(images[0], auxs[0])
    state, want = vo.state, []
    before = _counts()
    for i in range(1, len(frames)):
        state, out = vo._step(state, images[i], auxs[i])
        want.append(out)
    n_eager = _delta(before)
    assert sum(bool(w.is_keyframe) for w in want) >= 2
    for chunk in (1, 3, 7):
        vo.state = None
        vo.add_frame(images[0], auxs[0])
        torch.cuda.synchronize()
        before = _counts()
        outs = []
        torch.cuda.set_sync_debug_mode("error")
        try:
            for lo in range(1, len(frames), chunk):
                outs.append(vo.add_frames(images[lo:lo + chunk],
                                          auxs[lo:lo + chunk]))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert _delta(before) == n_eager and n_eager[
            "irls" if path == "lm_bitplanes" else "level_gn"] > 0
        got = [device_vo.VOStepOutput(*(f[i] for f in o))
               for o in outs for i in range(o.pose.shape[0])]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w, device_vo.VOStepOutput._fields)


@pytest.mark.gpu
def test_if_nodes_on_the_card(cuda):
    """``graphs.cond`` in a captured function: an IF node (nested in a
    second) runs its body only on replays whose predicate is true, copies
    its results over ``into``, and counts its launches (a fake op module)
    only for the replays that took it, once settled."""
    import types
    mod = types.SimpleNamespace(launch_count=0)
    cache = graphs.GraphCache(cuda, modules=(mod,))
    x = torch.zeros(4, device=cuda)
    flags = torch.zeros(2, dtype=torch.bool, device=cuda)
    out = torch.zeros(3, device=cuda)

    def op(t):
        mod.launch_count += 1
        return t + 1.0

    def fn():
        y = op(x)
        out.copy_(torch.stack([y.sum(), torch.zeros((), device=cuda),
                               torch.zeros((), device=cuda)]))

        def outer():
            z = op(op(y))

            def inner():
                return (z * 10.0).sum().reshape(1)
            w = graphs.cond(flags[1], inner, torch.zeros(1, device=cuda))
            return torch.cat([z.sum().reshape(1), w])
        graphs.cond(flags[0], outer, out[1:])
        return out

    want_launches = 0
    for a, bb in [(0, 0), (1, 0), (1, 1), (0, 1), (1, 1), (0, 0), (1, 0)]:
        x.add_(1.0)
        flags.copy_(torch.tensor([bool(a), bool(bb)], device=cuda))
        got = cache("k", fn).clone()
        s1 = float((x + 1).sum())
        z = float((x + 3).sum())
        want = [s1, z if a else 0.0, 10 * z if a and bb else 0.0]
        assert got.tolist() == pytest.approx(want), (a, bb, got)
        want_launches += 1 + (2 if a else 0)
        graphs.settle()
        assert mod.launch_count == want_launches
    assert len(cache) == 1


@pytest.mark.gpu
def test_while_nodes_on_the_card(cuda):
    """``graphs.while_loop`` in a captured function: a WHILE node, an IF
    node nested in its body and a WHILE node in an IF body give the host
    loop's results bit for bit on every replay as the trip counts change,
    and count their launches (a fake op module) per run once settled."""
    import types
    mod = types.SimpleNamespace(launch_count=0)
    cache = graphs.GraphCache(cuda, modules=(mod,))
    x = torch.linspace(0.0, 1.0, 1000, device=cuda)
    n = torch.zeros((), dtype=torch.int32, device=cuda)
    flags = torch.zeros(2, dtype=torch.bool, device=cuda)

    def op(t):
        mod.launch_count += 1
        return t * 1.5 + 0.25

    def fn():
        carry = (torch.zeros((), dtype=torch.int32, device=cuda), x.clone())

        def body(c):
            i, acc = c
            acc = op(acc)
            acc = graphs.cond(flags[0] & (i % 2 == 0),
                              lambda: op(op(acc)) * 0.5, acc.clone())
            return i + 1, acc
        i, acc = graphs.while_loop(lambda c: (c[0] < n) & (c[0] < 9), body,
                                   carry)

        def branch():
            inner = (torch.zeros((), dtype=torch.int32, device=cuda),
                     acc.clone())
            return graphs.while_loop(lambda c: c[0] < n - 1,
                                     lambda c: (c[0] + 1, op(c[1])),
                                     inner)[1]
        return i, graphs.cond(flags[1], branch, acc.clone())

    for m, a, bb in [(3, 1, 1), (0, 1, 0), (12, 0, 1), (5, 1, 1), (1, 0, 0),
                     (4, 0, 1), (7, 1, 0)]:
        n.fill_(m)
        flags.copy_(torch.tensor([bool(a), bool(bb)], device=cuda))
        graphs.settle()
        before = mod.launch_count
        want = fn()                          # eager: the host loops
        graphs.settle()
        n_eager = mod.launch_count - before
        before = mod.launch_count
        got = [t.clone() for t in cache("k", fn)]
        graphs.settle()
        assert mod.launch_count - before == n_eager, (m, a, bb)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), (m, a, bb)
    assert len(cache) == 1


@pytest.mark.gpu
def test_while_body_freeing_an_outer_tensor(cuda):
    """A WHILE body that drops the last reference to a tensor from before
    the loop (allocated by the captured function) and then allocates
    temporaries of its size: every iteration of a replay still reads that
    tensor, because the body is captured in a memory pool of its own (in
    the capture's pool the temporaries would take its block, and the
    second iteration would read them)."""
    cache = graphs.GraphCache(cuda)
    base = torch.ones(1 << 20, device=cuda)
    n = torch.zeros((), dtype=torch.int32, device=cuda)

    def fn():
        holder = [base * 3.0]          # the outer tensor, held only here

        def body(c):
            i, acc = c
            outer = holder.pop()
            y = acc + outer
            if not torch.cuda.is_current_stream_capturing():
                holder.append(outer)   # the host loop reads it again
            del outer
            t = torch.full_like(acc, 1000.0)
            return i + 1, y + t * 0.0
        carry = (torch.zeros((), dtype=torch.int32, device=cuda),
                 base.clone())
        return graphs.while_loop(lambda c: c[0] < n, body, carry)

    for m in (2, 5, 1, 3):
        n.fill_(m)
        i, acc = (t.clone() for t in cache("k", fn))
        assert int(i) == m
        assert torch.equal(acc, torch.full_like(base, 1.0 + 3.0 * m)), m


@pytest.fixture(scope="module")
def dense_levels(cuda):
    """Dense VO at 376x1241 (L0 131072, L1 32768 points, both on ``run``):
    frame 0's templates and frame 1's channels, intensity and Bit-Planes."""
    out = {}
    K, b, frames = synthetic.synthesize_sequence(2)
    for name, desc in (("C1", DescriptorType.INTENSITY),
                       ("C8", DescriptorType.BITPLANES)):
        vo = device_vo.DeviceVO(K, b, (synthetic.ROWS, synthetic.COLS),
                                AlgorithmParameters(**dict(
                                    DENSE, descriptor=desc)), device=cuda)
        vo.init(*frames[0])
        ch = device_vo._compute_channels_pyr(
            torch.as_tensor(frames[1][0]).to(cuda), vo._p, 4)
        out[name] = (vo, ch)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("C", ["C1", "C8"])
@pytest.mark.parametrize("level", [0, 1])
def test_run_graphed_equals_eager(dense_levels, C, level):
    """A level solve through ``GraphCache.jit`` (each one replay of one
    graph, with no device read once the graph exists) against the eager
    ``gauss_newton.run`` at the dense L0/L1 shapes: every GNState field
    bit for bit, the same launches, from two starts and on a second
    template (copied into the graph's buffers)."""
    vo, ch = dense_levels[C]
    td, cam, opts = vo.state.templates[level], vo._cams[level], vo._opts[level]
    assert not gn.level_kernel_supported(opts, 1, 1, 1, td.pixels.shape[1])
    dev = ch[level].device
    T1 = torch.tensor([[1.0, -2e-3, 1e-3, 5e-3], [2e-3, 1.0, -1e-3, -2e-3],
                       [-1e-3, 1e-3, 1.0, 1e-2], [0.0, 0.0, 0.0, 1.0]],
                      device=dev)
    td2 = td._replace(pixels=td.pixels * 1.01)
    cache = graphs.GraphCache(dev)
    iters = 0
    for tdata in (td, td2, td):
        for T0 in (torch.eye(4, device=dev), T1):
            before = _counts()
            want = gn.run(tdata, ch[level], cam, T0, opts)
            n_eager = _delta(before)
            got = _no_read_solve(cache, gn.run, tdata, ch[level], cam, T0,
                                 opts)
            before = _counts()
            got = _no_read_solve(cache, gn.run, tdata, ch[level], cam, T0,
                                 opts)
            assert _delta(before) == n_eager and n_eager["fused_linearize"]
            _equal(got, want, gn.GNState._fields)
            iters += int(want.num_iters)
    assert len(cache) == 1 and iters > 6


@pytest.mark.gpu
@pytest.mark.parametrize("C", ["C1", "C8"])
def test_run_timer_counts_and_times_the_iterations(dense_levels, C):
    """The L0 solve's ``graphs.Timer`` in a graph: after each replay,
    settled, it counts the solve's iterations (the first between its own
    start and stop nodes, the rest in the WHILE body), and its
    nanoseconds fall within 5% of CUDA events around the same replay;
    the eager solve counts its iterations on the host and no time."""
    vo, ch = dense_levels[C]
    td, cam, opts = vo.state.templates[0], vo._cams[0], vo._opts[0]
    dev = ch[0].device
    timer = graphs.timer(f"test.run_timer.{C}")
    T0 = torch.eye(4, device=dev)
    cache = graphs.GraphCache(dev)

    def solve():
        return gn.run(td, ch[0], cam, T0, opts, timer=timer)

    graphs.settle()
    it0, ns0 = timer.launch_count, timer.ns
    want = solve()
    graphs.settle()
    n = int(want.num_iters)
    assert n > 2 and timer.launch_count - it0 == n and timer.ns == ns0
    cache("k", solve)               # warm-up (counted on the host), capture
    graphs.settle()
    for T in (torch.eye(4, device=dev), torch.tensor(
            [[1.0, -2e-3, 1e-3, 5e-3], [2e-3, 1.0, -1e-3, -2e-3],
             [-1e-3, 1e-3, 1.0, 1e-2], [0.0, 0.0, 0.0, 1.0]], device=dev)):
        T0.copy_(T)
        it0, ns0 = timer.launch_count, timer.ns
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        start.record()
        got = cache("k", solve)
        end.record()
        torch.cuda.synchronize()
        graphs.settle()
        ms = start.elapsed_time(end)
        assert timer.launch_count - it0 == int(got.num_iters) > 2
        timed_ms = (timer.ns - ns0) * 1e-6
        assert abs(timed_ms - ms) <= 0.05 * ms, (timed_ms, ms)


def _no_read_solve(cache, solve, tdata, channels, cam, T0, opts):
    """``solve`` of a level through ``cache.jit`` (the template copied in
    only when another template object arrives): the first call captures;
    later ones must be one replay with no device-to-host read
    (``set_sync_debug_mode("error")`` raises on one)."""
    def run():
        return cache.jit((solve, opts, cam), (tdata, channels, T0),
                         lambda b: solve(b[0], b[1], cam, b[2], opts),
                         held=(0,))
    if not len(cache):
        return run()
    replays = graphs.replay_count
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert graphs.replay_count == replays + 1
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("C", ["C1", "C8"])
@pytest.mark.parametrize("level", [0, 1])
def test_lm_graphed_equals_eager(dense_levels, C, level):
    """An LM level solve through ``GraphCache.jit`` (each one replay, no
    device read) against the eager ``levenberg_marquardt.run`` at the
    dense L0/L1 shapes, at most 12 iterations: every LMState field bit for
    bit, the same launches (``irls_reduce`` every iteration at C=8), from
    two starts."""
    import dataclasses
    from bpvo_tpu_torch.solver import levenberg_marquardt as lm
    vo, ch = dense_levels[C]
    td, cam = vo.state.templates[level], vo._cams[level]
    opts = dataclasses.replace(vo._opts[level], max_iterations=12)
    dev = ch[level].device
    T1 = torch.tensor([[1.0, -2e-3, 1e-3, 5e-3], [2e-3, 1.0, -1e-3, -2e-3],
                       [-1e-3, 1e-3, 1.0, 1e-2], [0.0, 0.0, 0.0, 1.0]],
                      device=dev)
    cache = graphs.GraphCache(dev)
    for T0 in (torch.eye(4, device=dev), T1, torch.eye(4, device=dev)):
        before = _counts()
        want = lm.run(td, ch[level], cam, T0, opts)
        n_eager = _delta(before)
        before = _counts()
        got = _no_read_solve(cache, lm.run, td, ch[level], cam, T0, opts)
        assert _delta(before) == n_eager
        assert n_eager["irls"] > 0 or C == "C1"
        _equal(got, want, lm.LMState._fields)
        assert int(want.num_iters) >= 2
    assert len(cache) == 1


@pytest.mark.gpu
def test_device_vo_with_run_levels_graphed_equals_eager(cuda):
    """A ``DeviceVO`` whose L0 and L1 go to ``run`` (dense settings) takes
    the one-graph step, those levels' loops WHILE nodes in it: bit for bit
    the eager step without graphs, with the same launches."""
    K, b, frames = synthetic.synthesize_sequence(5)
    params = AlgorithmParameters(**DENSE)
    shape = (synthetic.ROWS, synthetic.COLS)
    vo = device_vo.DeviceVO(K, b, shape, params, device=cuda)
    assert vo._graphs is not None
    eager = device_vo.make_vo_step(vo._p, vo._cams, vo._capacities, vo._opts)
    vo.add_frame(*frames[0])
    state = vo.state
    for image, disp in frames[1:]:
        before = _counts()
        got = vo.add_frame(image, disp)
        n_graphed = _delta(before)
        before = _counts()
        state, want = eager(state, vo._as_tensor(image), vo._as_tensor(disp))
        assert _delta(before) == n_graphed
        _equal(got, want, device_vo.VOStepOutput._fields)
    assert len(vo._graphs) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("solver", ["GaussNewton", "LevenbergMarquardt"])
def test_visual_odometry_graphed_equals_eager(cuda, solver):
    """Dense ``VisualOdometry`` (L0 and L1 on ``run``; with LM every
    level): the estimate graph (those levels' loops WHILE nodes in it, one
    replay an estimate) with the frame and template graphs against the
    eager route, every Result field equal, the same launches."""
    K, b, frames = synthetic.synthesize_sequence(5)
    params = AlgorithmParameters(**dict(DENSE, poseEstimator=solver))
    shape = (synthetic.ROWS, synthetic.COLS)
    vo = VisualOdometry(K, b, shape, params, device=cuda)
    ref = VisualOdometry(K, b, shape, params, device=cuda)
    assert vo._graphs is not None
    ref._graphs = None
    for image, disp in frames:
        before = _counts()
        rg = vo.add_frame(image, disp)
        n_graphed = _delta(before)
        before = _counts()
        re = ref.add_frame(image, disp)
        assert _delta(before) == n_graphed
        assert np.array_equal(rg.pose, re.pose)
        assert np.array_equal(rg.covariance, re.covariance)
        assert rg.is_keyframe == re.is_keyframe
        assert rg.optimizer_statistics == re.optimizer_statistics
    kinds = sorted(key[0][0] for key in vo._graphs._entries)
    assert kinds.count("frame") == kinds.count("templates") == 1
    assert 1 <= kinds.count("estimate") <= 2


def _allowed_reads(monkeypatch, reads):
    """Let only ``PoseEstimator._read`` (the estimate's copy) and
    ``VisualOdometry._cloud_read`` (a keyframe's point cloud) synchronize
    under ``set_sync_debug_mode("error")``, counting each in ``reads``."""
    from bpvo_tpu_torch.vo import odometry, pose_estimator

    def allowed(name, fn):
        def read(*a):
            reads[name] += 1
            torch.cuda.set_sync_debug_mode(0)
            try:
                return fn(*a)
            finally:
                torch.cuda.set_sync_debug_mode("error")
        return staticmethod(read)
    monkeypatch.setattr(pose_estimator.PoseEstimator, "_read", allowed(
        "estimate", pose_estimator.PoseEstimator._read))
    monkeypatch.setattr(odometry.VisualOdometry, "_cloud_read", allowed(
        "cloud", odometry.VisualOdometry._cloud_read))


@pytest.mark.gpu
@pytest.mark.parametrize("desc", ["intensity", "bitplanes", "multistart"])
def test_visual_odometry_three_graphs_equal_eager(cuda, desc, monkeypatch):
    """``VisualOdometry`` at 240x320 on its graphed route (the frame,
    template and estimate graphs) against ``_graphs = None``: every Result
    field bit for bit, the same settled launches.  Both routes run under
    ``set_sync_debug_mode("error")`` with only the estimate's read and a
    keyframe's point-cloud read allowed (the eager route's levels are all
    ``level_gn``, which reads nothing: so the multi-start's median and
    candidate pick read nothing either).  The graphed pass takes over a
    first pass's cache (its keys captured): an other step is 2 replays
    and 1 read; a keyframe adds the template replay and the cloud's read,
    and with a candidate the re-estimate's replay and read."""
    K, b, frames = synthetic.synthesize_sequence(1 + N_STEPS, 240, 320)
    frames = [tuple(torch.as_tensor(x).to(cuda) for x in f) for f in frames]
    params = AlgorithmParameters(**dict(
        BENCH_PARAMS, minTranslationMagToKeyFrame=0.08,
        coarseInitOffsetPx=2.0 if desc == "multistart" else 0.0,
        descriptor=(DescriptorType.BITPLANES if desc == "bitplanes"
                    else DescriptorType.INTENSITY)))
    shape = (240, 320)

    def no_other_read(vo, image, disp):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return vo.add_frame(image, disp)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    first = VisualOdometry(K, b, shape, params, device=cuda)
    for image, disp in frames:
        first.add_frame(image, disp)
    reads = {"estimate": 0, "cloud": 0}
    _allowed_reads(monkeypatch, reads)
    ref = VisualOdometry(K, b, shape, params, device=cuda)
    ref._graphs = None
    want = []
    for image, disp in frames:
        before = _counts()
        want.append((no_other_read(ref, image, disp), _delta(before)))
    vo = VisualOdometry(K, b, shape, params, device=cuda)
    vo._graphs = first._graphs
    n_keys = len(vo._graphs)
    kinds = set()
    for (image, disp), (re, n_eager) in zip(frames, want):
        candidate = not vo._prev.empty
        before, r0, n0 = _counts(), graphs.replay_count, dict(reads)
        rg = no_other_read(vo, image, disp)
        assert _delta(before) == n_eager
        assert np.array_equal(rg.pose, re.pose)
        assert np.array_equal(rg.covariance, re.covariance)
        assert rg.is_keyframe == re.is_keyframe
        assert rg.keyframing_reason == re.keyframing_reason
        assert rg.optimizer_statistics == re.optimizer_statistics
        if re.point_cloud is not None:
            for field in ("points", "colors", "weights"):
                assert np.array_equal(getattr(rg.point_cloud, field),
                                      getattr(re.point_cloud, field))
        got = (graphs.replay_count - r0, reads["estimate"] - n0["estimate"],
               reads["cloud"] - n0["cloud"])
        if not re.optimizer_statistics:          # the first frame
            assert got == (2, 0, 0)
            continue
        kind = ("other" if not re.is_keyframe else
                "candidate" if candidate else "no_candidate")
        kinds.add(kind)
        assert got == {"other": (2, 1, 0), "no_candidate": (3, 1, 1),
                       "candidate": (4, 2, 1)}[kind], kind
    assert "other" in kinds and len(kinds) >= 2
    assert len(vo._graphs) == n_keys


@pytest.mark.gpu
def test_refused_if_body_raises(cuda):
    """A host copy inside an IF body makes the capture fail: the call
    raises and no graph is kept (the warm-up ran the body eagerly, where
    the copy is allowed).  In a process of its own."""
    script = textwrap.dedent("""
        import sys
        import torch
        sys.path.insert(0, sys.argv[1])
        from bpvo_tpu_torch.utils import graphs
        cache = graphs.GraphCache("cuda")
        x = torch.ones(8, device="cuda")
        pred = torch.ones((), dtype=torch.bool, device="cuda")

        def body():
            return x + torch.tensor([1.0] * 8, device="cuda")   # host copy

        def fn():
            return graphs.cond(pred, body, x * 2)

        try:
            cache("k", fn)
        except RuntimeError as e:
            assert "k" not in cache, len(cache)
            print("raised:", str(e).splitlines()[0])
        else:
            sys.exit("the capture did not fail")
    """)
    proc = subprocess.run([sys.executable, "-c", script,
                           os.path.dirname(HERE)], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "raised:" in proc.stdout


@pytest.mark.gpu
def test_broken_capture_raises(cuda):
    """A host read inside the captured function makes the capture fail:
    the call raises, no graph is kept, and nothing runs in its place.  In a
    process of its own, so a failed capture cannot touch the other
    tests."""
    script = textwrap.dedent("""
        import sys
        import torch
        sys.path.insert(0, sys.argv[1])
        from bpvo_tpu_torch.utils import graphs
        cache = graphs.GraphCache("cuda")
        x = torch.ones(8, device="cuda")
        calls = []

        def fn():
            calls.append(1)
            return x * float((x + 1).sum())    # a host read

        try:
            cache("k", fn)
        except RuntimeError as e:
            assert "k" not in cache and len(calls) == 2, (calls, len(cache))
            print("raised:", str(e).splitlines()[0])
        else:
            sys.exit("the capture did not fail")
    """)
    proc = subprocess.run([sys.executable, "-c", script,
                           os.path.dirname(HERE)], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "raised:" in proc.stdout


@pytest.mark.gpu
def test_refused_node_type_in_a_body_raises(cuda):
    """A conditional body holds only kernel, memcpy, memset, empty,
    child-graph and conditional nodes: an IF or WHILE body whose segment
    holds an event record node (an external event recorded in the
    capture) raises when the graph is joined, naming the type, and no graph
    is kept; the same segment outside a body is joined, its node counted.
    The graphs' node types are reported (``node_types``)."""
    x = torch.ones(8, device=cuda)
    pred = torch.ones((), dtype=torch.bool, device=cuda)
    event = torch.cuda.Event(external=True)

    def recorded():
        event.record()
        return x + 1

    cache = graphs.GraphCache(cuda)
    with pytest.raises(RuntimeError, match="event_record"):
        cache("if", lambda: graphs.cond(pred, lambda: (recorded(),),
                                        (x * 2,)))
    n = torch.zeros((), dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="event_record"):
        cache("while", lambda: graphs.while_loop(
            lambda c: c[0] < 3, lambda c: (c[0] + 1, recorded()),
            (n.clone(), x.clone())))
    assert "if" not in cache and "while" not in cache
    cache("top", recorded)
    assert torch.equal(cache("top", recorded), x + 1)
    joined = cache._entries["top"][0]
    assert joined.node_types["top"].get("event_record") == 1
    assert joined.node_types["if"] == joined.node_types["while"] == {}
