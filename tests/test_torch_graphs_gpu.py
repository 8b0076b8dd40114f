"""The graphed routes on the card against the eager ones: ``DeviceVO``'s step
graphs, ``gauss_newton.run``'s iteration graphs (alone, in a ``DeviceVO``
with a level on ``run``, and in ``VisualOdometry``) bit for bit, with equal
launch counts, and a capture that fails raising.  Marked ``gpu``: without a
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
    return {m.__name__.rsplit(".", 1)[-1]: m.launch_count
            for m in graphs.op_modules()}


def _delta(before):
    return {k: v - before[k] for k, v in _counts().items()}


def _equal(a, b, fields):
    for name, x, y in zip(fields, a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), name


def _vo_case(path, rows, cols):
    K, b, frames = synthetic.synthesize_stereo_sequence(1 + N_STEPS, rows,
                                                        cols)
    if path == "intensity":
        return (K, b, [(f[0], f[2]) for f in frames],
                AlgorithmParameters(**BENCH_PARAMS), None)
    cf = ConfigFile(CONF)
    return (K, b, [f[:2] for f in frames], AlgorithmParameters.from_config(cf),
            stereo.create_stereo_algorithm(cf).as_fn())


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(120, 160), (240, 320)])
@pytest.mark.parametrize("path", ["intensity", "stereo_bitplanes"])
def test_device_vo_graphed_equals_eager(cuda, path, shape):
    """Over 12 steps with keyframes, twice on the same objects (``init``
    re-run), the graphed ``add_frame`` gives the eager step's outputs bit
    for bit (poses, world poses, iterations, keyframes, f_norm, ...), and
    the kernels' launch counts, replays counted, are the eager ones."""
    K, b, frames, params, stereo_fn = _vo_case(path, *shape)
    vo = device_vo.DeviceVO(K, b, shape, params, device=cuda,
                            stereo_fn=stereo_fn)
    ref = device_vo.DeviceVO(K, b, shape, params, device=cuda,
                             stereo_fn=stereo_fn)
    assert vo._graphs is not None and vo._run_graphs is None
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
        assert _delta(before) == n_graphed and n_graphed["level_gn"] > 0
        for g, w in zip(got, want):
            _equal(g, w, fields)
        assert sum(bool(w.is_keyframe) for w in want) >= 2
    assert len(vo._graphs) == 2 and graphs.replay_count > 0


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
    """``RunGraphs.run`` (every iteration a replay once its graph exists)
    against the eager ``gauss_newton.run`` at the dense L0/L1 shapes: every
    GNState field bit for bit, the same launches, from two starts and on a
    second template (copied into the graphs' buffers)."""
    vo, ch = dense_levels[C]
    td, cam, opts = vo.state.templates[level], vo._cams[level], vo._opts[level]
    assert not gn.level_kernel_supported(opts, 1, 1, 1, td.pixels.shape[1])
    dev = ch[level].device
    T1 = torch.tensor([[1.0, -2e-3, 1e-3, 5e-3], [2e-3, 1.0, -1e-3, -2e-3],
                       [-1e-3, 1e-3, 1.0, 1e-2], [0.0, 0.0, 0.0, 1.0]],
                      device=dev)
    td2 = td._replace(pixels=td.pixels * 1.01)
    rg = gn.RunGraphs()
    iters = 0
    for tdata in (td, td2, td):
        for T0 in (torch.eye(4, device=dev), T1):
            before = _counts()
            want = gn.run(tdata, ch[level], cam, T0, opts)
            n_eager = _delta(before)
            before = _counts()
            got = gn.run(tdata, ch[level], cam, T0, opts, graphs=rg)
            assert _delta(before) == n_eager and n_eager["fused_linearize"]
            _equal(got, want, gn.GNState._fields)
            iters += int(want.num_iters)
    assert len(rg._cache) <= 4 and iters > 2 * len(rg._cache)


@pytest.mark.gpu
def test_device_vo_with_run_levels_graphed_equals_eager(cuda):
    """A ``DeviceVO`` whose L0 and L1 go to ``run`` (dense settings) keeps
    the eager step and replays those levels' iterations: bit for bit the
    eager step without graphs, with the same launches."""
    K, b, frames = synthetic.synthesize_sequence(5)
    params = AlgorithmParameters(**DENSE)
    shape = (synthetic.ROWS, synthetic.COLS)
    vo = device_vo.DeviceVO(K, b, shape, params, device=cuda)
    assert vo._graphs is None and vo._run_graphs is not None
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
    assert len(vo._run_graphs[0]._cache) >= 2


@pytest.mark.gpu
def test_visual_odometry_graphed_equals_eager(cuda):
    """Dense ``VisualOdometry`` (L0 and L1 on ``run``): the pose
    estimator's iteration graphs against the eager loop, every Result field
    equal, the same launches."""
    K, b, frames = synthetic.synthesize_sequence(5)
    params = AlgorithmParameters(**DENSE)
    shape = (synthetic.ROWS, synthetic.COLS)
    vo = VisualOdometry(K, b, shape, params, device=cuda)
    ref = VisualOdometry(K, b, shape, params, device=cuda)
    ref._pose_estimator._level_graphs = lambda channels_pyr: None
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
    assert len(vo._pose_estimator._run_graphs[0]._cache) >= 2


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
