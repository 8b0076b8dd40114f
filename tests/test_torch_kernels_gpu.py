"""The hand-written CUDA kernels against their plain PyTorch versions on the
card, at the shapes of the bench's main path.  Marked ``gpu``: without a
CUDA device they skip (the decision is made in a fixture, so every test
worker collects the same tests).  On a machine with an NVIDIA GPU (no JAX
needed):

    python -m pytest --noconftest -o "markers=gpu: needs a CUDA device" \\
        -m gpu tests/test_torch_kernels_gpu.py
"""
import os

import numpy as np
import pytest
import torch

from bpvo_tpu_torch import (AlgorithmParameters, ConfigFile, DescriptorType,
                            InterpolationType, LossFunctionType)
from bpvo_tpu_torch.core import se3
from bpvo_tpu_torch.data import stereo, synthetic
from bpvo_tpu_torch.ops import census
from bpvo_tpu_torch.ops import level_gn as lg
from bpvo_tpu_torch.ops import sgm
from bpvo_tpu_torch.vo import device_vo

CONF = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "conf",
                    "kitti_bitplanes.cfg")
BENCH_PARAMS = dict(minSaliency=2.0, numPyramidLevels=4,
                    descriptor=DescriptorType.INTENSITY,
                    functionTolerance=1e-4, parameterTolerance=1e-6,
                    maxIterations=50)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are built with nvcc "
                    "for sm_90a and run only on the GPU")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def bench_levels(cuda):
    """Templates from frame 0 of the 376x1241 sequence and the channel
    pyramid of frame 1, on the card, at the 4 bench levels."""
    K, b, frames = synthetic.synthesize_sequence(2)
    vo = device_vo.DeviceVO(K, b, (synthetic.ROWS, synthetic.COLS),
                            AlgorithmParameters(**BENCH_PARAMS), device=cuda)
    vo.init(*frames[0])
    channels = device_vo._compute_channels_pyr(
        torch.as_tensor(frames[1][0]).to(cuda), vo._p, 4)
    return vo, channels


def _args(bench_levels, level, T0=None):
    vo, channels = bench_levels
    td = vo.state.templates[level]
    T0 = torch.eye(4, device=channels[0].device) if T0 is None else T0
    return (vo._cams[level], td.points, td.valid, td.pixels, td.jacobians,
            channels[level], T0, 1.0, 1e10, td.norm_scale, td.norm_center,
            vo._opts[level])


@pytest.mark.gpu
@pytest.mark.parametrize("level", range(4))
def test_level_gn_kernel_matches_plain(bench_levels, level):
    args = _args(bench_levels, level)
    before = lg.launch_count
    Tk, sk, Hk, gk, wk, bo = lg.level_gn(*args)
    torch.cuda.synchronize()
    assert lg.launch_count == before + 1
    Tp, sp, Hp, gp, wp, _ = lg.level_gn_reference(*args)
    # same inputs, same device: only the order of float32 sums differs
    np.testing.assert_allclose(Tk.cpu(), Tp.cpu(), atol=1e-4)
    sk, sp = sk.cpu().numpy(), sp.cpu().numpy()
    assert sk[3] == sp[3] and sk[6] == sp[6] == 1.0 and sk[7] == sp[7]
    assert abs(sk[0] - sp[0]) <= 1
    np.testing.assert_allclose(sk[4], sp[4], rtol=1e-2)
    np.testing.assert_allclose(Hk.cpu(), Hp.cpu(),
                               atol=1e-2 * float(Hp.abs().max()))
    assert wk.shape == wp.shape and int(bo) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("change", [
    {"loss": LossFunctionType.L2}, {"interp": InterpolationType.COSINE},
    {"channels": 3}])
def test_level_gn_kernel_options_match_plain(bench_levels, change):
    """Paths the bench levels do not take: the L2 loss, cosine
    interpolation, and C=3 (scaled copies of the channel, as in
    tests/test_pallas.py's multichannel cases)."""
    import dataclasses
    args = list(_args(bench_levels, 1))
    change = dict(change)
    if change.pop("channels", 1) == 3:
        ch, px, J = args[5], args[3], args[4]
        args[5] = torch.cat([ch, ch * 0.5, ch * 2.0])
        args[3] = torch.cat([px, px * 0.5, px * 2.0])
        args[4] = torch.cat([J, J * 0.5, J * 2.0])
    args[-1] = dataclasses.replace(args[-1], **change)
    Tk, sk, Hk, _, wk, _ = lg.level_gn(*args)
    Tp, sp, Hp, _, wp, _ = lg.level_gn_reference(*args)
    np.testing.assert_allclose(Tk.cpu(), Tp.cpu(), atol=1e-4)
    sk, sp = sk.cpu().numpy(), sp.cpu().numpy()
    assert sk[3] == sp[3] and sk[6] == sp[6] == 1.0
    assert abs(sk[0] - sp[0]) <= 1 and sk[0] >= 2
    assert wk.shape == wp.shape == args[3].shape


@pytest.mark.gpu
def test_level_gn_kernel_one_iteration_tight(bench_levels):
    """One iteration at the finest level: the first linearization's sigma,
    weights and normal equations match the plain version tightly."""
    import dataclasses
    args = list(_args(bench_levels, 0))
    args[-1] = dataclasses.replace(args[-1], max_iterations=1)
    Tk, sk, Hk, gk, wk, _ = lg.level_gn(*args)
    Tp, sp, Hp, gp, wp, _ = lg.level_gn_reference(*args)
    np.testing.assert_allclose(sk[4].item(), sp[4].item(), rtol=1e-3)
    np.testing.assert_allclose(Hk.cpu(), Hp.cpu(), rtol=1e-3,
                               atol=1e-4 * float(Hp.abs().max()))
    np.testing.assert_allclose(gk.cpu(), gp.cpu(), rtol=1e-3,
                               atol=1e-4 * float(gp.abs().max()))
    np.testing.assert_allclose(wk.cpu(), wp.cpu(), atol=1e-3)
    np.testing.assert_allclose(Tk.cpu(), Tp.cpu(), atol=1e-5)


@pytest.mark.gpu
def test_level_gn_kernel_bitwise_repeatable(bench_levels):
    """Fixed-tree reductions without atomics: two runs agree bit for bit."""
    a = lg.level_gn(*_args(bench_levels, 0))
    b = lg.level_gn(*_args(bench_levels, 0))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.gpu
def test_level_gn_rejects_what_the_kernel_cannot_take(bench_levels):
    args = list(_args(bench_levels, 1))
    bad = list(args)
    bad[1] = args[1].double()
    with pytest.raises(ValueError):
        lg.level_gn(*bad)
    bad = list(args)
    bad[4] = torch.cat([args[4], args[4]], -1)[..., ::2]   # strided jacobians
    assert not bad[4].is_contiguous()
    with pytest.raises(ValueError):
        lg.level_gn(*bad)
    bad = list(args)
    bad[6] = args[6].cpu()
    with pytest.raises(ValueError):
        lg.level_gn(*bad)


@pytest.mark.gpu
def test_device_vo_on_cuda_counts_launches(cuda):
    """A short run of the full step on the card: finite poses near the
    known motion, and one kernel launch per level solve."""
    K, b, frames = synthetic.synthesize_sequence(4)
    vo = device_vo.DeviceVO(K, b, (synthetic.ROWS, synthetic.COLS),
                            AlgorithmParameters(**BENCH_PARAMS), device=cuda)
    before = lg.launch_count
    outs = vo.add_frames(np.stack([f[0] for f in frames]),
                         np.stack([f[1] for f in frames]))
    n_kf = int(outs.is_keyframe.sum())
    assert lg.launch_count - before == 3 * 4 + n_kf * 2
    step_inv = torch.as_tensor(np.linalg.inv(synthetic.step_pose()),
                               dtype=torch.float32)
    err = se3.log(outs.pose.cpu() @ step_inv).abs().max()
    assert torch.isfinite(outs.pose).all() and float(err) < 1e-3


# ---------------------------------------------------------------------------
# the stereo Bit-Planes path: census, SGM aggregation, level_gn at C=8
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bitplanes_levels(cuda):
    """conf/kitti_bitplanes.cfg: templates from the stereo pair of frame 0
    (SGM disparity on the card), Bit-Planes channels of frame 1."""
    cf = ConfigFile(CONF)
    K, b, frames = synthetic.synthesize_stereo_sequence(2)
    vo = device_vo.DeviceVO(
        K, b, (synthetic.ROWS, synthetic.COLS),
        AlgorithmParameters.from_config(cf), device=cuda,
        stereo_fn=stereo.create_stereo_algorithm(cf).as_fn())
    vo.init(frames[0][0], frames[0][1])
    channels = device_vo._compute_channels_pyr(
        torch.as_tensor(frames[1][0]).to(cuda), vo._p, 4)
    return vo, channels


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(376, 1241), (5, 7), (2, 3, 33)])
def test_census_kernel_matches_plain(cuda, shape):
    """Bit for bit, on an image quantized to ties; a leading axis is one
    launch per image."""
    r = np.random.default_rng(0)
    x = torch.as_tensor(np.round(r.uniform(0, 4, shape)).astype(np.float32),
                        device=cuda)
    before = census.launch_count
    got = census.census_planes(x)
    torch.cuda.synchronize()
    n_images = int(np.prod(shape[:-2])) if len(shape) > 2 else 1
    assert census.launch_count == before + n_images
    assert torch.equal(got, census.census_planes_reference(x))
    assert torch.equal(census.census(x), census.census(x.cpu()).to(cuda))


def _int_cost(shape, seed=0):
    r = np.random.default_rng(seed)
    return r.integers(0, 9, shape).astype(np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [128, 256, 48, 32, 100, 7])
def test_sgm_kernel_bitwise_integer(cuda, D):
    """Integer costs and penalties: every lane layout (D/32 per lane, with
    and without the float4 path, a partial last lane) equals the plain
    version bit for bit, in all 4 directions and in the first alone."""
    cost = torch.as_tensor(_int_cost((23, 37, D)), device=cuda)
    before = sgm.launch_count
    got = sgm.aggregate_4dir(cost, 2.0, 8.0)
    one = sgm.aggregate_direction(cost, 2.0, 8.0)
    torch.cuda.synchronize()
    assert sgm.launch_count == before + 2
    assert torch.equal(got, sgm.aggregate_4dir_reference(cost, 2.0, 8.0))
    assert torch.equal(one, sgm.aggregate_direction_reference(cost, 2.0,
                                                              8.0))


@pytest.mark.gpu
def test_sgm_kernel_real_penalties(cuda):
    """tests/test_pallas.py's case, uniform real costs, p1=1.0, p2=8.0:
    the same operations in the same order, held at its atol 1e-4."""
    r = np.random.default_rng(1)
    cost = torch.as_tensor(r.uniform(0, 8, (16, 20, 128)).astype(np.float32),
                           device=cuda)
    np.testing.assert_allclose(
        sgm.aggregate_4dir(cost, 1.0, 8.0).cpu(),
        sgm.aggregate_4dir_reference(cost, 1.0, 8.0).cpu(), atol=1e-4)


@pytest.mark.gpu
def test_sgm_rejects_what_the_kernel_cannot_take(cuda):
    cost = torch.zeros(8, 9, 32, device=cuda)
    for bad in (cost.double(), cost.transpose(0, 1),
                torch.zeros(8, 9, 300, device=cuda), cost[None]):
        with pytest.raises(ValueError):
            sgm.aggregate_4dir(bad, 2.0, 8.0)


@pytest.mark.gpu
def test_matcher_on_cuda_matches_cpu(cuda):
    """The whole matcher on a 120x320 crop of the stereo pair, D=64: the
    card's disparity equals the CPU's plain versions bit for bit."""
    _, _, frames = synthetic.synthesize_stereo_sequence(1)
    L, R = (np.ascontiguousarray(a[100:220, 400:720]) for a in frames[0][:2])
    m = stereo.TpuSGM(num_disparities=64)
    got = m.as_fn()(torch.as_tensor(L, device=cuda),
                    torch.as_tensor(R, device=cuda)).cpu()
    assert torch.equal(got, torch.as_tensor(m.run(L, R)))
    assert float((got > 0).float().mean()) > 0.5


@pytest.mark.gpu
@pytest.mark.parametrize("level", range(4))
def test_level_gn_kernel_c8_matches_plain(bitplanes_levels, level):
    """C=8 Bit-Planes channels at the 4 level shapes: one iteration tight,
    converged at the tolerances of the C=1 levels."""
    import dataclasses
    vo, channels = bitplanes_levels
    td = vo.state.templates[level]
    assert td.pixels.shape[0] == 8
    args = [vo._cams[level], td.points, td.valid, td.pixels, td.jacobians,
            channels[level], torch.eye(4, device=channels[0].device), 1.0,
            1e10, td.norm_scale, td.norm_center, vo._opts[level]]
    one = args[:-1] + [dataclasses.replace(args[-1], max_iterations=1)]
    _, sk, Hk, gk, wk, _ = lg.level_gn(*one)
    _, sp, Hp, gp, wp, _ = lg.level_gn_reference(*one)
    np.testing.assert_allclose(sk[4].item(), sp[4].item(), rtol=1e-3)
    np.testing.assert_allclose(Hk.cpu(), Hp.cpu(), rtol=1e-3,
                               atol=1e-4 * float(Hp.abs().max()))
    np.testing.assert_allclose(wk.cpu(), wp.cpu(), atol=1e-3)
    Tk, sk, Hk, _, _, _ = lg.level_gn(*args)
    Tp, sp, Hp, _, _, _ = lg.level_gn_reference(*args)
    np.testing.assert_allclose(Tk.cpu(), Tp.cpu(), atol=1e-4)
    sk, sp = sk.cpu().numpy(), sp.cpu().numpy()
    assert sk[3] == sp[3] and sk[6] == sp[6] == 1.0 and sk[0] == sp[0]
    np.testing.assert_allclose(sk[4], sp[4], rtol=1e-2)


@pytest.mark.gpu
def test_stereo_bitplanes_vo_on_cuda_counts_launches(cuda):
    """conf/kitti_bitplanes.cfg over 1+3 stereo pairs on the card: finite
    poses near the known motion; census levels x frames + 2 per matcher
    call, one SGM launch set per matcher call, one level_gn per solve."""
    cf = ConfigFile(CONF)
    K, b, frames = synthetic.synthesize_stereo_sequence(4)
    vo = device_vo.DeviceVO(
        K, b, (synthetic.ROWS, synthetic.COLS),
        AlgorithmParameters.from_config(cf), device=cuda,
        stereo_fn=stereo.create_stereo_algorithm(cf).as_fn())
    before = (lg.launch_count, census.launch_count, sgm.launch_count)
    outs = vo.add_frames(np.stack([f[0] for f in frames]),
                         np.stack([f[1] for f in frames]))
    n_kf = int(outs.is_keyframe.sum())
    assert lg.launch_count - before[0] == 3 * 4 + n_kf * 2
    assert census.launch_count - before[1] == 4 * 4 + 2 * (1 + n_kf)
    assert sgm.launch_count - before[2] == 1 + n_kf
    step_inv = torch.as_tensor(np.linalg.inv(synthetic.step_pose()),
                               dtype=torch.float32)
    err = se3.log(outs.pose.cpu() @ step_inv).abs().max()
    assert torch.isfinite(outs.pose).all() and float(err) < 2e-2
