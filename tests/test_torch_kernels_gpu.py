"""The hand-written CUDA kernels against their plain PyTorch versions on the
card, at the shapes of the bench's main path.  Marked ``gpu``: without a
CUDA device they skip (the decision is made in a fixture, so every test
worker collects the same tests).  On a machine with an NVIDIA GPU (no JAX
needed):

    python -m pytest --noconftest -o "markers=gpu: needs a CUDA device" \\
        -m gpu tests/test_torch_kernels_gpu.py
"""
import json
import os

import numpy as np
import pytest
import torch

from bpvo_tpu_torch import (AlgorithmParameters, ConfigFile, DescriptorType,
                            InterpolationType, LossFunctionType)
from bpvo_tpu_torch.core import se3
from bpvo_tpu_torch.data import stereo, synthetic
from bpvo_tpu_torch.ops import census, census_cost
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


@pytest.fixture(scope="module")
def stereo_codes(cuda):
    """The packed census codes of the 376x1241 stereo pair of frame 0, on
    the card, and the pair itself."""
    _, _, frames = synthetic.synthesize_stereo_sequence(1)
    L, R = (torch.as_tensor(a, device=cuda) for a in frames[0][:2])
    codes = census.census(torch.stack([L, R]))
    return codes[0], codes[1], L, R


@pytest.mark.gpu
def test_census_cost_kernel_matches_plain(stereo_codes):
    """Bit for bit at the matcher's shape, 376x1241 and D = 128, on real
    census codes; one launch a call."""
    cl, cr, _, _ = stereo_codes
    before = census_cost.launch_count
    got = census_cost.census_cost_volume(cl, cr, 128)
    torch.cuda.synchronize()
    assert census_cost.launch_count == before + 1
    assert got.shape == (376, 1241, 128) and got.is_contiguous()
    assert torch.equal(got, census_cost.census_cost_volume_reference(cl, cr,
                                                                     128))
    assert torch.equal(stereo.census_cost_volume(cl, cr, 128), got)


@pytest.mark.gpu
@pytest.mark.parametrize("H, W", [(1, 1), (3, 31), (5, 33), (7, 100),
                                  (4, 150), (2, 1241)])
@pytest.mark.parametrize("D", [1, 7, 48, 128, 200])
def test_census_cost_kernel_edges(cuda, H, W, D):
    """Random codes: D not a multiple of 4 (a scalar head and tail), W not
    a multiple of the 32-column tile, W < D, one row or column."""
    r = np.random.default_rng(H * 100003 + W * 101 + D)
    cl, cr = (torch.as_tensor(r.integers(0, 256, (H, W)).astype(np.uint8),
                              device=cuda) for _ in range(2))
    got = census_cost.census_cost_volume(cl, cr, D)
    torch.cuda.synchronize()
    assert torch.equal(got, census_cost.census_cost_volume_reference(cl, cr,
                                                                     D))


@pytest.mark.gpu
def test_census_cost_kernel_graph_replay_equals_eager(stereo_codes):
    """Captured in a CUDA graph (on the current stream, nothing synced)
    and replayed on new codes, it equals the eager call."""
    cl, cr, _, _ = stereo_codes
    a, b = cl.clone(), cr.clone()
    census_cost.census_cost_volume(a, b, 128)         # warm-up
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = census_cost.census_cost_volume(a, b, 128)
    a.copy_(cr)
    b.copy_(cl)
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, census_cost.census_cost_volume(cr, cl, 128))


@pytest.mark.gpu
def test_matcher_with_the_kernel_equals_the_plain_cost(stereo_codes):
    """``TpuSGM.as_fn()`` at 376x1241, D = 128: the disparity equals the
    same pipeline built on the plain cost volume, bit for bit."""
    cl, cr, L, R = stereo_codes
    m = stereo.TpuSGM(num_disparities=128)
    cost = census_cost.census_cost_volume_reference(cl, cr, 128)
    want = stereo._wta_subpixel(sgm.aggregate_4dir(cost, m.p1, m.p2), 128)
    assert torch.equal(m.as_fn()(L, R), want)


@pytest.mark.gpu
def test_census_cost_rejects_what_the_kernel_cannot_take(cuda):
    c = torch.zeros(8, 9, dtype=torch.uint8, device=cuda)
    for bad_l, bad_r, D in ((c.to(torch.int16), c, 4),
                            (torch.zeros(9, 8, dtype=torch.uint8,
                                         device=cuda).t(), c, 4),
                            (c, c[:, :8], 4), (c, c.cpu(), 4), (c[None], c, 4),
                            (c, c, 0),
                            (c, c, census_cost.MAX_DISPARITIES + 1)):
        with pytest.raises(ValueError):
            census_cost.census_cost_volume(bad_l, bad_r, D)


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
@pytest.mark.parametrize("H, W", [(1, 1), (1, 37), (23, 1), (5, 7), (8, 8),
                                  (12, 12), (8, 37), (23, 8), (16, 24),
                                  (19, 45), (24, 13)])
@pytest.mark.parametrize("D", [7, 32, 48, 100, 128, 256])
def test_sgm_two_pass_edges_bitwise(cuda, H, W, D):
    """The carry pass and the tile pass at the tile's edges (8x8): images
    that are not a multiple of the tile, smaller than one tile, one row or
    column, a line exactly one or a few tiles long.  Integer costs with
    p1 = 2, p2 = 8 and uniform real costs with p1 = 1, p2 = 8 equal the
    plain versions bit for bit: the re-run from a carry repeats the
    operations of the single scan in its order, and the sum keeps its
    order."""
    r = np.random.default_rng(H * 1000 + W * 10 + D)
    for cost, p1 in ((_int_cost((H, W, D), H + W), 2.0),
                     (r.uniform(0, 8, (H, W, D)).astype(np.float32), 1.0)):
        cost = torch.as_tensor(cost, device=cuda)
        got = sgm.aggregate_4dir(cost, p1, 8.0)
        one = sgm.aggregate_direction(cost, p1, 8.0)
        torch.cuda.synchronize()
        assert torch.equal(got, sgm.aggregate_4dir_reference(cost, p1, 8.0))
        assert torch.equal(one, sgm.aggregate_direction_reference(cost, p1,
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
        with pytest.raises(ValueError):
            sgm.disparity_4dir(bad, 2.0, 8.0)


def _winner_cases(H, W, D, seed):
    """Cost volumes for the tile pass's winner: integer costs with ties, a
    constant volume (every winner d = 0, so -1), the minimum at d = D - 1
    (the clamped c2) and at d = 1 (the clamped c0), each with p1 = 2; and
    uniform real costs with p1 = 1."""
    r = np.random.default_rng(seed)
    last = r.integers(4, 9, (H, W, D)).astype(np.float32)
    last[..., -1] = 0.0
    one = r.integers(4, 9, (H, W, D)).astype(np.float32)
    one[..., min(1, D - 1)] = 0.0
    return [(_int_cost((H, W, D), seed), 2.0),
            (np.full((H, W, D), 3.0, np.float32), 2.0),
            (last, 2.0), (one, 2.0),
            (r.uniform(0, 8, (H, W, D)).astype(np.float32), 1.0)]


@pytest.mark.gpu
@pytest.mark.parametrize("H, W", [(23, 37), (8, 8), (1, 45), (19, 1),
                                  (13, 21)])
@pytest.mark.parametrize("D", [32, 64, 96, 128, 256, 7, 48, 200])
def test_sgm_winner_equals_the_plain_winner(cuda, H, W, D):
    """``disparity_4dir`` on the card equals ``_wta_subpixel`` of
    ``aggregate_4dir`` bit for bit: every lane layout, H and W not a
    multiple of the 8x8 tile, ties (the first index), the clamped
    neighbours at d = 1 and d = D - 1, real costs with p1 = 1.  Each call
    counts one launch set and one winner."""
    for k, (cost, p1) in enumerate(_winner_cases(H, W, D, H * W + D)):
        cost = torch.as_tensor(cost, device=cuda)
        before = (sgm.launch_count, sgm.winner_count.launch_count)
        got = sgm.disparity_4dir(cost, p1, 8.0)
        torch.cuda.synchronize()
        assert (sgm.launch_count, sgm.winner_count.launch_count) == (
            before[0] + 1, before[1] + 1)
        assert got.shape == (H, W) and got.dtype == torch.float32
        want = stereo._wta_subpixel(sgm.aggregate_4dir(cost, p1, 8.0), D)
        assert torch.equal(got, want), k
        assert torch.equal(got, sgm.disparity_4dir_reference(cost, p1, 8.0)
                           ), k
        if k == 1:
            assert bool((got == -1).all())


@pytest.mark.gpu
def test_matcher_replayed_equals_eager(stereo_codes):
    """``TpuSGM.as_fn()`` at 376x1241, D = 128, through ``GraphCache.jit``:
    the replayed disparity equals the eager call bit for bit, and a replay
    advances the launch and winner counts by one each."""
    from bpvo_tpu_torch.utils import graphs
    _, _, L, R = stereo_codes
    fn = stereo.TpuSGM(num_disparities=128).as_fn()
    eager = fn(L, R)
    cache = graphs.GraphCache(L.device)
    for _ in range(2):       # warm-up and capture, then a replay
        cache.jit("sgm", (L, R), lambda b: fn(*b))
    before = (sgm.launch_count, sgm.winner_count.launch_count)
    replayed = cache.jit("sgm", (L, R), lambda b: fn(*b))
    assert (sgm.launch_count, sgm.winner_count.launch_count) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(replayed, eager)
    swapped = cache.jit("sgm", (R, L), lambda b: fn(*b))
    assert torch.equal(swapped, fn(R, L))


@pytest.mark.gpu
def test_matcher_on_cuda_matches_cpu(cuda):
    """The whole matcher on a 120x320 crop of the stereo pair, D=64: the
    card's disparity equals the CPU's plain versions bit for bit."""
    _, _, frames = synthetic.synthesize_stereo_sequence(1)
    L, R = (np.ascontiguousarray(a[100:220, 400:720]) for a in frames[0][:2])
    m = stereo.TpuSGM(num_disparities=64)
    got = m.as_fn()(torch.as_tensor(L, device=cuda),
                    torch.as_tensor(R, device=cuda)).cpu()
    assert torch.equal(got, torch.as_tensor(m.run(L, R, device="cpu")))
    # run() on the card by default, from numpy or from tensors on the card
    assert torch.equal(got, torch.as_tensor(m.run(L, R)))
    assert torch.equal(got, torch.as_tensor(m.run(
        torch.as_tensor(L, device=cuda), torch.as_tensor(R, device=cuda))))
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


def _level_args(levels, level, K=None):
    """level_gn's arguments at ``level`` of a fixture's templates, from the
    identity pose; with ``K``, the template's first K points only."""
    vo, channels = levels
    td = vo.state.templates[level]
    pts, valid, pix, jac = td.points, td.valid, td.pixels, td.jacobians
    if K is not None:
        pts, valid = pts[:K].contiguous(), valid[:K].contiguous()
        pix, jac = pix[:, :K].contiguous(), jac[:, :K].contiguous()
    return [vo._cams[level], pts, valid, pix, jac, channels[level],
            torch.eye(4, device=channels[0].device), 1.0, 1e10,
            td.norm_scale, td.norm_center, vo._opts[level]]


def _one_iteration(args):
    import dataclasses
    return args[:-1] + [dataclasses.replace(args[-1], max_iterations=1)]


@pytest.fixture(scope="module")
def eight_levels(bench_levels, bitplanes_levels):
    """The 8 bench level shapes: C=1 and C=8 at K = 16384/4096/1024/512."""
    return {(name, level): levels for name, levels in
            (("intensity", bench_levels), ("bitplanes", bitplanes_levels))
            for level in range(4)}


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["intensity", "bitplanes"])
@pytest.mark.parametrize("level", range(4))
def test_level_gn_first_sigma_equals_plain(eight_levels, path, level):
    """The first linearization's sigma is the plain version's bit for bit
    at any cluster size: integer counts, a count and a max reduce in any
    order, and the residuals round as the plain version's."""
    args = _one_iteration(_level_args(eight_levels[path, level], level))
    sk = lg.level_gn(*args)[1]
    sp = lg.level_gn_reference(*args)[1]
    assert sk[4].item() == sp[4].item()
    assert sk[0].item() == sp[0].item() == 1


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["intensity", "bitplanes"])
@pytest.mark.parametrize("level", range(4))
def test_level_gn_cluster_size_rule(eight_levels, path, level):
    """One CTA up to 512 points, else one per 256 points, at most 16: 16 /
    16 / 4 / 1 CTAs at the bench levels (and 16 / 8 at the dense L2 / L3,
    K = 8192 / 2048); one launch counted per call."""
    args = _level_args(eight_levels[path, level], level)
    K = args[1].shape[0]
    assert K == (16384, 4096, 1024, 512)[level]
    assert lg.n_ctas(K) == (16, 16, 4, 1)[level]
    assert [lg.n_ctas(k) for k in (1, 512, 513, 2048, 8192, 10 ** 6)] == \
        [1, 1, 3, 8, 16, 16]
    before = lg.launch_count
    lg.level_gn(*args)
    torch.cuda.synchronize()
    assert lg.launch_count == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["intensity", "bitplanes"])
@pytest.mark.parametrize("K, ctas", [(12345, 16), (3001, 12)])
def test_level_gn_ragged_k_matches_plain(eight_levels, path, K, ctas):
    """The first K points of the finest template: clusters whose last
    chunk is short, 12 CTAs also a size that is no power of two."""
    args = _level_args(eight_levels[path, 0], 0, K=K)
    assert lg.n_ctas(K) == ctas
    one = _one_iteration(args)
    assert lg.level_gn(*one)[1][4].item() == \
        lg.level_gn_reference(*one)[1][4].item()
    Tk, sk, Hk, _, wk, _ = lg.level_gn(*args)
    Tp, sp, Hp, _, wp, _ = lg.level_gn_reference(*args)
    np.testing.assert_allclose(Tk.cpu(), Tp.cpu(), atol=1e-4)
    sk, sp = sk.cpu().numpy(), sp.cpu().numpy()
    assert sk[0] == sp[0] and sk[3] == sp[3] and sk[6] == sp[6] == 1.0
    np.testing.assert_allclose(sk[4], sp[4], rtol=1e-2)
    np.testing.assert_allclose(Hk.cpu(), Hp.cpu(),
                               atol=1e-2 * float(Hp.abs().max()))
    assert wk.shape == wp.shape == (args[3].shape[0], K)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["c9", "k32768"])
def test_level_gn_scratch_path_matches_plain(bench_levels, dense_intensity,
                                             case):
    """Inputs beyond a thread's registers go through the (C, K) scratch:
    9 channels (scaled copies of the bench L1 channel), or the dense L1
    template's 32768 points (2048 a CTA at 16 CTAs)."""
    if case == "c9":
        args = list(_args(bench_levels, 1))
        scale = [1.0 + 0.25 * i for i in range(9)]
        for i in (3, 4, 5):        # pixels, jacobians, channels
            args[i] = torch.cat([args[i] * s for s in scale]).contiguous()
    else:
        td, ch, opts = dense_intensity[1][:3]
        K, b, _ = synthetic.synthesize_sequence(1)
        cam = device_vo.DeviceVO(K, b, (synthetic.ROWS, synthetic.COLS),
                                 AlgorithmParameters(**DENSE),
                                 device=ch.device)._cams[1]
        args = [cam, td.points, td.valid, td.pixels, td.jacobians, ch,
                torch.eye(4, device=ch.device), 1.0, 1e10, td.norm_scale,
                td.norm_center, opts]
        assert td.points.shape[0] == 32768 and lg.n_ctas(32768) == 16
    one = _one_iteration(args)
    assert lg.level_gn(*one)[1][4].item() == \
        lg.level_gn_reference(*one)[1][4].item()
    Tk, sk, _, _, wk, _ = lg.level_gn(*args)
    Tp, sp, _, _, wp, _ = lg.level_gn_reference(*args)
    np.testing.assert_allclose(Tk.cpu(), Tp.cpu(), atol=1e-4)
    sk, sp = sk.cpu().numpy(), sp.cpu().numpy()
    assert sk[3] == sp[3] and sk[6] == sp[6] == 1.0
    assert abs(sk[0] - sp[0]) <= 1
    np.testing.assert_allclose(sk[4], sp[4], rtol=1e-2)
    assert wk.shape == wp.shape == args[3].shape


@pytest.mark.gpu
def test_level_gn_c8_bitwise_repeatable(bitplanes_levels):
    """The C=8 finest level on a cluster of 16 CTAs: DSMEM reductions in
    rank order, no atomics, so two runs agree bit for bit."""
    args = _level_args(bitplanes_levels, 0)
    assert lg.n_ctas(args[1].shape[0]) == 16
    for x, y in zip(lg.level_gn(*args), lg.level_gn(*args)):
        assert torch.equal(x, y)


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


# ---------------------------------------------------------------------------
# the per-iteration route: fused_linearize, irls_reduce, gauss_newton.run
# ---------------------------------------------------------------------------

DENSE = dict(BENCH_PARAMS, minNumPixelsForNonMaximaSuppression=20000000,
             pointCapacity=131072)


def _dense_level(cuda, descriptor, level):
    """Dense VO (NMS off, 131072 points at L0) on the 376x1241 sequence:
    the template of frame 0 at ``level``, frame 1's channels there, the
    warp's sample points at the identity pose and a sigma from them."""
    from bpvo_tpu_torch.ops import interp
    from bpvo_tpu_torch.solver import mestimator
    from bpvo_tpu_torch.vo import template_data, warp
    K, b, frames = synthetic.synthesize_sequence(2)
    vo = device_vo.DeviceVO(K, b, (synthetic.ROWS, synthetic.COLS),
                            AlgorithmParameters(**dict(
                                DENSE, descriptor=descriptor)), device=cuda)
    vo.init(*frames[0])
    ch = device_vo._compute_channels_pyr(
        torch.as_tensor(frames[1][0]).to(cuda), vo._p, 4)[level]
    td, cam, opts = vo.state.templates[level], vo._cams[level], vo._opts[level]
    u, v, Z = warp.project(cam, torch.eye(4, device=cuda), td.points)
    ok = td.valid & (Z > 1e-6) & interp.valid_mask(u, v, ch.shape[1],
                                                   ch.shape[2], opts.interp)
    r, _ = template_data.compute_residuals(td, ch, cam,
                                           torch.eye(4, device=cuda),
                                           opts.interp)
    sigma = mestimator.estimate_scale(r[0], ok)
    return td, ch, opts, u, v, ok, r, sigma


@pytest.fixture(scope="module")
def dense_intensity(cuda):
    return {lvl: _dense_level(cuda, DescriptorType.INTENSITY, lvl)
            for lvl in (0, 1)}


@pytest.fixture(scope="module")
def dense_bitplanes(cuda):
    return {lvl: _dense_level(cuda, DescriptorType.BITPLANES, lvl)
            for lvl in (0, 1)}


def _close(a, b, rel):
    """|a - b| <= rel * max|b|, elementwise."""
    a, b = a.cpu(), b.cpu()
    assert float((a - b).abs().max()) <= rel * float(b.abs().max()) + 1e-30


def _check_fused(td, ch, opts, u, v, ok, sigma, channels=None):
    from bpvo_tpu_torch.ops import fused_linearize as fl
    from bpvo_tpu_torch.solver import mestimator
    n = ch.shape[0] if channels is None else channels
    args = (u, v, ok, ch[:n], td.pixels[:n], td.jacobians[:n], sigma,
            opts.loss, opts.interp)
    before = fl.launch_count
    H, g, f, r0, w = fl.fused_linearize(*args)
    torch.cuda.synchronize()
    assert fl.launch_count == before + 1
    Hp, gp, fp, r0p, wp = fl.fused_linearize_reference(*args)
    # r0 bit for bit, so the histogram median gives the same sigma
    assert torch.equal(r0.view(torch.int32), r0p.view(torch.int32))
    assert torch.equal(mestimator.estimate_scale(r0, ok),
                       mestimator.estimate_scale(r0p, ok))
    assert float((w - wp).abs().max()) <= 1e-6
    for a, b in ((H, Hp), (g, gp), (f, fp)):
        _close(a, b, 1e-4)
    return H, g, f, r0, w


@pytest.mark.gpu
@pytest.mark.parametrize("level", (0, 1))
def test_fused_linearize_kernel_matches_plain_c1(dense_intensity, level):
    td, ch, opts, u, v, ok, _, sigma = dense_intensity[level]
    assert td.pixels.shape == (1, 131072 >> (2 * level))
    _check_fused(td, ch, opts, u, v, ok, sigma)


@pytest.mark.gpu
@pytest.mark.parametrize("level", (0, 1))
def test_fused_linearize_kernel_matches_plain_c8(dense_bitplanes, level):
    """All 8 Bit-Planes channels, and the channel-0 pass gauss_newton.run
    makes for sigma."""
    td, ch, opts, u, v, ok, _, sigma = dense_bitplanes[level]
    assert td.pixels.shape[0] == 8
    _check_fused(td, ch, opts, u, v, ok, sigma)
    _check_fused(td, ch, opts, u, v, ok, sigma, channels=1)


@pytest.mark.gpu
@pytest.mark.parametrize("change", [
    {"loss": LossFunctionType.HUBER, "interp": InterpolationType.COSINE},
    {"loss": LossFunctionType.L2}])
def test_fused_linearize_kernel_options_match_plain(dense_intensity, change):
    import dataclasses
    td, ch, opts, u, v, ok, _, sigma = dense_intensity[1]
    opts = dataclasses.replace(opts, **change)
    from bpvo_tpu_torch.ops import fused_linearize as fl
    args = (u, v, ok, ch, td.pixels, td.jacobians, sigma, opts.loss,
            opts.interp)
    H, g, f, r0, w = fl.fused_linearize(*args)
    Hp, gp, fp, r0p, wp = fl.fused_linearize_reference(*args)
    # cosf on the card and torch.cos may differ in the last bit
    np.testing.assert_allclose(r0.cpu(), r0p.cpu(), rtol=1e-5, atol=1e-4)
    assert float((w - wp).abs().max()) <= 1e-5
    for a, b in ((H, Hp), (g, gp), (f, fp)):
        _close(a, b, 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("loss", [LossFunctionType.TUKEY,
                                  LossFunctionType.HUBER,
                                  LossFunctionType.L2])
@pytest.mark.parametrize("channels", (1, 8))
def test_irls_reduce_kernel_matches_plain(dense_bitplanes, loss, channels):
    """M = K (channel 0) and M = 8K (all channels) at L0."""
    from bpvo_tpu_torch.ops import irls
    td, ch, opts, u, v, ok, r, sigma = dense_bitplanes[0]
    J = td.jacobians[:channels].reshape(-1, 6)
    rr = r[:channels].reshape(-1)
    valid = ok.expand(channels, -1).reshape(-1)
    before = irls.launch_count
    H, g, f, w = irls.irls_reduce_w(J, rr, valid, sigma, loss)
    H2, g2, f2 = irls.irls_reduce(J, rr, valid, sigma, loss)
    torch.cuda.synchronize()
    assert irls.launch_count == before + 2
    Hp, gp, fp, wp = irls.irls_reduce_reference(J, rr, valid, sigma, loss)
    assert float((w - wp).abs().max()) <= 1e-6
    for a, b in ((H, Hp), (g, gp), (f, fp)):
        _close(a, b, 1e-4)
    for a, b in ((H2, H), (g2, g), (f2, f)):     # the same sums, bit for bit
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_gn_kernels_bitwise_repeatable(dense_bitplanes):
    from bpvo_tpu_torch.ops import fused_linearize as fl
    from bpvo_tpu_torch.ops import irls
    td, ch, opts, u, v, ok, r, sigma = dense_bitplanes[0]
    args = (u, v, ok, ch, td.pixels, td.jacobians, sigma, opts.loss,
            opts.interp)
    for x, y in zip(fl.fused_linearize(*args), fl.fused_linearize(*args)):
        assert torch.equal(x, y)
    a = (td.jacobians.reshape(-1, 6), r.reshape(-1),
         ok.expand(8, -1).reshape(-1), sigma, opts.loss)
    for x, y in zip(irls.irls_reduce_w(*a), irls.irls_reduce_w(*a)):
        assert torch.equal(x, y)


@pytest.mark.gpu
def test_gn_kernels_reject_what_they_cannot_take(dense_intensity):
    from bpvo_tpu_torch.ops import fused_linearize as fl
    from bpvo_tpu_torch.ops import irls
    td, ch, opts, u, v, ok, r, sigma = dense_intensity[1]
    args = [u, v, ok, ch, td.pixels, td.jacobians, sigma, opts.loss,
            opts.interp]
    for i, bad in ((0, u.double()), (2, ok.to(torch.uint8)),
                   (3, ch.transpose(1, 2)), (5, td.jacobians.cpu()),
                   (6, torch.ones(2, device=u.device))):
        b = list(args)
        b[i] = bad
        with pytest.raises(ValueError):
            fl.fused_linearize(*b)
    b = list(args)
    b[-1] = InterpolationType.CUBIC
    with pytest.raises(NotImplementedError):
        fl.fused_linearize(*b)
    J = td.jacobians.reshape(-1, 6)
    for bad in ((J.T, r[0], ok), (J, r[0].double(), ok), (J, r[0], ok[:-1])):
        with pytest.raises(ValueError):
            irls.irls_reduce_w(*bad, sigma, opts.loss)


def _offset_copy(x, offset):
    """A contiguous copy of ``x`` that starts ``offset`` floats (or bytes)
    into its storage: a base address that is not 8- or 16-byte aligned."""
    buf = torch.empty(offset + x.numel(), dtype=x.dtype, device=x.device)
    out = buf[offset:].view(x.shape)
    out.copy_(x)
    return out


def _ragged_fused_args(dense, K, C, offset):
    td, ch, opts, u, v, ok, r, sigma = dense[0]
    return (tuple(_offset_copy(x, offset) for x in (
        u[:K], v[:K], ok[:K], ch[:C].contiguous(),
        td.pixels[:C, :K].contiguous(), td.jacobians[:C, :K].contiguous()))
        + (sigma, opts.loss, opts.interp))


@pytest.mark.gpu
@pytest.mark.parametrize("offset", (0, 1))
@pytest.mark.parametrize("C", (1, 8))
@pytest.mark.parametrize("K", (1, 255, 257, 1001, 32769))
def test_fused_linearize_ragged_matches_plain(dense_bitplanes, K, C, offset):
    """Sizes that leave a ragged last tile and, at odd K or a shifted base,
    Jacobian rows that are not 8-byte aligned (read as single floats)."""
    from bpvo_tpu_torch.ops import fused_linearize as fl
    args = _ragged_fused_args(dense_bitplanes, K, C, offset)
    H, g, f, r0, w = fl.fused_linearize(*args)
    Hp, gp, fp, r0p, wp = fl.fused_linearize_reference(*args)
    assert torch.equal(r0.view(torch.int32), r0p.view(torch.int32))
    assert float((w - wp).abs().max()) <= 1e-6
    for a, b in ((H, Hp), (g, gp), (f, fp)):
        _close(a, b, 1e-4)


def _irls_args(dense, M, offset):
    td, ch, opts, u, v, ok, r, sigma = dense[0]
    return (_offset_copy(td.jacobians.reshape(-1, 6)[:M], offset),
            _offset_copy(r.reshape(-1)[:M], offset),
            _offset_copy(ok.expand(8, -1).reshape(-1)[:M], offset),
            sigma, opts.loss)


@pytest.mark.gpu
@pytest.mark.parametrize("offset", (0, 1))
@pytest.mark.parametrize("M", (1, 255, 257, 1001, 32769))
def test_irls_reduce_ragged_matches_plain(dense_bitplanes, M, offset):
    from bpvo_tpu_torch.ops import irls
    args = _irls_args(dense_bitplanes, M, offset)
    H, g, f, w = irls.irls_reduce_w(*args)
    Hp, gp, fp, wp = irls.irls_reduce_reference(*args)
    assert float((w - wp).abs().max()) <= 1e-6
    for a, b in ((H, Hp), (g, gp), (f, fp)):
        _close(a, b, 1e-4)
    for a, b in zip(irls.irls_reduce(*args), (H, g, f)):
        assert torch.equal(a, b)


def _gn_calls(dense_bitplanes, dense_intensity):
    """{name: a call of one GN kernel's wrapper} at the dense shapes."""
    from bpvo_tpu_torch.ops import fused_linearize as fl
    from bpvo_tpu_torch.ops import irls
    td, ch, opts, u, v, ok, r, sigma = dense_bitplanes[0]
    fused8 = (u, v, ok, ch, td.pixels, td.jacobians, sigma, opts.loss,
              opts.interp)
    td1, ch1, opts1, u1, v1, ok1, r1, sigma1 = dense_intensity[1]
    fused1 = (u1, v1, ok1, ch1, td1.pixels, td1.jacobians, sigma1,
              opts1.loss, opts1.interp)
    m1 = (td1.jacobians.reshape(-1, 6), r1.reshape(-1), ok1, sigma1,
          opts1.loss)
    m8 = (td.jacobians.reshape(-1, 6), r.reshape(-1),
          ok.expand(8, -1).reshape(-1), sigma, opts.loss)
    return {"fused_linearize C=8 L0": lambda: fl.fused_linearize(*fused8),
            "fused_linearize C=1 L1": lambda: fl.fused_linearize(*fused1),
            "irls_reduce_w M=K L1": lambda: irls.irls_reduce_w(*m1),
            "irls_reduce M=8K L0": lambda: irls.irls_reduce(*m8)}


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.gpu
def test_gn_kernels_repeat_under_graph_replay(dense_bitplanes,
                                              dense_intensity):
    """Two back-to-back calls and 10 replays of a captured CUDA graph all
    equal the first call bit for bit: the completion ticket resets."""
    for name, call in _gn_calls(dense_bitplanes, dense_intensity).items():
        first = [x.clone() for x in call()]
        second = call()
        torch.cuda.synchronize()
        assert _same(second, first), name
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            outs = call()
        for _ in range(10):
            g.replay()
            torch.cuda.synchronize()
            assert _same(outs, first), name


@pytest.mark.gpu
def test_gn_kernels_interleaved_on_one_stream(dense_bitplanes,
                                              dense_intensity):
    """The kernels launched back to back in turns, with no sync between,
    give what each gives alone."""
    calls = _gn_calls(dense_bitplanes, dense_intensity)
    alone = {}
    for name, call in calls.items():
        alone[name] = [x.clone() for x in call()]
        torch.cuda.synchronize()
    got = [(name, call()) for _ in range(3) for name, call in calls.items()]
    torch.cuda.synchronize()
    for name, outs in got:
        assert _same(outs, alone[name]), name


@pytest.mark.gpu
def test_gn_kernels_on_two_streams_at_once(dense_bitplanes, dense_intensity):
    """Each kernel launched on two streams with no sync between them gives,
    on both, what it gives alone: each stream has its own ticket counter."""
    from bpvo_tpu_torch.ops import _build
    calls = _gn_calls(dense_bitplanes, dense_intensity)
    alone = {name: [x.clone() for x in call()] for name, call in calls.items()}
    torch.cuda.synchronize()
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    counters = {_build.ticket_counter(s).value for s in streams}
    assert len(counters) == 2
    got = []
    for _ in range(5):
        for name, call in calls.items():
            for s in streams:
                with torch.cuda.stream(s):
                    got.append((name, call()))
    torch.cuda.synchronize()
    for name, outs in got:
        assert _same(outs, alone[name]), name


@pytest.mark.gpu
def test_gn_kernels_one_device_kernel_per_call(dense_bitplanes,
                                               dense_intensity):
    """One device kernel per wrapper call: a CUDA graph of the call holds
    one kernel node, the wrapper's kernel."""
    from bpvo_tpu_torch.probes import timing
    for name, call in _gn_calls(dense_bitplanes, dense_intensity).items():
        kernels = timing.device_kernels(call)
        kernel = ("fused_linearize_kernel" if name.startswith("fused")
                  else "irls_reduce_kernel")
        assert len(kernels) == 1 and kernel in kernels[0], (name, kernels)


@pytest.mark.gpu
@pytest.mark.parametrize("descriptor", [DescriptorType.INTENSITY,
                                        DescriptorType.BITPLANES])
def test_run_on_cuda_matches_plain(dense_intensity, dense_bitplanes,
                                   descriptor):
    """gauss_newton.run at the dense L1 (K=32768) through the kernels and,
    on the CPU copies of the same tensors, through the plain versions."""
    from bpvo_tpu_torch.solver import gauss_newton as gn
    from bpvo_tpu_torch.vo import template_data
    levels = (dense_intensity if descriptor == DescriptorType.INTENSITY
              else dense_bitplanes)
    td, ch, opts = levels[1][:3]
    K, b, _ = synthetic.synthesize_sequence(1)
    cam = device_vo.DeviceVO(K, b, (synthetic.ROWS, synthetic.COLS),
                             AlgorithmParameters(**DENSE))._cams[1]
    st = gn.run(td, ch, cam, torch.eye(4, device=ch.device), opts)
    td_cpu = template_data.TemplateData(*(x.cpu() for x in td))
    sp = gn.run(td_cpu, ch.cpu(), cam, torch.eye(4), opts)
    np.testing.assert_allclose(st.T.cpu(), sp.T, atol=1e-4)
    assert abs(int(st.num_iters) - int(sp.num_iters)) <= 1
    assert bool(st.converged) and bool(sp.converged)
    np.testing.assert_allclose(float(st.scale), float(sp.scale), rtol=1e-2)


@pytest.mark.gpu
def test_visual_odometry_on_cuda_counts_launches(cuda):
    """Dense intensity VisualOdometry over 1+3 frames on the card: L0 and
    L1 through gauss_newton.run (one fused_linearize per iteration, one
    irls_reduce per sigma re-estimate), L2 and L3 through level_gn."""
    from bpvo_tpu_torch import VisualOdometry
    from bpvo_tpu_torch.ops import fused_linearize as fl
    from bpvo_tpu_torch.ops import irls
    K, b, frames = synthetic.synthesize_sequence(4)
    vo = VisualOdometry(K, b, (synthetic.ROWS, synthetic.COLS),
                        AlgorithmParameters(**DENSE), device=cuda)
    before = (fl.launch_count, irls.launch_count, lg.launch_count)
    res = [vo.add_frame(*f) for f in frames][1:]
    d_fl, d_irls, d_lg = (fl.launch_count - before[0],
                          irls.launch_count - before[1],
                          lg.launch_count - before[2])
    n_kf = sum(r.is_keyframe for r in res)
    assert d_lg == 2 * len(res)            # L2, L3 of each first estimate
    assert d_fl > 0 and 0 < d_irls <= d_fl
    step_inv = np.linalg.inv(synthetic.step_pose())
    for r in res:
        err = se3.log(torch.as_tensor(r.pose @ step_inv, dtype=torch.float32))
        assert float(err.abs().max()) < 1e-3
    assert vo.num_points_at_level(0) == 131072 and n_kf >= 0


# ---------------------------------------------------------------------------
# the probe microbenchmarks (bpvo_tpu_torch/probes): every kernel and
# variant against its plain version at the JAX scripts' shapes
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("variant", [
    ("cta", None), ("cluster", 2), ("cluster", 4), ("cluster", 8),
    ("cluster", 16), ("grid", None)])
@pytest.mark.parametrize("iters", [0, 7, 1024])
def test_probe_while_loop_bitwise(cuda, variant, iters):
    """Each barrier's loop rounds every step as the plain version does."""
    from bpvo_tpu_torch.probes import kernel_features as kf
    barrier, cluster = variant
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (8, 128)).astype(np.float32), device=cuda)
    before = kf.launch_count[f"while_loop_{barrier}"]
    got = kf.while_loop(x, iters, barrier, cluster or 8)
    torch.cuda.synchronize()
    assert kf.launch_count[f"while_loop_{barrier}"] == before + 1
    assert torch.equal(got, kf.while_loop_reference(x, iters))


@pytest.mark.gpu
@pytest.mark.parametrize("h", [(4.0, 2.0, 5.0), (2.5, 7.0, 1.0),
                               (0.0, 1.0, 3.0)])
def test_probe_scalar_chain_bitwise(cuda, h):
    from bpvo_tpu_torch.probes import kernel_features as kf
    h = torch.tensor(h, device=cuda)
    assert torch.equal(kf.scalar_chain(h), kf.scalar_chain_reference(h))


@pytest.mark.gpu
def test_probe_matmul_chain(cuda):
    from bpvo_tpu_torch.probes import kernel_features as kf
    r = np.random.default_rng(1)
    a = torch.as_tensor(r.uniform(0, 1, (8, 128)).astype(np.float32),
                        device=cuda)
    b = torch.as_tensor(r.uniform(0, 1, (128, 128)).astype(np.float32),
                        device=cuda)
    np.testing.assert_allclose(kf.matmul_chain(a, b).cpu(),
                               kf.matmul_chain_reference(a, b).cpu(),
                               rtol=kf.MATMUL_RTOL)


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [1024, 16384, 384 * 1280, 376 * 1241])
@pytest.mark.parametrize("placement", ["global", "smem", "dsmem"])
def test_probe_take_along_lanes_bitwise(cuda, lanes, placement):
    from bpvo_tpu_torch.probes import gather
    idx, data = (torch.as_tensor(a, device=cuda) for a in gather.lane_inputs(
        np.random.default_rng(lanes), lanes))
    if not gather.fits(lanes, placement):
        with pytest.raises(ValueError):
            gather.take_along_lanes(idx, data, placement)
        return
    before = gather.launch_count[f"take_along_lanes_{placement}"]
    got = gather.take_along_lanes(idx, data, placement)
    torch.cuda.synchronize()
    assert gather.launch_count[f"take_along_lanes_{placement}"] == before + 1
    assert torch.equal(got, gather.take_along_lanes_reference(idx, data))
    bad = idx.clone()
    bad[0, :3] = torch.tensor([-1, lanes, 2 ** 30], dtype=torch.int32)
    got = gather.take_along_lanes(bad, data, placement)
    assert torch.isnan(got[0, :3]).all()
    assert torch.equal(got[:, 3:], gather.take_along_lanes_reference(
        bad, data)[:, 3:])


@pytest.mark.gpu
@pytest.mark.parametrize("points", ["script", "wide"])
@pytest.mark.parametrize("staged", [True, False])
def test_probe_band_bilinear(cuda, staged, points):
    """The script's points, and points over the whole image, most of which
    leave their block's band and sample its clipped rows."""
    from bpvo_tpu_torch.probes import band, gather
    _, U, V, IMG = gather.sampling_inputs(0)
    if points == "wide":
        U, V = band.wide_points(len(U))
    u, v, img = (torch.as_tensor(a, device=cuda) for a in (U, V, IMG))
    got = band.band_bilinear(u, v, img, staged=staged)
    want = band.band_bilinear_reference(u, v, img)
    assert float((got - want).abs().max()) <= band.BAND_ATOL
    if points == "wide":
        moved = (want - band.bilinear_reference(u, v, img)).abs() > 1e-3
        assert float(moved.float().mean()) > 0.5


@pytest.mark.gpu
@pytest.mark.parametrize("part", range(5))
def test_probe_band_parts(cuda, part):
    from bpvo_tpu_torch.probes import band
    name, kernel, plain, keys, exact = band.PARTS[part]
    data = band.part_inputs(cuda)
    args = tuple(data[k] for k in keys)
    before = band.launch_count[f"band_{name}"]
    got = kernel(*args)
    torch.cuda.synchronize()
    assert band.launch_count[f"band_{name}"] == before + 1
    diff = float((got - plain(*args)).abs().max())
    assert diff == 0.0 if exact else diff <= band.BAND_ATOL


@pytest.mark.gpu
def test_probe_kernels_reject_what_they_cannot_take(cuda):
    from bpvo_tpu_torch.probes import band, gather
    from bpvo_tpu_torch.probes import kernel_features as kf
    x = torch.ones(8, 128, device=cuda)
    for call in (lambda: kf.while_loop(x.double()),
                 lambda: kf.while_loop(torch.ones(5000, device=cuda)),
                 lambda: kf.while_loop(x, barrier="cluster", cluster=3),
                 lambda: kf.matmul_chain(x, x),
                 lambda: kf.scalar_chain(torch.ones(4, device=cuda)),
                 lambda: gather.take_along_lanes(
                     torch.zeros(8, 4, dtype=torch.int64, device=cuda), x),
                 lambda: gather.take_along_lanes(
                     torch.zeros(8, 4, dtype=torch.int32, device=cuda),
                     x.t()),
                 lambda: band.band_bilinear(x[0], x[0].cpu(), x),
                 lambda: band.band_bilinear(
                     torch.zeros(1024, device=cuda),
                     torch.zeros(1024, device=cuda),
                     torch.zeros(64, 4000, device=cuda))):
        with pytest.raises(ValueError):
            call()


@pytest.mark.gpu
def test_probe_runner_on_cuda(cuda):
    """The four groups on the card: no step or variant fails, and every
    probe kernel launches."""
    from bpvo_tpu_torch import probes
    probes.reset_launch_counts()
    report = probes.run(device=cuda)
    assert "FAIL" not in json.dumps(report)
    assert all(n > 0 for n in probes.launch_counts().values())
    oks = [v["ok"] for group in report["results"].values()
           for step in group.values() if isinstance(step, dict)
           for v in [step, *step.values()]
           if isinstance(v, dict) and "ok" in v]
    assert len(oks) == 27 and all(oks)


# ---------------------------------------------------------------------------
# the option zoo's new paths: level_gn at C = 3, 5, 10, 48 on the corridor's
# finest level, fused_linearize at C = 3, 5, 10 above 16384 points, and
# irls_reduce_w on the gather route (Bit-Planes under CUBIC_HERMITE)
# ---------------------------------------------------------------------------

CORRIDOR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "conf", "eval_corridor.cfg")
ZOO_C = {3: DescriptorType.INTENSITY_AND_GRADIENT,
         5: DescriptorType.DESCRIPTOR_FIELDS_FIRST_ORDER,
         10: DescriptorType.DESCRIPTOR_FIELDS_SECOND_ORDER,
         48: DescriptorType.CENTRAL_DIFFERENCE}


def _corridor_level0(cuda, **change):
    """(DeviceVO initialised on corridor frame 0 at 240x320, the finest
    level's channels of frame 1) for conf/eval_corridor.cfg's settings with
    ``change``."""
    from bpvo_tpu_torch.data.synthetic import SyntheticCorridorDataset
    p = AlgorithmParameters.from_config(ConfigFile(CORRIDOR)).replace(
        **change)
    ds = SyntheticCorridorDataset(n_frames=2)
    f0, f1 = ds.get_frame(0), ds.get_frame(1)
    vo = device_vo.DeviceVO(ds.calibration.K, ds.calibration.baseline,
                            ds.image_size, p, device=cuda)
    vo.init(f0.image, f0.disparity)
    ch = device_vo._compute_channels_pyr(
        torch.as_tensor(f1.image).to(cuda), p, p.numPyramidLevels)
    return vo, ch


@pytest.mark.gpu
@pytest.mark.parametrize("C", sorted(ZOO_C))
def test_level_gn_zoo_channels_match_plain(cuda, C):
    """level_gn at the zoo's channel counts (C = 48 takes the scratch path)
    on the corridor's finest level (K = 16384): the first linearization's
    sigma equal, H and the weights tight; converged, the pose at atol 1e-4,
    the same iterations and status."""
    vo, ch = _corridor_level0(cuda, descriptor=ZOO_C[C])
    args = _level_args((vo, ch), 0)
    assert args[3].shape == (C, 16384)
    _, sk, Hk, _, wk, _ = lg.level_gn(*_one_iteration(args))
    _, sp, Hp, _, wp, _ = lg.level_gn_reference(*_one_iteration(args))
    assert sk[4].item() == sp[4].item()
    np.testing.assert_allclose(Hk.cpu(), Hp.cpu(), rtol=1e-3,
                               atol=1e-4 * float(Hp.abs().max()))
    np.testing.assert_allclose(wk.cpu(), wp.cpu(), atol=1e-3)
    Tk, sk, _, _, _, _ = lg.level_gn(*args)
    Tp, sp, _, _, _, _ = lg.level_gn_reference(*args)
    np.testing.assert_allclose(Tk.cpu(), Tp.cpu(), atol=1e-4)
    sk, sp = sk.cpu().numpy(), sp.cpu().numpy()
    assert sk[0] == sp[0] and sk[3] == sp[3] and sk[7] == sp[7] == 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("C", (3, 5, 10))
def test_fused_linearize_zoo_channels_match_plain(cuda, C):
    """fused_linearize at C = 3, 5, 10 (channel groups of 4 with a
    remainder) on a dense corridor finest level of 65536 points."""
    from bpvo_tpu_torch.ops import interp
    from bpvo_tpu_torch.solver import mestimator
    from bpvo_tpu_torch.vo import template_data, warp
    vo, ch = _corridor_level0(cuda, descriptor=ZOO_C[C], pointCapacity=65536,
                              minNumPixelsForNonMaximaSuppression=10 ** 9)
    td, cam, opts = vo.state.templates[0], vo._cams[0], vo._opts[0]
    assert td.pixels.shape == (C, 65536)
    T0 = torch.eye(4, device=cuda)
    u, v, Z = warp.project(cam, T0, td.points)
    ok = td.valid & (Z > 1e-6) & interp.valid_mask(
        u, v, ch[0].shape[1], ch[0].shape[2], opts.interp)
    r, _ = template_data.compute_residuals(td, ch[0], cam, T0, opts.interp)
    sigma = mestimator.estimate_scale(r[0], ok)
    _check_fused(td, ch[0], opts, u, v, ok, sigma)


@pytest.mark.gpu
def test_irls_reduce_gather_route_matches_plain(cuda):
    """The gather route's reduction (Bit-Planes, CUBIC_HERMITE, M = 8K) and
    ``gauss_newton.run`` on it: the kernel against its plain version, and
    the run eager against the run replayed through ``GraphCache.jit``,
    bit for bit, with irls_reduce launched once per iteration."""
    from bpvo_tpu_torch.ops import irls
    from bpvo_tpu_torch.solver import gauss_newton as gn
    from bpvo_tpu_torch.solver import mestimator
    from bpvo_tpu_torch.utils import graphs
    from bpvo_tpu_torch.vo import template_data
    vo, ch = _corridor_level0(cuda, descriptor=DescriptorType.BITPLANES,
                              interp=InterpolationType.CUBIC_HERMITE)
    td, cam, opts = vo.state.templates[0], vo._cams[0], vo._opts[0]
    T0 = torch.eye(4, device=cuda)
    r, ok = template_data.compute_residuals(td, ch[0], cam, T0, opts.interp)
    sigma = mestimator.estimate_scale(r[0], ok)
    b = (td.jacobians.reshape(-1, 6), r.reshape(-1),
         ok.expand(8, -1).reshape(-1), sigma, opts.loss)
    H, g, f, w = irls.irls_reduce_w(*b)
    Hp, gp, fp, wp = irls.irls_reduce_reference(*b)
    assert float((w - wp).abs().max()) <= 1e-6
    for a, c in ((H, Hp), (g, gp), (f, fp)):
        _close(a, c, 1e-4)
    before = irls.launch_count
    eager = gn.run(td, ch[0], cam, T0, opts)
    n_eager = irls.launch_count - before
    assert n_eager == int(eager.num_iters) >= 2
    cache = graphs.GraphCache(cuda)
    for _ in range(2):       # warm-up and capture, then replays
        replayed = cache.jit(("gn", opts, cam), (td, ch[0], T0),
                             lambda t: gn.run(t[0], t[1], cam, t[2], opts),
                             held=(0,))
    for a, c in zip(eager, replayed):
        assert torch.equal(a, c)
