"""The port's distributed layer in one process, on the CPU, against the
JAX package: the two template stages, ``shard_template``, the sharded sigma,
the sharded GN (the kernel route, and the gather route at CUBIC and
CUBIC_HERMITE sampling) and the sharded VO with no reducer against JAX's
on a one-device mesh (atol 5e-4), the hooked ``make_vo_step`` against
JAX's with identity hooks, a world-1 gloo group bit for bit the
no-reducer route, the ``Reducer``, ``initialize``'s refusals and the layout of ranks.  The
multi-process cases are in tests/test_torch_multiprocess.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from bpvo_tpu.config import AlgorithmParameters as JParams
from bpvo_tpu.parallel import bundle_adjustment as jba
from bpvo_tpu.parallel import sharded as jsh
from bpvo_tpu.parallel import sharded_vo as jsvo
from bpvo_tpu.solver import gauss_newton as jgn
from bpvo_tpu.types import InterpolationType as JInterp
from bpvo_tpu.types import LossFunctionType as JLoss
from bpvo_tpu.vo import device_vo as jdvo
from bpvo_tpu.vo import template_data as jtd
from bpvo_tpu_torch.parallel import collectives, multihost, sharded
from bpvo_tpu_torch.parallel import sharded_vo
from bpvo_tpu_torch.solver import gauss_newton as gn
from bpvo_tpu_torch.types import InterpolationType
from bpvo_tpu_torch.utils import convert
from bpvo_tpu_torch.vo import device_vo
from bpvo_tpu_torch.vo import pose_estimator as pe
from bpvo_tpu_torch.vo import template_data as td_mod
from test_gn import H_IMG, W_IMG, build_template, make_cam, render_pair
from test_odometry import make_sequence

ATOL = 5e-4
VO_KW = dict(minSaliency=2.0, numPyramidLevels=3, functionTolerance=1e-4,
             parameterTolerance=1e-6, maxIterations=50,
             minTranslationMagToKeyFrame=0.04)
TWIST = [0.001, -0.002, 0.001, 0.01, -0.005, 0.015]


def _np(tree):
    return {k: np.asarray(v) for k, v in tree._asdict().items()}


@pytest.fixture(scope="module")
def problem():
    """One GN problem: the JAX template, target image, camera, options,
    and the port's template and camera."""
    I0, I1, D, cam, _ = render_pair(TWIST)
    tdata, _ = build_template(I0, D, cam, capacity=2048)
    opts = jgn.GNOptions(loss=JLoss.HUBER, function_tolerance=1e-4,
                         parameter_tolerance=1e-6)
    return (tdata, jnp.asarray(I1)[None], cam, opts,
            convert.template_from_numpy(_np(tdata), "cpu"),
            torch.from_numpy(np.array(I1))[None],
            convert.camera_from_numpy(cam))


@pytest.fixture(scope="module")
def sequence():
    frames = make_sequence([0, 0, 0, 0.0, 0.0, 0.011], 5)
    cam = make_cam()
    return (np.asarray(cam.K()), float(cam.baseline),
            np.stack([f[0] for f in frames]).astype(np.float32),
            np.stack([f[1] for f in frames]).astype(np.float32))


@pytest.fixture(scope="module")
def world1():
    """A world-1 gloo group in this process and its Reducer."""
    reducer = multihost.initialize("gloo", 1, 0,
                                   f"tcp://127.0.0.1:{multihost.free_port()}")
    yield reducer
    multihost.shutdown()


def test_template_stages_match_jax(problem):
    """``build_from_selection`` on a slice of JAX's selection: JAX's values
    and Jacobians; ``set_data`` is the two stages."""
    _, ch, cam, _, _, tch, tcam = problem
    I0, _, D, _, _ = render_pair(TWIST)
    p = JParams(minSaliency=2.0)
    tp = convert.params_from_jax(dataclasses.asdict(p))
    sel, pts, s, c = jtd.select_and_backproject(jnp.asarray(I0)[None],
                                                jnp.asarray(D), cam, p, 2048)
    lo, hi = 512, 1024
    jt = jtd.build_from_selection(
        jnp.asarray(I0)[None], cam, p, sel.rows[lo:hi], sel.cols[lo:hi],
        sel.valid[lo:hi], sel.num_valid, pts[lo:hi], s, c)

    def t(a, dtype=None):
        return torch.from_numpy(np.array(a)).to(dtype) if dtype else \
            torch.from_numpy(np.array(a))
    tt = td_mod.build_from_selection(
        t(I0)[None], tcam, tp, t(sel.rows[lo:hi], torch.int64),
        t(sel.cols[lo:hi], torch.int64), t(sel.valid[lo:hi]),
        t(sel.num_valid, torch.int64), t(pts[lo:hi]), t(s), t(c))
    np.testing.assert_allclose(tt.pixels.numpy(), np.asarray(jt.pixels),
                               atol=1e-4)
    np.testing.assert_allclose(tt.jacobians.numpy(), np.asarray(jt.jacobians),
                               atol=1e-4 * np.abs(jt.jacobians).max())
    assert int(tt.num_valid) == int(sel.num_valid)
    whole = td_mod.set_data(t(I0)[None], t(D), tcam, tp, 2048, 0)
    sel_t, pts_t, s_t, c_t = td_mod.select_and_backproject(
        t(I0)[None], t(D), tcam, tp, 2048)
    staged = td_mod.build_from_selection(
        t(I0)[None], tcam, tp, sel_t.rows, sel_t.cols, sel_t.valid,
        sel_t.num_valid, pts_t, s_t, c_t)
    assert all(torch.equal(a, b) for a, b in zip(whole, staged))


@pytest.mark.parametrize("capacity", [2048, 1001])
def test_shard_template_matches_jax(problem, capacity):
    """The ranks' slices put together are JAX's padded template (invalid
    padding at z = 1); num_valid stays global."""
    I0, _, D, cam, _ = render_pair(TWIST)
    tdata, _ = build_template(I0, D, cam, capacity=capacity)
    want = _np(jsh.shard_template(tdata, jsh.make_mesh(2)))
    port = convert.template_from_numpy(_np(tdata), "cpu")
    parts = [sharded.shard_template(port, r, 2) for r in range(2)]
    for name, axis in zip(port._fields, sharded._POINT_AXIS):
        got = [getattr(s, name).numpy() for s in parts]
        if axis is None:
            assert all(np.array_equal(g, want[name]) for g in got)
        else:
            np.testing.assert_array_equal(np.concatenate(got, axis),
                                          want[name])
    assert parts[0].capacity == (capacity + capacity % 2) // 2


def test_global_sigma_matches_jax():
    """No reducer: JAX's sharded sigma arithmetic (``_global_sigma``), bit
    for bit."""
    r = np.random.default_rng(0)
    for n in (1, 7, 5000):
        a = np.abs(r.standard_normal(n)).astype(np.float32) * 3
        v = r.random(n) > 0.3
        want = np.asarray(jba._global_sigma(jnp.asarray(a), jnp.asarray(v)))
        got = sharded.global_sigma(torch.from_numpy(a), torch.from_numpy(v))
        assert got.numpy() == want, (n, got, want)


def test_sharded_gn_without_reducer_matches_jax(problem):
    tdata, ch, cam, opts, tt, tch, tcam = problem
    st_j = jsh.make_sharded_gn(jsh.make_mesh(1), opts)(
        jsh.shard_template(tdata, jsh.make_mesh(1)), ch, cam, jnp.eye(4))
    st_t = sharded.make_sharded_gn(None, convert.gn_options_from_jax(opts))(
        tt, tch, tcam, torch.eye(4))
    np.testing.assert_allclose(st_t.T.numpy(), np.asarray(st_j.T), atol=ATOL)
    assert abs(int(st_t.num_iters) - int(st_j.num_iters)) <= 1
    np.testing.assert_allclose(float(st_t.scale), float(st_j.scale),
                               rtol=1e-3)


@pytest.mark.parametrize("interp", ["CUBIC", "CUBIC_HERMITE"])
def test_sharded_gn_gather_route_matches_jax(problem, world1, interp):
    """CUBIC and CUBIC_HERMITE sampling take ``gauss_newton``'s gather
    route with the sharded sigma and reduction: against JAX's sharded GN on
    a one-device mesh, pose at atol 5e-4, the same iterations, sigma and f
    at the bounds of test_torch_zoo.py's gather-route test (cubic sampling
    of the noise-free scene leaves residuals at the rounding floor, sigma
    ~7e-4; the single-device routes differ from JAX's as much there), and a
    world-1 gloo group bit for bit the no-reducer route."""
    tdata, ch, cam, opts, tt, tch, tcam = problem
    opts = dataclasses.replace(opts, interp=JInterp[interp])
    st_j = jsh.make_sharded_gn(jsh.make_mesh(1), opts)(
        jsh.shard_template(tdata, jsh.make_mesh(1)), ch, cam, jnp.eye(4))
    o = convert.gn_options_from_jax(opts)
    assert o.interp == InterpolationType[interp]
    st_t = sharded.make_sharded_gn(None, o)(tt, tch, tcam, torch.eye(4))
    np.testing.assert_allclose(st_t.T.numpy(), np.asarray(st_j.T), atol=ATOL)
    assert int(st_t.num_iters) == int(st_j.num_iters) >= 2
    np.testing.assert_allclose(float(st_t.scale), float(st_j.scale),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(float(st_t.f_norm), float(st_j.f_norm),
                               rtol=1e-3, atol=1e-3)
    world1.reset()
    st_w = sharded.make_sharded_gn(world1, o)(tt, tch, tcam, torch.eye(4))
    assert all(torch.equal(x, y) for x, y in zip(st_t, st_w))
    assert world1.calls >= int(st_w.num_iters)


def test_sharded_vo_without_reducer_matches_jax(sequence):
    """The sharded VO with no reducer against JAX's on a one-device mesh
    over 4 frames in 2 chunks: world poses at atol 5e-4, the same keyframe
    flags."""
    K, b, images, disps = sequence
    p = JParams(**VO_KW)
    init_j, _, scan_j = jsvo.make_sharded_vo(jsh.make_mesh(1), K, b,
                                             (H_IMG, W_IMG), p)
    init_t, _, scan_t = sharded_vo.make_sharded_vo(
        None, K, b, (H_IMG, W_IMG),
        convert.params_from_jax(dataclasses.asdict(p)), device="cpu")
    sj = init_j(jnp.asarray(images[0]), jnp.asarray(disps[0]))
    st = init_t(images[0], disps[0])
    for lo, hi in ((1, 3), (3, 5)):
        sj, oj = scan_j(sj, jnp.asarray(images[lo:hi]),
                        jnp.asarray(disps[lo:hi]))
        st, ot = scan_t(st, images[lo:hi], disps[lo:hi])
        np.testing.assert_allclose(ot.pose_world.numpy(),
                                   np.asarray(oj.pose_world), atol=ATOL)
        np.testing.assert_array_equal(ot.is_keyframe.numpy(),
                                      np.asarray(oj.is_keyframe))
    assert bool(ot.is_keyframe.any())


def test_hooked_step_matches_jax_identity_hooks(sequence):
    """``make_vo_step`` with hooks that change nothing (the default
    linearization handed in by ``linearize_factory``, an identity
    ``count_reduce``, the default template build) against JAX's with the
    same identity hooks, and against the port's own unhooked step: poses at
    atol 1e-5, the same keyframes."""
    K, b, images, disps = sequence
    p = JParams(**VO_KW).replace(numPyramidLevels=3)
    tp = convert.params_from_jax(dataclasses.asdict(p))
    jv, tv = jdvo.DeviceVO(K, b, (H_IMG, W_IMG), p), device_vo.DeviceVO(
        K, b, (H_IMG, W_IMG), tp, device="cpu")

    def jlin(level, td, ch, cam, o):
        return lambda T, s, d: jgn._linearize(td, ch, cam, T, s, d, o)

    def tlin(level, td, ch, cam, o):
        return lambda T, s, d, est: gn._linearize(td, ch, cam, T, s, d, est,
                                                  o)
    jstep = jax.jit(jdvo.make_vo_step(
        p, jv._cams, jv._capacities, jv._opts, linearize_factory=jlin,
        count_reduce=lambda x: x,
        build_templates_fn=lambda ch, d: jdvo._build_templates(
            ch, d, jv._cams, p, jv._capacities)))
    tstep = device_vo.make_vo_step(
        tp, tv._cams, tv._capacities, tv._opts, hooks=device_vo.StepHooks(
            linearize_factory=tlin, count_reduce=lambda x: x,
            build_templates_fn=lambda ch, d: device_vo._build_templates(
                ch, d, tv._cams, tp, tv._capacities)))
    jv.init(images[0], disps[0])
    tv.init(images[0], disps[0])
    sj, st, plain = jv.state, tv.state, tv.state
    n_kf = 0
    for I, D in zip(images[1:], disps[1:]):
        sj, oj = jstep(sj, jnp.asarray(I), jnp.asarray(D))
        st, ot = tstep(st, torch.from_numpy(I), torch.from_numpy(D))
        plain, op = tv._step(plain, torch.from_numpy(I), torch.from_numpy(D))
        np.testing.assert_allclose(ot.pose.numpy(), np.asarray(oj.pose),
                                   atol=1e-5)
        assert bool(ot.is_keyframe) == bool(oj.is_keyframe)
        assert bool(op.is_keyframe) == bool(ot.is_keyframe)
        n_kf += int(bool(ot.is_keyframe))
    assert n_kf >= 1


def test_world_one_group_equals_no_reducer(problem, sequence, world1):
    """The sharded GN and the sharded VO with a world-1 gloo Reducer are
    the no-reducer route bit for bit; the Reducer counts its calls."""
    _, _, _, opts, tt, tch, tcam = problem
    o = convert.gn_options_from_jax(opts)
    a = sharded.make_sharded_gn(None, o)(tt, tch, tcam, torch.eye(4))
    world1.reset()
    c = sharded.make_sharded_gn(world1, o)(tt, tch, tcam, torch.eye(4))
    assert all(torch.equal(x, y) for x, y in zip(a, c))
    # per iteration one sum of (H, g, f_sq); per sigma estimate a max and a
    # histogram sum
    assert world1.calls >= int(c.num_iters)
    K, b, images, disps = sequence
    tp = convert.params_from_jax(dataclasses.asdict(JParams(**VO_KW)))
    outs = []
    for red in (None, world1):
        init, _, scan = sharded_vo.make_sharded_vo(red, K, b, (H_IMG, W_IMG),
                                                   tp, device="cpu")
        outs.append(scan(init(images[0], disps[0]), images[1:], disps[1:])[1])
    assert all(torch.equal(x, y) for x, y in zip(*outs))


def test_reducer(world1):
    world1.reset()
    H, g, f = torch.randn(6, 6), torch.randn(6), torch.tensor(3.0)
    Hs, gs, fs = world1.sum(H, g, f)
    assert Hs.shape == (6, 6) and gs.shape == (6,) and fs.shape == ()
    assert torch.equal(Hs, H) and torch.equal(fs, f)
    n = world1.sum(torch.tensor([3, 4], dtype=torch.int32))[0]
    assert n.dtype == torch.int32 and n.tolist() == [3, 4]
    assert float(world1.max(torch.tensor(2.5))) == 2.5
    assert world1.stats() == {"calls": 3, "bytes": (36 + 6 + 1) * 4 + 8 + 4}
    with pytest.raises(ValueError, match="dtype"):
        world1.sum(H, torch.tensor([1]))
    assert world1.backend == "gloo" and collectives.Reducer().world == 1
    assert (world1.rank, world1.world) == (0, 1)
    assert multihost.process_info()["process_count"] == 1


def test_initialize_refuses():
    address = f"tcp://127.0.0.1:{multihost.free_port()}"
    with pytest.raises(ValueError, match="backend"):
        multihost.initialize("mpi", 1, 0, address)
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="NCCL cannot place"):
            multihost.initialize("nccl", 2, 0, address)
    assert not dist.is_initialized() or dist.get_world_size() == 1


def test_hooks_refuse_graphs_lm_and_the_multistart(sequence):
    K, b, *_ = sequence
    tp = convert.params_from_jax(dataclasses.asdict(JParams(**VO_KW)))
    tv = device_vo.DeviceVO(K, b, (H_IMG, W_IMG), tp, device="cpu")
    lin = lambda *a: None  # noqa: E731
    with pytest.raises(ValueError, match="graphed"):
        device_vo.make_vo_step(tp, tv._cams, tv._capacities, tv._opts,
                               run_graphs=(None,) * 3,
                               hooks=device_vo.StepHooks(lin))
    for kw in ({"solver": "LevenbergMarquardt"}, {"multistart_px": 1.0}):
        with pytest.raises(ValueError, match="custom linearization"):
            pe._estimate_all((), (None,), (), torch.eye(4), (), 0, 0.5,
                             linearize_factory=lin, **kw)
    with pytest.raises(ValueError, match="GaussNewton"):
        sharded_vo.make_sharded_vo(None, K, b, (H_IMG, W_IMG), tp.replace(
            poseEstimator="LevenbergMarquardt"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            sharded_vo.make_sharded_vo(None, K, b, (H_IMG, W_IMG), tp)


def test_rank_layout():
    layout = multihost.global_mesh(kf_axis_size=2, world_size=8)
    assert layout == multihost.RankLayout(kf=2, points=4)
    assert [layout.coords(r) for r in (0, 3, 4, 7)] == [(0, 0), (0, 3),
                                                        (1, 0), (1, 3)]
    assert multihost.global_mesh(2, 3, world_size=6) == (3, 2)
    with pytest.raises(ValueError):
        multihost.global_mesh(kf_axis_size=3, world_size=8)
    assert sharded_vo._round_capacities((16384, 1001, 3), 4) == (16384,
                                                                 1000, 4)


def test_state_shard_from_numpy(sequence):
    """A whole JAX VOState read back: the ranks' shards put together are
    the state's templates and finest weights."""
    K, b, images, disps = sequence
    jv = jdvo.DeviceVO(K, b, (H_IMG, W_IMG), JParams(**VO_KW))
    jv.init(images[0], disps[0])
    jv.add_frame(images[1], disps[1])
    s = jv.state
    d = {"templates": [_np(t) for t in s.templates],
         "prev_channels": [np.asarray(c) for c in s.prev_channels],
         **{k: np.asarray(getattr(s, k)) for k in
            ("prev_disparity", "has_prev", "T_kf", "pose_world", "T_delta",
             "last_weights")}}
    whole = convert.state_from_numpy(d, "cpu")
    parts = [convert.state_shard_from_numpy(d, r, 2, "cpu") for r in range(2)]
    for lvl, td in enumerate(whole.templates):
        np.testing.assert_array_equal(
            torch.cat([p.templates[lvl].points for p in parts]).numpy(),
            td.points.numpy())
        assert int(parts[1].templates[lvl].num_valid) == int(td.num_valid)
    np.testing.assert_array_equal(
        torch.cat([p.last_weights for p in parts], 1).numpy(),
        whole.last_weights.numpy())
    assert torch.equal(parts[0].T_kf, whole.T_kf)


def test_sharded_reference_file():
    """tests/data/torch_port_sharded_ref.npz, which chip_smoke.py holds the
    card to: JAX's sharded VO over 4 steps at 376x1241 (intensity and
    Bit-Planes, each with a keyframe event) and JAX's BA windows after each
    keyframe event of 30 steps; poses only, finite, rigid."""
    import os
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "torch_port_sharded_ref.npz")
    with np.load(path) as f:
        ref = dict(f)
    assert (int(ref["rows"]), int(ref["cols"])) == (376, 1241)
    for key in ("intensity", "bitplanes"):
        world = ref[f"sharded_{key}_world"]
        assert world.shape == (4, 4, 4) and np.isfinite(world).all()
        assert ref[f"sharded_{key}_keyframe"].any()
        np.testing.assert_allclose(world[:, :3, :3] @ np.swapaxes(
            world[:, :3, :3], 1, 2), np.broadcast_to(np.eye(3), (4, 3, 3)),
            atol=1e-5)
    sizes = ref["ba_window_sizes"]
    assert len(sizes) == len(ref["ba_frames"]) >= 2
    assert sizes.sum() == len(ref["ba_windows"])
    assert sizes.max() == int(ref["ba_window"]) == 8
    assert np.isfinite(ref["ba_windows"]).all()
