"""The port's stereo matcher and stereo-in-the-loop VO against ``bpvo_tpu``
on the CPU (the wrappers take their plain versions for CPU tensors).

Tolerances: with integer costs and penalties every aggregate is an integer
below 2^24, so float32 sums are exact in any order and the SGM aggregation
is compared bit for bit; the p1=1.0/p2=8.0 case on uniform real costs keeps
tests/test_pallas.py's atol 1e-4.  The disparity is compared bit for bit on
its invalid mask and at atol 1e-6 in value.  The stereo Bit-Planes
``DeviceVO`` is held to JAX's level-kernel route (``BPVO_LEVEL_KERNEL=force``,
interpret mode, whose "small" variant is float32 at K <= 1024) at POSE_ATOL."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpvo_tpu import AlgorithmParameters as JParams
from bpvo_tpu.data import stereo as jstereo
from bpvo_tpu.data.synthetic import SyntheticPlaneDataset
from bpvo_tpu.ops import census as jcensus
from bpvo_tpu.ops.pallas import sgm_kernel
from bpvo_tpu.types import DescriptorType as JDesc
from bpvo_tpu.types import LossFunctionType as JLoss
from bpvo_tpu.vo.device_vo import DeviceVO as JDeviceVO
from bpvo_tpu_torch import AlgorithmParameters, ConfigFile, DescriptorType
from bpvo_tpu_torch import LossFunctionType
from bpvo_tpu_torch.data import stereo, synthetic
from bpvo_tpu_torch.ops import census, census_cost, sgm
from bpvo_tpu_torch.utils import graphs
from bpvo_tpu_torch.utils.convert import state_from_numpy
from bpvo_tpu_torch.vo.device_vo import DeviceVO

TWIST = (0.0, 0.0, 0.0, 0.01, 0.0, 0.02)
# port vs JAX poses on the stereo Bit-Planes run: the same disparity and
# descriptor bit for bit, the level solves differ only in float32 order
# (measured 6.3e-6, with equal per-level iterations)
POSE_ATOL = 3e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Whole-frame runs of small ops: one torch thread keeps the suite's
    workers from waiting on each other's spinning thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.array(a, np.float32))


def _int_cost(shape, seed):
    r = np.random.default_rng(seed)
    return r.integers(0, 9, shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(16, 20, 128), (9, 13, 48)])
def test_aggregate_4dir_bitwise_integer(shape):
    cost = _int_cost(shape, 0)
    got = sgm.aggregate_4dir(_t(cost), 2.0, 8.0)
    before = sgm.launch_count
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(jstereo._aggregate_4dir_scan(jnp.asarray(cost), 2.0, 8.0)))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(sgm_kernel.aggregate_4dir(
            jnp.asarray(cost), 2.0, 8.0, interpret=True)))
    np.testing.assert_array_equal(
        sgm.aggregate_4dir_reference(_t(cost), 2.0, 8.0).numpy(), got.numpy())
    assert sgm.launch_count == before      # CPU tensors: no kernel launch


def test_aggregate_real_penalties_match_jax():
    """tests/test_pallas.py's case: uniform real costs, p1=1.0, p2=8.0."""
    r = np.random.default_rng(0)
    cost = r.uniform(0, 8, (16, 20, 128)).astype(np.float32)
    np.testing.assert_allclose(
        sgm.aggregate_direction(_t(cost), 1.0, 8.0).numpy(),
        np.asarray(sgm_kernel.aggregate_direction(jnp.asarray(cost), 1.0, 8.0,
                                                  interpret=True)),
        atol=1e-4)
    np.testing.assert_allclose(
        sgm.aggregate_4dir(_t(cost), 1.0, 8.0).numpy(),
        np.asarray(sgm_kernel.aggregate_4dir(jnp.asarray(cost), 1.0, 8.0,
                                             interpret=True)),
        atol=1e-4)
    with pytest.raises(ValueError):
        sgm.aggregate_4dir(_t(cost).to("meta"), 1.0, 8.0)


def _stereo_pair(rows=60, cols=80, baseline=0.5):
    ds = SyntheticPlaneDataset(rows=rows, cols=cols, n_frames=1,
                               baseline=baseline, texture="noise",
                               twist_per_frame=TWIST)
    return ds.get_frame(0).image, ds.right_image(0), ds.get_frame(0).disparity


def test_cost_volume_matches_rolled_planes():
    """The gathered Hamming volume equals stereo.py's rolled-plane cost
    (stereo.py:212-218), including d >= W."""
    L, R, _ = _stereo_pair(rows=12, cols=40)
    cl, cr = (np.asarray(jcensus.census_planes(jnp.asarray(x)))
              for x in (L, R))
    D = 48
    col = np.arange(40)[None, :]
    want = np.stack([np.where(col < d, 8.0, np.abs(
        cl - np.roll(cr, d, axis=-1)).sum(0)) for d in range(D)], -1)
    codes = census.census(torch.stack([_t(L), _t(R)]))
    got = stereo.census_cost_volume(codes[0], codes[1], D)
    assert got.shape == (12, 40, D) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))


@pytest.mark.parametrize("D", [8, 64, 200])
def test_cost_volume_op_count_independent_of_d(D):
    """The volume is built by the same tensor ops for every D (no loop over
    disparities), the same as at D = 1."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    r = np.random.default_rng(D)
    cl, cr = (torch.as_tensor(r.integers(0, 256, (6, 40)).astype(np.uint8))
              for _ in range(2))
    counts = []
    for n in (1, D):
        with Count() as c:
            stereo.census_cost_volume(cl, cr, n)
        counts.append(c.ops)
    assert counts[0] == counts[1] and len(counts[1]) <= 16


def _loop_cost(cl, cr, D):
    """The cost volume pixel by pixel: popcount(cR[y, x - d] ^ cL[y, x]),
    8 where x < d."""
    H, W = cl.shape
    out = np.full((H, W, D), 8.0, np.float32)
    for d in range(min(D, W)):
        x = np.arange(d, W)
        out[:, d:, d] = np.unpackbits(
            (cr[:, x - d] ^ cl[:, x])[..., None], axis=-1).sum(-1)
    return out


@pytest.mark.parametrize("H, W, D", [(3, 40, 1), (4, 37, 7), (5, 40, 48),
                                     (2, 33, 200), (3, 1, 5)])
def test_cost_volume_on_cpu_is_the_plain_version(monkeypatch, H, W, D):
    """CPU tensors take ``census_cost_volume_reference`` and never ask for
    the kernels' library or count a launch; it equals the cost pixel by
    pixel at ragged D, W not a multiple of the kernel's column tile, and
    W < D (the shapes the card's tests hold the kernel to)."""
    from bpvo_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "library", lambda: pytest.fail("built"))
    r = np.random.default_rng(H * W * D)
    cl, cr = (r.integers(0, 256, (H, W)).astype(np.uint8) for _ in range(2))
    before = census_cost.launch_count
    got = stereo.census_cost_volume(torch.as_tensor(cl), torch.as_tensor(cr),
                                    D)
    assert census_cost.launch_count == before
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert torch.equal(got, census_cost.census_cost_volume_reference(
        torch.as_tensor(cl), torch.as_tensor(cr), D))
    np.testing.assert_array_equal(got.numpy(), _loop_cost(cl, cr, D))


def test_cost_volume_launches_are_counted_with_the_kernels():
    """The module is one of ``graphs.op_modules()``, so graph replays and
    the benchmark's settled counts (``census_cost``) include its launches."""
    from vobench import program
    assert census_cost in graphs.op_modules()
    assert "census_cost" in program.settled_counts()


def test_cost_volume_refuses_other_devices():
    c = torch.zeros(4, 6, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        census_cost.census_cost_volume(c, c, 3)


def test_tpusgm_run_takes_tensors_and_returns_numpy():
    """run() takes numpy arrays or tensors and computes on the device it is
    given; the disparity comes back as numpy, equal for both inputs."""
    L, R, _ = _stereo_pair(rows=24, cols=48)
    m = stereo.TpuSGM(num_disparities=16)
    a = m.run(L, R, device="cpu")
    b = m.run(_t(L).double(), _t(R), device="cpu")
    assert isinstance(b, np.ndarray) and b.dtype == np.float32
    np.testing.assert_array_equal(a, b)


def test_wta_ties_take_the_first_index():
    r = np.random.default_rng(3)
    a = r.integers(0, 4, (6, 7, 16)).astype(np.float32)   # many ties
    a[0, 0] = 5.0
    a[0, 0, [3, 9]] = 1.0
    np.testing.assert_array_equal(
        stereo._wta_subpixel(_t(a), 16).numpy(),
        np.asarray(jstereo._wta_subpixel(jnp.asarray(a), 16)))
    assert float(stereo._wta_subpixel(_t(a), 16)[0, 0]) == 3.0


def _winner_cases(H, W, D, seed):
    """Cost volumes for the fused winner: integer costs with ties, a
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


@pytest.mark.parametrize("H, W, D", [(9, 13, 32), (5, 7, 48), (16, 20, 128)])
def test_disparity_4dir_on_cpu_is_the_plain_chain(H, W, D):
    """The fused entry point's CPU route is the plain aggregation followed
    by the plain winner, bit for bit, and counts no launch; on integer
    costs it also equals JAX's chain."""
    before = (sgm.launch_count, sgm.winner_count.launch_count)
    for k, (cost, p1) in enumerate(_winner_cases(H, W, D, H + W + D)):
        got = sgm.disparity_4dir(_t(cost), p1, 8.0)
        assert got.shape == (H, W) and got.dtype == torch.float32
        want = stereo._wta_subpixel(
            sgm.aggregate_4dir_reference(_t(cost), p1, 8.0), D)
        assert torch.equal(got, want), k
        assert torch.equal(sgm.disparity_4dir_reference(_t(cost), p1, 8.0),
                           got), k
        if p1 == 2.0:
            np.testing.assert_array_equal(got.numpy(), np.asarray(
                jstereo._wta_subpixel(jstereo._aggregate_4dir_scan(
                    jnp.asarray(cost), 2.0, 8.0), D)))
    assert (sgm.launch_count, sgm.winner_count.launch_count) == before
    assert bool((sgm.disparity_4dir(
        _t(np.full((3, 4, D), 3.0, np.float32)), 2.0, 8.0) == -1).all())
    with pytest.raises(ValueError):
        sgm.disparity_4dir(_t(cost).to("meta"), 1.0, 8.0)


def test_sgm_disparity_matches_jax():
    L, R, gt = _stereo_pair()
    want = np.asarray(jstereo._sgm(jnp.asarray(L), jnp.asarray(R), 32, 2.0,
                                   8.0))
    before = (census.launch_count, sgm.launch_count,
              sgm.winner_count.launch_count)
    got = stereo.TpuSGM(num_disparities=32).run(L, R, device="cpu")
    assert (census.launch_count, sgm.launch_count,
            sgm.winner_count.launch_count) == before
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got < 0, want < 0)
    np.testing.assert_allclose(got, want, atol=1e-6)
    ok = got > 0
    assert ok.mean() > 0.5
    assert np.median(np.abs(got - gt)[ok]) < 0.5
    # the jittable form is the same function
    np.testing.assert_array_equal(
        stereo.TpuSGM(num_disparities=32).as_fn()(_t(L), _t(R)).numpy(), got)


def test_factory_and_config():
    cf = ConfigFile(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "..", "conf", "kitti_bitplanes.cfg"))
    alg = stereo.create_stereo_algorithm(cf)
    assert isinstance(alg, stereo.TpuSGM)
    assert (alg.num_disparities, alg.p1, alg.p2) == (128, 2.0, 8.0)
    assert isinstance(alg, stereo.StereoAlgorithm)
    cf.set("sgmP1", 3).set("sgmP2", 20)
    alg = stereo.create_stereo_algorithm(cf)
    assert (alg.p1, alg.p2) == (3.0, 20.0)
    # every JAX name: OpenCV's matchers (cv2 is installed here), the
    # device block matcher with its keys
    for name, cls in (("BlockMatching", stereo.CvBlockMatching),
                      ("bm", stereo.CvBlockMatching),
                      ("SGBM", stereo.CvSGBM),
                      ("SemiGlobalBlockMatching", stereo.CvSGBM),
                      ("TpuBlockMatching", stereo.TpuBlockMatching),
                      ("TpuBM", stereo.TpuBlockMatching),
                      ("rsgm", stereo.TpuSGM)):
        assert isinstance(stereo.create_stereo_algorithm(
            ConfigFile().set("StereoAlgorithm", name)), cls)
    bm = stereo.create_stereo_algorithm(
        ConfigFile().set("StereoAlgorithm", "TpuBlockMatching")
        .set("numberOfDisparities", 96).set("SADWindowSize", 11)
        .set("uniquenessRatio", 10))
    assert (bm.num_disparities, bm.radius, bm.uniqueness_ratio) == (96, 5, 10)
    with pytest.raises(ValueError):
        stereo.create_stereo_algorithm(ConfigFile().set("StereoAlgorithm",
                                                        "nope"))


def test_stereo_renderer_matches_jax_right_image():
    """The port's stereo pairs reproduce SyntheticPlaneDataset on the bench
    scene (fx 718.856, baseline 0.537, the bench step), left and right."""
    n, rows, cols = 3, 64, 96
    K, b, frames = synthetic.synthesize_stereo_sequence(n, rows, cols)
    ds = SyntheticPlaneDataset(rows=rows, cols=cols, n_frames=n,
                               fx=synthetic.FX, baseline=synthetic.BASELINE,
                               texture="noise",
                               twist_per_frame=synthetic.STEP_TWIST)
    np.testing.assert_allclose(K, ds.calibration.K)
    assert b == ds.calibration.baseline
    for i, (left, right, disp) in enumerate(frames):
        np.testing.assert_allclose(left, ds.get_frame(i).image, atol=1e-3)
        np.testing.assert_allclose(right, ds.right_image(i), atol=1e-3)
        np.testing.assert_allclose(disp, ds.get_frame(i).disparity,
                                   atol=1e-3)
        assert np.abs(left - right).mean() > 1.0     # a real second view
    _, _, mono = synthetic.synthesize_sequence(n, rows, cols)
    for (left, _, disp), (image, d) in zip(frames, mono):
        np.testing.assert_array_equal(left, image)
        np.testing.assert_array_equal(disp, d)


# ---------------------------------------------------------------------------
# stereo Bit-Planes VO, 120x160, D=48, 3 levels, 6 frames
# ---------------------------------------------------------------------------

VO_KW = dict(sigmaPriorToCensusTransform=0.5, sigmaBitPlanes=0.5,
             numPyramidLevels=3, maxIterations=50, functionTolerance=1e-4,
             parameterTolerance=1e-6, minSaliency=0.05,
             # K <= 1024 at L0: JAX's level kernel takes its f32 "small"
             # variant; 0.022 m per frame against 0.03 keyframes every
             # second frame, each with a candidate
             pointCapacity=1024, minTranslationMagToKeyFrame=0.03,
             minValidDisparity=1.0, maxValidDisparity=48.0)


def _params(cls, desc, loss):
    return cls(descriptor=desc.BITPLANES, lossFunction=loss.HUBER, **VO_KW)


@pytest.fixture(scope="module")
def stereo_frames():
    ds = SyntheticPlaneDataset(rows=120, cols=160, n_frames=6, baseline=0.5,
                               texture="noise", twist_per_frame=TWIST)
    return ds, [(ds.get_frame(i).image, ds.right_image(i)) for i in range(6)]


def _np_state(st):
    return {"templates": [{k: np.asarray(v) for k, v in td._asdict().items()}
                          for td in st.templates],
            "prev_channels": [np.asarray(c) for c in st.prev_channels],
            **{k: np.asarray(getattr(st, k))
               for k in ("prev_disparity", "has_prev", "T_kf", "pose_world",
                         "T_delta", "last_weights")}}


@pytest.fixture(scope="module")
def jax_stereo_run(stereo_frames):
    """JAX DeviceVO(stereo_fn=TpuSGM) on its level-kernel route over the 6
    pairs: the outputs as numpy, and the state (numpy) before each step."""
    ds, frames = stereo_frames
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BPVO_LEVEL_KERNEL", "force")
        jvo = JDeviceVO(ds.calibration.K, ds.calibration.baseline,
                        ds.image_size, _params(JParams, JDesc, JLoss),
                        stereo_fn=jstereo.TpuSGM(num_disparities=48).as_fn())
        outs, states = [], []
        for L, R in frames:
            states.append(None if jvo.state is None
                          else _np_state(jvo.state))
            o = jvo.add_frame(L, R)
            outs.append(None if o is None else
                        {k: np.asarray(v) for k, v in o._asdict().items()})
        states.append(_np_state(jvo.state))
    return outs, states


def test_stereo_bitplanes_device_vo_matches_jax(stereo_frames,
                                                jax_stereo_run):
    ds, frames = stereo_frames
    outs_j, states_j = jax_stereo_run
    tvo = DeviceVO(ds.calibration.K, ds.calibration.baseline, ds.image_size,
                   _params(AlgorithmParameters, DescriptorType,
                           LossFunctionType),
                   stereo_fn=stereo.TpuSGM(num_disparities=48).as_fn(),
                   device="cpu")
    n_kf_with_candidate = 0
    for (L, R), oj, sj in zip(frames, outs_j, states_j[1:]):
        has_prev = tvo.state is not None and tvo.state.has_prev
        ot = tvo.add_frame(L, R)
        # the store carries the stereo pair
        assert tvo.state.prev_disparity.shape == (2, 120, 160)
        np.testing.assert_array_equal(tvo.state.prev_disparity.numpy(),
                                      sj["prev_disparity"])
        if oj is None:
            assert ot is None
            continue
        assert bool(ot.is_keyframe) == bool(oj["is_keyframe"])
        assert int(ot.reason) == int(oj["reason"])
        n_kf_with_candidate += int(bool(ot.is_keyframe) and has_prev)
        np.testing.assert_allclose(ot.pose.numpy(), oj["pose"],
                                   atol=POSE_ATOL)
        np.testing.assert_allclose(ot.pose_world.numpy(), oj["pose_world"],
                                   atol=POSE_ATOL)
        assert np.abs(ot.iters.numpy() - oj["iters"]).max() <= 1
    assert n_kf_with_candidate >= 1
    # the keyframe template: as many points, from the same disparity
    for tt, tj in zip(tvo.state.templates, states_j[-1]["templates"]):
        assert int(tt.num_valid) == int(tj["num_valid"])
        assert tt.pixels.shape[0] == 8


def test_stereo_state_carried_from_jax(stereo_frames, jax_stereo_run):
    """A JAX state whose store holds the (2, H, W) pair, carried across with
    state_from_numpy, steps to JAX's pose through a keyframe with a
    candidate: the matcher runs on the carried pair."""
    ds, frames = stereo_frames
    outs_j, states_j = jax_stereo_run
    last = len(frames) - 1
    oj, sj = outs_j[last], states_j[last]
    assert bool(oj["is_keyframe"]) and bool(sj["has_prev"])
    tvo = DeviceVO(ds.calibration.K, ds.calibration.baseline, ds.image_size,
                   _params(AlgorithmParameters, DescriptorType,
                           LossFunctionType),
                   stereo_fn=stereo.TpuSGM(num_disparities=48).as_fn(),
                   device="cpu")
    tvo.state = state_from_numpy(sj, "cpu")
    assert tvo.state.prev_disparity.shape == (2, 120, 160)
    ot = tvo.add_frame(*frames[last])
    assert bool(ot.is_keyframe) and int(ot.reason) == int(oj["reason"])
    np.testing.assert_allclose(ot.pose.numpy(), oj["pose"], atol=POSE_ATOL)


def test_stereo_pose_difference_not_amplified_at_keyframes():
    """ROADMAP C.11: both packages' level-kernel routes over 12 stereo pairs
    (the run above, longer).  Per step, the relative pose's max |port -
    JAX| and the world pose's; the world difference may grow only by the
    step's own difference (additive), never by a factor at a keyframe.
    ``pytest -s`` prints the table."""
    n = 12
    ds = SyntheticPlaneDataset(rows=120, cols=160, n_frames=n, baseline=0.5,
                               texture="noise", twist_per_frame=TWIST)
    K, b = ds.calibration.K, ds.calibration.baseline
    tvo = DeviceVO(K, b, ds.image_size,
                   _params(AlgorithmParameters, DescriptorType,
                           LossFunctionType),
                   stereo_fn=stereo.TpuSGM(num_disparities=48).as_fn(),
                   device="cpu")
    rows = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BPVO_LEVEL_KERNEL", "force")
        jvo = JDeviceVO(K, b, ds.image_size, _params(JParams, JDesc, JLoss),
                        stereo_fn=jstereo.TpuSGM(num_disparities=48).as_fn())
        for i in range(n):
            L, R = ds.get_frame(i).image, ds.right_image(i)
            oj, ot = jvo.add_frame(L, R), tvo.add_frame(L, R)
            if oj is None:
                continue
            assert bool(ot.is_keyframe) == bool(oj.is_keyframe)
            rows.append((i, bool(oj.is_keyframe),
                         np.abs(ot.pose.numpy() - np.asarray(oj.pose)).max(),
                         np.abs(ot.pose_world.numpy()
                                - np.asarray(oj.pose_world)).max()))
    for i, kf, dp, dw in rows:
        print(f"step {i:2d} {'keyframe' if kf else '        '} "
              f"max|dpose| {dp:.3e} max|dpose_world| {dw:.3e}")
    assert sum(kf for _, kf, _, _ in rows) >= 4
    worst = 0.0
    for _, _, dp, dw in rows:
        assert dw <= worst + dp + 1e-6
        worst = max(worst, dw)
    assert worst < 1e-3


def test_stereo_fn_matches_precomputed_disparity(stereo_frames):
    """DeviceVO(stereo_fn=...) fed (left, right) gives the trajectory of
    DeviceVO fed the same matcher's disparity of every frame (as
    tests/test_stereo_vo.py:141-173): keyframe-rate stereo is a schedule,
    not another algorithm."""
    ds, frames = stereo_frames
    K, b = ds.calibration.K, ds.calibration.baseline
    matcher = stereo.TpuSGM(num_disparities=48)
    p = _params(AlgorithmParameters, DescriptorType, LossFunctionType)
    vo_a = DeviceVO(K, b, ds.image_size, p, stereo_fn=matcher.as_fn(),
                    device="cpu")
    vo_b = DeviceVO(K, b, ds.image_size, p, device="cpu")
    n_out = 0
    for L, R in frames:
        out_a = vo_a.add_frame(L, R)
        out_b = vo_b.add_frame(L, matcher.run(L, R, device="cpu"))
        if out_a is not None:
            n_out += 1
            np.testing.assert_allclose(out_a.pose.numpy(),
                                       out_b.pose.numpy(), atol=1e-5)
            assert bool(out_a.is_keyframe) == bool(out_b.is_keyframe)
    assert n_out == 5


def test_bitplanes_sgm_reference_file():
    """The committed JAX reference that chip_smoke.py holds the card's
    stereo Bit-Planes run to (scripts/make_torch_port_ref.py) is sane."""
    ref = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "data", "torch_port_bitplanes_sgm_ref.npz"))
    assert ref["poses"].shape == (30, 4, 4) and ref["iters"].shape == (30, 4)
    assert np.all(np.isfinite(ref["poses"])) and ref["gt_err"].max() < 1e-2
    assert 0 < ref["is_keyframe"].sum() < 30
    assert int(ref["num_disparities"]) == 128
    n_px = int(ref["rows"]) * int(ref["cols"])
    assert 0.9 * n_px < int(ref["disp0_valid"]) <= n_px
    assert 0.0 < float(ref["disp0_mean_abs_err"]) < 2.0
