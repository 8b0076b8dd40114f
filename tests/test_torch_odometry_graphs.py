"""``VisualOdometry``'s three graphs on the CPU: the frame's pyramid, the
keyframe's templates and the whole coarse-to-fine estimate (JAX's
``_process_frame``, ``_set_templates_all`` and ``_estimate_all`` jits),
driven through ``ReplayStandIn`` (a cache whose "replay" reruns the
captured function into the same output tensors) and held bit for bit to
the eager route (``_graphs = None``) on the same frames: every ``Result``
field, the keys the cache holds, the replays and device reads of each
step, checkpoints (JAX's) continued, and bundle adjustment with its graphs
captured at ``enable_bundle_adjustment``.  JAX parity on the graphed route
at tests/test_torch_odometry.py's tolerances.  On the card:
tests/test_torch_graphs_gpu.py and chip_smoke.py's graph phase."""
import numpy as np
import pytest
import torch

from bpvo_tpu import AlgorithmParameters as JParams
from bpvo_tpu import VisualOdometry as JVisualOdometry
from bpvo_tpu_torch import AlgorithmParameters, DescriptorType, VisualOdometry
from bpvo_tpu_torch.solver import gauss_newton as gn
from bpvo_tpu_torch.types import KeyFramingReason
from bpvo_tpu_torch.utils import graphs
from bpvo_tpu_torch.vo.pose_estimator import PoseEstimator
from test_gn import H_IMG, W_IMG, make_cam
from test_odometry import make_sequence
from test_torch_graphs import ReplayStandIn
from test_torch_odometry import KW, STEP, _check_results

N_FRAMES = 8    # keyframes at frames 2, 3, 5, 6: with and without candidate
SIZE = (H_IMG, W_IMG)

# the cases: AlgorithmParameters over KW, and the level-kernel bound
CASES = {
    "level_kernel": ({}, None),
    "run": ({}, 1024),          # L0 (2048 points) on gauss_newton.run
    "lm": ({"poseEstimator": "LevenbergMarquardt"}, None),
    "multistart": ({"coarseInitOffsetPx": 2.0}, None),
    "bitplanes": ({"descriptor": DescriptorType.BITPLANES}, None),
    "reestimate_from_coarsest": ({"keyframeReestimateStartLevel": -1},
                                 None),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Whole-frame runs of small ops: one torch thread keeps the suite's
    workers from waiting on each other's spinning thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames():
    return make_sequence(STEP, N_FRAMES)


def _camera():
    cam = make_cam()
    return np.asarray(cam.K()), float(cam.baseline)


def _pair(params):
    """(eager, graphed) VisualOdometry on the CPU: the graphed one's
    ``_graphs`` the stand-in."""
    K, b = _camera()
    eager = VisualOdometry(K, b, SIZE, params, device="cpu")
    graphed = VisualOdometry(K, b, SIZE, params, device="cpu")
    assert eager._graphs is None and graphed._graphs is None
    graphed._graphs = ReplayStandIn("cpu")
    return eager, graphed


def _assert_same(re, rg):
    """Every Result field bit for bit."""
    assert np.array_equal(re.pose, rg.pose)
    assert np.array_equal(re.covariance, rg.covariance)
    assert re.is_keyframe == rg.is_keyframe
    assert re.keyframing_reason == rg.keyframing_reason
    assert re.optimizer_statistics == rg.optimizer_statistics
    assert (re.point_cloud is None) == (rg.point_cloud is None)
    if re.point_cloud is not None:
        for field in ("points", "colors", "weights", "pose"):
            a, b = getattr(re.point_cloud, field), getattr(rg.point_cloud,
                                                           field)
            assert np.asarray(a).dtype == np.asarray(b).dtype
            assert np.array_equal(a, b), field


class _Reads:
    """Counts ``PoseEstimator._read``, the estimate's one device read, and
    the estimates' static keys (start level, alternative start given,
    multi-start offset)."""

    def __init__(self, monkeypatch):
        self.reads, self.keys = 0, set()
        read, estimate = PoseEstimator._read, PoseEstimator.estimate

        def counted_read(packed):
            self.reads += 1
            return read(packed)

        def recorded(pe, *a, start_level=-1, alt_init=None,
                     multistart_px=0.0, **k):
            self.keys.add((start_level, alt_init is not None, multistart_px))
            return estimate(pe, *a, start_level=start_level,
                            alt_init=alt_init, multistart_px=multistart_px,
                            **k)
        monkeypatch.setattr(PoseEstimator, "_read", staticmethod(counted_read))
        monkeypatch.setattr(PoseEstimator, "estimate", recorded)


def _kinds(cache):
    """The cache's keys by graph: {"frame": n, "templates": n, ...}."""
    out = {}
    for key in cache._entries:
        out[key[0][0]] = out.get(key[0][0], 0) + 1
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_graphed_equals_eager(case, frames, monkeypatch):
    """The graphed route (stand-in) against the eager route, frame by
    frame: every Result field bit for bit; one frame key, one template key
    and an estimate key for each (start level, alternative start,
    multi-start) that ran; on steps after the keys exist, an other step
    two replays (frame, estimate) and one read, a keyframe one more replay
    (templates), and with a candidate one more replay and read (the
    re-estimate)."""
    kw, bound = CASES[case]
    if bound is not None:
        monkeypatch.setattr(gn, "MAX_LEVEL_KERNEL_POINTS", bound)
    eager, graphed = _pair(AlgorithmParameters(**KW, **kw))
    counter = _Reads(monkeypatch)
    kinds = set()
    for image, disp in frames:
        re = eager.add_frame(image, disp)
        n_keys, replays, reads = (len(graphed._graphs), graphs.replay_count,
                                  counter.reads)
        candidate = not graphed._prev.empty
        rg = graphed.add_frame(image, disp)
        _assert_same(re, rg)
        replays, reads = graphs.replay_count - replays, counter.reads - reads
        if re.keyframing_reason == KeyFramingReason.FIRST_FRAME:
            continue
        kind = ("other" if not re.is_keyframe else
                "candidate" if candidate else "no_candidate")
        kinds.add(kind)
        assert reads == {"other": 1, "no_candidate": 1, "candidate": 2}[kind]
        if len(graphed._graphs) == n_keys:       # no first call this step
            assert replays == {"other": 2, "no_candidate": 3,
                               "candidate": 4}[kind], kind
    assert kinds == {"other", "no_candidate", "candidate"}
    assert _kinds(graphed._graphs) == {"frame": 1, "templates": 1,
                                       "estimate": len(counter.keys)}
    # the re-estimate from the coarsest level with no alternative start
    # shares the first estimate's key
    assert len(counter.keys) == (1 if case == "reestimate_from_coarsest"
                                 else 2)
    assert not hasattr(graphed._pose_estimator, "_run_graphs")


def test_templates_copied_only_when_another_arrives(frames, monkeypatch):
    """``GraphCache.jit``'s copies into the graphs' buffers: on an other
    step the frame graph's image and the estimate's channels and starts,
    plus the templates (9 leaves a level) only when the keyframe changed
    since that estimate key last ran, on the step after a keyframe."""
    eager, graphed = _pair(AlgorithmParameters(**KW))
    copies = []
    copy_into = graphs.copy_into

    def recorded(dst, src):
        if not graphs.in_run():     # jit's, not a rerun's branch copies
            copies.append(len(graphs._leaves(src)))
        return copy_into(dst, src)
    monkeypatch.setattr(graphs, "copy_into", recorded)
    L = KW["numPyramidLevels"]
    after_keyframe, checked = False, 0
    for image, disp in frames:
        copies.clear()
        n_keys = len(graphed._graphs)
        rg = graphed.add_frame(image, disp)
        _assert_same(eager.add_frame(image, disp), rg)
        if not rg.is_keyframe and len(graphed._graphs) == n_keys:
            want = L + 1 + (9 * L if after_keyframe else 0)
            assert copies == [1, want], (copies, after_keyframe)
            checked += 1
        after_keyframe = rg.is_keyframe
    assert checked >= 2


def test_graphed_route_matches_jax(frames, monkeypatch):
    """JAX's VisualOdometry against the port's graphed route (stand-in)
    on JAX's CPU route (every level on ``gauss_newton.run``, the bound
    patched to 0): tests/test_torch_odometry.py's tolerances."""
    monkeypatch.setattr(gn, "MAX_LEVEL_KERNEL_POINTS", 0)
    K, b = _camera()
    jvo = JVisualOdometry(K, b, SIZE, JParams(**KW))
    tvo = VisualOdometry(K, b, SIZE, AlgorithmParameters(**KW), device="cpu")
    tvo._graphs = ReplayStandIn("cpu")
    results = [(jvo.add_frame(I, D), tvo.add_frame(I, D))
               for I, D in frames[:6]]
    _check_results(jvo, tvo, results, pose_atol=1e-5, it_tol=1)
    assert _kinds(tvo._graphs)["estimate"] == 2


def test_jax_checkpoint_continued_graphed(frames, tmp_path):
    """A checkpoint JAX's VisualOdometry wrote (keyframe, candidate,
    trajectory) loads into both routes of the port (the graphed one
    rebuilding the pyramids and templates through its graphs), and the
    continuations are bit for bit equal."""
    jvo = JVisualOdometry(*_camera(), SIZE, JParams(**KW))
    for image, disp in frames[:5]:       # frame 4 is the candidate
        jvo.add_frame(image, disp)
    path = str(tmp_path / "jax_vo")
    jvo.save(path)
    eager, graphed = _pair(AlgorithmParameters(**KW))
    for vo in (eager, graphed):
        vo.load(path)
    assert not graphed._prev.empty and graphed._ref.has_template
    assert _kinds(graphed._graphs) == {"frame": 1, "templates": 1}
    for image, disp in frames[5:]:
        _assert_same(eager.add_frame(image, disp),
                     graphed.add_frame(image, disp))
    np.testing.assert_array_equal(np.stack(graphed.trajectory.poses),
                                  np.stack(eager.trajectory.poses))


def test_bundle_adjustment_captured_at_enable(frames):
    """With BA enabled, the graphed route captures the BA graph of every
    window size at ``enable_bundle_adjustment`` (with the frame and
    template graphs, on a zero frame), captures nothing of BA in the frame
    loop, and its refined poses equal the eager route's bit for bit."""
    window = 3
    eager, graphed = _pair(AlgorithmParameters(**KW))
    first_calls = []
    first_call = graphed._graphs._first_call

    def recorded(key, fn):
        first_calls.append(key[0][0])
        return first_call(key, fn)
    graphed._graphs._first_call = recorded
    for vo in (eager, graphed):
        vo.enable_bundle_adjustment(window)
    assert not eager._ba_window.graphed()
    assert first_calls == ["frame", "templates"] + ["ba_solve"] * (
        window - 1)
    first_calls.clear()
    refined = 0
    for image, disp in frames:
        re, rg = eager.add_frame(image, disp), graphed.add_frame(image, disp)
        _assert_same(re, rg)
        got, want = (graphed.refined_keyframe_poses(),
                     eager.refined_keyframe_poses())
        assert got.dtype == want.dtype and np.array_equal(got, want)
        refined += int(re.is_keyframe and len(want) >= 2)
    assert refined >= 3 and len(graphed._ba_window) == window
    assert "ba_solve" not in first_calls
    assert set(first_calls) <= {"estimate"}
