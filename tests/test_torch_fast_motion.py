"""The ``kitti00_bitplanes_stereo.fast_motion`` cell on the CPU, at a tiny
copy of its data files (``vobench/tests/conftest.py``'s sizes): its pool
is the configured pool thinned to every ``step_scale``-th frame, the
port's ``VisualOdometry`` (eager) follows ``vobench.reference`` step by
step with every step a keyframe without a candidate while the bfloat16
control does not, the level-solve counters give what each estimate's
statistics and the capacities give, and a whole run of the cell is
correct, keyframes nearly every frame and survives no planted fault."""
import argparse
import copy
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bpvo_tpu_torch.config import AlgorithmParameters
from bpvo_tpu_torch.ops import descriptors
from bpvo_tpu_torch.utils import profiling
from bpvo_tpu_torch.vo.pose_estimator import PoseEstimator
from vobench import bench, check, control, program, run, scene
from vobench.drivers import fast_motion
from vobench.drivers.base import Context, Pool
from vobench.reference import vo as ref_vo
from vobench.tests.conftest import TINY_CAMERA, tiny_cell
from vobench.tests.test_vobench_control import FAULTS

CELL = "kitti00_bitplanes_stereo.fast_motion"
SEED = 2 ** 31 + 77
# sound tiny runs read 2.2e-5 (seed 2**31 + 77); the bfloat16 control 7.1e-2
POSE_TOL = 5e-4
# the fast pool's step is exp(4 xi) where the configured pool's is exp(xi)
# composed four times, each exp in float32 (2.3e-7 apart a step): the
# frames land up to 0.0092 grey levels (of 0-400) and 7.6e-6 px of
# disparity apart over 31 frames, three seeds
IMAGE_ATOL, DISP_ATOL, STEP_ATOL = 0.05, 1e-4, 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Whole-frame runs of small ops: one torch thread keeps the suite's
    workers from waiting on each other's spinning thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cell(tmp_path):
    return tiny_cell(tmp_path, CELL)


def _driver(cell, setup=None, n_frames=8):
    """The cell's driver on the CPU, set up (``setup``: the program, or
    the control in its place) and run for ``n_frames`` more frames."""
    drv = fast_motion.Driver(cell, SEED, torch.device("cpu"), Context(cell))
    (setup or fast_motion.Driver.setup)(drv)
    drv._run(n=n_frames)
    return drv


def _steps(drv):
    stream = drv.stream
    return check.steps_of([x["frame"] for x in stream],
                          [x["pose"] for x in stream[1:]],
                          [x["is_kf"] for x in stream[1:]])


@pytest.mark.parametrize("seed", [7, 2 ** 31 + 5, 2 ** 33 + 1])
def test_fast_pool_is_every_fourth_frame_of_the_configured_pool(seed):
    """The configuration's 121 frames (at the tiny camera) against the
    fast pool's 31: images, right images and disparities within the
    float32 rounding of the step's exponential, and the true step the
    configured step four times."""
    cfg = copy.deepcopy(bench.Cell(CELL).config)
    cfg["camera"] = dict(TINY_CAMERA)
    cells = [SimpleNamespace(config=c, mix={"sequences": 1},
                             inputs="stereo")
             for c in (cfg, fast_motion.fast_config(cfg, 4))]
    base, fast = (Pool(c, seed, torch.device("cpu")) for c in cells)
    assert (base.n_frames, fast.n_frames) == (121, 31)
    for name, atol in (("images", IMAGE_ATOL), ("rights", IMAGE_ATOL),
                       ("disparities", DISP_ATOL)):
        a, b = getattr(base, name)[:, ::4], getattr(fast, name)
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= atol, name
    assert fast.disparity_range == pytest.approx(base.disparity_range,
                                                 abs=DISP_ATOL)
    step = scene.step_pose(cfg["scene"]["step_twist"])
    assert np.abs(fast.gt_step() - np.linalg.matrix_power(step, 4)).max() \
        <= STEP_ATOL


def test_step_scale_must_divide_the_sequence():
    cfg = {"sequence_frames": 121, "scene": {"step_twist": [0.0] * 6}}
    assert fast_motion.fast_config(cfg, 8)["sequence_frames"] == 16
    with pytest.raises(ValueError, match="does not divide"):
        fast_motion.fast_config(cfg, 7)


def test_configuration_is_the_cfg_as_bpvo_reads_it():
    """The configuration's params are ``conf/kitti_bitplanes.cfg`` read by
    the config-file constructor (reference types.cc:69-109, mirrored by
    ``AlgorithmParameters.from_config``), field for field: the keys the
    file leaves out take that constructor's fallbacks (0.1 m and 2.5
    degrees to keyframe, CD5, gradientTolerance 1e-6, minValidDisparity
    1.0), not the default constructor's (types.cc:31-66)."""
    params = program.algorithm_parameters(bench.Cell(CELL).config["params"])
    from_cfg = AlgorithmParameters.from_config_file(
        str(bench.ROOT / "conf" / "kitti_bitplanes.cfg"))
    assert params == from_cfg
    assert params != AlgorithmParameters(
        **{f: getattr(from_cfg, f) for f in (
            "descriptor", "lossFunction", "sigmaPriorToCensusTransform",
            "sigmaBitPlanes", "numPyramidLevels", "maxIterations",
            "parameterTolerance", "functionTolerance", "minSaliency",
            "goodPointThreshold", "maxFractionOfGoodPointsToKeyFrame")})


def test_the_fast_step_alone_passes_the_keyframe_test():
    """The cell's premise: the fast step's translation passes the
    configuration's translation test (0.1226 m against 0.1) and the
    configured step's does not (0.0307 m); neither turns 2.5 degrees."""
    cfg = bench.Cell(CELL).config
    p = cfg["params"]
    for scale, passes in ((1, False), (4, True)):
        step = scene.step_pose(fast_motion.fast_config(cfg, scale)
                               ["scene"]["step_twist"])
        assert (np.linalg.norm(step[:3, 3])
                > p["minTranslationMagToKeyFrame"]) == passes
        angle = np.degrees(np.arccos((np.trace(step[:3, :3]) - 1) / 2))
        assert angle < p["minRotationMagToKeyFrame"]


@pytest.mark.parametrize("who", ["program", "control"])
def test_port_follows_the_reference_step_by_step(cell, who):
    """Every step after the first frame, recomputed by the reference from
    the program's earlier outputs: the port within ``POSE_TOL`` with the
    reference's keyframe decisions, every step a keyframe and none with a
    candidate (``keyframes_own`` counts each); the bfloat16 control in the
    port's place beyond it."""
    profiling.reset()
    drv = _driver(cell, None if who == "program" else control.put_in_place)
    steps = _steps(drv)
    ref = check.reference(cell.config, drv.pool.images[0],
                          drv.pool.rights[0], True,
                          ref_vo.MIN_POINTS_VISUAL_ODOMETRY)
    out = check.judge_steps(ref, steps, list(range(len(steps))),
                            cell.limits["bands"])
    if who == "control":
        assert out["pose_err"] > POSE_TOL
        return
    assert out["pose_err"] <= POSE_TOL
    assert out["kf_differ"] == [] and out["kf_mismatch"] == 0
    assert all(s["is_kf"] and not s["has_prev"] for s in steps)
    n = len(steps)
    assert profiling.counts()["keyframes"] == n
    assert profiling.counts()["keyframes_own"] == n


def _expected_solves(p, capacities, C, calls):
    """The ``gn_*`` counters' sums over ``calls`` ((start_level, stats)
    of each estimate): each solved level's 1, K, C K, it K and it C K,
    ``it`` its statistics' iterations, at least 1."""
    n = k = ck = itk = itck = 0
    L = len(capacities)
    for start, stats in calls:
        first = L - 1 if start < 0 else start
        for level in range(first, p.maxTestLevel - 1, -1):
            it = max(stats[level - p.maxTestLevel].num_iterations, 1)
            K = capacities[level]
            n, k, ck = n + 1, k + K, ck + C * K
            itk, itck = itk + it * K, itck + it * C * K
    return {"gn_solves": n, "gn_points": k, "gn_channel_points": ck,
            "gn_iter_points": itk, "gn_iter_channel_points": itck}


def test_solve_counters_give_the_statistics_and_capacities(cell,
                                                           monkeypatch):
    """Each estimate's levels from its start down, with the iterations
    its statistics read and the template capacities, at C = 8."""
    calls = []
    orig = PoseEstimator.estimate

    def estimate(self, *a, start_level=-1, **kw):
        T, stats = orig(self, *a, start_level=start_level, **kw)
        calls.append((start_level, stats))
        return T, stats
    monkeypatch.setattr(PoseEstimator, "estimate", estimate)
    profiling.reset()
    drv = _driver(cell)
    p = drv.vo.params
    C = descriptors.num_channels(p.descriptor, p)
    assert C == 8 and calls
    got = {k: v for k, v in profiling.counts().items()
           if k.startswith("gn_")}
    assert got == _expected_solves(p, drv.vo._capacities, C, calls)
    assert any(s.num_iterations > 1 for _, st in calls for s in st)


def _run_cell(cell, trace=0, **kw):
    args = argparse.Namespace(workload=cell.name, seed=SEED, seconds=1.0,
                              trace=trace)
    return run.run_cell(args, device="cpu", cell=cell,
                        setup_clock=lambda: 0.0, **kw)


def test_a_run_of_the_cell_is_correct_and_keyframes_every_frame(cell):
    """The result line of ``vobench.run``: the cell's end-to-end metrics,
    ``correct``, and a window whose frames are keyframes (share >= 0.9)."""
    drivers = []
    out = _run_cell(cell, fault=drivers.append)
    assert set(out["metrics"]) == {"frame_ms_p50", "frame_ms_p95",
                                   "setup_s"}
    assert out["correct"] and out["failed"] == 0
    (drv,) = drivers
    lo, hi = drv._window
    window = drv.stream[lo:hi]
    assert len(window) == out["attempted"] > 0
    assert sum(s["is_kf"] for s in window) / len(window) >= 0.9


def test_a_traced_run_on_the_cpu_reads_the_host_metrics(cell):
    """No device trace and no spans on the CPU: only the harness's host
    readings, of the cell's per-layer metrics."""
    out = _run_cell(cell, trace=1)
    names = {m["name"] for m in cell.metrics(trace=True)}
    assert {"level_gn_roofline_pct.online",
            "keyframes_own_per_frame.online"} <= names
    assert set(out["metrics"]) == {"add_frame_ms_p50.online",
                                   "matcher_ms_p50.online"}
    assert out["correct"]


@pytest.mark.parametrize("plant", FAULTS["online"],
                         ids=["stuck", "half", "altered"])
def test_a_planted_fault_is_not_correct(cell, plant):
    """The online faults of ``vobench/tests/test_vobench_control.py`` (a
    state left unchanged, every other frame's result repeated, poses moved
    2 cm), each under the timed path."""
    assert not _run_cell(cell, fault=lambda drv: plant(drv.vo))["correct"]
