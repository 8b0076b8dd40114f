"""The ``kitti00_dense.online_stereo`` cell on the CPU: its configuration is
``conf/tunnel.cfg`` as bpvo's config-file constructor reads it, with the
one capacity the port needs; at the cell's shape every level with more than
``MAX_LEVEL_KERNEL_POINTS`` points takes ``gauss_newton.run``; and on a
small dense plane sequence whose finest level takes ``run`` the port's
``VisualOdometry``, eager and through a graph stand-in, follows
``vobench.reference`` within the cell's ``pose_err``, its ``gn_run_*``
counters and the ``run`` timers giving the iterations its estimates
report."""
import copy
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bpvo_tpu_torch import VisualOdometry
from bpvo_tpu_torch.config import AlgorithmParameters
from bpvo_tpu_torch.data.stereo import TpuSGM
from bpvo_tpu_torch.solver import gauss_newton as gn
from bpvo_tpu_torch.utils import graphs, profiling
from bpvo_tpu_torch.vo import device_vo
from vobench import bench, check, program
from vobench.drivers.base import Pool
from vobench.reference import vo as ref_vo

CELL = "kitti00_dense.online_stereo"
# the small sequence: 128x400 (the KITTI camera's focal length scaled by
# 400 / 1241), L0's 51200-point capacity above MAX_LEVEL_KERNEL_POINTS
SMALL = {"rows": 128, "cols": 400, "fx": 231.71, "baseline": 0.537,
         "rate_hz": 10}
SMALL_DISPARITIES, SMALL_FRAMES, STEPS = 32, 9, 4
SEED = 2 ** 32 + 2026


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Whole-frame runs of small ops: one torch thread keeps the suite's
    workers from waiting on each other's spinning thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cell():
    return bench.Cell(CELL)


def test_configuration_is_tunnel_cfg_with_a_capacity_that_never_binds():
    """The params are ``conf/tunnel.cfg`` read by the config-file
    constructor (reference types.cc:69-109): the keys it sets (Bit-Planes,
    census at sigma 1.0 and planes at 1.6, 6 levels, Huber, function
    tolerance 5e-4, a 0 m translation threshold, NMS off at 2e7 pixels) and
    that constructor's fallbacks for the rest (0.75 good-point threshold,
    CD5); only ``pointCapacity`` differs, 2^19, every level's whole
    image."""
    cfg = _cell().config
    params = program.algorithm_parameters(cfg["params"])
    from_cfg = AlgorithmParameters.from_config_file(
        str(bench.ROOT / "conf" / "tunnel.cfg"))
    assert params == from_cfg.replace(pointCapacity=2 ** 19)
    assert from_cfg.pointCapacity != params.pointCapacity
    assert (params.numPyramidLevels, params.functionTolerance,
            params.minTranslationMagToKeyFrame, params.goodPointThreshold,
            params.sigmaPriorToCensusTransform, params.sigmaBitPlanes) == (
                6, 5e-4, 0.0, 0.75, 1.0, 1.6)
    c = cfg["camera"]
    assert c["rows"] * c["cols"] < params.minNumPixelsForNonMaximaSuppression
    assert cfg["reduced"].keys() == {"sequence_frames"}


def test_levels_above_the_level_kernel_take_run_at_the_cells_shape():
    """At 376x1241 the capacities are the levels' whole images (466616
    points at L0 down to 468 at the 12x39 top), and ``solve_level`` sends
    exactly the levels above ``MAX_LEVEL_KERNEL_POINTS`` (L0-L2) to
    ``run``, the rest to the level kernel."""
    cfg = _cell().config
    c = cfg["camera"]
    p = program.algorithm_parameters(cfg["params"])
    K = program.camera_matrix(cfg)
    p, _, capacities, opts = device_vo._setup_levels(
        K, c["baseline"], (c["rows"], c["cols"]), p)
    shapes = [(376, 1241), (188, 621), (94, 311), (47, 156), (24, 78),
              (12, 39)]
    assert list(capacities) == [r * w for r, w in shapes]
    on_run = [not gn.level_kernel_supported(o, 8, r, w, k)
              for o, (r, w), k in zip(opts, shapes, capacities)]
    assert on_run == [k > gn.MAX_LEVEL_KERNEL_POINTS for k in capacities]
    assert on_run == [True, True, True, False, False, False]


@pytest.fixture(scope="module")
def small():
    """The cell's configuration at 128x400 and its rendered pool."""
    cfg = copy.deepcopy(_cell().config)
    cfg["camera"] = dict(SMALL)
    cfg["matcher"]["num_disparities"] = SMALL_DISPARITIES
    cfg["sequence_frames"] = SMALL_FRAMES
    pool = Pool(SimpleNamespace(config=cfg, mix={"sequences": 1},
                                inputs="stereo"), SEED, torch.device("cpu"))
    return cfg, pool


@pytest.mark.parametrize("graphed", [False, True])
def test_small_dense_sequence_follows_the_reference(small, graphed):
    """1 + ``STEPS`` frames, each matched by ``TpuSGM`` and handed to
    ``VisualOdometry`` (eager, or through ``graphs.RerunCache``): every
    step a keyframe without a candidate, each within the cell's
    ``pose_err`` of the reference's step from the same state; over the
    estimates ``gn_run_solves`` is one a frame (L0 alone takes ``run``),
    ``gn_run_iters`` the iterations the statistics report at L0, and the
    L0 timer, settled, counts the same iterations and no time."""
    cfg, pool = small
    c = cfg["camera"]
    vo = VisualOdometry(program.camera_matrix(cfg), c["baseline"],
                        (c["rows"], c["cols"]),
                        program.algorithm_parameters(cfg["params"]),
                        device="cpu")
    assert vo._capacities[0] > gn.MAX_LEVEL_KERNEL_POINTS
    assert vo._capacities[1] <= gn.MAX_LEVEL_KERNEL_POINTS
    if graphed:
        vo._graphs = graphs.RerunCache("cpu")
    sgm = program.matcher(cfg)
    assert isinstance(sgm, TpuSGM)
    timer = graphs.timer("gn.run.L0")
    graphs.settle()
    profiling.reset()
    t_iters, t_ns = timer.launch_count, timer.ns
    poses, kfs, reported = [], [], 0
    for f in range(STEPS + 1):
        left, right = pool.images[0, f], pool.rights[0, f]
        res = vo.add_frame(left, sgm.run(left, right, device="cpu"))
        if f:
            poses.append(np.asarray(res.pose, np.float64))
            kfs.append(res.is_keyframe)
            reported += res.optimizer_statistics[0].num_iterations
    graphs.settle()
    counts = profiling.counts()
    assert counts["gn_run_solves"] == STEPS
    assert counts["gn_run_iters"] == reported > STEPS
    assert timer.launch_count - t_iters == reported
    assert timer.ns == t_ns
    assert counts["gn.run.L0.iterations"] == reported
    assert all(kfs) and counts["keyframes_own"] == STEPS
    steps = check.steps_of(list(range(STEPS + 1)), poses, kfs)
    ref = check.reference(cfg, pool.images[0], pool.rights[0], True,
                          ref_vo.MIN_POINTS_VISUAL_ODOMETRY)
    limits = _cell().limits
    out = check.judge_steps(ref, steps, list(range(STEPS)), limits["bands"])
    assert out["pose_err"] <= limits["pose_err"], out
    assert out["kf_mismatch"] == 0
