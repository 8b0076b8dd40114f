"""The port's apps against the JAX package's on the CPU: ``VoApp`` on the
same written sequence (keyframes, poses within accepted delta (b), the
output files), the ``vo`` command line, threaded and unthreaded runs,
``vo_perf``, and ``eval_kitti run`` / ``eval`` on a written KITTI tree,
compared key by key with JAX's JSON."""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from bpvo_tpu.apps import eval_kitti as jeval_kitti
from bpvo_tpu.apps import vo_perf as jvo_perf
from bpvo_tpu.apps.vo_app import VoApp as JVoApp
from bpvo_tpu.data.synthetic import SyntheticPlaneDataset as JPlane
from bpvo_tpu.data.synthetic import write_sequence as jwrite_sequence
from bpvo_tpu_torch.apps import eval_kitti, vo, vo_perf
from bpvo_tpu_torch.apps.vo_app import VoApp
from bpvo_tpu_torch.data import synthetic
from bpvo_tpu_torch.eval import kitti_eval
from bpvo_tpu_torch.vo.point_cloud import read_ply

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POSE_ATOL = 1.8e-4          # accepted delta (b), ROADMAP C
# where a level's convergence test fires on another iteration (accepted
# delta (a)) the levels after it start elsewhere: chip_smoke.py's
# port-vs-JAX pose tolerance
EDGE_ATOL = 5e-4
OUTPUTS = ("_path.txt", "_poses.txt", "_kitti.txt", "_time.txt",
           "_iterations.txt")
N_FRAMES = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run both packages' whole pipelines, one step of small
    ops after another: with torch's thread pool as wide as the machine,
    they and the test files beside them (the suite runs several workers)
    wait on each other's spinning threads many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    """A noise-textured plane at 120x160 written by JAX's write_sequence
    (left PNG, PFM disparity, calib.txt), and a ``disparity`` config that
    keyframes every few frames."""
    root = tmp_path_factory.mktemp("seq")
    jwrite_sequence(JPlane(rows=120, cols=160, n_frames=N_FRAMES,
                           texture="noise", baseline=0.5), str(root / "seq"))
    cfg = root / "seq.cfg"
    cfg.write_text(
        "Dataset = disparity\n"
        f"DataSetRootDirectory = {root}/seq\n"
        f"CalibrationFile = {root}/seq/calib.txt\n"
        "numPyramidLevels = 3\nminSaliency = 2.0\nlossFunction = Huber\n"
        "functionTolerance = 1e-4\nparameterTolerance = 1e-6\n"
        "maxIterations = 50\nminTranslationMagToKeyFrame = 0.05\n"
        "minPointWeight = 0.5\nmaxDepth = 100\n")
    return str(cfg)


def _run_both(cfg, tmp_path, **kw):
    jres = JVoApp.from_config(cfg, trajectory_prefix=str(tmp_path / "j"),
                              points_prefix=str(tmp_path / "j"), **kw).run()
    tres = VoApp.from_config(cfg, device="cpu",
                             trajectory_prefix=str(tmp_path / "t"),
                             points_prefix=str(tmp_path / "t"), **kw).run()
    return jres, tres


def test_vo_app_matches_jax(sequence, tmp_path):
    """Threaded VoApp over the same files: the same frames, the motion of
    every frame within (b) where both packages ran the same number of GN
    iterations, within EDGE_ATOL where one level stopped elsewhere
    (measured: frame 7, its coarsest level 6 iterations in JAX and 3 in
    the port, 1.94e-4), and JAX's set of output files with the same rows."""
    jres, tres = _run_both(sequence, tmp_path)
    assert tres.num_frames == jres.num_frames == N_FRAMES
    assert len(tres.frame_interval_ms) == N_FRAMES
    pt = np.stack(tres.vo.trajectory.poses)
    pj = np.stack(jres.vo.trajectory.poses)
    same_iters = np.equal(tres.iterations, jres.iterations)
    assert same_iters.sum() >= N_FRAMES - 2
    for i in range(1, N_FRAMES):
        np.testing.assert_allclose(
            np.linalg.inv(pt[i - 1]) @ pt[i], np.linalg.inv(pj[i - 1]) @ pj[i],
            atol=POSE_ATOL if same_iters[i] else EDGE_ATOL)
    for suffix in OUTPUTS:
        a = np.loadtxt(tmp_path / f"t{suffix}")
        b = np.loadtxt(tmp_path / f"j{suffix}")
        assert a.shape == b.shape, suffix
        if suffix in ("_path.txt", "_poses.txt", "_kitti.txt"):
            np.testing.assert_allclose(a, b, atol=EDGE_ATOL)
    np.testing.assert_array_equal(np.loadtxt(tmp_path / "t_iterations.txt"),
                                  tres.iterations)
    plys = sorted(p.name for p in tmp_path.glob("t_*.ply"))
    assert len(plys) >= 2
    assert plys == sorted(p.name.replace("j_", "t_", 1)
                          for p in tmp_path.glob("j_*.ply"))
    for name in plys:
        a, b = read_ply(str(tmp_path / name)), read_ply(
            str(tmp_path / name.replace("t_", "j_", 1)))
        # the selections may keep other pixels among equal saliencies at
        # the capacity boundary (ROADMAP C.4)
        assert abs(len(a) - len(b)) <= 0.01 * len(b)


def test_vo_app_threaded_prefetched_and_unthreaded_are_bitwise(sequence,
                                                               tmp_path):
    """The loader thread (numpy frames, or CPU tensors with ``prefetch``)
    and frames read on the calling thread give the same trajectory bit for
    bit."""
    runs = {}
    for threaded, prefetch in ((True, True), (True, False), (False, False)):
        res = VoApp.from_config(sequence, device="cpu", threaded=threaded,
                                prefetch=prefetch, max_num_frames=6).run()
        runs[threaded, prefetch] = np.stack(res.vo.trajectory.poses)
        assert res.num_frames == 6
    first = runs[True, True]
    for poses in runs.values():
        np.testing.assert_array_equal(poses, first)


def test_vo_command_line(sequence, tmp_path):
    """``python -m bpvo_tpu_torch.apps.vo`` with JAX's flags and
    ``--device``: the files VoApp writes; ``--viewer`` dumps frames
    headless under ``<output>_frames``."""
    prefix = str(tmp_path / "cli")
    res = vo.main(["--config", sequence, "--output", prefix, "--points",
                   "--numframes", "5", "--buffersize", "2",
                   "--device", "cpu"])
    assert res.num_frames == 5
    for suffix in OUTPUTS:
        assert len(np.loadtxt(prefix + suffix)) == 5
    assert list(tmp_path.glob("cli_*.ply"))
    viewed = str(tmp_path / "viewed")
    assert vo.main(["--config", sequence, "--output", viewed, "--viewer",
                    "--numframes", "3", "--device", "cpu"]).num_frames == 3
    assert sorted(os.listdir(viewed + "_frames")) == ["frame_00000.png"]
    prefix2 = str(tmp_path / "notiming")
    vo.main(["--config", sequence, "--output", prefix2, "--numframes", "2",
             "--dontstoretiming", "--device", "cpu"])
    assert os.path.exists(prefix2 + "_kitti.txt")
    assert not os.path.exists(prefix2 + "_time.txt")


def test_vo_perf_matches_jax(sequence, tmp_path):
    j = jvo_perf.run_perf(sequence, str(tmp_path / "j"), num_frames=6,
                          warmup=2)
    t = vo_perf.run_perf(sequence, str(tmp_path / "t"), num_frames=6,
                         warmup=2, device="cpu")
    assert set(j) <= set(t) and t["frames"] == j["frames"] == 6
    assert t["device"] == "cpu"
    for suffix in OUTPUTS + ("_summary.json",):
        assert (tmp_path / f"t{suffix}").exists()
    np.testing.assert_allclose(np.loadtxt(tmp_path / "t_kitti.txt"),
                               np.loadtxt(tmp_path / "j_kitti.txt"),
                               atol=POSE_ATOL)


# The KITTI tree of the eval test: the bench scene's camera (fx 718.856 at
# 1241 columns, so the same field of view) at 120x320, 11 frames, the scene
# 400 times larger so the 10 steps cover the devkit's first 100 m segment
KITTI_ROWS, KITTI_COLS, KITTI_FRAMES, KITTI_SCALE = 120, 320, 11, 400.0


def test_eval_kitti_run_and_eval_match_jax(tmp_path, capsys):
    """``eval_kitti run`` (Intensity, TpuSGM with 128 disparities) then
    ``eval`` on a written KITTI tree, port and JAX: the same JSON keys,
    segment counts, and t_err / r_err / ATE within what (b) allows.
    JAX's values here set chip_smoke.py's bounds for the 376x1241 run
    (twice JAX's t_err and twice its ATE per metre of path)."""
    cs = _chip_smoke()
    ds = synthetic.SyntheticPlaneDataset(
        rows=KITTI_ROWS, cols=KITTI_COLS, n_frames=KITTI_FRAMES,
        fx=synthetic.FX * KITTI_COLS / synthetic.COLS,
        baseline=synthetic.BASELINE, texture="noise",
        twist_per_frame=synthetic.STEP_TWIST)
    frames = [(ds.get_frame(i).image, ds.right_image(i))
              for i in range(KITTI_FRAMES)]
    root = cs.write_kitti_tree(str(tmp_path / "kitti"), frames,
                               ds.calibration.K, ds.calibration.baseline,
                               KITTI_SCALE)
    eval_kitti.main(["run", "--root", root, "--out", str(tmp_path / "t"),
                     "--seqs", "0", "--device", "cpu"])
    jeval_kitti.run_sequences(root, str(tmp_path / "j"), [0])
    capsys.readouterr()
    eval_kitti.main(["eval", "--gt", os.path.join(root, "poses"),
                     "--results", str(tmp_path / "t"), "--seqs", "0",
                     "--plot-prefix", str(tmp_path / "plot")])
    got = json.loads(capsys.readouterr().out)
    want = json.loads(json.dumps(jeval_kitti.evaluate(
        os.path.join(root, "poses"), str(tmp_path / "j"), [0])))
    print(f"eval_kitti at {KITTI_ROWS}x{KITTI_COLS}: port {got}, JAX {want}")
    assert got.keys() == want.keys() == {"00"}
    g, w = got["00"], want["00"]
    assert g.keys() == w.keys()
    assert g["segments"] == w["segments"] == 1
    path_m = kitti_eval.trajectory_distances(kitti_eval.load_poses(
        os.path.join(root, "poses", "00.txt")))[-1]
    # (b) on each step of a 400x scene: 1.8e-4 x 400 m per step at most
    assert abs(g["ate_rmse_m"] - w["ate_rmse_m"]) <= 0.01 * w["ate_rmse_m"]
    assert abs(g["t_err_percent"] - w["t_err_percent"]) <= 0.05
    assert abs(g["r_err_deg_per_m"] - w["r_err_deg_per_m"]) <= 1e-4
    assert (tmp_path / "plot_00_tl.txt").exists()
    # each frame's motion within (b), its translation in the unscaled scene
    est = kitti_eval.load_poses(str(tmp_path / "t" / "00.txt"))
    jest = kitti_eval.load_poses(str(tmp_path / "j" / "00.txt"))
    for i in range(1, KITTI_FRAMES):
        a = np.linalg.inv(est[i - 1]) @ est[i]
        b = np.linalg.inv(jest[i - 1]) @ jest[i]
        np.testing.assert_allclose(a[:3, :3], b[:3, :3], atol=POSE_ATOL)
        np.testing.assert_allclose(a[:3, 3] / KITTI_SCALE,
                                   b[:3, 3] / KITTI_SCALE, atol=POSE_ATOL)
    # chip_smoke.py's bounds are twice JAX's values here
    assert cs.KITTI_T_ERR_BOUND >= 2 * w["t_err_percent"]
    assert cs.KITTI_ATE_PER_M >= 2 * w["ate_rmse_m"] / path_m


def test_app_entry_points_default_to_cuda(sequence, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        VoApp.from_config(sequence)
    with pytest.raises(RuntimeError, match="CUDA"):
        vo.main(["--config", sequence, "--output", str(tmp_path / "x")])
    with pytest.raises(RuntimeError, match="CUDA"):
        vo_perf.run_perf(sequence)
    with pytest.raises(RuntimeError, match="CUDA"):
        eval_kitti.run_sequences(str(tmp_path), str(tmp_path / "out"), [0])
