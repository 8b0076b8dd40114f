"""The port's windowed bundle adjustment (``bpvo_tpu_torch.parallel
.bundle_adjustment``) against the JAX package's on the CPU, on
tests/test_ba.py's window (M = 4 keyframes of 1024 points at 120x160):
poses at atol 5e-4 and the cost at rtol 1e-3 (pose-only), atol 1e-3 with
the depth Schur complement; the gauge, the edges, the adjoint, the host
window, and ``VisualOdometry.enable_bundle_adjustment`` against JAX's
``refined_keyframe_poses`` at atol 5e-4.  On the CPU ``irls_reduce_w``
(pass 2 of each edge) runs its plain version."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpvo_tpu import AlgorithmParameters as JParams
from bpvo_tpu import VisualOdometry as JVisualOdometry
from bpvo_tpu.core import se3 as jse3
from bpvo_tpu.parallel import bundle_adjustment as jba
from bpvo_tpu.vo import warp as jwarp
from bpvo_tpu_torch import AlgorithmParameters, VisualOdometry
from bpvo_tpu_torch.parallel import bundle_adjustment as ba
from bpvo_tpu_torch.parallel import multihost, sharded
from bpvo_tpu_torch.solver import gauss_newton as gn
from bpvo_tpu_torch.utils import convert
from test_ba import build_window, perturb, pose_errors
from test_gn import H_IMG, W_IMG, make_cam
from test_odometry import make_sequence

POSE_ATOL = 5e-4
COST_RTOL = 1e-3
DEPTH_ATOL = 1e-3


@pytest.fixture(scope="module")
def window():
    """(JAX cam, gt poses, JAX stacked templates, JAX channels, the port's
    cam, stacked templates and channels)."""
    cam, poses_gt, templates, channels = build_window()
    stacked = jba.stack_templates(templates)
    ch = jnp.stack(channels)
    t_stacked = convert.template_from_numpy(
        {k: np.asarray(v) for k, v in stacked._asdict().items()}, "cpu")
    return (cam, poses_gt, stacked, ch, convert.camera_from_numpy(cam),
            t_stacked, torch.from_numpy(np.array(ch)))


def _corrupt_depths(stacked, scale=0.02, seed=3):
    """tests/test_ba.py's depth corruption, per keyframe, as numpy."""
    r = np.random.default_rng(seed)
    pts = np.array(stacked.points)
    for i in range(pts.shape[0]):
        f = (1.0 + scale * r.standard_normal(pts.shape[1])).astype(
            np.float32)
        pts[i] = pts[i] * f[:, None]
    return pts


def _both(window, opts_kw, poses0, points=None, with_depth=False):
    """JAX's and the port's ``ba_solve`` (``ba_solve_with_depth`` with
    ``with_depth``, which also returns the points) on the same inputs."""
    cam, _, stacked, ch, tcam, tstacked, tch = window
    if points is not None:
        stacked = stacked._replace(points=jnp.asarray(points))
        tstacked = tstacked._replace(points=torch.from_numpy(points))
    jopts = jba.BAOptions(**opts_kw)
    topts = convert.ba_options_from_jax(jopts)
    p0 = np.stack(poses0)
    if with_depth:
        pj, tdj, cj = jax.jit(lambda t, c, p: jba.ba_solve_with_depth(
            t, c, cam, p, jopts))(stacked, ch, jnp.asarray(p0))
        pt, tdt, ct = ba.ba_solve_with_depth(tstacked, tch, tcam,
                                             torch.from_numpy(p0), topts)
        return (np.asarray(pj), np.asarray(tdj.points), float(cj),
                pt.numpy(), tdt.points.numpy(), float(ct))
    pj, cj = jax.jit(lambda t, c, p: jba.ba_solve(t, c, cam, p, jopts))(
        stacked, ch, jnp.asarray(p0))
    pt, ct = ba.ba_solve(tstacked, tch, tcam, torch.from_numpy(p0), topts)
    return np.asarray(pj), float(cj), pt.numpy(), float(ct)


def test_edges_match_jax():
    for m, r in ((3, 1), (4, 2), (8, 1), (5, 3)):
        assert ba.window_edges(m, r) == jba.window_edges(m, r)
    assert len(ba.window_edges(8, 1)) == 14


def test_adjoint_similarity_matches_jax():
    r = np.random.default_rng(2)
    s = np.float32(1.7)
    c = r.standard_normal(3).astype(np.float32)
    T = np.asarray(jse3.exp(jnp.asarray(
        (0.3 * r.standard_normal(6)).astype(np.float32))))
    G = np.asarray(jwarp.normalization_matrix(jnp.asarray(s),
                                              jnp.asarray(c))) @ T
    Aj = np.asarray(jba.adjoint_similarity(jnp.asarray(G), jnp.asarray(s)))
    At = ba.adjoint_similarity(torch.from_numpy(G), torch.tensor(s)).numpy()
    np.testing.assert_allclose(At, Aj, atol=1e-6)


def test_ba_solve_matches_jax(window):
    _, poses_gt, *_ = window
    poses0 = perturb(poses_gt)
    pj, cj, pt, ct = _both(window, dict(max_iterations=10), poses0)
    np.testing.assert_allclose(pt, pj, atol=POSE_ATOL)
    np.testing.assert_allclose(ct, cj, rtol=COST_RTOL)
    err_before = pose_errors(poses0, poses_gt)
    err_after = pose_errors(pt, poses_gt)
    assert err_after.max() < min(err_before[1:].max() * 0.35, 2e-3)


def test_ba_gauge_fixed(window):
    _, poses_gt, *_ = window
    pj, _, pt, _ = _both(window, dict(max_iterations=5), perturb(poses_gt))
    np.testing.assert_allclose(pt[0], poses_gt[0], atol=1e-4)
    np.testing.assert_allclose(pt, pj, atol=POSE_ATOL)


def test_depth_schur_matches_jax(window):
    """tests/test_ba.py's corrupted depths: poses within DEPTH_ATOL of JAX's
    and within 3e-3 of the truth, the depths pulled back toward the truth
    and within 0.5% of JAX's."""
    _, poses_gt, stacked, *_ = window
    bad = _corrupt_depths(stacked)
    pj, zj, cj, pt, zt, ct = _both(
        window, dict(max_iterations=8, refine_depth=True),
        perturb(poses_gt, scale=0.002), points=bad, with_depth=True)
    np.testing.assert_allclose(pt, pj, atol=DEPTH_ATOL)
    assert pose_errors(pt, poses_gt).max() < 3e-3
    valid = np.asarray(stacked.valid)
    gt_Z = np.asarray(stacked.points)[..., 2]
    before = np.abs(bad[..., 2] - gt_Z)[valid].mean()
    after = np.abs(zt[..., 2] - gt_Z)[valid].mean()
    assert after < before * 0.8, (before, after)
    # the depths agree to 0.5% (measured: 12 of 12288 coordinates of
    # weakly observed points past 1e-3 absolute, at most 0.2% relative)
    np.testing.assert_allclose(zt[valid], zj[valid], rtol=5e-3)


def test_depth_refinement_on_clean_data_matches_jax(window):
    """``ba_solve`` with ``refine_depth`` delegates to the Schur solver."""
    _, poses_gt, *_ = window
    pj, cj, pt, ct = _both(window, dict(max_iterations=8, refine_depth=True),
                           perturb(poses_gt, scale=0.003))
    np.testing.assert_allclose(pt, pj, atol=DEPTH_ATOL)
    assert pose_errors(pt, poses_gt).max() < 3.5e-3


def test_keyframe_window_matches_jax(window):
    cam, poses_gt, stacked, ch, tcam, tstacked, tch = window
    poses0 = perturb(poses_gt)
    opts = jba.BAOptions(max_iterations=6)
    jwin = jba.KeyframeWindow(max_keyframes=3, cam=cam, opts=opts)
    twin = ba.KeyframeWindow(3, tcam, convert.ba_options_from_jax(opts),
                             device="cpu")
    assert twin.optimize().shape == (0,)
    for i, pose in enumerate(poses0):
        jwin.push(jax.tree.map(lambda x: x[i], stacked), ch[i], pose)
        twin.push(ba.TemplateData(*(x[i] for x in tstacked)), tch[i], pose)
    assert len(twin) == len(jwin) == 3          # the window slid
    np.testing.assert_allclose(twin.optimize(), jwin.optimize(),
                               atol=POSE_ATOL)


def test_one_rank_layouts_equal_ba_solve(window):
    """With no reducer, the point-sharded runner and the 2-D runner on a
    1 x 1 layout are ``ba_solve`` bit for bit (the same edges in the same
    order)."""
    _, poses_gt, _, _, tcam, tstacked, tch = window
    p0 = torch.from_numpy(np.stack(perturb(poses_gt)))
    opts = ba.BAOptions(max_iterations=3)
    want, cost = ba.ba_solve(tstacked, tch, tcam, p0, opts)
    got, c1 = ba.make_sharded_ba(None, opts, 4)(tstacked, tch, tcam, p0)
    layout = multihost.global_mesh(kf_axis_size=1, world_size=1)
    loc = ba.shard_window_2d(tstacked, 0, layout)
    got2, c2 = ba.make_sharded_ba_2d(None, opts, 4, layout)(loc, tch, tcam,
                                                            p0)
    assert torch.equal(got, want) and torch.equal(got2, want)
    assert float(c1) == float(c2) == float(cost)


def test_shard_window_2d_slices_keyframes_and_points(window):
    tstacked = window[5]
    layout = multihost.RankLayout(kf=2, points=3)
    K = tstacked.points.shape[1]
    k = (K + (-K) % 3) // 3
    for rank in range(6):
        kf, pt = layout.coords(rank)
        loc = ba.shard_window_2d(tstacked, rank, layout)
        assert loc.points.shape == (2, k, 3)
        want = sharded.shard_template(
            ba.TemplateData(*(x[2 * kf:2 * kf + 2] for x in tstacked)), pt, 3)
        assert all(torch.equal(a, b) for a, b in zip(loc, want))
    with pytest.raises(ValueError):
        ba.shard_window_2d(tstacked, 0, multihost.RankLayout(kf=3, points=1))


STEP = [0, 0, 0, 0.004, 0, 0.008]
KW = dict(minSaliency=2.0, numPyramidLevels=3, functionTolerance=1e-4,
          parameterTolerance=1e-6, maxIterations=50, pointCapacity=2048,
          minTranslationMagToKeyFrame=0.015)


def test_visual_odometry_bundle_adjustment_matches_jax(monkeypatch):
    """``enable_bundle_adjustment`` on both packages' ``VisualOdometry`` (a
    keyframe every second frame, a window of 3 that slides), the port on
    JAX's CPU route (``gauss_newton.run`` at every level): the refined
    keyframe poses after every keyframe at atol 5e-4; the tracked poses
    are untouched by BA."""
    monkeypatch.setattr(gn, "MAX_LEVEL_KERNEL_POINTS", 0)
    frames = make_sequence(STEP, 8)
    cam = make_cam()
    K, b = np.asarray(cam.K()), float(cam.baseline)
    jvo = JVisualOdometry(K, b, (H_IMG, W_IMG), JParams(**KW))
    tvo = VisualOdometry(K, b, (H_IMG, W_IMG), AlgorithmParameters(**KW),
                         device="cpu")
    plain = VisualOdometry(K, b, (H_IMG, W_IMG), AlgorithmParameters(**KW),
                           device="cpu")
    opts = jba.BAOptions(max_iterations=5)
    jvo.enable_bundle_adjustment(3, ba_options=opts)
    tvo.enable_bundle_adjustment(3, ba_options=convert.ba_options_from_jax(
        opts))
    n_checked = 0
    for I, D in frames:
        rj, rt = jvo.add_frame(I, D), tvo.add_frame(I, D)
        np.testing.assert_allclose(rt.pose, plain.add_frame(I, D).pose,
                                   atol=0)
        assert rt.is_keyframe == rj.is_keyframe
        pj, pt = jvo.refined_keyframe_poses(), tvo.refined_keyframe_poses()
        assert pt.shape == pj.shape
        if len(pt) >= 2:
            np.testing.assert_allclose(pt, pj, atol=POSE_ATOL)
            n_checked += 1
    assert n_checked >= 3 and len(tvo.refined_keyframe_poses()) == 3
