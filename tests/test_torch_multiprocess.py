"""The port's distributed layer across real process boundaries on the CPU:
ranks spawned by ``multihost.launch`` (``python -m
bpvo_tpu_torch.parallel.worker``, one per rank, gloo, one CPU thread each),
their inputs and outputs npz files, against the JAX package on a mesh of
conftest's 8 virtual devices, as tests/test_multiprocess.py runs JAX's own
workers: 2-rank sharded GN (and at capacity 1001, padding masked), 2-rank
sharded VO over 4 frames with a keyframe, 4-rank 2-D BA (kf 2 x points 2),
all at atol 5e-4 with the ranks bitwise equal, and a 2-rank
``KeyframeWindow`` (pose-only at 5e-4, depth Schur at 1e-3); the dry run and the scaling
bench at a small size; a rank whose peer never comes fails at the group's
timeout instead of hanging."""
import dataclasses
import enum
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bpvo_tpu.config import AlgorithmParameters as JParams
from bpvo_tpu.parallel import bundle_adjustment as jba
from bpvo_tpu.parallel import multihost as jmh
from bpvo_tpu.parallel import sharded as jsh
from bpvo_tpu.parallel import sharded_vo as jsvo
from bpvo_tpu.solver import gauss_newton as jgn
from bpvo_tpu.types import LossFunctionType as JLoss
from bpvo_tpu_torch.parallel import multihost
from test_ba import build_window, perturb
from test_gn import H_IMG, W_IMG, build_template, make_cam, render_pair
from test_odometry import make_sequence

ATOL = 5e-4
TIMEOUT_S = 300
WORKER = "bpvo_tpu_torch.parallel.worker"


def _json(obj) -> str:
    d = obj._asdict() if hasattr(obj, "_asdict") else dataclasses.asdict(obj)
    return json.dumps({k: v.value if isinstance(v, enum.Enum) else v
                       for k, v in d.items()})


def _cam(cam):
    return np.array([cam.fx, cam.fy, cam.cx, cam.cy, cam.baseline],
                    np.float32)


def _template_arrays(tdata):
    return {f"td_{k}": np.asarray(v) for k, v in tdata._asdict().items()}


def _run(tmp_path, mode, world, **inputs):
    """Spawn ``world`` ranks of the worker; each rank's outputs."""
    inp = str(tmp_path / "in.npz")
    np.savez(inp, **inputs)
    done = multihost.launch(WORKER, ["--mode", mode, "--inp", inp, "--out",
                                     str(tmp_path), "--backend", "gloo",
                                     "--device", "cpu", "--threads", "1"],
                            world, TIMEOUT_S)
    for r, d in enumerate(done):
        assert d.returncode == 0, f"rank {r}: {d.returncode}\n{d.stdout[-3000:]}"
        assert f"WORKER_OK mode={mode} rank={r} world={world}" in d.stdout
    outs = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]
    for o in outs[1:]:
        for k in o:
            if k != "weights":       # the weights stay per rank
                np.testing.assert_array_equal(o[k], outs[0][k], err_msg=k)
    return outs


@pytest.mark.parametrize("capacity", [2048, 1001])
def test_two_rank_sharded_gn(tmp_path, capacity):
    """Against JAX's ``make_sharded_gn`` on a 2-device mesh; at capacity
    1001 the second rank's last slot is padding (masked)."""
    I0, I1, D, cam, T_true = render_pair(
        [0.001, -0.002, 0.001, 0.01, -0.005, 0.015])
    tdata, _ = build_template(I0, D, cam, capacity=capacity)
    opts = jgn.GNOptions(loss=JLoss.HUBER, function_tolerance=1e-4,
                         parameter_tolerance=1e-6)
    mesh = jsh.make_mesh(2)
    st = jsh.make_sharded_gn(mesh, opts)(jsh.shard_template(tdata, mesh),
                                         jnp.asarray(I1)[None], cam,
                                         jnp.eye(4))
    outs = _run(tmp_path, "gn", 2, **_template_arrays(tdata),
                channels=np.asarray(I1, np.float32)[None], cam=_cam(cam),
                opts=_json(opts), T_init=np.eye(4, dtype=np.float32))
    np.testing.assert_allclose(outs[0]["T"], np.asarray(st.T), atol=ATOL)
    assert abs(int(outs[0]["num_iters"]) - int(st.num_iters)) <= 1
    half = (capacity + capacity % 2) // 2
    assert [o["weights"].shape for o in outs] == [(1, half)] * 2
    if capacity % 2:
        assert outs[1]["weights"][0, -1] == 0.0


def test_two_rank_sharded_vo(tmp_path):
    """The whole sharded VO step over 4 frames in two chunks, a keyframe
    among them, against JAX's ``make_sharded_vo`` on a 2-device mesh: world
    poses at atol 5e-4, the same keyframe flags."""
    p = JParams(minSaliency=2.0, numPyramidLevels=3, functionTolerance=1e-4,
                parameterTolerance=1e-6, maxIterations=50,
                minTranslationMagToKeyFrame=0.04)
    frames = make_sequence([0, 0, 0, 0.0, 0.0, 0.011], 5)
    cam = make_cam()
    K = np.asarray(cam.K(), np.float32)
    images = np.stack([f[0] for f in frames]).astype(np.float32)
    disps = np.stack([f[1] for f in frames]).astype(np.float32)
    init_fn, _, scan_fn = jsvo.make_sharded_vo(jsh.make_mesh(2), K,
                                               float(cam.baseline),
                                               (H_IMG, W_IMG), p)
    state = init_fn(jnp.asarray(images[0]), jnp.asarray(disps[0]))
    world, kf = [], []
    for lo, hi in ((1, 3), (3, 5)):
        state, out = scan_fn(state, jnp.asarray(images[lo:hi]),
                             jnp.asarray(disps[lo:hi]))
        world.append(np.asarray(out.pose_world))
        kf.append(np.asarray(out.is_keyframe))
    outs = _run(tmp_path, "vo", 2, images=images, disparities=disps, K=K,
                baseline=np.float32(cam.baseline), params=_json(p),
                chunks=np.array([2, 2]))
    np.testing.assert_allclose(outs[0]["pose_world"], np.concatenate(world),
                               atol=ATOL)
    np.testing.assert_array_equal(outs[0]["is_keyframe"],
                                  np.concatenate(kf))
    assert outs[0]["is_keyframe"].any()
    assert outs[0]["collective_calls"] > 0


def test_four_rank_ba_2d(tmp_path):
    """2-D BA with the keyframe axis across processes (kf 2 x points 2)
    against JAX's ``make_sharded_ba_2d`` on a (2, 2) mesh: poses at atol
    5e-4, the cost at rtol 1e-3."""
    cam, poses_gt, templates, channels = build_window()
    stacked = jba.stack_templates(templates)
    ch = jnp.stack(channels)
    poses0 = np.stack(perturb(poses_gt))
    opts = jba.BAOptions(max_iterations=6)
    mesh = jmh.global_mesh(devices=jax.devices()[:4], kf_axis_size=2)
    pj, cj = jba.make_sharded_ba_2d(mesh, opts, 4)(stacked, ch, cam,
                                                   jnp.asarray(poses0))
    outs = _run(tmp_path, "ba2d", 4, **_template_arrays(stacked),
                channels=np.asarray(ch), cam=_cam(cam), poses=poses0,
                ba_opts=_json(opts), kf=2)
    np.testing.assert_allclose(outs[0]["poses"], np.asarray(pj), atol=ATOL)
    np.testing.assert_allclose(float(outs[0]["cost"]), float(cj), rtol=1e-3)


@pytest.mark.parametrize("refine_depth", [False, True])
def test_two_rank_keyframe_window_ba(tmp_path, refine_depth):
    """``KeyframeWindow`` with a 2-rank reducer (the points split over the
    ranks) against JAX's ``make_sharded_ba`` on a 2-device mesh: poses at
    atol 5e-4, with the depth Schur complement at 1e-3 (tests/test_ba.py's
    corrupted depths)."""
    cam, poses_gt, templates, channels = build_window()
    stacked = jba.stack_templates(templates)
    if refine_depth:
        r = np.random.default_rng(3)
        pts = np.array(stacked.points)
        for i in range(pts.shape[0]):
            pts[i] *= (1.0 + 0.02 * r.standard_normal(pts.shape[1])).astype(
                np.float32)[:, None]
        stacked = stacked._replace(points=jnp.asarray(pts))
    ch = jnp.stack(channels)
    poses0 = np.stack(perturb(poses_gt, scale=0.002 if refine_depth
                              else 0.004))
    opts = jba.BAOptions(max_iterations=4, refine_depth=refine_depth)
    mesh = jsh.make_mesh(2)
    tmpl = jax.tree.map(lambda x, s: jax.device_put(
        x, jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(
            *((None,) + tuple(s))))), stacked, jsh.template_spec())
    pj, _ = jba.make_sharded_ba(mesh, opts, 4)(tmpl, ch, cam,
                                               jnp.asarray(poses0))
    outs = _run(tmp_path, "ba", 2, **_template_arrays(stacked),
                channels=np.asarray(ch), cam=_cam(cam), poses=poses0,
                ba_opts=_json(opts))
    np.testing.assert_allclose(outs[0]["poses"], np.asarray(pj),
                               atol=1e-3 if refine_depth else ATOL)


def _module(args, timeout):
    return subprocess.run([sys.executable, "-m", *args], capture_output=True,
                          text=True, timeout=timeout, cwd=multihost.ROOT)


def test_dryrun_small(tmp_path):
    """The dry run's checks at 96x128 with 2 gloo ranks: ranks bitwise
    equal, a keyframe event, within 1e-3 of ``DeviceVO``, BA finite."""
    r = _module(["bpvo_tpu_torch.parallel.dryrun", "--procs", "2",
                 "--backend", "gloo", "--device", "cpu", "--rows", "96",
                 "--cols", "128", "--threads", "1"], TIMEOUT_S)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["ok"] and res["ranks_bitwise_equal"]
    assert res["keyframe_events"] >= 1 and not res["staged"]
    assert res["collectives_per_step"]["calls_per_step"] > 0


def test_scaling_bench_small():
    r = _module(["bpvo_tpu_torch.apps.scaling_bench", "--points", "2048",
                 "--rows", "96", "--cols", "128", "--reps", "2", "--sizes",
                 "1,2", "--device", "cpu", "--threads", "1"], TIMEOUT_S)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert set(res["by_world"]) == {"1", "2"}
    for n, v in res["by_world"].items():
        assert v["ms_per_solve"] > 0 and v["iterations"] == 10
        np.testing.assert_allclose(v["efficiency"] * v["ms_per_solve"]
                                   * int(n),
                                   res["by_world"]["1"]["ms_per_solve"])


def test_rank_without_peer_fails_at_the_timeout():
    """A rank whose peer never joins raises at the group's timeout (2 s
    here) instead of hanging."""
    code = ("from bpvo_tpu_torch.parallel import multihost\n"
            f"multihost.initialize('gloo', 2, 0, 'tcp://127.0.0.1:"
            f"{multihost.free_port()}', timeout_s=2)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=multihost.ROOT)
    assert r.returncode != 0
