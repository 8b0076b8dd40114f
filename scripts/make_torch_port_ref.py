"""Write the JAX package's reference runs that ``chip_smoke.py`` and the
tests hold the PyTorch port to:

- ``tests/data/torch_port_bench_ref.npz``: JAX ``DeviceVO`` on the CPU over
  1+30 frames of the synthetic 376x1241 KITTI-shape sequence
  (``bench.synthesize_sequence``) with bench.py's intensity settings;
- ``tests/data/torch_port_bitplanes_sgm_ref.npz``: JAX
  ``DeviceVO(stereo_fn=TpuSGM(cf).as_fn())`` on the CPU over 1+30 stereo
  pairs of the same scene (``bpvo_tpu_torch.data.synthetic
  .synthesize_stereo_sequence``, the images the port sees) with
  conf/kitti_bitplanes.cfg's VO and matcher settings (Bit-Planes, Huber,
  100 iterations, SGM with 128 disparities).

- ``tests/data/torch_port_dense_ref.npz``: JAX ``VisualOdometry`` on the
  CPU over 1+30 frames of the port's synthetic sequence (given disparity)
  with bench.py's settings, non-maxima suppression off and
  ``pointCapacity=131072`` (dense VO: 131072/32768/8192/2048 points per
  level), for the intensity descriptor (``intensity_*`` keys) and for
  Bit-Planes (``bitplanes_*`` keys).

- ``tests/data/torch_port_zoo_ref.npz``: JAX ``VisualOdometry`` on the CPU
  over conf/eval_corridor.cfg (the synthetic corridor at 240x320, cut to
  chip_smoke.ZOO_FRAMES frames) for each of the 8 descriptors with
  Gauss-Newton and Levenberg-Marquardt (``<descriptor>_<solver>_world``:
  world poses, ``_iters``: iterations per frame, ``_ate``: ATE RMSE
  against the ground truth), as ``apps.eval_descriptors`` runs them; and
  conf/tsukuba.cfg's settings (CD5 gradients, CUBIC_HERMITE sampling) over
  the NewTsukuba tree that chip_smoke.py's app phase writes
  (``tsukuba_world``, ``tsukuba_iters``).  The cells of
  chip_smoke.ZOO_JAX_LEVEL_ROUTE are run a second time with JAX's level
  kernel forced (``BPVO_LEVEL_KERNEL=force``: the Pallas kernel in
  interpret mode, the route the port's ``level_gn`` takes on the card;
  ``<descriptor>_<solver>_level_world``, ``_level_iters``, ``_level_ate``),
  in a process of its own (``zoo_level``, which adds them to the file).

- ``tests/data/torch_port_sharded_ref.npz``: JAX ``make_sharded_vo`` on
  the CPU on a 2-device mesh over 1+4 frames of the port's synthetic
  376x1241 sequence in two ``scan_fn`` chunks, with the dry run's
  parameters (``bpvo_tpu_torch.parallel.dryrun.DRYRUN_PARAMS``, JAX
  __graft_entry__.py:127-130), intensity (``sharded_intensity_*``) and
  Bit-Planes (``sharded_bitplanes_*``): world poses and keyframe flags; and
  JAX ``VisualOdometry`` with ``enable_bundle_adjustment(8)`` over 1+30
  frames with bench.py's intensity settings: after each keyframe event the
  refined keyframe poses of the window (``ba_windows``, stacked, with
  ``ba_window_sizes``) and the frame index (``ba_frames``).  Poses only.

The first three store per frame the relative pose, the keyframe flag, the per-level
GN iterations and the ground-truth error max|se3.log(pose @ step^-1)| (the
``DeviceVO`` files also the world pose); the stereo file also stores the
frame-0 disparity's valid count and mean |d - GT| over the valid pixels
(not the map).

Route note: on the CPU the JAX package takes ``gauss_newton.run`` with the
1024-bin histogram median at every level, while the port runs the level
kernel's 16-step bisection median on levels of at most 16384 points.  The
two routes walk slightly different iterate paths to the same optimum (for
Bit-Planes also with other per-level iteration counts), so the port is held
to these poses by a cross-route tolerance, not by bitwise equality.

    JAX_PLATFORMS=cpu python scripts/make_torch_port_ref.py \
        [bench|stereo|dense|zoo|sharded]
    JAX_PLATFORMS=cpu BPVO_LEVEL_KERNEL=force \
        python scripts/make_torch_port_ref.py zoo_level
"""
from __future__ import annotations

import os
import sys

import numpy as np

N_STEPS = 30
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "torch_port_bench_ref.npz")
OUT_STEREO = os.path.join(ROOT, "tests", "data",
                          "torch_port_bitplanes_sgm_ref.npz")
OUT_DENSE = os.path.join(ROOT, "tests", "data", "torch_port_dense_ref.npz")
OUT_ZOO = os.path.join(ROOT, "tests", "data", "torch_port_zoo_ref.npz")
OUT_SHARDED = os.path.join(ROOT, "tests", "data",
                           "torch_port_sharded_ref.npz")
SHARDED_DEVICES = 2
BA_WINDOW = 8
CONF = os.path.join(ROOT, "conf", "kitti_bitplanes.cfg")
# dense VO at KITTI shape: NMS off as conf/tunnel.cfg sets it, and a point
# capacity that every level fills
DENSE = dict(minNumPixelsForNonMaximaSuppression=20000000,
             pointCapacity=131072)


def _run(vo, pairs, step):
    """Init on the first pair, step through the rest; per-step arrays."""
    import jax.numpy as jnp
    from bpvo_tpu.core import se3
    vo.add_frame(*pairs[0])
    poses, worlds, kfs, iters, errs = [], [], [], [], []
    for a, b in pairs[1:]:
        out = vo.add_frame(a, b)
        pose = np.asarray(out.pose)
        poses.append(pose)
        worlds.append(np.asarray(out.pose_world))
        kfs.append(bool(out.is_keyframe))
        iters.append(np.asarray(out.iters))
        errs.append(float(np.abs(np.asarray(se3.log(jnp.asarray(
            pose @ np.linalg.inv(step), jnp.float32)))).max()))
    return dict(poses=np.stack(poses).astype(np.float32),
                pose_world=np.stack(worlds).astype(np.float32),
                is_keyframe=np.asarray(kfs),
                iters=np.stack(iters).astype(np.int32),
                gt_err=np.asarray(errs, np.float32))


def _step_pose():
    import jax.numpy as jnp
    from bpvo_tpu.core import se3
    return np.asarray(se3.exp(jnp.asarray(
        [0.0005, 0.001, 0.0008, 0.006, 0.002, 0.03], jnp.float32)))


def _report(path, ref):
    print(f"wrote {path}: {len(ref['poses'])} frames, "
          f"{int(ref['is_keyframe'].sum())} keyframes, max gt err "
          f"{ref['gt_err'].max():.3e}, iters/frame "
          f"{ref['iters'].sum(1).mean():.1f}")


def bench_ref():
    import bench
    from bpvo_tpu.vo.device_vo import DeviceVO

    K, baseline, frames = bench.synthesize_sequence(1 + N_STEPS)
    vo = DeviceVO(K, baseline, (bench.ROWS, bench.COLS),
                  bench._make_params("Intensity"))
    ref = _run(vo, frames, _step_pose())
    np.savez_compressed(OUT, rows=bench.ROWS, cols=bench.COLS, **ref)
    _report(OUT, ref)


def stereo_ref():
    from bpvo_tpu import AlgorithmParameters
    from bpvo_tpu.config import ConfigFile
    from bpvo_tpu.data.stereo import create_stereo_algorithm
    from bpvo_tpu.vo.device_vo import DeviceVO
    from bpvo_tpu_torch.data import synthetic

    cf = ConfigFile(CONF)
    params = AlgorithmParameters.from_config(cf)
    matcher = create_stereo_algorithm(cf)
    K, baseline, frames = synthetic.synthesize_stereo_sequence(1 + N_STEPS)
    left0, right0, gt0 = frames[0]
    d0 = np.asarray(matcher.run(left0, right0))
    valid = d0 > 0
    vo = DeviceVO(K, baseline, (synthetic.ROWS, synthetic.COLS), params,
                  stereo_fn=matcher.as_fn())
    ref = _run(vo, [(f[0], f[1]) for f in frames], _step_pose())
    np.savez_compressed(
        OUT_STEREO, rows=synthetic.ROWS, cols=synthetic.COLS,
        num_disparities=matcher._D, disp0_valid=int(valid.sum()),
        disp0_mean_abs_err=float(np.abs(d0 - gt0)[valid].mean()), **ref)
    _report(OUT_STEREO, ref)
    print(f"frame-0 disparity: {int(valid.sum())} valid, mean |d - GT| "
          f"{float(np.abs(d0 - gt0)[valid].mean()):.6f}")


def _run_odometry(vo, frames, step):
    """``VisualOdometry.add_frame`` over the frames; per-step arrays."""
    import jax.numpy as jnp
    from bpvo_tpu.core import se3
    vo.add_frame(*frames[0])
    poses, kfs, iters, errs = [], [], [], []
    for image, disp in frames[1:]:
        res = vo.add_frame(image, disp)
        pose = np.asarray(res.pose, np.float32)
        poses.append(pose)
        kfs.append(bool(res.is_keyframe))
        iters.append([s.num_iterations for s in res.optimizer_statistics])
        errs.append(float(np.abs(np.asarray(se3.log(jnp.asarray(
            pose @ np.linalg.inv(step), jnp.float32)))).max()))
    return dict(poses=np.stack(poses), is_keyframe=np.asarray(kfs),
                iters=np.asarray(iters, np.int32),
                gt_err=np.asarray(errs, np.float32))


def _wide_select_pixels(orig):
    """JAX's ``selection.select_pixels`` refuses capacities above 46340: its
    closed-form block balance, a layout step for the TPU kernels' row bands,
    would overflow int32.  Above that bound this takes the same gated exact
    top-K and keeps the valid points compacted to the front in raster order,
    as the port's selection does; the solver's reductions do not depend on
    the point order."""
    import jax
    import jax.numpy as jnp
    from bpvo_tpu.ops import imgproc
    from bpvo_tpu.ops.selection import Selection

    def select_pixels(saliency, disparity, capacity, *, min_saliency,
                      nms_radius, use_nms, min_disparity, max_disparity,
                      border):
        if capacity <= 46340:
            return orig(saliency, disparity, capacity,
                        min_saliency=min_saliency, nms_radius=nms_radius,
                        use_nms=use_nms, min_disparity=min_disparity,
                        max_disparity=max_disparity, border=border)
        H, W = saliency.shape
        ok = saliency >= min_saliency
        if use_nms and nms_radius > 0:
            ok &= imgproc.is_local_max(saliency, nms_radius)
        ok &= (disparity >= min_disparity) & (disparity <= max_disparity)
        bm = jnp.zeros((H, W), bool)
        if H - 2 * border - 1 > 0 and W - 2 * border - 1 > 0:
            bm = bm.at[border:H - border - 1, border:W - border - 1].set(True)
        ok &= bm
        vals, idx = jax.lax.top_k(jnp.where(ok, saliency, -jnp.inf)
                                  .reshape(-1), capacity)
        valid = vals > -jnp.inf
        order = jnp.argsort(jnp.where(valid, idx, jnp.iinfo(jnp.int32).max))
        idx, valid = idx[order], valid[order]
        return Selection(rows=(idx // W).astype(jnp.int32),
                         cols=(idx % W).astype(jnp.int32),
                         disparity=disparity.reshape(-1)[idx], valid=valid,
                         num_valid=jnp.sum(valid).astype(jnp.int32))

    return select_pixels


def dense_ref():
    import time

    import bench
    from bpvo_tpu import VisualOdometry
    from bpvo_tpu.ops import selection
    from bpvo_tpu_torch.data import synthetic

    selection.select_pixels = _wide_select_pixels(selection.select_pixels)
    K, baseline, frames = synthetic.synthesize_sequence(1 + N_STEPS)
    out = {}
    for name, desc in (("intensity", "Intensity"), ("bitplanes", "BitPlanes")):
        t0 = time.perf_counter()
        vo = VisualOdometry(K, baseline, (synthetic.ROWS, synthetic.COLS),
                            bench._make_params(desc).replace(**DENSE))
        ref = _run_odometry(vo, frames, _step_pose())
        print(f"{name}: {time.perf_counter() - t0:.1f} s, levels "
              f"{[int(vo.num_points_at_level(l)) for l in range(4)]} points")
        _report(f"{OUT_DENSE} [{name}]", ref)
        out.update({f"{name}_{k}": v for k, v in ref.items()})
    np.savez_compressed(OUT_DENSE, rows=synthetic.ROWS, cols=synthetic.COLS,
                        **out)


def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _odometry_run(cf, params):
    """The loop of apps.eval_descriptors: (world poses, iterations per
    frame, ATE RMSE or NaN without ground truth)."""
    from bpvo_tpu import VisualOdometry
    from bpvo_tpu.data.dataset import create_dataset
    from bpvo_tpu.eval import kitti_eval
    dataset = create_dataset(cf)
    calib = dataset.calibration
    vo = VisualOdometry(calib.K, calib.baseline, dataset.image_size, params)
    iters = [sum(s.num_iterations for s in vo.add_frame(
        f.image, f.disparity).optimizer_statistics) for f in dataset]
    world = np.stack(vo.trajectory.poses).astype(np.float64)
    ate = np.nan
    if hasattr(dataset, "gt_world_pose"):
        gt = [dataset.gt_world_pose(i) for i in range(len(world))]
        ate = float(kitti_eval.ate_rmse(gt, list(world)))
    return world, np.asarray(iters, np.int32), ate


def zoo_ref():
    import tempfile
    import time

    from bpvo_tpu import AlgorithmParameters
    from bpvo_tpu.config import ConfigFile
    from bpvo_tpu.types import DescriptorType

    cs = _chip_smoke()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tsukuba = cs.write_tsukuba_tree(os.path.join(tmp, "tsukuba"),
                                        cs.APP_SHORT_FRAMES)
        corridor_cfg, tsukuba_cfg = cs.write_zoo_configs(tmp, tsukuba)
        cf = ConfigFile(corridor_cfg)
        base = AlgorithmParameters.from_config(cf)
        for desc in cs.ZOO_DESCRIPTORS:
            for solver in cs.ZOO_SOLVERS:
                t0 = time.perf_counter()
                key = f"{desc}_{solver}"
                world, iters, ate = _odometry_run(cf, base.replace(
                    descriptor=DescriptorType(desc), poseEstimator=solver))
                out.update({f"{key}_world": world, f"{key}_iters": iters,
                            f"{key}_ate": ate})
                print(f"{key}: {len(world)} frames, ATE {ate:.5f} m, "
                      f"iterations/frame {iters[1:].mean():.1f} "
                      f"({time.perf_counter() - t0:.1f} s)")
        cf = ConfigFile(tsukuba_cfg)
        world, iters, _ = _odometry_run(cf, AlgorithmParameters.from_config(
            cf))
        out.update(tsukuba_world=world, tsukuba_iters=iters)
        print(f"tsukuba: {len(world)} frames, iterations/frame "
              f"{iters[1:].mean():.1f}")
    np.savez_compressed(OUT_ZOO, frames=cs.ZOO_FRAMES, **out)
    print(f"wrote {OUT_ZOO}")
    import subprocess
    subprocess.run([sys.executable, os.path.abspath(__file__), "zoo_level"],
                   env=dict(os.environ, BPVO_LEVEL_KERNEL="force"),
                   check=True)


def zoo_level_ref():
    """Adds to OUT_ZOO the cells of chip_smoke.ZOO_JAX_LEVEL_ROUTE run with
    JAX's level kernel (the caller sets BPVO_LEVEL_KERNEL=force)."""
    import tempfile

    from bpvo_tpu import AlgorithmParameters
    from bpvo_tpu.config import ConfigFile
    from bpvo_tpu.types import DescriptorType

    if os.environ.get("BPVO_LEVEL_KERNEL") != "force":
        raise SystemExit("zoo_level needs BPVO_LEVEL_KERNEL=force")
    cs = _chip_smoke()
    out = dict(np.load(OUT_ZOO))
    with tempfile.TemporaryDirectory() as tmp:
        cf = ConfigFile(cs.write_zoo_configs(tmp, tmp)[0])
        base = AlgorithmParameters.from_config(cf)
        for tag in cs.ZOO_JAX_LEVEL_ROUTE:
            desc, solver = tag.split("+")
            key = f"{desc}_{solver}_level"
            world, iters, ate = _odometry_run(cf, base.replace(
                descriptor=DescriptorType(desc), poseEstimator=solver))
            out.update({f"{key}_world": world, f"{key}_iters": iters,
                        f"{key}_ate": ate})
            cpu_route = out[f"{desc}_{solver}_world"]
            print(f"{key}: ATE {ate:.5f} m, iterations {iters.tolist()}, "
                  f"max |pose - CPU route| "
                  f"{np.abs(world - cpu_route).max():.3e}")
    np.savez_compressed(OUT_ZOO, **out)
    print(f"added the level-route cells to {OUT_ZOO}")


def sharded_ref():
    import time

    import jax.numpy as jnp
    from bpvo_tpu import AlgorithmParameters, VisualOdometry
    from bpvo_tpu.parallel import sharded
    from bpvo_tpu.parallel.sharded_vo import make_sharded_vo
    from bpvo_tpu.types import DescriptorType
    from bpvo_tpu_torch.data import synthetic
    from bpvo_tpu_torch.parallel.dryrun import CHUNKS, DRYRUN_PARAMS
    import bench

    out = {}
    K, baseline, frames = synthetic.synthesize_sequence(CHUNKS[-1][1])
    images = jnp.asarray(np.stack([f[0] for f in frames]))
    disps = jnp.asarray(np.stack([f[1] for f in frames]))
    mesh = sharded.make_mesh(SHARDED_DEVICES)
    for name, desc in (("intensity", DescriptorType.INTENSITY),
                       ("bitplanes", DescriptorType.BITPLANES)):
        t0 = time.perf_counter()
        p = AlgorithmParameters(**DRYRUN_PARAMS, descriptor=desc)
        init_fn, _, scan_fn = make_sharded_vo(
            mesh, K, baseline, (synthetic.ROWS, synthetic.COLS), p)
        state = init_fn(images[0], disps[0])
        world, kf = [], []
        for lo, hi in CHUNKS:
            state, o = scan_fn(state, images[lo:hi], disps[lo:hi])
            world.append(np.asarray(o.pose_world))
            kf.append(np.asarray(o.is_keyframe))
        out[f"sharded_{name}_world"] = np.concatenate(world).astype(
            np.float32)
        out[f"sharded_{name}_keyframe"] = np.concatenate(kf)
        print(f"sharded {name}: keyframes "
              f"{out[f'sharded_{name}_keyframe'].tolist()} "
              f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    K, baseline, frames = synthetic.synthesize_sequence(1 + N_STEPS)
    vo = VisualOdometry(K, baseline, (synthetic.ROWS, synthetic.COLS),
                        bench._make_params("Intensity"))
    vo.enable_bundle_adjustment(BA_WINDOW)
    windows, sizes, at = [], [], []
    for i, (image, disp) in enumerate(frames):
        if vo.add_frame(image, disp).is_keyframe and i > 0:
            w = vo.refined_keyframe_poses()
            windows.append(w.astype(np.float32))
            sizes.append(len(w))
            at.append(i)
    out.update(ba_windows=np.concatenate(windows),
               ba_window_sizes=np.asarray(sizes, np.int32),
               ba_frames=np.asarray(at, np.int32), ba_window=BA_WINDOW)
    print(f"BA: keyframe events at {at}, window sizes {sizes} "
          f"({time.perf_counter() - t0:.1f} s)")
    np.savez_compressed(OUT_SHARDED, rows=synthetic.ROWS,
                        cols=synthetic.COLS, devices=SHARDED_DEVICES, **out)
    print(f"wrote {OUT_SHARDED}")


def main():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    if "sharded" in sys.argv[1:]:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "") +
            f" --xla_force_host_platform_device_count={SHARDED_DEVICES}")
    sys.path.insert(0, ROOT)
    import jax
    jax.config.update("jax_platforms", "cpu")
    which = sys.argv[1:] or ["bench", "stereo", "dense", "zoo"]
    if "bench" in which:
        bench_ref()
    if "stereo" in which:
        stereo_ref()
    if "dense" in which:
        dense_ref()
    if "zoo" in which:
        zoo_ref()
    if "zoo_level" in which:
        zoo_level_ref()
    if "sharded" in which:
        sharded_ref()


if __name__ == "__main__":
    main()
