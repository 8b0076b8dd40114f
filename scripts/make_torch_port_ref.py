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

Each stores per frame the relative pose, the world pose, the keyframe flag,
the per-level GN iterations and the ground-truth error
max|se3.log(pose @ step^-1)|; the stereo file also stores the frame-0
disparity's valid count and mean |d - GT| over the valid pixels (not the
map).

Route note: on the CPU the JAX package takes ``gauss_newton.run`` with the
1024-bin histogram median at every level, while the port runs the level
kernel's 16-step bisection median.  The two routes walk slightly different
iterate paths to the same optimum (for Bit-Planes also with other
per-level iteration counts), so the port is held to these poses by a
cross-route tolerance, not by bitwise equality.

    JAX_PLATFORMS=cpu python scripts/make_torch_port_ref.py [bench|stereo]
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
CONF = os.path.join(ROOT, "conf", "kitti_bitplanes.cfg")


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


def main():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, ROOT)
    import jax
    jax.config.update("jax_platforms", "cpu")
    which = sys.argv[1:] or ["bench", "stereo"]
    if "bench" in which:
        bench_ref()
    if "stereo" in which:
        stereo_ref()


if __name__ == "__main__":
    main()
