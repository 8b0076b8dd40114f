"""Multi-process dry run of the distributed layer (the counterpart of
``__graft_entry__.dryrun_multichip``):

    python -m bpvo_tpu_torch.parallel.dryrun --procs N \\
        --backend {gloo,nccl} --device {cpu,cuda} [--rows 376 --cols 1241]

starts N ranks (``multihost.launch``), each of which runs:

1. the full sharded VO (``sharded_vo.make_sharded_vo``) at ``--rows`` x
   ``--cols`` (KITTI shape by default, 16384/4096/1024/512 points) over
   1+4 frames of the synthetic sequence in two ``scan_fn`` chunks, the
   keyframe threshold tightened so that at least one keyframe event
   happens (JAX __graft_entry__.py:127-145);
2. on rank 0, ``DeviceVO`` on the same frames on the same device: the
   world poses must agree within POSE_ATOL (JAX's bound);
3. the point-sharded windowed BA (``make_sharded_ba``) on a small
   synthetic window: finite poses;
4. the collective calls and bytes of the VO steps (``Reducer.stats``),
   per step.

The parent checks that every rank exited 0, that the ranks' poses are
bitwise equal, and prints one JSON object.  With ``--backend gloo
--device cuda`` all ranks share cuda:0 and every reduction is staged
through pinned host memory: its times measure the host, not a
collective.  Exit code 0 only when every check holds.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

POSE_ATOL = 1e-3
CHUNKS = ((1, 3), (3, 5))
DRYRUN_PARAMS = dict(minSaliency=2.0, numPyramidLevels=4, maxIterations=8,
                     coarseMaxIterations=6, functionTolerance=1e-4,
                     parameterTolerance=1e-6,
                     minTranslationMagToKeyFrame=0.05)


def synthetic_problem(rows: int, cols: int, capacity: int, seed: int = 0,
                      device="cuda"):
    """A small VO problem (the counterpart of
    ``__graft_entry__._synthetic_problem``): a template of ``capacity``
    points on a textured image and the image shifted by (1, 2) pixels.
    Returns (tdata, channels (1, rows, cols), cam, params)."""
    from bpvo_tpu_torch.config import AlgorithmParameters
    from bpvo_tpu_torch.vo import template_data as td_mod
    from bpvo_tpu_torch.vo import warp as warp_mod
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:rows, 0:cols].astype(np.float32)
    I0 = (128 + 60 * np.sin(xx / 7.0) * np.cos(yy / 9.0)
          + 40 * np.sin((xx + 2 * yy) / 13.0)).astype(np.float32)
    I1 = np.roll(I0, (1, 2), axis=(0, 1))
    D = np.full((rows, cols), 8.0, np.float32)
    D += r.uniform(-0.5, 0.5, D.shape).astype(np.float32)
    K = np.array([[0.8 * cols, 0, cols / 2],
                  [0, 0.8 * cols, rows / 2], [0, 0, 1]], np.float32)
    cam = warp_mod.CameraModel.from_K(K, 0.12)
    p = AlgorithmParameters(minSaliency=1.0)
    dev = torch.device(device)
    tdata = td_mod.set_data(torch.from_numpy(I0)[None].to(dev),
                            torch.from_numpy(D).to(dev), cam, p, capacity, 0)
    return tdata, torch.from_numpy(I1)[None].to(dev), cam, p


def run_rank(args) -> dict:
    """One rank of the dry run; returns its result (also written to
    ``args.out/rank<R>.npz``)."""
    from bpvo_tpu_torch.config import AlgorithmParameters
    from bpvo_tpu_torch.data import synthetic
    from bpvo_tpu_torch.parallel import bundle_adjustment as ba
    from bpvo_tpu_torch.parallel import multihost, sharded, sharded_vo
    from bpvo_tpu_torch.parallel.worker import join
    from bpvo_tpu_torch.vo.device_vo import DeviceVO

    reducer, dev = join(args)
    try:
        rows, cols = args.rows, args.cols
        K, baseline, frames = synthetic.synthesize_sequence(
            CHUNKS[-1][1], rows, cols)
        images = np.stack([f[0] for f in frames])
        disps = np.stack([f[1] for f in frames])
        p = AlgorithmParameters(**DRYRUN_PARAMS)
        init_fn, _, scan_fn = sharded_vo.make_sharded_vo(
            reducer, K, baseline, (rows, cols), p, device=dev)
        state = init_fn(images[0], disps[0])
        reducer.reset()
        t0 = time.perf_counter()
        outs = []
        for lo, hi in CHUNKS:
            state, out = scan_fn(state, images[lo:hi], disps[lo:hi])
            outs.append(out)
        world = torch.cat([o.pose_world for o in outs]).cpu().numpy()
        vo_ms = (time.perf_counter() - t0) * 1e3 / len(world)
        n_steps = len(world)
        stats = {"calls_per_step": reducer.calls / n_steps,
                 "bytes_per_step": reducer.bytes / n_steps}
        kf_events = int(sum(int(o.is_keyframe.sum()) for o in outs))
        res = {"rank": reducer.rank, "world": reducer.world,
               "backend": reducer.backend, "device": str(dev),
               "staged": reducer.backend == "gloo" and dev.type == "cuda",
               "keyframe_events": kf_events, "vo_ms_per_step": vo_ms,
               "collectives": stats, "finite": bool(np.isfinite(world).all())}
        if reducer.rank == 0:
            vo = DeviceVO(K, baseline, (rows, cols), p, device=dev)
            single = vo.add_frames(images, disps).pose_world.cpu().numpy()
            res["max_abs_vs_device_vo"] = float(np.abs(world - single).max())

        # the point-sharded BA on a small window (JAX's dryrun's)
        tdata, channels, cam, _ = synthetic_problem(48, 64,
                                                    16 * reducer.world,
                                                    device=dev)
        M = 3
        window = sharded.shard_template(ba.stack_templates([tdata] * M),
                                        reducer.rank, reducer.world)
        reducer.reset()
        poses, cost = ba.make_sharded_ba(reducer, ba.BAOptions(
            max_iterations=2), M)(
            window, torch.stack([channels] * M), cam,
            torch.eye(4, device=dev).expand(M, 4, 4))
        poses = poses.cpu().numpy()
        res.update(ba_cost=float(cost), ba_finite=bool(
            np.isfinite(poses).all()), ba_collectives=reducer.stats())
        np.savez(os.path.join(args.out, f"rank{reducer.rank}.npz"),
                 pose_world=world, ba_poses=poses)
    finally:
        multihost.shutdown()
    print("DRYRUN_RANK " + json.dumps(res), flush=True)
    return res


def run(procs: int, backend: str, device: str, rows: int, cols: int,
        timeout_s: float = 900.0, threads: int = 0) -> dict:
    """Launch the ranks and check them; returns the summary (``ok``)."""
    from bpvo_tpu_torch.parallel import multihost
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        done = multihost.launch(
            "bpvo_tpu_torch.parallel.dryrun",
            ["--out", out, "--backend", backend, "--device", device,
             "--rows", str(rows), "--cols", str(cols), "--threads",
             str(threads)], procs, timeout_s)
        wall = time.perf_counter() - t0
        failed = [f"rank {r}: exit {d.returncode}\n{d.stdout[-3000:]}"
                  for r, d in enumerate(done) if d.returncode != 0]
        if failed:
            return {"ok": False, "failed": failed}
        ranks = [json.loads(line.split(" ", 1)[1]) for d in done
                 for line in d.stdout.splitlines()
                 if line.startswith("DRYRUN_RANK ")]
        arrays = [dict(np.load(os.path.join(out, f"rank{r}.npz")))
                  for r in range(procs)]
    bitwise = all(np.array_equal(a[k], arrays[0][k]) for a in arrays
                  for k in ("pose_world", "ba_poses"))
    r0 = ranks[0]
    ok = (bitwise and all(r["finite"] and r["ba_finite"] for r in ranks)
          and r0["keyframe_events"] >= 1
          and r0["max_abs_vs_device_vo"] < POSE_ATOL)
    return {"ok": ok, "procs": procs, "backend": backend, "device": device,
            "shape": [rows, cols], "ranks_bitwise_equal": bitwise,
            "keyframe_events": r0["keyframe_events"],
            "max_abs_vs_device_vo": r0["max_abs_vs_device_vo"],
            "pose_atol": POSE_ATOL, "staged": r0["staged"],
            "vo_ms_per_step": [r["vo_ms_per_step"] for r in ranks],
            "collectives_per_step": r0["collectives"],
            "ba_cost": r0["ba_cost"], "ba_collectives": r0["ba_collectives"],
            "wall_s": wall}


def main(argv=None) -> int:
    from bpvo_tpu_torch.parallel.worker import rank_args
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--rows", type=int, default=376)
    ap.add_argument("--cols", type=int, default=1241)
    if argv is None:
        argv = sys.argv[1:]
    if "--rank" in argv:
        ap.add_argument("--out", required=True)
        rank_args(ap)
        run_rank(ap.parse_args(argv))
        return 0
    ap.add_argument("--backend", choices=("gloo", "nccl"), required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--threads", type=int, default=0)
    ap.add_argument("--timeout", type=float, default=900.0)
    args = ap.parse_args(argv)
    res = run(args.procs, args.backend, args.device, args.rows, args.cols,
              args.timeout, args.threads)
    print(json.dumps(res))
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
