"""Where the time goes in the PyTorch/CUDA port's VO step, on one GPU.

    python3 scripts/profile_torch_vo.py [--config intensity|stereo-bitplanes|
        dense-intensity|dense-bitplanes] [--steps 30] [--trace out.json]
        [--root DIR]

Runs VO on the card over 1+steps frames of the synthetic 376x1241 sequence:
``DeviceVO(device="cuda")`` with bench.py's intensity settings
(``intensity``, the default) or as stereo pairs with
conf/kitti_bitplanes.cfg's Bit-Planes VO and SGM matcher in the keyframe
branch (``stereo-bitplanes``); or ``VisualOdometry(device="cuda")`` with
bench.py's settings, non-maxima suppression off and pointCapacity 131072
(dense VO: L0 and L1 through ``gauss_newton.run``), intensity or Bit-Planes
(``dense-intensity``, ``dense-bitplanes``):

1. two untraced passes (the first pays first-use costs, the CUDA-graph
   captures among them), each printing frames/s and per-frame p50/p90 ms
   on the host clock, also for keyframe and other steps apart;
2. one pass under ``torch.profiler`` (CPU + CUDA activities), printing the
   ops by device time, the device busy share (union of the device events'
   intervals over the pass's wall time), each hand-written kernel's
   (``level_gn``, ``census``, ``sgm``, ``fused_linearize``,
   ``irls_reduce``) device total and launches, and the top-level host ops
   issued per step (a CUDA-graph replay, which torch.profiler records as no
   op, counted as one).

Every pass starts from the first frame on a VO that keeps what earlier
passes built, as a long-running process does: the same ``DeviceVO`` with
its state reset (its step graphs stay), or a new ``VisualOdometry`` (it has
no reset) that takes over the previous one's ``gauss_newton.run`` graphs.
``--root DIR`` profiles the package of another checkout (a parent commit
unpacked under ``build/`` with ``git archive``) with this script.

Imports no JAX.  Times are only comparable inside one run.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = os.path.join(ROOT, "conf", "kitti_bitplanes.cfg")
KERNELS = ("level_gn", "census", "sgm", "fused_linearize", "irls_reduce")

BENCH_PARAMS = dict(minSaliency=2.0, numPyramidLevels=4,
                    functionTolerance=1e-4, parameterTolerance=1e-6,
                    maxIterations=50)
DENSE = dict(minNumPixelsForNonMaximaSuppression=20000000,
             pointCapacity=131072)
STEP_LABEL = "vo_step_"


def _busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + (cur_e - cur_s if cur_e is not None else 0.0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=("intensity", "stereo-bitplanes",
                                         "dense-intensity", "dense-bitplanes"),
                    default="intensity")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--trace", help="write a Chrome trace of the profiled pass")
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose bpvo_tpu_torch is profiled")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_vo: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from bpvo_tpu_torch import (AlgorithmParameters, ConfigFile,
                                DescriptorType, VisualOdometry)
    from bpvo_tpu_torch.data import stereo, synthetic
    from bpvo_tpu_torch.vo.device_vo import DeviceVO
    try:
        from bpvo_tpu_torch.utils import graphs
    except ImportError:         # a checkout from before the CUDA graphs
        graphs = None

    def replays():
        return graphs.replay_count if graphs else 0

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    if args.config == "intensity":
        K, b, frames = synthetic.synthesize_sequence(1 + args.steps)
        params, stereo_fn = AlgorithmParameters(
            **BENCH_PARAMS, descriptor=DescriptorType.INTENSITY), None
    elif args.config.startswith("dense"):
        K, b, frames = synthetic.synthesize_sequence(1 + args.steps)
        params, stereo_fn = AlgorithmParameters(**dict(
            BENCH_PARAMS, **DENSE, descriptor=(
                DescriptorType.BITPLANES if args.config == "dense-bitplanes"
                else DescriptorType.INTENSITY))), None
    else:   # the second input is the right image
        K, b, frames = synthetic.synthesize_stereo_sequence(1 + args.steps)
        cf = ConfigFile(CONF)
        params = AlgorithmParameters.from_config(cf)
        stereo_fn = stereo.create_stereo_algorithm(cf).as_fn()
    print(f"config {args.config}, package {os.path.abspath(args.root)}")
    images = [torch.as_tensor(f[0]).to(dev) for f in frames]
    disps = [torch.as_tensor(f[1]).to(dev) for f in frames]
    shape = (synthetic.ROWS, synthetic.COLS)
    held = [None]

    def start_pass():
        """The first frame, on a VO that keeps what earlier passes built
        (see the module docstring)."""
        prev = held[0]
        if args.config.startswith("dense"):
            vo = VisualOdometry(K, b, shape, params, device=dev)
            run_graphs = getattr(prev and prev._pose_estimator,
                                 "_run_graphs", None)
            if run_graphs is not None:
                vo._pose_estimator._run_graphs = run_graphs
        else:
            vo = prev or DeviceVO(K, b, shape, params, device=dev,
                                  stereo_fn=stereo_fn)
            vo.state = None
        vo.add_frame(images[0], disps[0])
        torch.cuda.synchronize()
        held[0] = vo
        return vo

    for rep in range(2):
        vo = start_pass()
        t_ms, kf = [], []
        for image, disp in zip(images[1:], disps[1:]):
            t0 = time.perf_counter()
            out = vo.add_frame(image, disp)
            torch.cuda.synchronize()
            t_ms.append((time.perf_counter() - t0) * 1e3)
            kf.append(bool(out.is_keyframe))
        t_ms, kf = np.array(t_ms), np.array(kf)
        split = "".join(f" {name} p50 {np.percentile(t_ms[sel], 50):.3f}"
                        f" p90 {np.percentile(t_ms[sel], 90):.3f}"
                        for name, sel in (("keyframe", kf), ("other", ~kf))
                        if sel.any())
        print(f"pass {rep}: {len(t_ms) / t_ms.sum() * 1e3:.2f} frames/s, "
              f"p50 {np.percentile(t_ms, 50):.3f} p90 "
              f"{np.percentile(t_ms, 90):.3f} ms;{split}; {int(kf.sum())} "
              f"keyframes")

    vo = start_pass()
    kf, n_replays = [], []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i, (image, disp) in enumerate(zip(images[1:], disps[1:])):
            r0 = replays()
            with record_function(f"{STEP_LABEL}{i}"):
                kf.append(bool(vo.add_frame(image, disp).is_keyframe))
            n_replays.append(replays() - r0)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    def device_us(e):
        return getattr(e, "device_time_total", None) or getattr(
            e, "cuda_time_total", 0)

    # the per-step record_function labels also appear as device-side
    # annotations spanning each step: they are not device work
    ops = sorted((e for e in prof.key_averages()
                  if not e.key.startswith(STEP_LABEL)), key=device_us,
                 reverse=True)
    print(f"{'op':<60} {'device ms':>10} {'calls':>6}")
    for e in ops[:20]:
        print(f"{e.key[:60]:<60} {device_us(e) / 1e3:>10.3f} {e.count:>6}")
    events = prof.events()
    dev_evs = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(STEP_LABEL)]
    busy = _busy_us([(e.time_range.start, e.time_range.end) for e in dev_evs])
    print(f"profiled pass: wall {wall_us / 1e3:.2f} ms for {len(kf)} steps; "
          f"device busy {busy / 1e3:.2f} ms ({100 * busy / wall_us:.1f}%)")
    for name in KERNELS:
        evs = [e for e in dev_evs if f"{name}_" in e.name]
        us = sum(e.time_range.end - e.time_range.start for e in evs)
        print(f"  {name} kernels: {us / 1e3:.2f} ms in {len(evs)} launches "
              f"({100 * us / max(busy, 1e-9):.1f}% of busy)")
    steps = {e.name: e for e in events if e.name.startswith(STEP_LABEL)
             and e.device_type == torch.autograd.DeviceType.CPU}
    n_ops = np.array([len(steps[f"{STEP_LABEL}{i}"].cpu_children)
                      + n_replays[i] for i in range(len(kf))])
    kf = np.array(kf)
    for name, sel in (("keyframe", kf), ("other", ~kf)):
        if sel.any():
            print(f"top-level host ops per {name} step: median "
                  f"{np.median(n_ops[sel]):.0f} (min {n_ops[sel].min()}, "
                  f"max {n_ops[sel].max()}; CUDA-graph replays in them: "
                  f"median {np.median(np.array(n_replays)[sel]):.0f})")
    if args.trace:
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
