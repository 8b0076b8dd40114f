"""Scaling of the distributed IRLS-GN step with the number of ranks
(counterpart of ``bpvo_tpu/apps/scaling_bench.py``).

    python -m bpvo_tpu_torch.apps.scaling_bench [--points 65536] \\
        [--rows 240] [--cols 320] [--sizes 1,2] [--backend gloo|nccl] \\
        [--device cuda|cpu]

For each world size it starts the ranks itself (``multihost.launch``);
each builds the same synthetic problem (``parallel.dryrun
.synthetic_problem``), keeps its ``shard_template`` slice and times
``make_sharded_gn`` over ``--reps`` solves of a fixed 10 iterations
(tolerances at 1e-12).  Prints one JSON object: per world size the ms per
solve (rank 0's host clock, synchronized), the speedup and the efficiency
t_1 / (n t_n).  gloo on CUDA tensors stages every reduction through host
memory, so its numbers measure the host, not a collective.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch


def run_rank(args) -> None:
    from bpvo_tpu_torch.parallel import multihost, sharded
    from bpvo_tpu_torch.parallel.dryrun import synthetic_problem
    from bpvo_tpu_torch.parallel.worker import join
    from bpvo_tpu_torch.solver import gauss_newton as gn

    reducer, dev = join(args)
    try:
        opts = gn.GNOptions(max_iterations=10, function_tolerance=1e-12,
                            parameter_tolerance=1e-12)
        tdata, channels, cam, _ = synthetic_problem(
            args.rows, args.cols, args.points, device=dev)
        shard = sharded.shard_template(tdata, reducer.rank, reducer.world)
        run = sharded.make_sharded_gn(reducer, opts)
        T0 = torch.eye(4, dtype=torch.float32, device=dev)

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        st = run(shard, channels, cam, T0)
        sync()
        reducer.reset()
        t0 = time.perf_counter()
        for _ in range(args.reps):
            st = run(shard, channels, cam, T0)
        sync()
        ms = (time.perf_counter() - t0) * 1e3 / args.reps
        print("SCALING_RANK " + json.dumps({
            "rank": reducer.rank, "ms_per_solve": ms,
            "iterations": int(st.num_iters),
            "collective_calls_per_solve": reducer.calls / args.reps,
            "collective_bytes_per_solve": reducer.bytes / args.reps}),
            flush=True)
    finally:
        multihost.shutdown()


def run_scaling(sizes=(1, 2), total_points: int = 65536, rows: int = 240,
                cols: int = 320, reps: int = 20, backend: str = "gloo",
                device: str = "cuda", threads: int = 0,
                timeout_s: float = 600.0) -> dict:
    from bpvo_tpu_torch.parallel import multihost
    results, t_base = {}, None
    for n in sizes:
        done = multihost.launch(
            "bpvo_tpu_torch.apps.scaling_bench",
            ["--points", str(total_points), "--rows", str(rows), "--cols",
             str(cols), "--reps", str(reps), "--backend", backend,
             "--device", device, "--threads", str(threads)], n, timeout_s)
        for r, d in enumerate(done):
            if d.returncode != 0:
                raise RuntimeError(f"scaling_bench: world {n} rank {r} exit "
                                   f"{d.returncode}\n{d.stdout[-3000:]}")
        r0 = next(json.loads(line.split(" ", 1)[1]) for line in
                  done[0].stdout.splitlines()
                  if line.startswith("SCALING_RANK "))
        dt = r0["ms_per_solve"]
        t_base = dt if t_base is None else t_base
        results[n] = {"ms_per_solve": dt, "speedup": t_base / dt,
                      "efficiency": t_base / (dt * n),
                      "iterations": r0["iterations"],
                      "collective_calls_per_solve":
                          r0["collective_calls_per_solve"],
                      "collective_bytes_per_solve":
                          r0["collective_bytes_per_solve"]}
    return {"backend": backend, "device": device, "points": total_points,
            "shape": [rows, cols], "staged": backend == "gloo"
            and device.startswith("cuda"), "by_world": results}


def main(argv=None) -> None:
    from bpvo_tpu_torch.parallel.worker import rank_args
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--points", type=int, default=65536)
    ap.add_argument("--rows", type=int, default=240)
    ap.add_argument("--cols", type=int, default=320)
    ap.add_argument("--reps", type=int, default=20)
    if argv is None:
        argv = sys.argv[1:]
    if "--rank" in argv:
        rank_args(ap)
        run_rank(ap.parse_args(argv))
        return
    ap.add_argument("--sizes", default="1,2")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--threads", type=int, default=0)
    args = ap.parse_args(argv)
    print(json.dumps(run_scaling(
        tuple(int(s) for s in args.sizes.split(",")), args.points, args.rows,
        args.cols, args.reps, args.backend, args.device, args.threads)))


if __name__ == "__main__":
    main()
