"""Scaling of the distributed IRLS-GN step with the number of ranks
(counterpart of ``bpvo_tpu/apps/scaling_bench.py``).

    python -m bpvo_tpu_torch.apps.scaling_bench [--points 65536] \\
        [--rows 240] [--cols 320] [--sizes 1,2] [--backend gloo|nccl] \\
        [--device cuda|cpu]

For each world size it starts the ranks itself (``multihost.launch``);
each builds the same synthetic problem (``parallel.dryrun
.synthetic_problem``), keeps its ``shard_template`` slice and times
``make_sharded_gn`` over ``--reps`` solves of a fixed 10 iterations
(tolerances at 1e-12).  Prints one JSON object: per world size the group's
route (``Reducer.route`` and ``peer_rule``), the ms per solve (rank 0's
host clock, synchronized), the speedup and the efficiency t_1 / (n t_n).
With nccl on CUDA (one rank, or the cards of one host reducing through
the peer kernel, ``parallel.peer``) the default route is graphed
(``"graphed": true``): each solve one replay of the solve's CUDA graph,
the all-reduces in it (the first, untimed solve captures it); the eager
route (``cache=False``) is then timed too, alternated with it in rounds
of eager, graphed, graphed, eager (``ms_per_solve_eager``, ``speedup_eager``
and ``efficiency_eager`` against the eager t_1).  gloo on CUDA tensors
stages every reduction through host memory and runs eagerly (``"staged":
true``), so its numbers measure the host, not a collective.
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
    from bpvo_tpu_torch.utils import graphs

    reducer, dev = join(args)
    try:
        opts = gn.GNOptions(max_iterations=10, function_tolerance=1e-12,
                            parameter_tolerance=1e-12)
        tdata, channels, cam, _ = synthetic_problem(
            args.rows, args.cols, args.points, device=dev)
        shard = sharded.shard_template(tdata, reducer.rank, reducer.world)
        run = sharded.make_sharded_gn(reducer, opts)
        run_e = sharded.make_sharded_gn(reducer, opts, cache=False)
        graphed = dev.type == "cuda" and graphs.capturable(reducer, dev)
        T0 = torch.eye(4, dtype=torch.float32, device=dev)

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        def timed(fn, reps):
            sync()
            t0 = time.perf_counter()
            for _ in range(reps):
                st = fn(shard, channels, cam, T0)
            sync()
            return (time.perf_counter() - t0) * 1e3 / reps, st

        st = run(shard, channels, cam, T0)
        sync()
        reducer.reset()
        ms, st = timed(run, args.reps)
        calls, nbytes = reducer.calls, reducer.bytes
        ms_e = None
        if graphed:     # eager, graphed, graphed, eager
            t = {"eager": [], "graphed": []}
            for name in ("eager", "graphed", "graphed", "eager"):
                t[name].append(timed(run_e if name == "eager" else run,
                                     args.reps)[0])
            ms = (ms + sum(t["graphed"])) / 3
            ms_e = sum(t["eager"]) / 2
        print("SCALING_RANK " + json.dumps({
            "rank": reducer.rank, "ms_per_solve": ms,
            "ms_per_solve_eager": ms_e, "route": reducer.route,
            "peer_rule": reducer.peer_rule, "graphed": graphed,
            "iterations": int(st.num_iters),
            "collective_calls_per_solve": calls / args.reps,
            "collective_bytes_per_solve": nbytes / args.reps}),
            flush=True)
    finally:
        multihost.shutdown()


def run_scaling(sizes=(1, 2), total_points: int = 65536, rows: int = 240,
                cols: int = 320, reps: int = 20, backend: str = "gloo",
                device: str = "cuda", threads: int = 0,
                timeout_s: float = 600.0) -> dict:
    from bpvo_tpu_torch.parallel import multihost
    results, t_base, t_base_e = {}, None, None
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
        dt, dt_e = r0["ms_per_solve"], r0["ms_per_solve_eager"]
        t_base = dt if t_base is None else t_base
        if dt_e is not None and t_base_e is None:
            t_base_e = dt_e
        eager = {} if dt_e is None or t_base_e is None else {
            "ms_per_solve_eager": dt_e, "speedup_eager": t_base_e / dt_e,
            "efficiency_eager": t_base_e / (dt_e * n)}
        results[n] = {"ms_per_solve": dt, "graphed": r0["graphed"],
                      "route": r0["route"], "peer_rule": r0["peer_rule"],
                      "speedup": t_base / dt,
                      "efficiency": t_base / (dt * n), **eager,
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
