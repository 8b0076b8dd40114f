"""What an NCCL all-reduce puts into a CUDA graph, and whether the
conditional bodies of the distributed layer's graphs can hold it.

    python3 scripts/nccl_graph_nodes.py [--worlds 1,2,4] [--mixing 0|1]
        [--out build/nccl_nodes.json]

For each world size N (at most the number of cards) it starts N ranks
(``multihost.launch``), an nccl group with a card a rank, and in each rank:

1. captures one all-reduce of a (43,) float32 buffer (the sharded GN's
   (H, g, f_sq)) alone into a CUDA graph (``torch.cuda.CUDAGraph``, kept
   un-instantiated) and counts its nodes by type (``graphs.NODE_TYPES``,
   through child graphs: ``bpvo_graph_node_types``);
2. runs ``sharded.make_sharded_gn`` on a 240x320 problem (8192 points split
   over the ranks) eagerly (``cache=False``) and graphed (its all-reduces
   in the WHILE body and in the sigma IF body inside it): the node types
   of the graph's top level and of its bodies, whether two replays equal
   the eager solve bit for bit, or the error the join raised (a body
   holding a node type it cannot hold).  On the cards of one host the
   group's ``Reducer`` takes the peer route (``parallel/peer.py``), so
   there step 2's all-reduces are the peer kernel, not NCCL's.

``--mixing`` sets ``NCCL_GRAPH_MIXING_SUPPORT`` for the ranks (unset by
default: NCCL's default, 1).  ``--linalg`` then checks, in this process,
which dense LU a capture takes: ``torch.linalg.solve_ex`` of a 48x48
system (bundle adjustment's at M = 8) captured into a ``GraphCache``
with the preferred library left at its default, set to cuSOLVER and set
to MAGMA: whether the capture holds and its replay equals the eager
solve.  Prints one JSON object (also to ``--out``).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _stage(res, what):
    """A progress line (where a rank stopped, if it hangs)."""
    print(f"NODES_STAGE rank {res['rank']}: {what}", flush=True)


def run_rank(args) -> None:
    import torch.distributed as dist
    from bpvo_tpu_torch.ops import _build
    from bpvo_tpu_torch.parallel import dryrun, multihost, sharded
    from bpvo_tpu_torch.parallel.worker import join
    from bpvo_tpu_torch.solver import gauss_newton as gn
    from bpvo_tpu_torch.utils import graphs

    reducer, dev = join(args)
    res = {"rank": reducer.rank, "world": reducer.world,
           "mixing": os.environ.get("NCCL_GRAPH_MIXING_SUPPORT")}
    try:
        lib = _build.library()
        buf = torch.ones(43, device=dev)
        dist.all_reduce(buf)                      # the communicator, warm
        torch.cuda.synchronize(dev)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            graph.capture_begin(capture_error_mode="thread_local")
            dist.all_reduce(buf)
            graph.capture_end()
        counts = (ctypes.c_longlong * len(graphs.NODE_TYPES))()
        rc = lib.bpvo_graph_node_types(ctypes.c_void_p(graph.raw_cuda_graph()),
                                       counts, len(graphs.NODE_TYPES))
        _build.launch(lib, "node types", rc)
        res["all_reduce_nodes"] = {name: n for name, n in
                                   zip(graphs.NODE_TYPES, counts) if n}
        graph.reset()            # before the group goes (multihost.shutdown)
        _stage(res, "captured one all-reduce")

        tdata, ch, cam, _ = dryrun.synthetic_problem(240, 320, 8192,
                                                     device=dev)
        shard = sharded.shard_template(tdata, reducer.rank, reducer.world)
        opts = gn.GNOptions(function_tolerance=1e-4, parameter_tolerance=1e-6)
        T0 = torch.eye(4, device=dev)
        want = sharded.make_sharded_gn(reducer, opts, cache=False)(
            shard, ch, cam, T0)
        _stage(res, "eager sharded GN")
        cache = graphs.GraphCache(dev)
        run = sharded.make_sharded_gn(reducer, opts, cache=cache)
        try:
            run(shard, ch, cam, T0)               # warm-up and capture
            _stage(res, "captured the sharded GN")
            got = [run(shard, ch, cam, T0) for _ in range(2)]
            torch.cuda.synchronize(dev)
            _stage(res, "replayed the sharded GN")
            types = {"top": {}, "if": {}, "while": {}}
            for captured, _ in cache._entries.values():
                for where, t in captured.node_types.items():
                    for name, n in t.items():
                        types[where][name] = types[where].get(name, 0) + n
            res["sharded_gn"] = {
                "iterations": int(want.num_iters),
                "graphed_equals_eager": all(
                    all(torch.equal(a, b) for a, b in zip(g, want))
                    for g in got),
                "node_types": types}
        except RuntimeError as e:
            res["sharded_gn"] = {"error": str(e)[:800]}
        print("NODES_RANK " + json.dumps(res), flush=True)
    finally:
        multihost.shutdown()
    _stage(res, "group destroyed")


def linalg_capture() -> dict:
    """Each preferred linalg library's dense solve under capture."""
    from bpvo_tpu_torch.utils import graphs
    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(0)
    A = torch.randn(48, 48, generator=g)
    A = (A @ A.T + 48 * torch.eye(48)).to(dev)
    b = torch.randn(48, generator=g).to(dev)
    saved = torch.backends.cuda.preferred_linalg_library()
    out = {"default": str(saved)}
    for lib in ("default", "cusolver", "magma"):
        torch.backends.cuda.preferred_linalg_library(lib)
        try:
            want = torch.linalg.solve_ex(A, b)[0]
            cache = graphs.GraphCache(dev)

            def fn():
                return torch.linalg.solve_ex(A, b)[0] * 1.0
            cache("solve", fn)
            got = cache("solve", fn)
            out[lib] = {"captured": True,
                        "replay_equals_eager": bool(torch.equal(got, want))}
        except RuntimeError as e:
            out[lib] = {"captured": False, "error": str(e)[:300]}
        finally:
            torch.backends.cuda.preferred_linalg_library(saved)
    return out


def main(argv=None) -> int:
    sys.path.insert(0, ROOT)
    from bpvo_tpu_torch.parallel.worker import rank_args
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    if argv is None:
        argv = sys.argv[1:]
    if "--rank" in argv:
        rank_args(ap)
        run_rank(ap.parse_args(argv))
        return 0
    ap.add_argument("--worlds", default="1,2,4")
    ap.add_argument("--mixing", choices=("0", "1"), default=None)
    ap.add_argument("--timeout", type=float, default=240.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--linalg", action="store_true")
    args = ap.parse_args(argv)
    from bpvo_tpu_torch.parallel import multihost
    if args.mixing is not None:
        os.environ["NCCL_GRAPH_MIXING_SUPPORT"] = args.mixing
    n_dev = torch.cuda.device_count()
    out = {"devices": n_dev, "mixing": args.mixing, "worlds": {}}
    ok = True
    for n in (int(w) for w in args.worlds.split(",")):
        if n > n_dev:
            out["worlds"][n] = "not measured: more ranks than cards"
            continue
        done = multihost.launch("scripts.nccl_graph_nodes",
                                ["--backend", "nccl", "--device", "cuda"], n,
                                args.timeout)
        ranks = [json.loads(line.split(" ", 1)[1]) for d in done
                 for line in d.stdout.splitlines()
                 if line.startswith("NODES_RANK ")]
        failed = [f"rank {r}: exit {d.returncode}\n{d.stdout[-2000:]}"
                  for r, d in enumerate(done) if d.returncode != 0]
        stages = [[line for line in d.stdout.splitlines()
                   if line.startswith("NODES_STAGE ")] for d in done]
        ok = ok and not failed
        out["worlds"][n] = {"ranks": ranks, "failed": failed,
                            "stages": stages}
        print(json.dumps(out["worlds"][n])[:3000], flush=True)
    if args.linalg:       # last: a refused capture ends this process's use
        out["linalg_capture"] = linalg_capture()
    text = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
