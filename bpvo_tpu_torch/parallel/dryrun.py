"""Multi-process dry run of the distributed layer (the counterpart of
``__graft_entry__.dryrun_multichip``):

    python -m bpvo_tpu_torch.parallel.dryrun --procs N \\
        --backend {gloo,nccl} --device {cpu,cuda} [--rows 376 --cols 1241] \\
        [--descriptors intensity,bitplanes] [--ref tests/data/X.npz]

starts N ranks (``multihost.launch``).  Each rank reports its group's
route (``Reducer.route``: "peer" for nccl over the cards of one host,
"nccl", "gloo"; ``peer_rule`` why) and runs, on the graphed route and on
the eager route (``cache=False``) alternately:

1. the full sharded VO (``sharded_vo.make_sharded_vo``) at ``--rows`` x
   ``--cols`` (KITTI shape by default, 16384/4096/1024/512 points) over
   1+4 frames of the synthetic sequence, for each of ``--descriptors``:
   ``scan_fn`` in two chunks (the graphed chunk's replays under
   ``torch.cuda.set_sync_debug_mode("error")``: no read) and ``step_fn``
   one frame at a time, the keyframe threshold tightened so that at least
   one keyframe event happens (JAX __graft_entry__.py:127-145);
2. the sharded GN (``sharded.make_sharded_gn``) on a synthetic template of
   CAPACITY points (at most rows * cols / 8), held on rank 0 to the same
   solve with no reducer within JAX_ATOL;
3. bundle adjustment on a window of BA_WINDOW keyframes of the sequence
   (as many points each, the poses perturbed):
   ``ba_solve``, ``make_sharded_ba`` and ``make_sharded_ba_2d`` (a kf axis
   of 2 when the world is even) held on rank 0 to ``ba_solve`` with no
   reducer within JAX_ATOL, and ``ba_solve_with_depth`` on the first
   DEPTH_M keyframes within DEPTH_ATOL;
4. on the "peer" route, the all-reduce at each size the layer reduces
   (``COLLECTIVE_SIZES``): the peer kernel bit for bit its plain version
   (``peer.plain_all_reduce`` over the same group) on random inputs,
   eagerly and over replays of a CUDA graph of 10 calls; µs per call of
   the peer kernel (back-to-back launches, and that graph replayed) and of
   eager ``dist.all_reduce`` (NCCL) on the same buffer;
5. last, on rank 0, ``DeviceVO`` on the same frames on the same device:
   the intensity world poses within POSE_ATOL (JAX's bound), Bit-Planes
   within JAX's own gap between its sharded VO and its ``DeviceVO`` plus
   ROUTE_ATOL (delta (r), from ``--ref``), and with ``--ref`` (a
   ``scripts/make_torch_port_ref.py sharded`` file at this shape) the
   sharded VO within JAX_ATOL of JAX's with its keyframes.

Each path records, per rank: graphed equal to eager bit for bit (outputs,
collective calls and bytes, kernel launches, ``peer_reduce``'s among
them: on the "peer" route every path must launch it), replays per call, host ms
per call of both routes (eager, graphed, graphed, eager for ``--rounds``
rounds) and the node types of its graphs (top level, IF and WHILE bodies;
the bodies hold kernel, memcpy and memset nodes only).  The graphed route
is CUDA graphs on CUDA where ``graphs.capturable`` (``"graphed": true``),
``graphs.RerunCache`` on the CPU (the stand-in: it rehearses the buffers
and branches), and none for gloo on CUDA (every reduction staged through
pinned host memory, ``"staged": true``: its times measure the host).

The parent checks that every rank exited 0, that the ranks' outputs are
bitwise equal, each path's checks, and prints one JSON object.  Exit code
0 only when every check holds.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

POSE_ATOL = 1e-3
JAX_ATOL = 5e-4               # sharded VO vs JAX's; GN and BA vs no reducer
ROUTE_ATOL = 2.3e-3           # Bit-Planes sharded VO vs DeviceVO (delta (e))
DEPTH_ATOL = 1e-3             # ba_solve_with_depth vs no reducer
DEPTH_M, DEPTH_ITERS = 4, 4
# BA's default 10 iterations: after 4 the pose-only solve on this window is
# still on a knife-edge (the no-reducer solve moves 2.2e-3 when its points
# are merely permuted, another sum order; 1.4e-4 after 10)
BA_ITERS = 10
CAPACITY = 16384              # points of the GN template, of a BA keyframe
BA_WINDOW = 8                 # keyframes of the BA window
CHUNKS = ((1, 3), (3, 5))
DRYRUN_PARAMS = dict(minSaliency=2.0, numPyramidLevels=4, maxIterations=8,
                     coarseMaxIterations=6, functionTolerance=1e-4,
                     parameterTolerance=1e-6,
                     minTranslationMagToKeyFrame=0.05)
# the all-reduces of the layer: (elements, dtype, op) at each call site
COLLECTIVE_SIZES = {
    "gn_H_g_fsq": (43, torch.float32, "sum"),        # sharded.py, GN
    "sigma_max": (1, torch.float32, "max"),          # global_sigma
    "sigma_histogram": (1024, torch.int32, "sum"),   # global_sigma
    "good_count": (1, torch.int64, "sum"),           # count_reduce
    "coarse_cost": (2, torch.float32, "sum"),        # the warm-start gate
    "ba_M8_H_g_fsq": (8 * 6 * 8 * 6 + 8 * 6 + 1, torch.float32, "sum"),
    "ba_depth_mean": (2, torch.float32, "sum"),      # ba_solve_with_depth
    # the depth Schur terms at M = 4, edge radius 1: 10 block rows' (6,)
    # and 26 pairs' (6, 6)
    "ba_depth_M4_terms": (10 * 6 + 26 * 36, torch.float32, "sum")}
COLLECTIVE_REPS = 200
GRAPH_CALLS = 10
COLLECTIVE_REPLAYS = 3


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


def ba_window(rows: int, cols: int, m: int, capacity: int, seed: int = 0,
              device="cuda"):
    """A BA window of ``m`` keyframes of the synthetic sequence: their
    templates (``capacity`` points each, stacked), images (m, 1, rows,
    cols), the camera and their warp poses T_i = step^i, each but the first
    perturbed by exp(0.002 n), n ~ N(0, 1)^6 (seeded).  Returns (templates,
    channels, cam, poses (m, 4, 4))."""
    from bpvo_tpu_torch.config import AlgorithmParameters
    from bpvo_tpu_torch.core import se3
    from bpvo_tpu_torch.data import synthetic
    from bpvo_tpu_torch.parallel import bundle_adjustment as ba
    from bpvo_tpu_torch.vo import template_data as td_mod
    from bpvo_tpu_torch.vo import warp as warp_mod
    dev = torch.device(device)
    K, baseline, frames = synthetic.synthesize_sequence(m, rows, cols)
    cam = warp_mod.CameraModel.from_K(K, baseline)
    p = AlgorithmParameters(minSaliency=1.0)
    images = torch.stack([torch.from_numpy(f[0])[None] for f in frames]).to(
        dev)
    templates = ba.stack_templates([td_mod.set_data(
        images[i], torch.from_numpy(f[1]).to(dev), cam, p, capacity, 0)
        for i, f in enumerate(frames)])
    step = synthetic.step_pose()
    truth = np.stack([np.linalg.matrix_power(step, i) for i in range(m)])
    noise = np.random.default_rng(seed).standard_normal((m, 6)) * 0.002
    noise[0] = 0.0
    poses = torch.from_numpy(truth.astype(np.float32)) @ se3.exp(
        torch.from_numpy(noise.astype(np.float32)))
    return templates, images, cam, poses.to(dev)


def _bitwise(a, b):
    from bpvo_tpu_torch.utils import graphs
    la, lb = graphs._leaves(a), graphs._leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def _no_reads(dev):
    """On CUDA, any call that synchronizes with the device raises."""
    if dev.type != "cuda":
        yield
        return
    old = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(old)


class _Paths:
    """One rank's graphed-against-eager records (``check``) and the arrays
    the parent compares across ranks (``arrays``)."""

    def __init__(self, reducer, dev, graphed_route, rounds):
        self.reducer, self.dev, self.rounds = reducer, dev, rounds
        self.graphed_route = graphed_route
        self.records, self.arrays = {}, {}

    def cache(self):
        from bpvo_tpu_torch.utils import graphs
        if self.graphed_route == "cuda_graphs":
            return graphs.GraphCache(self.dev)
        return graphs.RerunCache(self.dev)

    def _counts(self):
        from bpvo_tpu_torch.utils import graphs
        graphs.settle()
        return dict({m.__name__.rsplit(".", 1)[-1]: m.launch_count
                     for m in graphs.op_modules()},
                    **self.reducer.stats())

    def _ms(self, eager, graphed):
        """Host ms a call of each (``(prepare, run)``: ``run(prepare())``,
        the preparation untimed), alternated eager, graphed, graphed, eager
        for ``rounds`` rounds (host time varies between calls, so only
        times taken together compare)."""
        ms = {"eager": [], "graphed": []}
        for _ in range(self.rounds):
            for name, (prepare, run) in (
                    ("eager", eager), ("graphed", graphed),
                    ("graphed", graphed), ("eager", eager)):
                arg = prepare()
                _sync(self.dev)
                t = time.perf_counter()
                run(arg)
                _sync(self.dev)
                ms[name].append((time.perf_counter() - t) * 1e3)
        return {k: sum(v) / len(v) for k, v in ms.items()}

    def check(self, name, fn, calls=1, prepare=None):
        """``fn(cache, prepare(cache))`` (``fn(cache)`` without ``prepare``)
        on the eager route (``cache=False``) and on the graphed one (a
        fresh cache: the first call warms up and captures, the second
        replays, ``calls`` replays expected, with no read; ``prepare`` runs
        outside that window); returns the graphed outputs of the second
        call.  Without a graphed route the eager route runs once, timed
        (first-use costs included: a host-staged route's times measure the
        host)."""
        from bpvo_tpu_torch.utils import graphs

        def route(cache):
            if prepare is None:
                return (lambda: None), (lambda _: fn(cache))
            return (lambda: prepare(cache)), (lambda arg: fn(cache, arg))

        def call(cache, no_reads=False):
            prep, run = route(cache)
            arg = prep()
            with _no_reads(self.dev) if no_reads else contextlib.nullcontext():
                return run(arg)
        before = self._counts()
        _sync(self.dev)
        t0 = time.perf_counter()
        want = call(False)
        _sync(self.dev)
        ms = (time.perf_counter() - t0) * 1e3
        after = self._counts()
        n_e = {k: after[k] - before[k] for k in after}
        rec = {"launches_and_collectives": n_e}
        if self.graphed_route is None:      # timed once: nothing to compare
            rec["ms_eager"] = ms
            self.records[name] = rec
            return want
        cache = self.cache()
        first = call(cache)
        before, r0 = self._counts(), graphs.replay_count
        got = call(cache, no_reads=True)
        replays = graphs.replay_count - r0
        after = self._counts()
        n_g = {k: after[k] - before[k] for k in after}
        same = _bitwise(got, want) and _bitwise(first, want) and n_g == n_e
        t = self._ms(route(False), route(cache))
        rec.update(graphed_equals_eager=same,
                   replays_per_call=replays / calls,
                   ms_eager=t["eager"], ms_graphed=t["graphed"])
        if self.graphed_route == "cuda_graphs":
            rec["node_types"] = cache.node_types()
            bodies = set(rec["node_types"]["if"]) | set(
                rec["node_types"]["while"])
            rec["bodies_kernel_memcpy_memset_only"] = bodies <= {
                "kernel", "memcpy", "memset", "graph", "empty",
                "conditional"}
        self.records[name] = rec
        return got


def _vo_paths(paths, reducer, dev, images, disps, K, baseline, shape, desc):
    """The sharded VO (``desc``) through ``scan_fn`` chunks and ``step_fn``
    steps; returns (world poses, keyframe flags) of the graphed route."""
    from bpvo_tpu_torch.config import AlgorithmParameters
    from bpvo_tpu_torch.parallel import sharded_vo
    from bpvo_tpu_torch.vo import device_vo
    p = AlgorithmParameters(**DRYRUN_PARAMS, descriptor=desc)
    routes = {}

    def route(cache):
        key = id(cache) if cache is not False else False
        if key not in routes:
            routes[key] = sharded_vo.make_sharded_vo(
                reducer, K, baseline, shape, p, device=dev, cache=cache)
        return routes[key]

    def init(cache):
        init_fn = route(cache)[0]
        return init_fn(images[0], disps[0])

    def chunks(cache, state):
        scan_fn = route(cache)[2]
        outs = []
        for lo, hi in CHUNKS:
            state, o = scan_fn(state, images[lo:hi], disps[lo:hi])
            outs.append(o)
        return device_vo.VOStepOutput(*(torch.cat(f) for f in zip(*outs)))

    def steps(cache, state):
        step_fn = route(cache)[1]
        outs = []
        for i in range(1, CHUNKS[-1][1]):
            state, o = step_fn(state, images[i], disps[i])
            outs.append(o)
        return device_vo.VOStepOutput(*(torch.stack(f) for f in zip(*outs)))

    name = str(desc.name).lower()
    n_steps = CHUNKS[-1][1] - 1
    out = paths.check(f"sharded_vo_{name}_chunks", chunks, n_steps, init)
    steps_out = paths.check(f"sharded_vo_{name}_steps", steps, n_steps, init)
    paths.records[f"sharded_vo_{name}_steps"]["equals_chunks"] = _bitwise(
        steps_out, out)
    for key in ("chunks", "steps"):
        rec = paths.records[f"sharded_vo_{name}_{key}"]
        for t in ("ms_eager", "ms_graphed"):
            if t in rec:
                rec[t.replace("ms", "ms_per_step")] = rec[t] / n_steps
    return out.pose_world, out.is_keyframe


def run_rank(args) -> dict:
    """One rank of the dry run; returns its result (also written to
    ``args.out/rank<R>.npz``)."""
    from bpvo_tpu_torch.data import synthetic
    from bpvo_tpu_torch.parallel import bundle_adjustment as ba
    from bpvo_tpu_torch.parallel import multihost, peer, sharded
    from bpvo_tpu_torch.parallel.worker import join
    from bpvo_tpu_torch.solver import gauss_newton as gn
    from bpvo_tpu_torch.types import DescriptorType
    from bpvo_tpu_torch.utils import graphs

    reducer, dev = join(args)
    try:
        rows, cols, world = args.rows, args.cols, reducer.world
        graphed = dev.type == "cuda" and graphs.capturable(reducer, dev)
        graphed_route = ("cuda_graphs" if graphed else
                         "rerun_stand_in" if dev.type == "cpu" else None)
        paths = _Paths(reducer, dev, graphed_route, args.rounds)
        res = {"rank": reducer.rank, "world": world,
               "backend": reducer.backend, "route": reducer.route,
               "peer_rule": reducer.peer_rule, "device": str(dev),
               "staged": reducer.backend == "gloo" and dev.type == "cuda",
               "graphed": graphed, "graphed_route": graphed_route}
        arrays = paths.arrays

        # 1. the sharded VO, each descriptor
        K, baseline, frames = synthetic.synthesize_sequence(
            CHUNKS[-1][1], rows, cols)
        # on the device first: a replay's window allows no host copy
        images = torch.from_numpy(np.stack([f[0] for f in frames])).to(dev)
        disps = torch.from_numpy(np.stack([f[1] for f in frames])).to(dev)
        descs = [DescriptorType[d.upper()] for d in args.descriptors]
        reducer.reset()
        graphs.settle()
        peer.launch_count = 0           # the main paths' (1-3) launches
        for desc in descs:
            name = str(desc.name).lower()
            world_poses, kf = _vo_paths(paths, reducer, dev, images, disps,
                                        K, baseline, (rows, cols), desc)
            arrays[f"vo_{name}_world"] = world_poses.cpu().numpy()
            arrays[f"vo_{name}_keyframe"] = kf.cpu().numpy()
        stats = paths.records[f"sharded_vo_{descs[0].name.lower()}_chunks"][
            "launches_and_collectives"]
        n_steps = CHUNKS[-1][1] - 1
        res["collectives"] = {"calls_per_step": stats["calls"] / n_steps,
                              "bytes_per_step": stats["bytes"] / n_steps}
        res["keyframe_events"] = int(arrays[
            f"vo_{descs[0].name.lower()}_keyframe"].sum())
        res["finite"] = all(np.isfinite(v).all() for v in arrays.values())

        # 2. the sharded GN
        capacity = min(CAPACITY, rows * cols // 8)
        tdata, channels, cam, _ = synthetic_problem(rows, cols, capacity,
                                                    device=dev)
        shard = sharded.shard_template(tdata, reducer.rank, world)
        opts = gn.GNOptions(function_tolerance=1e-4,
                            parameter_tolerance=1e-6)
        T0 = torch.eye(4, dtype=torch.float32, device=dev)
        runs = {}

        def solve(cache):
            key = id(cache) if cache is not False else False
            if key not in runs:
                runs[key] = sharded.make_sharded_gn(reducer, opts,
                                                    cache=cache)
            return runs[key](shard, channels, cam, T0)
        st = paths.check("sharded_gn", solve)
        arrays["gn_T"] = st.T.cpu().numpy()
        res["gn_iterations"] = int(st.num_iters)

        # 3. bundle adjustment on a window of the sequence
        templates, chans, bcam, poses = ba_window(
            rows, cols, BA_WINDOW, capacity, device=dev)
        bopts = ba.BAOptions(max_iterations=BA_ITERS)
        window = sharded.shard_template(templates, reducer.rank, world)
        M = BA_WINDOW
        layout = multihost.global_mesh(
            kf_axis_size=2 if world % 2 == 0 and M % 2 == 0 else 1,
            world_size=world)
        window_2d = ba.shard_window_2d(templates, reducer.rank, layout)
        dopts = ba.BAOptions(max_iterations=DEPTH_ITERS, refine_depth=True)
        depth_window = sharded.shard_template(ba.TemplateData(
            *(x[:DEPTH_M] for x in templates)), reducer.rank, world)
        ba_cases = {
            "ba_solve": lambda c: ba.ba_solve(window, chans, bcam, poses,
                                              bopts, reducer, cache=c),
            "make_sharded_ba": lambda c: ba.make_sharded_ba(
                reducer, bopts, M, cache=c)(window, chans, bcam, poses),
            "make_sharded_ba_2d": lambda c: ba.make_sharded_ba_2d(
                reducer, bopts, M, layout, cache=c)(window_2d, chans, bcam,
                                                     poses),
            "ba_solve_with_depth": lambda c: ba.ba_solve_with_depth(
                depth_window, chans[:DEPTH_M], bcam, poses[:DEPTH_M], dopts,
                reducer, cache=c)}
        for name, fn in ba_cases.items():
            out = paths.check(name, fn)
            arrays[f"{name}_poses"] = out[0].cpu().numpy()
        res["ba"] = {"M": M, "K": capacity, "iterations": BA_ITERS,
                     "layout_2d": list(layout), "depth_M": DEPTH_M}

        graphs.settle()
        res["peer_launches"] = peer.launch_count

        # 4. the all-reduce alone: the peer kernel against its plain
        # version and NCCL
        if reducer.route == "peer":
            res["collective_us"] = _collective_us(reducer, dev)

        # 5. rank 0: the references
        if reducer.rank == 0:
            res["checks"] = _references(args, dev, arrays, images, disps, K,
                                        baseline, tdata, channels, cam, T0,
                                        opts, templates, chans, bcam, poses,
                                        bopts, dopts, st)
        res["paths"] = paths.records
        np.savez(os.path.join(args.out, f"rank{reducer.rank}.npz"), **arrays)
    finally:
        multihost.shutdown()
    print("DRYRUN_RANK " + json.dumps(res), flush=True)
    return res


def _collective_us(reducer, dev):
    """Each ``COLLECTIVE_SIZES`` all-reduce through ``reducer.peer``: bit
    for bit ``peer.plain_all_reduce`` over the same group on random inputs
    (each rank's own), eagerly and over COLLECTIVE_REPLAYS replays of a
    CUDA graph of GRAPH_CALLS calls on fresh inputs (``bitwise_plain``);
    µs per call of the peer kernel (CUDA events over COLLECTIVE_REPS
    back-to-back launches; that graph replayed) and of eager
    ``dist.all_reduce`` (NCCL) on the same buffer."""
    import torch.distributed as dist
    from bpvo_tpu_torch.parallel import peer
    out = {}
    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
    gen = torch.Generator().manual_seed(reducer.rank)

    def inputs(shape, dtype):
        if dtype == torch.float32:
            return (torch.randn(shape, generator=gen) * 100).to(dev)
        return torch.randint(-2 ** 20, 2 ** 20, shape, generator=gen,
                             dtype=dtype).to(dev)

    def plain(x, op):
        return peer.plain_all_reduce(x.clone(), op, reducer.group,
                                     reducer.world)
    for name, (n, dtype, op) in COLLECTIVE_SIZES.items():
        x = inputs((n,), dtype)
        same = torch.equal(reducer.peer.all_reduce(x.clone(), op),
                           plain(x, op))
        xs = inputs((GRAPH_CALLS, n), dtype)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            for k in range(GRAPH_CALLS):
                reducer.peer.all_reduce(xs[k], op)
        for _ in range(COLLECTIVE_REPLAYS):
            fresh = inputs(tuple(xs.shape), dtype)
            xs.copy_(fresh)
            graph.replay()
            same = same and all(torch.equal(xs[k], plain(fresh[k], op))
                                for k in range(GRAPH_CALLS))
        del graph
        buf = torch.zeros(n, dtype=dtype, device=dev)

        def timed(fn, reps=COLLECTIVE_REPS):
            fn()
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            torch.cuda.synchronize(dev)
            return start.elapsed_time(end) * 1e3 / reps

        peer_us = timed(lambda: reducer.peer.all_reduce(buf, op))
        graph = torch.cuda.CUDAGraph()
        # thread-local: ProcessGroupNCCL's watchdog thread queries events
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            for _ in range(GRAPH_CALLS):
                reducer.peer.all_reduce(buf, op)
        replay_us = timed(graph.replay, COLLECTIVE_REPS // GRAPH_CALLS) / \
            GRAPH_CALLS
        del graph
        nccl_us = timed(lambda: dist.all_reduce(buf, op=ops[op],
                                                group=reducer.group))
        out[name] = {"elements": n, "dtype": str(dtype).split(".")[-1],
                     "op": op, "bitwise_plain": bool(same), "peer_us": peer_us,
                     "peer_replayed_us": replay_us, "nccl_us": nccl_us,
                     "nvlink_bound_us": (reducer.world * n * buf.element_size()
                                         / 450e9 * 1e6)}
    return out


def _references(args, dev, arrays, images, disps, K, baseline, tdata,
                channels, cam, T0, opts, templates, chans, bcam, poses,
                bopts, dopts, st):
    """Rank 0's tolerance checks (after every collective): the sharded VO
    against ``DeviceVO`` and, with ``--ref``, JAX's sharded VO; the GN and
    BA paths against their runs with no reducer."""
    from bpvo_tpu_torch.config import AlgorithmParameters
    from bpvo_tpu_torch.parallel import bundle_adjustment as ba
    from bpvo_tpu_torch.parallel import sharded
    from bpvo_tpu_torch.types import DescriptorType
    from bpvo_tpu_torch.vo.device_vo import DeviceVO
    ref = None
    if args.ref:
        ref = dict(np.load(args.ref))
        if (int(ref["rows"]), int(ref["cols"])) != (args.rows, args.cols):
            ref = None
    checks = {}
    for d in args.descriptors:
        p = AlgorithmParameters(**DRYRUN_PARAMS,
                                descriptor=DescriptorType[d.upper()])
        vo = DeviceVO(K, baseline, (args.rows, args.cols), p, device=dev)
        single = vo.add_frames(images, disps).pose_world.cpu().numpy()
        world = arrays[f"vo_{d}_world"]
        c = {"max_abs_vs_device_vo": float(np.abs(world - single).max())}
        # without --ref the Bit-Planes gap to DeviceVO has no bound here
        c["atol_vs_device_vo"] = POSE_ATOL if d == "intensity" else None
        if ref is not None:
            c["max_abs_vs_jax"] = float(np.abs(
                world - ref[f"sharded_{d}_world"]).max())
            c["keyframes_as_jax"] = bool(np.array_equal(
                arrays[f"vo_{d}_keyframe"], ref[f"sharded_{d}_keyframe"]))
            if d != "intensity":      # delta (r): JAX's own gap, + ROUTE_ATOL
                c["atol_vs_device_vo"] = float(np.abs(
                    ref[f"sharded_{d}_world"]
                    - ref[f"sharded_{d}_device_vo_level_world"]).max()
                    + ROUTE_ATOL)
        c["ok"] = ((c["atol_vs_device_vo"] is None
                    or c["max_abs_vs_device_vo"] <= c["atol_vs_device_vo"])
                   and c.get("max_abs_vs_jax", 0.0) <= JAX_ATOL
                   and c.get("keyframes_as_jax", True))
        checks[f"sharded_vo_{d}"] = c
    st_none = sharded.make_sharded_gn(None, opts, cache=False)(
        tdata, channels, cam, T0)
    d_gn = float((st.T - st_none.T).abs().max())
    checks["sharded_gn"] = {"max_abs_vs_no_reducer": d_gn, "atol": JAX_ATOL,
                            "ok": d_gn <= JAX_ATOL}
    want = ba.ba_solve(templates, chans, bcam, poses, bopts, cache=False)[0]
    for name in ("ba_solve", "make_sharded_ba", "make_sharded_ba_2d"):
        d = float(np.abs(arrays[f"{name}_poses"] - want.cpu().numpy()).max())
        checks[name] = {"max_abs_vs_no_reducer": d, "atol": JAX_ATOL,
                        "ok": d <= JAX_ATOL}
    want_d = ba.ba_solve_with_depth(
        ba.TemplateData(*(x[:DEPTH_M] for x in templates)), chans[:DEPTH_M],
        bcam, poses[:DEPTH_M], dopts, cache=False)[0]
    d = float(np.abs(arrays["ba_solve_with_depth_poses"]
                     - want_d.cpu().numpy()).max())
    checks["ba_solve_with_depth"] = {"max_abs_vs_no_reducer": d,
                                     "atol": DEPTH_ATOL, "ok": d <= DEPTH_ATOL}
    return checks


def run(procs: int, backend: str, device: str, rows: int, cols: int,
        timeout_s: float = 900.0, threads: int = 0, descriptors=("intensity",
        "bitplanes"), ref: str = "", rounds: int = 3) -> dict:
    """Launch the ranks and check them; returns the summary (``ok``)."""
    from bpvo_tpu_torch.parallel import multihost
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        done = multihost.launch(
            "bpvo_tpu_torch.parallel.dryrun",
            ["--out", out, "--backend", backend, "--device", device,
             "--rows", str(rows), "--cols", str(cols), "--threads",
             str(threads), "--descriptors", ",".join(descriptors),
             "--rounds", str(rounds)]
            + (["--ref", ref] if ref else []), procs, timeout_s)
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
                  for k in arrays[0])
    r0 = ranks[0]
    graphed_ok = {name: all(
        r["paths"][name].get("graphed_equals_eager", True) for r in ranks)
        for name in r0["paths"]}
    bodies_ok = all(r["paths"][n].get("bodies_kernel_memcpy_memset_only",
                                      True) for r in ranks for n in r["paths"])
    replays_ok = all(r["paths"][n].get("replays_per_call", 1) == 1
                     for r in ranks for n in r["paths"]
                     if r["graphed_route"] == "cuda_graphs")
    checks_ok = all(c["ok"] for c in r0["checks"].values())
    # on the peer route every path reduces through the kernel on every
    # rank, and the kernel equals its plain version at every size
    peer_by_path = {n: [r["paths"][n]["launches_and_collectives"]["peer"]
                        for r in ranks] for n in r0["paths"]}
    collective_plain = [c["bitwise_plain"] for r in ranks
                        for c in (r.get("collective_us") or {}).values()]
    peer_ok = r0["route"] != "peer" or (
        min(min(v) for v in peer_by_path.values()) > 0
        and len(collective_plain) == len(ranks) * len(COLLECTIVE_SIZES)
        and all(collective_plain))
    ok = (bitwise and all(r["finite"] for r in ranks) and checks_ok
          and all(graphed_ok.values()) and bodies_ok and replays_ok
          and peer_ok and r0["keyframe_events"] >= 1)
    return {"ok": ok, "procs": procs, "backend": backend, "device": device,
            "shape": [rows, cols], "route": r0["route"],
            "peer_rule": r0["peer_rule"], "staged": r0["staged"],
            "graphed": r0["graphed"], "graphed_route": r0["graphed_route"],
            "ranks_bitwise_equal": bitwise,
            "graphed_equals_eager_on_every_rank": graphed_ok,
            "bodies_kernel_memcpy_memset_only": bodies_ok,
            "one_replay_a_call": replays_ok,
            "keyframe_events": r0["keyframe_events"],
            "checks": r0["checks"],
            "max_abs_vs_device_vo": r0["checks"][
                f"sharded_vo_{descriptors[0]}"]["max_abs_vs_device_vo"],
            "pose_atol": POSE_ATOL,
            "collectives_per_step": r0["collectives"],
            # the sharded VO's chunks on the route the group takes, by rank
            "vo_ms_per_step": [
                r["paths"][f"sharded_vo_{descriptors[0]}_chunks"].get(
                    "ms_per_step_graphed", r["paths"][
                        f"sharded_vo_{descriptors[0]}_chunks"][
                        "ms_per_step_eager"]) for r in ranks],
            "gn_iterations": r0["gn_iterations"], "ba": r0["ba"],
            # peer_reduce's launches in the paths (1-3) by rank, and by path
            "peer_launches": [r["peer_launches"] for r in ranks],
            "peer_launches_by_path": peer_by_path,
            "collectives_bitwise_plain": all(collective_plain),
            "collective_us": r0.get("collective_us"),
            "paths": {n: {"by_rank": [r["paths"][n] for r in ranks]}
                      for n in r0["paths"]},
            "wall_s": wall}


def main(argv=None) -> int:
    from bpvo_tpu_torch.parallel.worker import rank_args
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--rows", type=int, default=376)
    ap.add_argument("--cols", type=int, default=1241)
    ap.add_argument("--descriptors", default="intensity,bitplanes",
                    help="the sharded VO's descriptors, comma-separated")
    ap.add_argument("--ref", default="",
                    help="JAX's sharded VO at this shape "
                         "(scripts/make_torch_port_ref.py sharded)")
    ap.add_argument("--rounds", type=int, default=3,
                    help="alternated eager/graphed timing rounds")
    if argv is None:
        argv = sys.argv[1:]
    if "--rank" in argv:
        ap.add_argument("--out", required=True)
        rank_args(ap)
        args = ap.parse_args(argv)
        args.descriptors = args.descriptors.split(",")
        run_rank(args)
        return 0
    ap.add_argument("--backend", choices=("gloo", "nccl"), required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--threads", type=int, default=0)
    ap.add_argument("--timeout", type=float, default=900.0)
    args = ap.parse_args(argv)
    res = run(args.procs, args.backend, args.device, args.rows, args.cols,
              args.timeout, args.threads, tuple(args.descriptors.split(",")),
              args.ref, args.rounds)
    for name, rec in res.get("paths", {}).items():    # per rank, to stderr
        for r, p in enumerate(rec["by_rank"]):
            print(f"rank {r} {name}: graphed bitwise eager "
                  f"{p.get('graphed_equals_eager')}, replays a call "
                  f"{p.get('replays_per_call')}, ms eager "
                  f"{p.get('ms_eager')} graphed {p.get('ms_graphed')}, "
                  f"node types {p.get('node_types')}", file=sys.stderr)
    print(json.dumps(res))
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
