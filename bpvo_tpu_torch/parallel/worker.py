"""One rank of a distributed run whose inputs and outputs are files:

    python -m bpvo_tpu_torch.parallel.worker --mode gn|vo|ba|ba2d \\
        --inp IN.npz --out DIR --backend gloo --device cpu \\
        --rank R --world N --port P

(``multihost.launch`` adds the last three.)  Each rank reads the same
inputs, joins the group, runs its part and writes ``DIR/rank<R>.npz``,
then prints ``WORKER_OK mode=<mode> rank=<R> world=<N>``.  The modes:

- ``gn``: ``sharded.make_sharded_gn`` on a template (``td_*`` arrays),
  ``channels``, ``cam`` (fx, fy, cx, cy, baseline), ``opts`` (GNOptions as
  JSON) and ``T_init``; writes T, num_iters, this rank's weights;
- ``vo``: ``sharded_vo.make_sharded_vo`` over ``images`` and
  ``disparities`` (the first initialises; ``chunks``: the frame counts of
  the ``scan_fn`` calls) with ``K``, ``baseline`` and ``params``
  (AlgorithmParameters as JSON); writes pose, pose_world, is_keyframe,
  iters and the collective calls and bytes;
- ``ba``: a ``bundle_adjustment.KeyframeWindow`` with the group's reducer
  (the points split over the ranks) fed the keyframes of a stacked window
  (``td_*``, ``channels`` (M, C, H, W), ``poses``), then ``optimize()``
  with ``ba_opts`` (JSON; ``refine_depth`` runs the depth Schur
  complement); writes poses;
- ``ba2d``: ``bundle_adjustment.make_sharded_ba_2d`` with ``kf`` keyframe
  coordinates on a stacked window (``td_*``), ``channels`` (M, C, H, W),
  ``cam``, ``poses`` and ``ba_opts`` (JSON); writes poses and cost.

With ``--rerun`` the ``gn`` and ``vo`` modes also run their graphed route
through ``utils.graphs.RerunCache`` (its "replays" rerun the captured
function, the branches read on the host), the first call and a replay,
and write its outputs and collective counts under ``rerun_`` names: on
gloo, where no CUDA graph runs, it rehearses the graphed route's buffers
and branches across processes (every rank must take the same ones).
"""
from __future__ import annotations

import argparse
import json
import os
import types

import numpy as np
import torch

from bpvo_tpu_torch.utils import convert


def _prefixed(data, prefix):
    return {k[len(prefix):]: v for k, v in data.items()
            if k.startswith(prefix)}


def _cam(data):
    return convert.camera_from_numpy(dict(zip(
        ("fx", "fy", "cx", "cy", "baseline"),
        np.asarray(data["cam"], np.float32))))


def _json(data, key):
    return json.loads(str(data[key]))


def _caches(args, dev):
    """The routes to run: ("", the default route) and, with ``--rerun``,
    ("rerun_", a ``RerunCache``)."""
    from bpvo_tpu_torch.utils import graphs
    return [("", None)] + ([("rerun_", graphs.RerunCache(dev))]
                           if args.rerun else [])


def mode_gn(data, reducer, dev, args):
    from bpvo_tpu_torch.parallel import sharded
    td = convert.template_from_numpy(_prefixed(data, "td_"), dev)
    shard = sharded.shard_template(td, reducer.rank, reducer.world)
    opts = convert.gn_options_from_jax(types.SimpleNamespace(
        **_json(data, "opts")))
    res = {}
    for prefix, cache in _caches(args, dev):
        run = sharded.make_sharded_gn(reducer, opts, cache=cache)
        for _ in range(2 if cache is not None else 1):  # a replay
            reducer.reset()
            st = run(shard, torch.from_numpy(data["channels"]).to(dev),
                     _cam(data), torch.from_numpy(data["T_init"]).to(dev))
        res.update({prefix + "T": st.T, prefix + "num_iters": st.num_iters,
                    prefix + "weights": st.weights,
                    prefix + "collective_calls": reducer.calls,
                    prefix + "collective_bytes": reducer.bytes})
    return res


def mode_vo(data, reducer, dev, args):
    from bpvo_tpu_torch.parallel import sharded_vo
    images, disps = data["images"], data["disparities"]
    p = convert.params_from_jax(_json(data, "params"))
    res = {}
    for prefix, cache in _caches(args, dev):
        init_fn, _, scan_fn = sharded_vo.make_sharded_vo(
            reducer, data["K"], float(data["baseline"]), images.shape[1:],
            p, device=dev, cache=cache)
        state = init_fn(images[0], disps[0])
        reducer.reset()
        outs, at = [], 1
        for n in data["chunks"]:
            state, out = scan_fn(state, images[at:at + n],
                                 disps[at:at + n])
            outs.append(out)
            at += n
        res.update({prefix + f: torch.cat([getattr(o, f) for o in outs])
                    for f in ("pose", "pose_world", "is_keyframe", "iters")})
        res.update({prefix + "collective_calls": reducer.calls,
                    prefix + "collective_bytes": reducer.bytes,
                    prefix + "steps": at - 1})
    return res


def mode_ba(data, reducer, dev, args):
    from bpvo_tpu_torch.parallel import bundle_adjustment as ba
    templates = convert.template_from_numpy(_prefixed(data, "td_"), dev)
    M = templates.points.shape[0]
    win = ba.KeyframeWindow(M, _cam(data), convert.ba_options_from_jax(
        _json(data, "ba_opts")), reducer=reducer, device=dev)
    channels = torch.from_numpy(data["channels"])
    for i in range(M):
        win.push(ba.TemplateData(*(x[i] for x in templates)), channels[i],
                 data["poses"][i])
    return {"poses": win.optimize()}


def mode_ba2d(data, reducer, dev, args):
    from bpvo_tpu_torch.parallel import bundle_adjustment as ba
    from bpvo_tpu_torch.parallel import multihost
    templates = convert.template_from_numpy(_prefixed(data, "td_"), dev)
    layout = multihost.global_mesh(kf_axis_size=int(data["kf"]),
                                   world_size=reducer.world)
    opts = convert.ba_options_from_jax(_json(data, "ba_opts"))
    M = templates.points.shape[0]
    run = ba.make_sharded_ba_2d(reducer, opts, M, layout)
    poses, cost = run(ba.shard_window_2d(templates, reducer.rank, layout),
                      torch.from_numpy(data["channels"]).to(dev), _cam(data),
                      torch.from_numpy(data["poses"]).to(dev))
    return {"poses": poses, "cost": cost}


MODES = {"gn": mode_gn, "vo": mode_vo, "ba": mode_ba, "ba2d": mode_ba2d}


def rank_args(ap: argparse.ArgumentParser) -> None:
    """The arguments ``multihost.launch`` passes and the group's."""
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--backend", choices=("gloo", "nccl"), required=True)
    ap.add_argument("--device", default="cuda",
                    help="cuda (every rank on cuda:<rank> with nccl, on "
                         "cuda:0 with gloo) or cpu")
    ap.add_argument("--threads", type=int, default=0,
                    help="torch CPU threads per rank (0: torch's default)")


def join(args):
    """Join the group of ``rank_args``; returns (reducer, device)."""
    from bpvo_tpu_torch.parallel import multihost
    from bpvo_tpu_torch.vo.device_vo import resolve_device
    if args.threads:
        torch.set_num_threads(args.threads)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", args.rank if args.backend == "nccl" else 0)
        torch.cuda.set_device(dev)
    reducer = multihost.initialize(
        args.backend, args.world, args.rank,
        f"tcp://127.0.0.1:{args.port}",
        device=dev if args.backend == "nccl" else None)
    return reducer, dev


def main(argv=None) -> None:
    from bpvo_tpu_torch.parallel import multihost
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", choices=sorted(MODES), required=True)
    ap.add_argument("--inp", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--rerun", action="store_true",
                    help="gn, vo: also run the graphed route through "
                         "graphs.RerunCache (rerun_ outputs)")
    rank_args(ap)
    args = ap.parse_args(argv)
    reducer, dev = join(args)
    try:
        with np.load(args.inp) as f:
            data = dict(f)
        res = MODES[args.mode](data, reducer, dev, args)
        np.savez(os.path.join(args.out, f"rank{args.rank}.npz"),
                 **{k: v.cpu().numpy() if torch.is_tensor(v) else v
                    for k, v in res.items()})
    finally:
        multihost.shutdown()
    print(f"WORKER_OK mode={args.mode} rank={args.rank} world={args.world}",
          flush=True)


if __name__ == "__main__":
    main()
