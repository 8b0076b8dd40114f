"""The online frame by the program's own spans, on the card:

    python3 scripts/online_spans.py [micro] [bench] [idle] [cost] \
        [--seed N] [--frames 30] [--pairs 6] [--seconds 10] \
        [--out build/online_spans.json]

from the root of a checkout.  Each phase named runs, in the order given
(all four by default):

- ``micro``: a span's cost while nothing records and while ``recording()``
  is on, and a counter's, in microseconds a use (10^5 uses, host clock);
- ``bench``: one traced run of ``kitti00_intensity.online_stereo`` as
  ``python3 -m vobench.run ... --trace 1`` makes it (20 s), its result
  line, and the medians of the ``sgm.run`` and ``vo.add_frame`` spans over
  its traced frames beside ``matcher_ms_p50.online`` and
  ``add_frame_ms_p50.online``;
- ``idle``: the same cell's program, warmed, then ``--frames`` frames
  inside ``profiling.trace`` (CPU and CUDA activity): the device's idle
  time between the first frame's ``sgm.run`` and the last frame's
  ``vo.add_frame`` in the Chrome trace, each idle interval split at span
  edges and given to the innermost program span over it ("between
  frames" where none is), in ms a frame;
- ``cost``: ``--pairs`` pairs of windows of ``--seconds`` each, spans
  recorded (``recording()``) and not, the order alternating from pair to
  pair: each window's frame p50 and p95 (ms);
- ``agree``: one window of ``--seconds`` with spans recorded: the medians
  of the ``sgm.run`` and ``vo.add_frame`` spans beside the harness's own
  readings of the same frames (the matcher's CUDA events, ``add_frame``'s
  host clock);
- ``session``: a device-only profiler session over 120 frames, as a
  traced ``vobench`` run makes it, and the two spans' medians there;
- ``copies``: one window of ``--seconds`` with CUDA events around each
  host copy (``profiling.device_read`` by its span's name, and
  ``profiling.upload`` from pageable or from page-locked host memory):
  each copy's device time in ms a frame, the window's frame p50 and p95,
  and torch's host allocator's stats at the window's end.  Named first
  among these phases, its window is the process's first.

``idle``, ``cost``, ``agree``, ``session`` and ``copies`` share one
program, built once.  A phase named twice runs twice.  One JSON object,
on stdout and in ``--out``.  Progress goes to stderr."""
from __future__ import annotations

import argparse
import bisect
import contextlib
import functools
import gc
import json
import os
import statistics
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CELL = "kitti00_intensity.online_stereo"
PREFIXES = ("sgm.", "vo.", "graph.")


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def micro(n=100_000):
    from bpvo_tpu_torch.utils import profiling

    def per_use(fn):
        t = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t) / n * 1e6

    def span():
        with profiling.annotate("vo.micro"):
            pass

    def nested():
        with profiling.annotate("vo.micro"):
            with profiling.annotate("vo.micro_child"):
                pass

    out = {"span_off_us": per_use(span),
           "count_us": per_use(lambda: profiling.count("micro"))}
    with profiling.recording():
        out["span_on_us"] = per_use(span)
        out["child_span_on_us"] = per_use(nested) - out["span_on_us"]
    profiling.reset()
    return out


def _env():
    from vobench import run
    for k, v in run.CACHES.items():
        os.environ[k] = str(v)
    os.environ["OMP_NUM_THREADS"] = "1"
    import torch
    torch.set_num_threads(1)


def bench(seed):
    """One traced run, as ``vobench.run`` makes it, and the program's
    root spans over its traced frames."""
    from bpvo_tpu_torch.utils import profiling
    from vobench import bench as bench_mod
    from vobench import run
    profiling.reset()
    args = argparse.Namespace(workload=CELL, seed=seed, seconds=20.0,
                              trace=1)
    cell = bench_mod.Cell(CELL)
    out = run.run_cell(args, cell=cell)
    spans = sorted(profiling.spans(), key=lambda s: s.id)
    roots = [s for s in spans if s.parent is None]
    n = int(cell.mix["trace_frames"])
    adds = [s for s in roots if s.name == "vo.add_frame"][:n]
    med = _root_medians(adds + [s for s in roots if s.name == "sgm.run"][:n])
    m = out["metrics"]
    gaps = {"vo.add_frame": med["vo.add_frame"]
            / m["add_frame_ms_p50.online"]["value"] - 1,
            "sgm.run": med["sgm.run"] / m["matcher_ms_p50.online"]["value"]
            - 1}
    kf = sum(any(s.name == "vo.keyframe" and s.root == a.id for s in spans)
             for a in adds)
    profiling.reset()
    return {"line": out, "span_median_ms": med, "gap_vs_metric": gaps,
            "traced_frames": len(adds), "traced_keyframes": kf,
            "add_frame_roots_recorded": sum(s.name == "vo.add_frame"
                                            for s in roots)}


def _driver(seed, cell=None, device="cuda:0"):
    import torch
    from vobench import bench as bench_mod
    from vobench.drivers.base import Context
    from vobench.drivers.online import Driver
    cell = cell or bench_mod.Cell(CELL)
    drv = Driver(cell, seed, torch.device(device), Context(cell))
    drv.setup()
    gc.collect()
    gc.freeze()
    return drv


def _root_medians(spans):
    return {name: statistics.median((s.t1_ns - s.t0_ns) * 1e-6
                                    for s in spans if s.parent is None
                                    and s.name == name)
            for name in ("sgm.run", "vo.add_frame")}


def _stage_medians(spans):
    """Each span name's ms summed within a root, the median over the roots
    that hold it, and the number of those roots."""
    per = defaultdict(lambda: defaultdict(float))
    for s in spans:
        per[s.name][s.root] += (s.t1_ns - s.t0_ns) * 1e-6
    return {name: [statistics.median(v.values()), len(v)]
            for name, v in sorted(per.items())}


def agree(drv, seconds):
    from bpvo_tpu_torch.utils import profiling
    profiling.reset()
    with profiling.recording():
        res = drv.window(seconds)
    spans = profiling.spans()
    med = _root_medians(spans)
    stages = _stage_medians(spans)
    profiling.reset()
    s = drv.ctx.samples
    harness = {"sgm.run": statistics.median(s["matcher_ms"]),
               "vo.add_frame": statistics.median(s["add_frame_ms"])}
    return {"frame_ms_p50": res["frame_ms_p50"], "span_median_ms": med,
            "harness_ms": harness,
            "gap": {k: med[k] / harness[k] - 1 for k in med},
            "stage_ms": stages}


def session(drv):
    from bpvo_tpu_torch.utils import profiling
    from vobench import trace as trace_mod
    profiling.reset()
    traced = {}
    with trace_mod.profiled(os.path.join(ROOT, "build", "online_spans"),
                            traced, False,
                            functools.partial(drv.traced, short=True)):
        drv.traced()
    spans = profiling.spans()
    profiling.reset()
    return {"span_median_ms": _root_medians(spans),
            "roots": sum(s.parent is None for s in spans),
            "stage_ms": _stage_medians(spans)}


def copies(drv, seconds):
    import torch

    from bpvo_tpu_torch.utils import profiling
    events = []
    read, upload = profiling.device_read, profiling.upload

    def timed(name, fn, *args, **kw):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        out = fn(*args, **kw)
        e1.record()
        events.append((name, e0, e1))
        return out

    def timed_upload(t, device, *args, **kw):
        if t.device.type != "cpu":
            return upload(t, device, *args, **kw)
        name = "upload." + ("pinned" if t.is_pinned() else "pageable")
        return timed(name, upload, t, device, *args, **kw)
    profiling.device_read = lambda name, t: timed(name, read, name, t)
    profiling.upload = timed_upload
    try:
        res = drv.window(seconds)
    finally:
        profiling.device_read, profiling.upload = read, upload
    torch.cuda.synchronize()
    ms, n = defaultdict(float), defaultdict(int)
    for name, e0, e1 in events:
        ms[name] += e0.elapsed_time(e1)
        n[name] += 1
    frames = res["attempted"]
    return {"frames": frames, "frame_ms_p50": res["frame_ms_p50"],
            "frame_ms_p95": res["frame_ms_p95"],
            "copy_ms_per_frame": {k: v / frames for k, v in ms.items()},
            "copy_ms_each": {k: v / n[k] for k, v in ms.items()},
            "copies": dict(n),
            "host_memory_stats": dict(torch.cuda.host_memory_stats())}


def _innermost(a, b, spans):
    """The innermost span over all of [a, b] (the shortest), or None."""
    best = None
    for s in spans:
        if s["ts"] <= a and b <= s["ts"] + s["dur"] and (
                best is None or s["dur"] < best["dur"]):
            best = s
    return best


def idle_by_span(events, frames):
    """The device's idle time in a Chrome trace's events between the first
    ``sgm.run`` span's start and the last ``vo.add_frame`` span's end
    (``vobench.trace.Trace``'s busy intervals over that window), each idle
    interval split at span edges and given to the innermost program span
    over it ("between frames" where none is), in ms a frame."""
    from vobench.trace import Trace
    t = Trace(events)
    spans = [e for e in t.host if e["name"].startswith(PREFIXES)]
    t.lo = min(e["ts"] for e in spans if e["name"] == "sgm.run")
    t.hi = max(e["ts"] + e["dur"] for e in spans
               if e["name"] == "vo.add_frame")
    busy = t._busy()
    gaps = [(a, b) for a, b in zip([t.lo] + [b for _, b in busy],
                                   [a for a, _ in busy] + [t.hi]) if b > a]
    edges = sorted({x for s in spans for x in (s["ts"], s["ts"] + s["dur"])})
    by = defaultdict(float)
    for a, b in gaps:
        cuts = [a] + edges[bisect.bisect_right(edges, a):
                           bisect.bisect_left(edges, b)] + [b]
        for x, y in zip(cuts, cuts[1:]):
            s = _innermost(x, y, spans)
            by[s["name"] if s else "between frames"] += (y - x) * 1e-3
    total = sum(by.values())
    return {"frames": frames, "window_ms": t.window_s * 1e3,
            "busy_ms": t.busy_s * 1e3, "idle_ms": total,
            "idle_under_span_share": 1 - by["between frames"] / total,
            "idle_ms_per_frame_by_span": {
                k: v / frames for k, v in sorted(by.items(),
                                                 key=lambda kv: -kv[1])},
            "device_events": len(t.device), "span_events": len(spans)}


def idle(drv, frames):
    import tempfile

    from bpvo_tpu_torch.utils import profiling
    from vobench.drivers.base import sync
    drv._run(n=30)
    sync(drv.device)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    d = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    with profiling.trace(d, device=drv.device):
        drv._run(n=frames)
        sync(drv.device)
    (name,) = os.listdir(d)
    with open(os.path.join(d, name)) as f:
        events = json.load(f)["traceEvents"]
    os.remove(os.path.join(d, name))
    os.rmdir(d)
    profiling.reset()
    return idle_by_span(events, frames)


def cost(drv, pairs, seconds):
    from bpvo_tpu_torch.utils import profiling
    out = {"off": [], "on": []}
    for i in range(pairs):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            profiling.reset()
            with profiling.recording() if on else contextlib.nullcontext():
                res = drv.window(seconds)
            key = "on" if on else "off"
            out[key].append([res["frame_ms_p50"], res["frame_ms_p95"],
                             res["attempted"]])
            log(f"cost: pair {i} {key} p50 {res['frame_ms_p50']:.4f} "
                f"p95 {res['frame_ms_p95']:.4f} "
                f"spans {len(profiling.spans())}")
    profiling.reset()
    p50 = {k: statistics.median(r[0] for r in v) for k, v in out.items()}
    out["p50_median"] = p50
    out["on_over_off"] = p50["on"] / p50["off"] - 1
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("phases", nargs="*",
                    default=["micro", "bench", "idle", "cost"])
    ap.add_argument("--seed", type=int, default=3_000_000_019)
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "online_spans.json"))
    args = ap.parse_args(argv)
    _env()
    from vobench import bench as bench_mod
    result = {"smi": bench_mod.smi()}
    drv = None
    for phase in args.phases:
        t = time.perf_counter()
        if phase == "micro":
            out = micro()
        elif phase == "bench":
            out = bench(args.seed)
        else:
            if drv is None:
                drv = _driver(args.seed + 1)
            out = {"idle": lambda: idle(drv, args.frames),
                   "cost": lambda: cost(drv, args.pairs, args.seconds),
                   "agree": lambda: agree(drv, args.seconds),
                   "session": lambda: session(drv),
                   "copies": lambda: copies(drv, args.seconds)}[phase]()
        result.setdefault(phase, []).append(out)
        log(f"{phase}: {time.perf_counter() - t:.1f} s "
            f"{json.dumps(out)[:2000]}")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
