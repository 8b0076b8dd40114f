"""Run one benchmark cell once:

    python3 -m vobench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the port (``bpvo_tpu_torch``) and
``BENCHMARK.json``.  Renders the cell's traffic on the card from the seed,
builds and warms up the program (set-up), runs it for ``--seconds``, then
checks its outputs against the plain reference and prints the result as
the last line of standard output (one JSON object).  With ``--trace 0``
the metrics are the cell's end-to-end metrics; with ``--trace 1`` the same
window feeds the per-layer metrics of the harness's spans, then a slice of
the same traffic runs under the profiler for the per-layer metrics of the
device trace.  Without a CUDA device, or with fewer than the cell's cards,
it exits with code 2 and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import json
import os
import sys
import time

from vobench import bench

# the checkout-local caches of what the port and the toolchain build
BUILD = bench.ROOT / "build"
CACHES = {"TRITON_CACHE_DIR": BUILD / "triton_cache",
          "CUDA_CACHE_PATH": BUILD / "cuda_cache",
          "TORCH_EXTENSIONS_DIR": BUILD / "torch_extensions"}


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="vobench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_cell(args, device=None, cell=None, setup_clock=None, setup=None,
             fault=None) -> dict:
    """One run of a cell; returns the result object.  ``device`` defaults
    to the first card.  ``setup(driver)`` replaces the driver's set-up
    (the control puts itself in the program's place so); ``fault(driver)``
    is called after the set-up and may break the program under it (the
    harness's own tests)."""
    import torch
    from vobench import check
    from vobench import trace as trace_mod
    from vobench.drivers.base import Context

    cell = cell or bench.Cell(args.workload)
    device = torch.device(device or "cuda:0")
    setup_clock = setup_clock or bench.process_age_s
    ctx = Context(cell)
    Driver = bench.driver_class(cell.mix["driver"])
    drv = Driver(cell, args.seed, device, ctx)
    bench.mark("traffic rendered")
    (setup or Driver.setup)(drv)
    if fault is not None:
        fault(drv)
    # the set-up's objects out of the collector's way: the window's host
    # work then meets the same collections in every run
    gc.collect()
    gc.freeze()
    setup_s = setup_clock()
    bench.mark("program built and warmed")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    pace, cpu = bench.host_pace_s(), time.process_time()
    res = drv.window(args.seconds)
    cpu = time.process_time() - cpu
    bench.log(f"host: a fixed loop took {pace:.4f} s before the window and "
              f"{bench.host_pace_s():.4f} s after; the process used {cpu:.3f}"
              f" CPU seconds in the window")
    n_window_runs = len(getattr(drv, "runs", ()))
    host_trace = None
    if args.trace:
        from vobench import program
        out_dir = str(BUILD / "vobench_trace")
        traced = {}
        cuda = device.type == "cuda"
        warm = functools.partial(drv.traced, short=True)
        with (trace_mod.profiled(out_dir, traced, False, warm) if cuda
              else contextlib.nullcontext()):
            before = program.settled_counts()
            drv.traced()
            after = program.settled_counts()
        ctx.launches = {k: after[k] - before[k] for k in after}
        ctx.trace = traced.get("trace")
        drv.traced_shapes()
        if cuda:
            # a second, shorter slice with the host's operations, for the
            # idle gaps' breakdown only
            with trace_mod.profiled(out_dir, traced, True, warm):
                drv.traced(short=True)
            host_trace = traced["trace"]
    dev_line = (bench.device_line(cell.chips) if device.type == "cuda"
                else {"platform": "cpu", "kind": "cpu", "count": 1,
                      "memory_peak_bytes": 0})
    data = drv.check_inputs()
    drv.free()
    # the reference runs after the window, with the program's state freed
    t_check = time.perf_counter()
    if cell.mix["driver"] == "reprocess":
        numbers = check.judge_reprocess(cell, drv.pool, data, args.seed,
                                        n_window_runs)
    else:
        numbers = check.judge_online(cell, drv.pool, data, args.seed)
    bench.log(f"check: {numbers} in {time.perf_counter() - t_check:.3f} s")
    correct, checks = check.verdict(numbers, cell.limits, res["failed"])

    metrics = {}
    if not args.trace:
        values = dict(res, setup_s=setup_s)
        for m in cell.metrics(trace=False):
            metrics[m["name"]] = {"value": float(values[m["name"]]),
                                  "unit": m["unit"]}
    else:
        for m in cell.metrics(trace=True):
            v = bench.metric_reader(m["name"], cell.here)(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        if ctx.trace is not None and ctx.trace.lo is not None:
            dev_line["busy_s"] = ctx.trace.busy_s
            dev_line["window_s"] = ctx.trace.window_s
    out = {"correct": bool(correct), "attempted": int(res["attempted"]),
           "failed": int(res["failed"]), "metrics": metrics,
           "device": dev_line}
    if args.trace:
        b = trace_mod.breakdown(ctx.trace, host_trace)
        if b is not None:
            out["breakdown"] = b
    out["checks"] = checks
    gc.unfreeze()
    return out


def main(argv=None) -> int:
    args = parse(argv)
    for k, v in CACHES.items():
        os.environ[k] = str(v)
    os.environ["USE_FLAX"] = "0"
    # one process with one host thread for the CPU's share of the work:
    # the host's pace then varies less from run to run
    os.environ["OMP_NUM_THREADS"] = "1"
    cell = bench.Cell(args.workload)   # fails where BENCHMARK.json is not
    import torch
    torch.set_num_threads(1)
    bench.mark("torch imported")
    if not torch.cuda.is_available():
        bench.log("vobench: no CUDA device; a measurement never falls back "
                  "to the CPU")
        return 2
    if torch.cuda.device_count() < cell.chips:
        bench.log(f"vobench: {cell.name} needs {cell.chips} cards, "
                  f"{torch.cuda.device_count()} present")
        return 2
    bench.log(f"vobench {cell.name} seed {args.seed} seconds {args.seconds}"
              f" trace {args.trace}; {bench.smi()}; torch {torch.__version__}"
              f" cuda {torch.version.cuda}")
    out = run_cell(args, cell=cell)
    bad = bench.forbidden_modules()
    if bad:
        bench.log(f"vobench: the run loaded {bad}; the benchmark may load "
                  "neither JAX nor the JAX package")
        return 3
    for name, c in out["checks"].items():
        bench.log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
