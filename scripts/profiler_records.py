"""Does torch.profiler record the card's kernels, and when does it stop?

On one CUDA device, each case in a process of its own.  The work: a few
eager launches of PyTorch kernels and of one of the port's own kernels
(``census_planes``, a ctypes-bound library with its own CUDA runtime), and
replays of a CUDA graph of the same launches.  Each is recorded in a
session with CPU and CUDA activities and read two ways: the kernel events
of the trace that ``bpvo_tpu_torch.utils.profiling.trace`` exports, and
the CUDA events of ``prof.events()`` (how ``probes.timing.device_kernels``
once read them).  The cases differ in what ran before in the same
process: nothing (``fresh``); a CPU-only session (``after_cpu_only``); a
CPU-only session with ``record_function`` labels over eager launches and
graph replays, as chip_smoke.py's graph phase runs them
(``after_cpu_only_over_replays``); a CUDA graph captured inside a CPU-only
session (``after_capture_in_cpu_only``); a CUDA session (``after_cuda``);
a CPU-only session before the process first touched the card
(``cpu_only_before_cuda_init``).

The ``if_body_*`` cases trace two steps of the bench intensity
``DeviceVO`` (376x1241, a step graph whose keyframe branch is an IF node
holding ``level_gn``'s cluster launches), the second a keyframe, and count
the kernel events named level_gn against the launches the wrappers
counted, the kernel events with no correlation to a launch, and their
streams.  Before that trace the process ran nothing else
(``if_body_fresh``); graphed steps of a dense ``DeviceVO`` (its L0 and L1
loops WHILE nodes: ``if_body_after_while_replays``); eager steps of that
``DeviceVO`` (``if_body_after_eager_dense``); or eager steps first, then a
dense ``DeviceVO``'s capture and graphed steps
(``if_body_after_eager_dense_then_while_replays``); the same with a
CPU-only session over each (``if_body_after_eager_dense_then_while_
replays_profiled``); or chip_smoke.py's graph phase on that path, eager,
graphed and chunked (``if_body_after_graph_phase``).

``while_body_iterations`` replays, traced, a graph whose WHILE node runs
WHILE_ITERS iterations of a body that launches ``census_planes`` on a
64x64 image, and counts the census kernel events against the launches
(WHILE_ITERS a replay) and the replays' results against the warm-up's.

    python3 scripts/profiler_records.py [--out build/profiler.json]

Prints one JSON object: per case and work, the kernel events of each
reading and the kernel launches the work issued.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = ("fresh", "after_cpu_only", "after_cpu_only_over_replays",
         "after_capture_in_cpu_only", "after_cuda",
         "cpu_only_before_cuda_init", "if_body_fresh",
         "if_body_after_while_replays", "if_body_after_eager_dense",
         "if_body_after_eager_dense_then_while_replays",
         "if_body_after_eager_dense_then_while_replays_profiled",
         "if_body_after_graph_phase", "while_body_iterations")
DENSE_STEPS = 15              # the dense DeviceVO's steps before the trace
WHILE_ITERS = 5               # while_body_iterations: a replay's iterations
WHILE_REPLAYS = 3             # and the traced replays
REPS = 4
LAUNCHES = 3 * REPS           # matmul, relu and census_planes per rep


def _record(work):
    """(kernel events of the exported trace, CUDA events of
    ``prof.events()``) of ``work`` in one session each."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from bpvo_tpu_torch.utils import profiling
    with tempfile.TemporaryDirectory() as d:
        with profiling.trace(d, device="cuda"):
            work()
            torch.cuda.synchronize()
        (name,) = os.listdir(d)
        with open(os.path.join(d, name)) as f:
            exported = sum(1 for e in json.load(f)["traceEvents"]
                           if e.get("cat") == "kernel")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        work()
        torch.cuda.synchronize()
    listed = sum(1 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    return {"exported": exported, "events": listed}


def if_body_case(case):
    """The ``if_body_*`` cases (see the module docstring)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from bpvo_tpu_torch import AlgorithmParameters, DescriptorType
    from bpvo_tpu_torch.data import synthetic
    from bpvo_tpu_torch.ops import level_gn
    from bpvo_tpu_torch.utils import graphs, profiling
    from bpvo_tpu_torch.vo.device_vo import DeviceVO

    bench = dict(minSaliency=2.0, numPyramidLevels=4, functionTolerance=1e-4,
                 parameterTolerance=1e-6, maxIterations=50)
    dense = AlgorithmParameters(**bench, descriptor=DescriptorType.INTENSITY,
                                minNumPixelsForNonMaximaSuppression=20000000,
                                pointCapacity=131072)
    K, b, frames = synthetic.synthesize_sequence(1 + DENSE_STEPS)
    shape = (synthetic.ROWS, synthetic.COLS)
    images = [torch.as_tensor(f[0]).cuda() for f in frames]
    disps = [torch.as_tensor(f[1]).cuda() for f in frames]
    profiled = case.endswith("_profiled")

    def steps(step):
        for i in range(1, len(images)):
            step(i)
        if profiled:            # chip_smoke.py's host-op count
            with profile(activities=[ProfilerActivity.CPU]):
                for i in range(1, len(images)):
                    with record_function(f"step_{i}"):
                        step(i)
        torch.cuda.synchronize()

    if case == "if_body_after_graph_phase":
        sys.path.insert(0, ROOT)
        import chip_smoke
        chip_smoke.graph_phase(
            "DeviceVO dense intensity",
            lambda: DeviceVO(K, b, shape, dense, device="cuda"), frames,
            torch.device("cuda", 0), "", chunked=True)
    if case.startswith("if_body_after_eager_dense"):
        vo = DeviceVO(K, b, shape, dense, device="cuda")
        vo.add_frame(images[0], disps[0])
        state = [vo.state]

        def eager(i):
            state[0] = vo._step(state[0], images[i], disps[i])[0]
        steps(eager)
    if "while_replays" in case:
        vo = DeviceVO(K, b, shape, dense, device="cuda")
        vo.add_frame(images[0], disps[0])
        steps(lambda i: vo.add_frame(images[i], disps[i]))
    # the traced work: steps 5 and 6 of the bench DeviceVO (6 a keyframe)
    vo = DeviceVO(K, b, shape, AlgorithmParameters(**bench), device="cuda")
    for i in range(5):
        vo.add_frame(images[i], disps[i])
    torch.cuda.synchronize()
    graphs.settle()
    before = level_gn.launch_count
    with tempfile.TemporaryDirectory() as d:
        with profiling.trace(d, device="cuda"):
            keyframes = [bool(vo.add_frame(images[i], disps[i]).is_keyframe)
                         for i in (5, 6)]
            torch.cuda.synchronize()
        (name,) = os.listdir(d)
        with open(os.path.join(d, name)) as f:
            kernels = [e for e in json.load(f)["traceEvents"]
                       if e.get("cat") == "kernel"]
    graphs.settle()
    loose = [e for e in kernels if not e["args"].get("correlation")]
    return {"keyframes": keyframes,
            "level_gn_launches": level_gn.launch_count - before,
            "level_gn_events": sum("level_gn" in e["name"] for e in kernels),
            "kernel_events": len(kernels),
            "uncorrelated_kernel_events": len(loose),
            "uncorrelated_streams": sorted({e["args"].get("stream")
                                            for e in loose})}


def while_body_case():
    """``while_body_iterations`` (see the module docstring)."""
    import torch
    from bpvo_tpu_torch.ops import census
    from bpvo_tpu_torch.utils import graphs, profiling

    img = torch.rand(64, 64, device="cuda") * 255
    n = torch.tensor(WHILE_ITERS, dtype=torch.int32, device="cuda")
    cache = graphs.GraphCache("cuda")

    def fn():
        def body(c):
            return c[0] + 1, c[1] + census.census_planes(img).sum()
        return graphs.while_loop(
            lambda c: c[0] < n, body,
            (torch.zeros((), dtype=torch.int32, device="cuda"),
             torch.zeros((), device="cuda")))
    want = cache("loop", fn)[1].clone()     # the warm-up's result
    torch.cuda.synchronize()
    graphs.settle()
    before = census.launch_count
    with tempfile.TemporaryDirectory() as d:
        with profiling.trace(d, device="cuda"):
            outs = [cache("loop", fn)[1].clone()
                    for _ in range(WHILE_REPLAYS)]
            torch.cuda.synchronize()
        (name,) = os.listdir(d)
        with open(os.path.join(d, name)) as f:
            kernels = [e for e in json.load(f)["traceEvents"]
                       if e.get("cat") == "kernel"]
    graphs.settle()
    return {"iterations_per_replay": WHILE_ITERS, "replays": WHILE_REPLAYS,
            "results_equal_warm_up": all(torch.equal(o, want)
                                         for o in outs),
            "census_launches": census.launch_count - before,
            "census_events": sum("census_kernel" in e["name"]
                                 for e in kernels),
            "set_condition_events": sum("set_condition" in e["name"]
                                        for e in kernels),
            "kernel_events": len(kernels)}


def run_case(case):
    if case.startswith("if_body"):
        return if_body_case(case)
    if case == "while_body_iterations":
        return while_body_case()
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from bpvo_tpu_torch.ops import census

    def cpu_only(fn=lambda: sum(range(1000))):
        with profile(activities=[ProfilerActivity.CPU]):
            fn()

    if case == "cpu_only_before_cuda_init":
        cpu_only()
    x = torch.randn(1024, 1024, device="cuda")
    img = torch.rand(376, 1241, device="cuda") * 255

    def eager():
        for _ in range(REPS):
            torch.relu_(x @ x)
            census.census_planes(img)

    def capture():
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            eager()
        torch.cuda.synchronize()
        return g

    eager()                      # first use: cuBLAS handle, the library
    torch.cuda.synchronize()
    if case == "after_capture_in_cpu_only":
        graph = []
        cpu_only(lambda: graph.append(capture()))
        g = graph[0]
    else:
        g = capture()
    if case == "after_cpu_only":
        cpu_only()
    elif case == "after_cpu_only_over_replays":
        def labelled():
            for i in range(3):
                with record_function(f"step_{i}"):
                    eager()
                    g.replay()
                torch.cuda.synchronize()
        cpu_only(labelled)
    elif case == "after_cuda":
        _record(eager)
    return {"eager": _record(eager), "replay": _record(g.replay),
            "launches": LAUNCHES}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--case", choices=CASES)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if args.case:
        print(json.dumps(run_case(args.case)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("profiler_records: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from bpvo_tpu_torch.ops import _build
    _build.compile_library()               # once, before the cases
    res = {"device": torch.cuda.get_device_name(0),
           "torch": torch.__version__, "cuda": torch.version.cuda}
    env = dict(os.environ, PYTHONPATH=ROOT)
    for case in CASES:
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--case", case], capture_output=True, text=True,
                           env=env, timeout=300)
        res[case] = (json.loads(p.stdout.strip().splitlines()[-1])
                     if p.returncode == 0 else {"error": p.stderr[-2000:]})
    line = json.dumps(res)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
