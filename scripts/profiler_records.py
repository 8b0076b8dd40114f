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
         "cpu_only_before_cuda_init")
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


def run_case(case):
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
