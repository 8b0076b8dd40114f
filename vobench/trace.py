"""One profiler session over a slice of a run (CPU and CUDA activity), read
back from its Chrome trace: the device's operations (kernels, copies,
sets) and the host's, the traced window, the device's busy time, the
operations that took the most device time and the longest idle gaps by
what the host was doing."""
from __future__ import annotations

import bisect
import contextlib
import json
import os
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

WINDOW_LABEL = "vobench.traced"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime", "cuda_driver",
             "python_function")


class Trace:
    """The events of one exported session (times in microseconds)."""

    def __init__(self, events: List[Dict]):
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS
                       and e.get("ph") == "X"]
        self.kernels = [e for e in self.device if e["cat"] == "kernel"]
        self.host = [e for e in events if e.get("cat") in HOST_CATS
                     and e.get("ph") == "X"]
        marks = [e for e in self.host if e.get("name") == WINDOW_LABEL]
        # the window: the annotated range where the host was traced, else
        # the span of the device's operations
        spans = marks or self.device
        if spans:
            self.lo = min(e["ts"] for e in spans)
            self.hi = max(e["ts"] + e["dur"] for e in spans)
        else:
            self.lo = self.hi = None

    def named(self, part: str) -> List[Dict]:
        """Kernel events whose name holds ``part``, in time order."""
        return sorted((e for e in self.kernels if part in e["name"]),
                      key=lambda e: e["ts"])

    def _busy(self) -> List[Tuple[float, float]]:
        """The union of device intervals inside the window, merged."""
        out = []
        for a, b in sorted((e["ts"], e["ts"] + e["dur"])
                           for e in self.device):
            a, b = max(a, self.lo), min(b, self.hi)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], b))
            else:
                out.append((a, b))
        return out

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._busy()) * 1e-6

    def device_ops(self, n: int = 10) -> List[List]:
        """The ``n`` device operations (by name) that took the most time
        in the window, with their seconds."""
        tot = defaultdict(float)
        for e in self.device:
            if self.lo <= e["ts"] <= self.hi:
                tot[e["name"][:120]] += e["dur"] * 1e-6
        return [[k, v] for k, v in sorted(tot.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """Idle device time in the window by what the host was doing then
        (the host event overlapping each gap the most; "host idle" where
        none does), the ``n`` largest sums, in seconds."""
        busy = self._busy()
        gaps, end = [], self.lo
        for a, b in busy:
            if a > end:
                gaps.append((end, a))
            end = max(end, b)
        if self.hi > end:
            gaps.append((end, self.hi))
        host = sorted((e for e in self.host if e.get("name") != WINDOW_LABEL),
                      key=lambda e: e["ts"])
        starts = [e["ts"] for e in host]
        tot = defaultdict(float)
        for a, b in gaps:
            best, over, best_dur = "host idle", 0.0, float("inf")
            i = bisect.bisect_right(starts, b)
            # host events starting before the gap's end; scan back over a
            # bounded number of them
            for e in host[max(0, i - 400):i]:
                o = min(b, e["ts"] + e["dur"]) - max(a, e["ts"])
                if o > over or (o == over and o > 0
                                and e["dur"] < best_dur):
                    best, over, best_dur = e["name"][:120], o, e["dur"]
            tot[best] += (b - a) * 1e-6
        return [[k, v] for k, v in sorted(tot.items(),
                                          key=lambda kv: -kv[1])[:n]]


@contextlib.contextmanager
def profiled(out_dir: str, result: Dict, host: bool, warm):
    """Profile the block, ending after a device sync; on exit
    ``result["trace"]`` holds the ``Trace``.  ``warm()`` runs first in the
    profiler's warm-up step, whose events are dropped: the first kernels
    of a session can go unrecorded.  ``host``: the host's operations too,
    inside a ``WINDOW_LABEL`` range (what the host did in the device's idle
    gaps); without it only the device's activity is recorded, which keeps
    the profiler's cost off the host's enqueueing and so off the device's
    idle share.  The Chrome file is written under ``out_dir`` and removed
    once read."""
    import torch
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"trace_{os.getpid()}.json")
    acts = ([ProfilerActivity.CPU] if host else []) + [ProfilerActivity.CUDA]
    with profile(activities=acts,
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
        warm()
        torch.cuda.synchronize()
        prof.step()
        with record_function(WINDOW_LABEL):
            yield
            torch.cuda.synchronize()
        prof.step()
    try:
        with open(path) as f:
            result["trace"] = Trace(json.load(f)["traceEvents"])
    finally:
        os.remove(path)


def breakdown(device: Optional[Trace], host: Optional[Trace]):
    """The device operations that took the most time (from the device-only
    trace) and the longest idle gaps by what the host was doing (from the
    trace with the host)."""
    out = {}
    if device is not None and device.lo is not None:
        out["device_ops"] = device.device_ops()
    if host is not None and host.lo is not None:
        out["idle_gaps"] = host.idle_gaps()
    return out or None
