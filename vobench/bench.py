"""What every cell shares: finding a cell's configuration, traffic mix,
limits and metrics by the names in ``BENCHMARK.json``, the process clock
that ``setup_s`` starts from, the device line, the import check and the
result line."""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level modules a run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "bpvo_tpu")


def process_age_s() -> float:
    """Seconds since this process started (its start time in /proc)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T0


_T0 = time.perf_counter()


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """A workload of ``BENCHMARK.json`` with its configuration, traffic
    mix, limits and the metrics it reports."""

    def __init__(self, name: str, benchmark: Optional[Dict] = None,
                 here: Path = HERE):
        self.here = here
        self.benchmark = benchmark or load_json(ROOT / "BENCHMARK.json")
        cells = {w["name"]: w for w in self.benchmark["workloads"]}
        if name not in cells:
            raise SystemExit(f"vobench: no workload {name!r} in "
                             f"BENCHMARK.json ({sorted(cells)})")
        self.workload = cells[name]
        self.name = name
        self.chips = int(self.workload["chips"])
        self.config = load_json(here / "configs" /
                                f"{self.workload['config']}.json")
        self.mix = load_json(here / "traffic" /
                             f"{self.workload['traffic']}.json")
        limits = here / "limits" / f"{name}.json"
        self.limits = load_json(limits) if limits.exists() else {}

    def metrics(self, trace: bool) -> List[Dict]:
        """The end-to-end metrics (``trace`` 0) or the per-layer ones
        (``trace`` 1) this cell reports."""
        key = "per_layer" if trace else "end_to_end"
        return [m for m in self.benchmark[key]
                if self.name in m.get("workloads", [self.name])]

    @property
    def inputs(self) -> str:
        return self.mix.get("inputs", self.config["inputs"])


def metric_reader(name: str, here: Path = HERE):
    """The ``read(ctx)`` of ``metrics/<name>.py``."""
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "vobench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver_class(name: str):
    """The ``Driver`` of ``drivers/<name>.py``."""
    return importlib.import_module(f"vobench.drivers.{name}").Driver


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def device_line(count: int) -> Dict:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(count))}


def smi() -> str:
    """The cards' names, power limits and clocks, as ``nvidia-smi`` reads
    them, for the log."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def mark(what: str) -> None:
    """Log a set-up stage with the process's age when it ended."""
    log(f"setup: {what} at {process_age_s():.3f} s")


def host_pace_s() -> float:
    """Seconds a fixed pure-Python loop takes now: the host CPU's pace,
    logged beside each window, since the cells wait on the host."""
    t = time.perf_counter()
    x = 0
    for i in range(1_000_000):
        x += i & 7
    return time.perf_counter() - t
