"""Wall-clock timing helpers (counterpart of ``bpvo_tpu/utils/timer.py``;
reference ``bpvo/timer.{h,cc}``): ``time_code`` and ``StageTimer`` wait for
the CUDA work they time, where the JAX package blocks on its arrays."""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Callable, Dict, List

import torch


def _synchronize(out) -> None:
    """Wait for the devices of every CUDA tensor in ``out`` (a tensor or
    a nest of tuples, lists and dicts of them)."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _synchronize(v)
    elif isinstance(out, (tuple, list)):
        for v in out:
            _synchronize(v)


class Timer:
    def __init__(self):
        self.start()

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        """Elapsed milliseconds since start."""
        return (time.perf_counter() - self._t0) * 1000.0

    def elapsed_ms(self) -> float:
        return self.stop()


def time_code(n_rep: int, fn: Callable, *args, block=True, **kw) -> float:
    """Average milliseconds over n_rep calls (reference timer.h:62-81
    ``TimeCode``), waiting for the CUDA tensors the last call returns."""
    t = Timer()
    out = None
    for _ in range(n_rep):
        out = fn(*args, **kw)
    if block and out is not None:
        _synchronize(out)
    return t.stop() / n_rep


class StageTimer:
    """Accumulates per-stage timings across frames (the role of the
    per-frame ms prints in reference apps/vo_app.cc:316-336).  Once CUDA
    is in use a stage waits for the current device at its end, so it times
    the device work it issued."""

    def __init__(self):
        self._acc: Dict[str, List[float]] = {}

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        yield
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self._acc.setdefault(name, []).append(
            (time.perf_counter() - t0) * 1000.0)

    def add(self, name: str, ms: float):
        self._acc.setdefault(name, []).append(ms)

    def summary(self) -> Dict[str, float]:
        return {k: sum(v) / len(v) for k, v in self._acc.items() if v}

    def report(self) -> str:
        return "\n".join(f"{k:>24s}: {v:8.3f} ms"
                         for k, v in sorted(self.summary().items()))
