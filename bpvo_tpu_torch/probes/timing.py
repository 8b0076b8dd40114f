"""Clocks for the probes.  On a CUDA device: the device time of a call
replayed from a CUDA graph (the launches without the Python around them),
the time of a call through its wrapper, both by CUDA events, and the device
kernels a call runs.  On the
CPU (plain versions only): the host clock, and the result says so."""
from __future__ import annotations

import time

import torch


def graph_ms(fn, reps=20, per_graph=10):
    """Mean device ms per call of ``fn()``: ``per_graph`` calls captured in
    one CUDA graph, replayed ``reps`` times between two CUDA events."""
    fn()                                  # first-use costs outside capture
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(per_graph):
            fn()
    return events_ms(g.replay, reps) / per_graph


def events_ms(fn, reps=20):
    """Mean ms per call of ``fn()`` called back to back, by CUDA events
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_kernels(fn) -> list:
    """Names of the device kernels that one call of ``fn()`` launches,
    after one warm-up call: the kernel nodes of a CUDA graph that captures
    the call, read through the driver.  (Not torch.profiler: its device
    records went missing in some sessions on the H100 host.)"""
    import ctypes
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        fn()
    torch.cuda.synchronize()
    driver = ctypes.CDLL("libcuda.so.1")

    def call(name, *args):
        rc = getattr(driver, name)(*args)
        if rc != 0:
            raise RuntimeError(f"{name} failed ({rc})")

    graph = ctypes.c_void_p(g.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    call("cuGraphGetNodes", graph, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * max(n.value, 1))()
    call("cuGraphGetNodes", graph, nodes, ctypes.byref(n))
    names = []
    for node in nodes[:n.value]:
        kind = ctypes.c_int(-1)
        call("cuGraphNodeGetType", ctypes.c_void_p(node), ctypes.byref(kind))
        if kind.value != 0:               # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        # CUDA_KERNEL_NODE_PARAMS_v2: the CUfunction is its first field
        params = (ctypes.c_void_p * 16)()
        call("cuGraphKernelNodeGetParams_v2", ctypes.c_void_p(node), params)
        name = ctypes.c_char_p()
        call("cuFuncGetName", ctypes.byref(name), ctypes.c_void_p(params[0]))
        names.append(name.value.decode())
    g.reset()
    return names


def host_ms(fn, reps=3):
    """Mean host ms per call of ``fn()`` after one warm-up call."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def device_ms(fn, device, reps=20):
    """``graph_ms`` on a CUDA device, ``host_ms`` on the CPU."""
    if device.type == "cuda":
        return graph_ms(fn, reps)
    return host_ms(fn, min(reps, 3))


def times(fn, device, prefix="", reps=20):
    """{prefix + "ms": ``device_ms``, prefix + "wrapper_ms": the time of a
    call through its wrapper}: on a CUDA device by CUDA events, on the CPU
    both the one host-clock measurement."""
    ms = device_ms(fn, device, reps)
    wrapper = events_ms(fn, reps) if device.type == "cuda" else ms
    return {prefix + "ms": ms, prefix + "wrapper_ms": wrapper}
