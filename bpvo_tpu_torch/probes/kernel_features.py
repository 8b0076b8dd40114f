"""The in-kernel loop, scalar-chain and matmul-chain probes: the kernels of
``csrc/probe_features.cu``, their wrappers and their plain PyTorch versions
(counterpart of ``scripts/probe_kernel_features.py``).

``while_loop`` runs the same recurrence with a barrier per iteration over
one CTA (``barrier="cta"``), one thread-block cluster of 2-16 CTAs
(``"cluster"``) or a cooperative grid of one CTA per SM (``"grid"``): the
three places level_gn's per-iteration reduction could live.  Timed at
several iteration counts, the difference per iteration is that barrier's
cost.

Each wrapper takes the plain version for CPU tensors only.  For CUDA
tensors it launches its kernel or raises; it never falls back.
"""
from __future__ import annotations

import numpy as np
import torch

from bpvo_tpu_torch.ops import _build
from bpvo_tpu_torch.probes._common import (LaunchCounts, compare, on_cpu,
                                           ptr, record, stream)
from bpvo_tpu_torch.probes.timing import device_ms, times

BARRIERS = ("cta", "cluster", "grid")
CLUSTER_SIZES = (2, 4, 8, 16)
WHILE_SHAPE = (8, 128)          # the TPU probe's carry
WHILE_ITERS = 7
MAX_WHILE_ELEMENTS = 4096       # 1024 threads x 4 registers
MATMUL_SHAPES = ((8, 128), (128, 128))
MATMUL_STEPS, MATMUL_SCALE = 5, 1e-2
# kernel vs plain version on the same device: while_loop and scalar_chain
# round every operation as the plain version does (bitwise); matmul_chain
# sums its 128 products in another order than the plain matmul
MATMUL_RTOL = 1e-5

launch_count = LaunchCounts("while_loop_cta", "while_loop_cluster",
                            "while_loop_grid", "scalar_chain", "matmul_chain")


def while_loop_reference(x, iters=WHILE_ITERS):
    """v <- 1.5 v + 1, ``iters`` times, then v + iters (the loop counter)."""
    v = x.to(torch.float32)
    for _ in range(iters):
        v = v * 1.5 + 1.0
    return v + float(max(iters, 0))


def while_loop(x, iters=WHILE_ITERS, barrier="cta", cluster=8):
    """``while_loop_reference`` as one kernel whose loop counter is
    broadcast through a barrier every iteration: over one 1024-thread CTA,
    a cluster of ``cluster`` CTAs, or a cooperative grid."""
    if barrier not in BARRIERS:
        raise ValueError(f"while_loop: barrier must be one of {BARRIERS}")
    if barrier == "cluster" and cluster not in CLUSTER_SIZES:
        raise ValueError(f"while_loop: cluster must be one of "
                         f"{CLUSTER_SIZES}")
    if on_cpu("while_loop", x):
        return while_loop_reference(x, iters)
    if x.numel() > MAX_WHILE_ELEMENTS or iters < 0:
        raise ValueError(f"while_loop: at most {MAX_WHILE_ELEMENTS} elements "
                         f"and iters >= 0, got {tuple(x.shape)}, {iters}")
    _build.check_tensors("while_loop", x.device,
                         {"x": (x, x.shape, torch.float32)})
    lib = _build.library()
    out = torch.empty_like(x)
    n, s = x.numel(), stream(x.device)
    if barrier == "cta":
        rc = lib.bpvo_probe_while_cta(ptr(x), ptr(out), n, iters, s)
    elif barrier == "cluster":
        rc = lib.bpvo_probe_while_cluster(ptr(x), ptr(out), n, iters,
                                          cluster, s)
    else:
        counter = torch.empty(2, dtype=torch.int32, device=x.device)
        rc = lib.bpvo_probe_while_grid(ptr(x), ptr(out), n, iters,
                                       ptr(counter), s)
    _build.launch(lib, f"while_loop ({barrier})", rc)
    launch_count[f"while_loop_{barrier}"] += 1
    return out


def scalar_chain_reference(h):
    """l0 = sqrt(max(a, 1e-20)), l1 = b / l0, l2 = sqrt(max(c - l1^2,
    1e-20)) for h = (a, b, c)."""
    h = h.to(torch.float32)
    l0 = torch.sqrt(h[0].clamp(min=1e-20))
    l1 = h[1] / l0
    l2 = torch.sqrt((h[2] - l1 * l1).clamp(min=1e-20))
    return torch.stack([l0, l1, l2])


def scalar_chain(h):
    """``scalar_chain_reference`` on one thread of the card."""
    if on_cpu("scalar_chain", h):
        return scalar_chain_reference(h)
    _build.check_tensors("scalar_chain", h.device,
                         {"h": (h, (3,), torch.float32)})
    lib = _build.library()
    out = torch.empty_like(h)
    _build.launch(lib, "scalar_chain", lib.bpvo_probe_scalar_chain(
        ptr(h), ptr(out), stream(h.device)))
    launch_count["scalar_chain"] += 1
    return out


def matmul_chain_reference(a, b, n=MATMUL_STEPS, scale=MATMUL_SCALE):
    """x <- (x @ b) * scale, ``n`` times from x = a."""
    x = a.to(torch.float32)
    for _ in range(n):
        x = torch.matmul(x, b) * scale
    return x


def matmul_chain(a, b, n=MATMUL_STEPS, scale=MATMUL_SCALE):
    """``matmul_chain_reference`` for a (8, 128) and b (128, 128) in one
    CTA: b and x in shared memory, one output per thread."""
    if on_cpu("matmul_chain", a, b):
        return matmul_chain_reference(a, b, n, scale)
    if n < 0:
        raise ValueError(f"matmul_chain: n must be >= 0, got {n}")
    _build.check_tensors("matmul_chain", a.device, {
        "a": (a, MATMUL_SHAPES[0], torch.float32),
        "b": (b, MATMUL_SHAPES[1], torch.float32)})
    lib = _build.library()
    out = torch.empty_like(a)
    _build.launch(lib, "matmul_chain", lib.bpvo_probe_matmul_chain(
        ptr(a), ptr(b), ptr(out), n, scale, stream(a.device)))
    launch_count["matmul_chain"] += 1
    return out


def grid_ctas() -> int:
    """CTAs of the cooperative grid: one per SM of the current device."""
    return int(_build.library().bpvo_probe_while_grid_ctas())


# ---------------------------------------------------------------------------
# the script's steps, timed
# ---------------------------------------------------------------------------

SWEEP_ITERS = (7, 64, 1024)
WHILE_VARIANTS = (("cta", None),) + tuple(
    ("cluster", c) for c in CLUSTER_SIZES) + (("grid", None),)


def variant_name(barrier, cluster=None):
    return f"while_loop_{barrier}{cluster or ''}"


def _while_step(device, data):
    """Each barrier's variant against the plain version at the script's 7
    iterations (bitwise) and timed there, then at 64 and 1024 iterations;
    the slope is the cost of one iteration, i.e. of one barrier and counter
    broadcast.  The work ("bytes", "ops") is that of 7 iterations."""
    x = torch.ones(WHILE_SHAPE, dtype=torch.float32, device=device)
    want = while_loop_reference(x)
    out = {**times(lambda: while_loop_reference(x), device, "plain_"),
           "library_ms": None, "bytes": 2 * 4 * x.numel(),
           "ops": (2 * WHILE_ITERS + 1) * x.numel()}

    def one(barrier, cluster):
        def call(n):
            return while_loop(x, n, barrier, cluster or 8)
        at7 = times(lambda: call(WHILE_ITERS), device)
        ms = {n: at7["ms"] if n == WHILE_ITERS else
              device_ms(lambda n=n: call(n), device) for n in SWEEP_ITERS}
        lo, hi = SWEEP_ITERS[0], SWEEP_ITERS[-1]
        return {**compare(call(WHILE_ITERS), want), **at7,
                "ms_by_iters": ms,
                "us_per_iter": (ms[hi] - ms[lo]) * 1e3 / (hi - lo)}
    for barrier, cluster in WHILE_VARIANTS:
        record(out, variant_name(barrier, cluster),
               lambda b=barrier, c=cluster: one(b, c))
    if device.type == "cuda":
        out["grid_ctas"] = grid_ctas()
    return out


def _scalar_step(device, data):
    h = torch.tensor([4.0, 2.0, 5.0], device=device)
    got = scalar_chain(h)
    return {**compare(got, scalar_chain_reference(h)),
            "sample": got.tolist(), **times(lambda: scalar_chain(h), device),
            **times(lambda: scalar_chain_reference(h), device, "plain_"),
            "library_ms": None, "bytes": 2 * 4 * h.numel(), "ops": 6}


def _matmul_step(device, data):
    """Seeded uniform [0, 1) inputs at the script's shapes, against the plain
    version at rtol MATMUL_RTOL, beside five ``torch.addmm`` calls."""
    r = np.random.default_rng(1)
    a, b = (torch.as_tensor(r.uniform(0, 1, s).astype(np.float32),
                            device=device) for s in MATMUL_SHAPES)

    def addmm_chain():
        y = a
        for _ in range(MATMUL_STEPS):
            y = torch.addmm(y, y, b, beta=0, alpha=MATMUL_SCALE)
        return y
    got = matmul_chain(a, b)
    rows, inner = MATMUL_SHAPES[0]
    return {**compare(got, matmul_chain_reference(a, b), rtol=MATMUL_RTOL),
            "sample": got.flatten()[:3].tolist(),
            **times(lambda: matmul_chain(a, b), device),
            **times(lambda: matmul_chain_reference(a, b), device, "plain_"),
            **times(addmm_chain, device, "library_"),
            "bytes": 4 * (2 * a.numel() + b.numel()),
            "ops": MATMUL_STEPS * (2 * rows * inner * inner + rows * inner)}


STEPS = (("while_loop", _while_step), ("scalar_chain", _scalar_step),
         ("matmul_chain", _matmul_step))
