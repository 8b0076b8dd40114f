"""GPU microbenchmarks: the port of the JAX package's Mosaic probe scripts.

The JAX package's probe scripts (``scripts/probe_kernel_features.py``,
``probe_gather_variants.py``, ``probe_band_bisect.py``,
``tpu_kernel_probe.py``) compiled small Pallas kernels to learn what Mosaic
supports and what it costs.  Here each of their kernels is a kernel written
by hand for Hopper (``csrc/probe_{features,gather,band}.cu``) with a plain
PyTorch version beside it, and the four step lists measure what level_gn's
multi-SM redesign needs: the cost of one loop iteration with a CTA, cluster
or grid barrier, and gathers from L2, shared memory or a cluster's
distributed shared memory.

    python -m bpvo_tpu_torch.probes [features|gather|band|kernel ...]
        [--device cuda] [--out build/probes.json]

``run`` executes the groups' steps, recording a failing step or variant as
``"FAIL <message>"`` and going on, and returns one JSON-ready dict.
"""
from __future__ import annotations

import numpy as np
import torch

from bpvo_tpu_torch.probes import band, gather, kernel_features, kernel_probe
from bpvo_tpu_torch.probes._common import record
from bpvo_tpu_torch.vo.device_vo import resolve_device

# group -> (steps, the data its steps share); the groups mirror
# probe_kernel_features.py, probe_gather_variants.py, probe_band_bisect.py
# and tpu_kernel_probe.py
GROUPS = {
    "features": (lambda: kernel_features.STEPS, lambda device: None),
    "gather": (gather.steps, lambda device: gather.sampling_inputs(0)),
    "band": (lambda: band.STEPS, band.part_inputs),
    "kernel": (lambda: kernel_probe.STEPS,
               lambda device: np.random.default_rng(0)),
}

_COUNTED = (kernel_features, gather, band)


def launch_counts() -> dict:
    """Kernel launches by kernel name since the last reset."""
    counts = {}
    for mod in _COUNTED:
        counts.update(mod.launch_count)
    return counts


def reset_launch_counts() -> None:
    for mod in _COUNTED:
        mod.launch_count.reset()


def run(groups=tuple(GROUPS), device="cuda") -> dict:
    """Run the named groups' steps on ``device``; returns {"device": ...,
    "clock": ..., "results": {group: {step: result or "FAIL ..."}}}."""
    device = resolve_device(device)
    unknown = set(groups) - set(GROUPS)
    if unknown:
        raise ValueError(f"unknown probe groups {sorted(unknown)}; choose "
                         f"from {list(GROUPS)}")
    results = {}
    for group in groups:
        steps, make_data = GROUPS[group]
        out = results[group] = {}
        data = make_data(device)
        for name, step in steps():
            record(out, name, lambda s=step: s(device, data))
    cuda = device.type == "cuda"
    return {"device": torch.cuda.get_device_name(device) if cuda else "cpu",
            "clock": "device ms, CUDA-graph replay" if cuda else
                     "host ms (plain versions)",
            "results": results}
