"""A gather along lanes, out[r, j] = data[r, idx[r, j]], in three placements
of the data: the kernels of ``csrc/probe_gather.cu``, their wrapper and the
plain PyTorch version (counterpart of ``probe_gather_variants.pallas_taa``
and ``tpu_kernel_probe._gather_kernel``), and the plain-torch counterpart of
that script's ``xla_packed_taps`` baseline.

Placements: ``"global"`` reads the data from device memory (L2-resident at
these sizes), ``"smem"`` stages each row in one CTA's shared memory (rows of
at most 58112 lanes), ``"dsmem"`` splits each row over a cluster of 16 CTAs
and reads the owner's slice through distributed shared memory.  Indices
outside [0, lanes) give NaN.

``take_along_lanes`` takes the plain version for CPU tensors only; for CUDA
tensors it launches its kernel or raises.
"""
from __future__ import annotations

import numpy as np
import torch

from bpvo_tpu_torch.ops import _build
from bpvo_tpu_torch.probes._common import (MAX_SMEM_BYTES, LaunchCounts,
                                           compare, on_cpu, ptr, record,
                                           stream)
from bpvo_tpu_torch.probes.timing import times

PLACEMENTS = ("global", "smem", "dsmem")
DSMEM_CLUSTER = 16      # CTAs per row of "dsmem": kCluster in probe_gather.cu
# probe_gather_variants.py's shapes: a KITTI frame padded to tiles, the L0
# template's point count, 8 rows of lanes
H, W = 384, 1280
N = 16384
ROWS = 8
LANES = (1024, 16384, H * W)
# tpu_kernel_probe.py's: the unpadded L0 image
KITTI_H, KITTI_W = 376, 1241

launch_count = LaunchCounts("take_along_lanes_global", "take_along_lanes_smem",
                            "take_along_lanes_dsmem")


def take_along_lanes_reference(idx, data):
    """out[r, j] = data[r, idx[r, j]]; NaN where idx is outside [0, lanes)."""
    lanes = data.shape[1]
    inside = (idx >= 0) & (idx < lanes)
    got = torch.gather(data, 1, idx.clamp(0, lanes - 1).long())
    return torch.where(inside, got, torch.full_like(got, float("nan")))


def fits(lanes: int, placement: str) -> bool:
    """Whether a row of ``lanes`` floats fits the placement's shared
    memory (one CTA for ``smem``, 16 CTAs for ``dsmem``)."""
    per_cta = {"global": 0, "smem": lanes,
               "dsmem": -(-lanes // DSMEM_CLUSTER)}[placement]
    return per_cta * 4 <= MAX_SMEM_BYTES


def take_along_lanes(idx, data, placement="global"):
    """``take_along_lanes_reference`` on (rows, lanes) float32 data and
    (rows, n) int32 indices, gathering from the given placement."""
    if placement not in PLACEMENTS:
        raise ValueError(f"take_along_lanes: placement must be one of "
                         f"{PLACEMENTS}")
    if data.dim() != 2 or idx.dim() != 2 or idx.shape[0] != data.shape[0]:
        raise ValueError(f"take_along_lanes: data (rows, lanes) and idx "
                         f"(rows, n), got {tuple(data.shape)} and "
                         f"{tuple(idx.shape)}")
    if on_cpu("take_along_lanes", idx, data):
        return take_along_lanes_reference(idx, data)
    rows, lanes = data.shape
    n = idx.shape[1]
    if not fits(lanes, placement) or rows >= 65536:
        raise ValueError(f"take_along_lanes: a row of {lanes} lanes does not "
                         f"fit the {placement} placement")
    _build.check_tensors("take_along_lanes", data.device, {
        "data": (data, (rows, lanes), torch.float32),
        "idx": (idx, (rows, n), torch.int32)})
    lib = _build.library()
    out = torch.empty(rows, n, dtype=torch.float32, device=data.device)
    args = (ptr(idx), ptr(data), ptr(out), rows, lanes, n)
    s = stream(data.device)
    if placement == "global":
        rc = lib.bpvo_probe_take_global(*args, s)
    elif placement == "smem":
        rc = lib.bpvo_probe_take_smem(*args, s)
    else:
        rc = lib.bpvo_probe_take_dsmem(*args, s)
    _build.launch(lib, f"take_along_lanes ({placement})", rc)
    launch_count[f"take_along_lanes_{placement}"] += 1
    return out


def dsmem_max_clusters(lanes: int) -> int:
    """How many ``dsmem`` clusters at ``lanes`` the card holds at once."""
    import ctypes
    lib = _build.library()
    out = ctypes.c_int(0)
    _build.launch(lib, "take_along_lanes (occupancy)",
                  lib.bpvo_probe_take_dsmem_clusters(lanes,
                                                     ctypes.byref(out)))
    return out.value


# ---------------------------------------------------------------------------
# the script's inputs and its XLA baseline
# ---------------------------------------------------------------------------

def sampling_inputs(seed=0):
    """probe_gather_variants.py's data, drawn in its order: raster-ordered
    points with a smooth flow (U, V of N points) over a standard-normal
    H x W image.  Returns (rng, U, V, IMG) as numpy float32; the rng goes on
    to draw each lane probe's data."""
    rng = np.random.default_rng(seed)
    base_rows = np.sort(rng.integers(2, H - 4, N)).astype(np.int32)
    base_cols = rng.integers(2, W - 4, N).astype(np.int32)
    U = (base_cols + rng.uniform(-3, 3, N)).astype(np.float32)
    V = (base_rows + rng.uniform(-3, 3, N)).astype(np.float32)
    IMG = rng.standard_normal((H, W)).astype(np.float32)
    return rng, U, V, IMG


def lane_inputs(rng, lanes, rows=ROWS, n=N):
    """``pallas_taa``'s data (rows, lanes) and indices (rows, n / rows)."""
    data = rng.standard_normal((rows, lanes)).astype(np.float32)
    idx = rng.integers(0, lanes, (rows, n // rows)).astype(np.int32)
    return idx, data


def pack_taps(img, dtype=torch.float32):
    """(H*W, 4) rows of the 2x2 neighbourhoods, in ``dtype``."""
    Wd = img.shape[1]
    flat = img.reshape(-1)
    return torch.stack([torch.roll(flat, -(dy * Wd + dx))
                        for dy in (0, 1) for dx in (0, 1)], 1).to(dtype)


def packed_taps_bilinear(u, v, img, taps=None):
    """Bilinear samples at (u, v) by one row gather of the packed 2x2 taps
    (``pack_taps``, built here unless given): the plain-torch counterpart of
    ``xla_packed_taps``, a yardstick and not a kernel."""
    Hd, Wd = img.shape
    taps = pack_taps(img) if taps is None else taps
    xi = torch.floor(u).to(torch.int32).clamp(0, Wd - 2)
    yi = torch.floor(v).to(torch.int32).clamp(0, Hd - 2)
    xf = u - xi.to(torch.float32)
    yf = v - yi.to(torch.float32)
    g = taps.index_select(0, (yi * Wd + xi).long()).to(torch.float32)
    return ((1 - yf) * ((1 - xf) * g[:, 0] + xf * g[:, 1])
            + yf * ((1 - xf) * g[:, 2] + xf * g[:, 3]))


# ---------------------------------------------------------------------------
# the script's steps, timed (the band step lives in probes/band.py)
# ---------------------------------------------------------------------------

def _packed_taps_step(dtype):
    def step(device, data):
        _, U, V, IMG = data
        u, v, img = (torch.as_tensor(a, device=device) for a in (U, V, IMG))
        taps = pack_taps(img, dtype)
        return times(lambda: packed_taps_bilinear(u, v, img, taps), device)
    return step


def lanes_result(idx, data, device):
    """``take_along_lanes`` in each placement that holds a row: against the
    plain version (bitwise) and timed, beside the plain version and
    ``torch.take_along_dim``; the work the gather must do ("bytes": the
    indices, the outputs and each distinct value read, once; no arithmetic)
    and how many DSMEM clusters the card holds at once."""
    rows, lanes = data.shape
    want = take_along_lanes_reference(idx, data)
    idx_l = idx.long()
    touched = torch.unique(idx_l + lanes * torch.arange(
        rows, device=idx.device)[:, None]).numel()
    out = {**times(lambda: take_along_lanes_reference(idx, data), device,
                   "plain_"),
           **times(lambda: torch.take_along_dim(data, idx_l, 1), device,
                   "library_"),
           "bytes": 2 * 4 * idx.numel() + 4 * touched, "ops": 0}
    for placement in PLACEMENTS:
        if not fits(lanes, placement):
            out[placement] = (f"n/a: a row of {lanes} floats exceeds "
                              f"one CTA")
            continue

        def one(p=placement):
            return {**compare(take_along_lanes(idx, data, p), want),
                    **times(lambda: take_along_lanes(idx, data, p), device)}
        record(out, placement, one)
    if device.type == "cuda" and fits(lanes, "dsmem"):
        record(out, "dsmem_max_active_clusters",
               lambda: dsmem_max_clusters(lanes))
    return out


def _lanes_step(lanes):
    def step(device, data):
        idx, dat = (torch.as_tensor(a, device=device)
                    for a in lane_inputs(data[0], lanes))
        return lanes_result(idx, dat, device)
    return step


def steps():
    from bpvo_tpu_torch.probes import band
    return (("xla_f32", _packed_taps_step(torch.float32)),
            ("xla_bf16", _packed_taps_step(torch.bfloat16)),
            ("taa_1k", _lanes_step(LANES[0])),
            ("taa_16k", _lanes_step(LANES[1])),
            ("taa_flat", _lanes_step(LANES[2])),
            ("band", band.band_step("script")),
            ("band_wide", band.band_step("wide")))
