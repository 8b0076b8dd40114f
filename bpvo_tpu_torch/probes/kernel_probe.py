"""The port's kernels against their plain versions, at the shapes of
``scripts/tpu_kernel_probe.py`` (its counterpart): the row gather that its
XLA step timed, the in-kernel gather from a resident (8, 376*1241) array,
``irls_reduce`` at M = 8 x 16384, census at 376x1241, SGM aggregation at
376x640x64 and one ``fused_linearize`` at the bench's L0.  Nothing new is
ported here: the steps time ``ops.irls``, ``ops.census``, ``ops.sgm``,
``ops.fused_linearize`` and ``probes.gather``.
"""
from __future__ import annotations

import numpy as np
import torch

from bpvo_tpu_torch.probes import gather
from bpvo_tpu_torch.probes.timing import device_ms

H, W = gather.KITTI_H, gather.KITTI_W
HW = H * W
N = 16384
SGM_SHAPE = (376, 640, 64)
SGM_P1, SGM_P2 = 1.0, 8.0


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _indices(rng):
    return rng.integers(0, HW - W - 2, N, dtype=np.int32)


def xla_take(device, rng):
    """N rows of 4 or 32 floats from an (H*W, tc) table (torch
    ``index_select``, the counterpart of the script's ``jnp.take``)."""
    idx = torch.as_tensor(_indices(rng), device=device).long()
    out = {}
    for tc in (4, 32):
        data = torch.as_tensor(rng.standard_normal((HW, tc)).astype(
            np.float32), device=device)
        out[f"torch_take_rows_{tc}f32_ms"] = device_ms(
            lambda d=data: d.index_select(0, idx), device)
    return out


def inkernel_gather(device, rng):
    """``take_along_lanes`` from an (8, H*W) array in each placement that
    holds a row (one CTA cannot: a row is 1.87 MB)."""
    idx = torch.as_tensor(_indices(rng).reshape(8, N // 8), device=device)
    data = torch.as_tensor(rng.standard_normal((8, HW)).astype(np.float32),
                           device=device)
    return gather.lanes_result(idx, data, device)


def irls(device, rng):
    """``irls_reduce`` at M = 8 x 16384 terms, Tukey, sigma 1.3."""
    from bpvo_tpu_torch.ops import irls as irls_mod
    from bpvo_tpu_torch.types import LossFunctionType
    M = 8 * N
    J = torch.as_tensor(rng.standard_normal((M, 6)).astype(np.float32),
                        device=device)
    r = torch.as_tensor(rng.standard_normal(M).astype(np.float32),
                        device=device)
    valid = torch.as_tensor(rng.random(M) > 0.1, device=device)
    sigma = torch.tensor([1.3], dtype=torch.float32, device=device)
    args = (J, r, valid, sigma, LossFunctionType.TUKEY)
    got = irls_mod.irls_reduce(*args)
    want = irls_mod.irls_reduce_reference(*args)[:3]
    return {"rel_diff": max(_rel(a, b) for a, b in zip(got, want)),
            "ms": device_ms(lambda: irls_mod.irls_reduce(*args), device),
            "plain_ms": device_ms(
                lambda: irls_mod.irls_reduce_reference(*args), device)}


def census(device, rng):
    """``census_planes`` on an H x W image of integer grey levels."""
    from bpvo_tpu_torch.ops import census as census_mod
    img = torch.as_tensor(rng.integers(0, 255, (H, W)).astype(np.float32),
                          device=device)
    got = census_mod.census_planes(img)
    return {"equal": bool(torch.equal(
                got, census_mod.census_planes_reference(img))),
            "ms": device_ms(lambda: census_mod.census_planes(img), device),
            "plain_ms": device_ms(
                lambda: census_mod.census_planes_reference(img), device)}


def sgm(device, rng):
    """4-direction SGM aggregation of a uniform [0, 8) cost volume."""
    from bpvo_tpu_torch.ops import sgm as sgm_mod
    cost = torch.as_tensor((rng.random(SGM_SHAPE) * 8).astype(np.float32),
                           device=device)
    got = sgm_mod.aggregate_4dir(cost, SGM_P1, SGM_P2)
    want = sgm_mod.aggregate_4dir_reference(cost, SGM_P1, SGM_P2)
    return {"max_abs_diff": float((got - want).abs().max()),
            "ms": device_ms(lambda: sgm_mod.aggregate_4dir(
                cost, SGM_P1, SGM_P2), device, reps=5),
            "plain_ms": device_ms(lambda: sgm_mod.aggregate_4dir_reference(
                cost, SGM_P1, SGM_P2), device, reps=1)}


def fused_iter(device, rng):
    """One ``fused_linearize`` at the bench's L0 (intensity C=1, Bit-Planes
    C=8) at the identity pose and sigma 1, templates and channels from
    frame 1 of the bench sequence, against its plain version."""
    from bpvo_tpu_torch import AlgorithmParameters, DescriptorType
    from bpvo_tpu_torch.data import synthetic
    from bpvo_tpu_torch.ops import fused_linearize as fl
    from bpvo_tpu_torch.ops import interp
    from bpvo_tpu_torch.vo import device_vo, warp
    K, baseline, frames = synthetic.synthesize_sequence(3)
    img, dsp = (torch.as_tensor(a, device=device) for a in frames[1])
    out = {}
    for desc in (DescriptorType.INTENSITY, DescriptorType.BITPLANES):
        p = AlgorithmParameters(minSaliency=2.0, numPyramidLevels=4,
                                descriptor=desc, maxIterations=50,
                                functionTolerance=1e-4,
                                parameterTolerance=1e-6)
        vo = device_vo.DeviceVO(K, baseline, (synthetic.ROWS,
                                              synthetic.COLS), p,
                                device=device)
        vo.init(img, dsp)
        td = vo.state.templates[0]
        ch = device_vo._compute_channels_pyr(img, p, 4)[0]
        cam, opts = vo._cams[0], vo._opts[0]
        T0 = torch.eye(4, dtype=torch.float32, device=device)
        u, v, Z = warp.project(cam, T0, td.points)
        ok = td.valid & (Z > 1e-6) & interp.valid_mask(
            u, v, ch.shape[1], ch.shape[2], opts.interp)
        sigma = torch.ones(1, dtype=torch.float32, device=device)
        args = (u, v, ok, ch, td.pixels, td.jacobians, sigma, opts.loss,
                opts.interp)
        got, want = fl.fused_linearize(*args), fl.fused_linearize_reference(
            *args)
        name = desc.value.lower()
        out[name] = {
            "K": int(td.points.shape[0]), "C": int(ch.shape[0]),
            "rel_diff": {k: _rel(a, b) for k, a, b in zip(
                ("H", "g", "f_sq"), got[:3], want[:3])},
            "ms": device_ms(lambda a=args: fl.fused_linearize(*a), device),
            "plain_ms": device_ms(
                lambda a=args: fl.fused_linearize_reference(*a), device)}
    return out


STEPS = (("xla_take", xla_take), ("pallas_gather", inkernel_gather),
         ("irls", irls), ("census", census), ("sgm", sgm),
         ("fused_iter", fused_iter))
