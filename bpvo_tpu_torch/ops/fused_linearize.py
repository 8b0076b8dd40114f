"""One Gauss-Newton linearization at a fixed pose and sigma: the hand-written
CUDA kernel ``csrc/fused_linearize.cu``, its wrapper and its plain PyTorch
version.

Counterpart of ``bpvo_tpu/ops/pallas/gn_kernel.py``: ``make_fused_linearize``
(C = 1) and ``make_fused_linearize_stacked`` (C > 1) are one kernel here,
for any C.  Every point samples the image directly, so no point is dropped
for leaving a row band: JAX's ``band_ok`` would always be true and is not
returned.  The TPU layout helpers (``pack_template*``, ``pad_channels``) have
no counterpart: the kernel reads the template's own arrays.

One call is one kernel launch (the grid-wide sum of the normal equations is
folded by the last block to finish, ``csrc/gn_reduce.cuh``).  Each stream
has its own completion counter (``_build.ticket_counter``): make the first
call on a device before capturing a CUDA graph there.
``fused_linearize`` takes the plain version for CPU tensors only.  For CUDA
tensors it launches the kernel or raises; it never falls back.
"""
from __future__ import annotations

import ctypes

import torch

from bpvo_tpu_torch.ops import interp as interp_mod
from bpvo_tpu_torch.ops.level_gn import LOSS_CODES
from bpvo_tpu_torch.solver import linear_system, mestimator
from bpvo_tpu_torch.types import InterpolationType

# kernel launches made by ``fused_linearize`` in this process (the plain
# version is not counted)
launch_count = 0


def fused_linearize_reference(u, v, ok, channels, pixels, jacobians, sigma,
                              loss, interp=InterpolationType.LINEAR):
    """Plain PyTorch version: sample, residual, weights, normal equations
    (``interp.sample`` + ``mestimator.compute_weights`` +
    ``linear_system.build``).  Same contract as ``fused_linearize``."""
    I1 = interp_mod.sample(channels, u, v, ok, interp)
    r = (I1 - pixels) * ok[None, :]
    w = mestimator.compute_weights(loss, r, ok[None, :], sigma)
    H, g, f_sq = linear_system.build(jacobians, r, w)
    return H, g, f_sq, r[0], w


def fused_linearize(u, v, ok, channels, pixels, jacobians, sigma, loss,
                    interp=InterpolationType.LINEAR):
    """Linearize at the warped points.

    ``u``, ``v`` (K,) float32 sample coordinates; ``ok`` (K,) bool, true
    only where the 2x2 footprint is inside the image (``interp.valid_mask``)
    and the point is valid; ``channels`` (C, H, W); ``pixels`` (C, K) and
    ``jacobians`` (C, K, 6) the template; ``sigma`` a one-element float32
    tensor (read on the device, never on the host).

    Returns (H (6,6), g (6,), f_sq = sum w r^2, r0 (K,) channel 0's
    residuals, w (C, K) IRLS weights), zero residuals and weights where
    ``ok`` is false.
    """
    global launch_count
    if channels.device.type == "cpu":
        return fused_linearize_reference(u, v, ok, channels, pixels,
                                         jacobians, sigma, loss, interp)
    if channels.device.type != "cuda":
        raise ValueError(f"fused_linearize: unsupported device "
                         f"{channels.device}")
    if interp not in (InterpolationType.LINEAR, InterpolationType.COSINE):
        raise NotImplementedError(f"fused_linearize: {interp.value} "
                                  f"interpolation is not ported yet")
    from bpvo_tpu_torch.ops import _build
    C, H, W = channels.shape
    K = u.shape[0]
    f32 = torch.float32
    _build.check_tensors("fused_linearize", channels.device, {
        "u": (u, (K,), f32), "v": (v, (K,), f32), "ok": (ok, (K,), torch.bool),
        "channels": (channels, (C, H, W), f32),
        "pixels": (pixels, (C, K), f32),
        "jacobians": (jacobians, (C, K, 6), f32),
        "sigma": (sigma, sigma.shape, f32)})
    if sigma.numel() != 1:
        raise ValueError("fused_linearize: sigma must hold one value")
    if H < 2 or W < 2 or K < 1 or C < 1 or C * K * 6 >= 2 ** 31:
        raise ValueError(f"fused_linearize: unsupported shape C={C} H={H} "
                         f"W={W} K={K}")
    lib = _build.library()
    dev = channels.device
    r0 = torch.empty(K, dtype=f32, device=dev)
    w = torch.empty(C, K, dtype=f32, device=dev)
    partials = torch.empty(lib.bpvo_fused_linearize_blocks(K, C) * 28,
                           dtype=f32, device=dev)
    out = torch.empty(43, dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev)
    ptr = ctypes.c_void_p
    rc = lib.bpvo_fused_linearize(
        ptr(u.data_ptr()), ptr(v.data_ptr()), ptr(ok.data_ptr()),
        ptr(channels.data_ptr()), ptr(pixels.data_ptr()),
        ptr(jacobians.data_ptr()), ptr(sigma.data_ptr()), C, H, W, K,
        LOSS_CODES[loss], int(interp == InterpolationType.COSINE),
        ptr(r0.data_ptr()), ptr(w.data_ptr()), ptr(partials.data_ptr()),
        _build.ticket_counter(stream), ptr(out.data_ptr()),
        ptr(stream.cuda_stream))
    _build.launch(lib, "fused_linearize", rc)
    with _build.count_lock:
        launch_count += 1
    return out[:36].view(6, 6), out[36:42], out[42], r0, w
