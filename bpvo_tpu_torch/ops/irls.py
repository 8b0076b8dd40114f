"""IRLS weights and the Gauss-Newton normal equations from given residuals:
the hand-written CUDA kernel ``csrc/irls_reduce.cu``, its wrappers and its
plain PyTorch version.

Counterpart of ``bpvo_tpu/ops/pallas/irls_kernel.py`` (``irls_reduce_w`` and
``irls_reduce``: one kernel, the weight store on or off).  J keeps the
template's own (M, 6) layout (``jacobians.reshape(-1, 6)``); the TPU
kernel's (6, M) transpose and 8-row slabs are not needed.

One call is one kernel launch (``csrc/gn_reduce.cuh``); each stream has its
own completion counter (``_build.ticket_counter``): make the first call on a
device before capturing a CUDA graph there.  The wrappers take
the plain version for CPU tensors only.  For CUDA tensors they launch the
kernel or raise; they never fall back.
"""
from __future__ import annotations

import ctypes

import torch

from bpvo_tpu_torch.ops.level_gn import LOSS_CODES
from bpvo_tpu_torch.solver import linear_system, mestimator

# kernel launches made by ``irls_reduce_w`` and ``irls_reduce`` in this
# process (the plain version is not counted)
launch_count = 0


def irls_reduce_reference(J, r, valid, sigma, loss):
    """Plain PyTorch version (``mestimator.compute_weights`` +
    ``linear_system.build``): (H (6,6), g (6,), f_sq, w (M,))."""
    w = mestimator.compute_weights(loss, r, valid, sigma)
    H, g, f_sq = linear_system.build(J, r, w)
    return H, g, f_sq, w


def _launch(J, r, valid, sigma, loss, with_w: bool):
    global launch_count
    from bpvo_tpu_torch.ops import _build
    dev = r.device
    if dev.type != "cuda":
        raise ValueError(f"irls_reduce: unsupported device {dev}")
    M = r.shape[0]
    f32 = torch.float32
    _build.check_tensors("irls_reduce", dev, {
        "J": (J, (M, 6), f32), "r": (r, (M,), f32),
        "valid": (valid, (M,), torch.bool),
        "sigma": (sigma, sigma.shape, f32)})
    if sigma.numel() != 1:
        raise ValueError("irls_reduce: sigma must hold one value")
    if M < 1 or M * 6 >= 2 ** 31:
        raise ValueError(f"irls_reduce: unsupported size M={M}")
    lib = _build.library()
    w = torch.empty(M, dtype=f32, device=dev) if with_w else None
    partials = torch.empty(lib.bpvo_irls_reduce_blocks(M) * 28, dtype=f32,
                           device=dev)
    out = torch.empty(43, dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev)
    ptr = ctypes.c_void_p
    rc = lib.bpvo_irls_reduce(
        ptr(J.data_ptr()), ptr(r.data_ptr()), ptr(valid.data_ptr()),
        ptr(sigma.data_ptr()), M, LOSS_CODES[loss],
        ptr(w.data_ptr() if with_w else None), ptr(partials.data_ptr()),
        _build.ticket_counter(stream), ptr(out.data_ptr()),
        ptr(stream.cuda_stream))
    _build.launch(lib, "irls_reduce", rc)
    with _build.count_lock:
        launch_count += 1
    return out[:36].view(6, 6), out[36:42], out[42], w


def irls_reduce_w(J, r, valid, sigma, loss):
    """Weights w = valid * weight(r / sigma) and the normal equations of the
    M terms: J (M, 6), r (M,), valid (M,) bool, sigma a one-element float32
    tensor (read on the device).  Returns (H (6,6), g (6,), f_sq, w (M,))."""
    if r.device.type == "cpu":
        return irls_reduce_reference(J, r, valid, sigma, loss)
    return _launch(J, r, valid, sigma, loss, True)


def irls_reduce(J, r, valid, sigma, loss):
    """``irls_reduce_w`` without the weights: (H (6,6), g (6,), f_sq)."""
    if r.device.type == "cpu":
        return irls_reduce_reference(J, r, valid, sigma, loss)[:3]
    return _launch(J, r, valid, sigma, loss, False)[:3]
