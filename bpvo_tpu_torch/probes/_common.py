"""What the probe wrappers and steps share: the CPU-or-kernel decision, raw
pointers and the current stream for the ctypes calls, the launch counters,
the kernel-vs-plain check and the failure record."""
from __future__ import annotations

import ctypes

import torch

MAX_SMEM_BYTES = 232448    # the shared memory one CTA can hold on sm_90


def on_cpu(op: str, *tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the wrapper then takes the
    plain version), False when every one lies on the same CUDA device;
    anything else raises ValueError."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{op}: tensors on several devices {devices}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"{op}: unsupported device {dev}")
    return False


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


class LaunchCounts(dict):
    """Kernel launches by kernel name, counted by the wrappers where they
    launch (the plain versions are not counted)."""

    def __init__(self, *names: str):
        super().__init__((n, 0) for n in names)

    def reset(self) -> None:
        for n in self:
            self[n] = 0


def compare(got: torch.Tensor, want: torch.Tensor, atol: float = 0.0,
            rtol: float = 0.0) -> dict:
    """{"ok": whether ``got`` agrees with ``want``, "max_abs_err": max
    |got - want|}: bit for bit when atol and rtol are 0, else within
    atol + rtol |want| everywhere."""
    diff = (got - want).abs()
    if atol == 0.0 and rtol == 0.0:
        ok = bool(torch.equal(got, want))
    else:
        ok = bool((diff <= atol + rtol * want.abs()).all())
    return {"ok": ok, "max_abs_err": float(diff.max())}


def record(results: dict, name: str, fn) -> None:
    """``results[name] = fn()``, or ``"FAIL <message>"`` when it raises:
    as the JAX probe scripts do, a failing variant is recorded and the run
    goes on."""
    try:
        results[name] = fn()
    except Exception as e:  # noqa: BLE001 - the failure is the result
        msg = " ".join(f"{type(e).__name__}: {e}".split())[:240]
        results[name] = f"FAIL {msg}"
