"""Times the per-iteration Gauss-Newton kernels (``fused_linearize``,
``irls_reduce_w`` and ``irls_reduce``) on one GPU at the dense VO shapes,
and sweeps their launch shape.

    python3 scripts/gn_kernel_bench.py [--root DIR] [--sweep] [--reps 20]
        [--device cuda|cpu] [--out build/gn_kernel_bench.json]

The shapes are those of ``chip_smoke.py``'s GN-kernel phase: frame 0 -> 1
of dense VO on the synthetic 376x1241 sequence (bench.py's settings,
non-maxima suppression off, pointCapacity 131072), at the identity pose, at
L0 (K = 131072) and L1 (K = 32768); ``fused_linearize`` for intensity
(C=1) and Bit-Planes (C=8, and its channel-0 sigma pass), ``irls_reduce_w``
and ``irls_reduce`` at M = K (both descriptors) and M = 8K (Bit-Planes).

1. Per shape: the device ms of a call replayed from a CUDA graph, the ms
   through the wrapper (CUDA events), the device kernels one wrapper call
   runs (torch.profiler), and the check against the plain version: channel
   0's residuals and their histogram sigma bit for bit, the weights within
   1e-6, H, g and f^2 within 1e-4 of their largest entry, and
   ``irls_reduce`` bit for bit equal to ``irls_reduce_w``.
2. With ``--sweep``: copies of ``fused_linearize.cu``, ``irls_reduce.cu``
   and ``gn_reduce.cuh`` under ``build/gn_kernel_sweep/<variant>/`` whose
   ``launch_for`` returns each (threads, terms per thread, tiles per
   block; above one channel ``fused_linearize`` folds the points per
   thread into tiles) of ``LAUNCHES``: as shipped, and with
   ``fused_linearize``'s channel groups of 2 and 8 (``kGroup``, 4 shipped);
   the shipped sources have no knob.  Each copy is built alone into one
   library with the package's nvcc flags, all builds started together; per
   copy and shape the device ms and the check.

``--root`` imports ``bpvo_tpu_torch`` from another checkout (for instance
the parent commit unpacked under ``build/`` with ``git archive``), so two
versions are timed by one script in one run.  ``--device cpu`` runs the
plain versions at 120x160 on the host clock (no device numbers).  Prints
one JSON object.  Imports no JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import functools
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "build"
CSRC = ROOT / "bpvo_tpu_torch" / "csrc"
SOURCES = ("fused_linearize.cu", "irls_reduce.cu", "gn_reduce.cuh")
BENCH = dict(minSaliency=2.0, numPyramidLevels=4, functionTolerance=1e-4,
             parameterTolerance=1e-6, maxIterations=50)
DENSE = dict(minNumPixelsForNonMaximaSuppression=20000000,
             pointCapacity=131072)
CPU_SHAPE = (120, 160)
GN_RTOL, GN_W_ATOL = 1e-4, 1e-6
# (threads, terms per thread per tile, tiles per block) of the sweep
LAUNCHES = ((128, 4, 2), (256, 1, 1), (256, 1, 2), (256, 2, 1), (256, 2, 2),
            (256, 4, 1), (256, 4, 2), (256, 4, 4))
# (launch, channels per group in fused_linearize): every launch shape as
# shipped and with groups of 2 and 8 channels
SWEEP = tuple((l, g) for g in (4, 2, 8) for l in LAUNCHES)
# (file, anchor, text inserted after it) of a copy with a fixed launch shape
_LAUNCH_ANCHORS = (
    ("fused_linearize.cu", "gn::Launch launch_for(int K, int C) {\n",
     "  (void)K;\n  (void)C;\n  return {{{}, {}, {}}};\n"),
    ("irls_reduce.cu", "gn::Launch launch_for(int M) {\n",
     "  (void)M;\n  return {{{}, {}, {}}};\n"))
_GROUP = "constexpr int kGroup = 4;"
# a copy is built without level_gn.cu, which defines the error string
_ERROR_STRING = """
extern "C" const char* bpvo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
"""


def variant_name(launch, group: int) -> str:
    return "t{}_u{}_r{}".format(*launch) + (f"_g{group}" if group != 4 else "")


def patched_sources(texts: dict, launch, group: int = 4) -> dict:
    """{file: text} of a copy whose ``launch_for`` returns ``launch`` in both
    kernels, with ``group`` channels per group in fused_linearize."""
    out = dict(texts)
    for name, anchor, insert in _LAUNCH_ANCHORS:
        if out[name].count(anchor) != 1:
            raise ValueError(f"gn_kernel_bench: {anchor!r} occurs "
                             f"{out[name].count(anchor)} times in {name}")
        out[name] = out[name].replace(
            anchor, anchor + insert.format(*(int(x) for x in launch)))
    if out["fused_linearize.cu"].count(_GROUP) != 1:
        raise ValueError(f"gn_kernel_bench: {_GROUP!r} is not in "
                         f"fused_linearize.cu once")
    out["fused_linearize.cu"] = out["fused_linearize.cu"].replace(
        _GROUP, _GROUP.replace("4", str(int(group))))
    out["irls_reduce.cu"] += _ERROR_STRING
    return out


def build_copies(variants) -> list:
    """One library per ``(name, {file: text})`` under
    build/gn_kernel_sweep/<name>/, one nvcc each, all started together; a
    failed build raises with nvcc's stderr."""
    from bpvo_tpu_torch.ops import _build
    jobs = []
    for name, texts in variants:
        d = BUILD / "gn_kernel_sweep" / name
        d.mkdir(parents=True, exist_ok=True)
        for fname, text in texts.items():
            (d / fname).write_text(text)
        lib = d / f"{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
               str(d / SOURCES[0]), str(d / SOURCES[1])]
        jobs.append((lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.PIPE, text=True)))
    failed = []
    for lib, proc in jobs:
        _, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) for {lib.name}\n"
                          f"{stderr}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return [lib for lib, _ in jobs]


@contextlib.contextmanager
def _using(lib):
    """The wrappers launch from ``lib`` inside the block."""
    from bpvo_tpu_torch.ops import _build
    saved = _build._lib
    _build._lib = lib
    try:
        yield
    finally:
        _build._lib = saved


@functools.cache
def _timing():
    """This checkout's ``bpvo_tpu_torch/probes/timing.py`` (it imports only
    torch), whichever checkout ``--root`` times: both are measured by the
    same clocks."""
    spec = importlib.util.spec_from_file_location(
        "_gn_kernel_bench_timing", CSRC.parent / "probes" / "timing.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def shapes(device, rows, cols) -> dict:
    """{name: (kernel, arguments, channel-0 validity)} at the dense L0 and
    L1 shapes of frame 0 -> 1, on ``device``."""
    import torch
    from bpvo_tpu_torch import AlgorithmParameters, DescriptorType
    from bpvo_tpu_torch.data import synthetic
    from bpvo_tpu_torch.ops import interp
    from bpvo_tpu_torch.solver import mestimator
    from bpvo_tpu_torch.vo import device_vo, template_data, warp
    K, b, frames = synthetic.synthesize_sequence(2, rows, cols)
    out = {}
    for name, desc in (("intensity", DescriptorType.INTENSITY),
                       ("bitplanes", DescriptorType.BITPLANES)):
        vo = device_vo.DeviceVO(K, b, (rows, cols), AlgorithmParameters(
            **BENCH, **DENSE, descriptor=desc), device=device)
        vo.init(*(torch.as_tensor(a).to(device) for a in frames[0]))
        pyr = device_vo._compute_channels_pyr(
            torch.as_tensor(frames[1][0]).to(device), vo._p, 4)
        T0 = torch.eye(4, dtype=torch.float32, device=device)
        for level in (0, 1):
            td, ch = vo.state.templates[level], pyr[level]
            cam, opts = vo._cams[level], vo._opts[level]
            C = td.pixels.shape[0]
            u, v, Z = warp.project(cam, T0, td.points)
            ok = td.valid & (Z > 1e-6) & interp.valid_mask(
                u, v, ch.shape[1], ch.shape[2], opts.interp)
            r, _ = template_data.compute_residuals(td, ch, cam, T0,
                                                   opts.interp)
            sigma = mestimator.estimate_scale(r[0], ok)
            for n in sorted({1, C}):
                out[f"fused_linearize {name} L{level} C={n}"
                    + (" sigma pass" if n < C else "")] = (
                    "fused_linearize",
                    (u, v, ok, ch[:n], td.pixels[:n], td.jacobians[:n],
                     sigma, opts.loss, opts.interp), ok)
            for m in sorted({1, C}):
                out[f"irls_reduce {name} L{level} M={m}K"] = (
                    "irls_reduce", (td.jacobians[:m].reshape(-1, 6),
                                    r[:m].reshape(-1),
                                    ok.expand(m, -1).reshape(-1), sigma,
                                    opts.loss), ok)
    return out


def _calls(kernel, args):
    """(kernel call, plain call) of one shape; the irls kernel call also
    runs ``irls_reduce`` (no weights) for the bitwise check."""
    from bpvo_tpu_torch.ops import fused_linearize as fl
    from bpvo_tpu_torch.ops import irls
    if kernel == "fused_linearize":
        return (lambda: fl.fused_linearize(*args),
                lambda: fl.fused_linearize_reference(*args))
    return (lambda: irls.irls_reduce_w(*args),
            lambda: irls.irls_reduce_reference(*args))


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def check(kernel, args, ok) -> dict:
    """The kernel against its plain version on the same inputs."""
    import torch
    from bpvo_tpu_torch.ops import irls
    from bpvo_tpu_torch.solver import mestimator
    call, plain = _calls(kernel, args)
    got, want = call(), plain()
    res = {"max_abs_dw": float((got[-1] - want[-1]).abs().max()),
           "rel_dHgf": max(_rel(a, b) for a, b in zip(got[:3], want[:3]))}
    if kernel == "fused_linearize":
        res["r0_bitwise"] = bool(torch.equal(got[3].view(torch.int32),
                                             want[3].view(torch.int32)))
        res["sigma_bitwise"] = bool(torch.equal(
            mestimator.estimate_scale(got[3], ok),
            mestimator.estimate_scale(want[3], ok)))
    else:
        res["no_w_bitwise"] = all(torch.equal(x, y) for x, y in zip(
            irls.irls_reduce(*args), got[:3]))
    res["agrees"] = (res["max_abs_dw"] <= GN_W_ATOL
                     and res["rel_dHgf"] <= GN_RTOL
                     and all(v for k, v in res.items()
                             if k.endswith("bitwise")))
    return res


def time_shape(kernel, args, device, reps) -> dict:
    """Device ms (graph replay) and wrapper ms on a CUDA device, or the
    host ms on the CPU; for irls_reduce also the call without weights."""
    from bpvo_tpu_torch.ops import irls
    timing = _timing()
    call, _ = _calls(kernel, args)
    res = timing.times(call, device, reps=reps)
    if kernel == "irls_reduce":
        res.update(timing.times(lambda: irls.irls_reduce(*args), device,
                                prefix="no_w_", reps=reps))
    if device.type == "cuda":
        res["kernels_per_call"] = len(timing.device_kernels(call))
    return res


def run(device="cuda", reps: int = 20, sweep: bool = False) -> dict:
    import torch
    from bpvo_tpu_torch.ops import fused_linearize as fl
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("gn_kernel_bench: needs a CUDA device (or "
                           "--device cpu for the plain versions)")
    if sweep and device.type != "cuda":
        raise ValueError("gn_kernel_bench: the sweep times the kernels, which "
                         "run only on a CUDA device")
    rows, cols = ((376, 1241) if device.type == "cuda" else CPU_SHAPE)
    data = shapes(device, rows, cols)
    res = {"package": str(Path(fl.__file__).resolve().parents[1]),
           "device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu"),
           "clock": ("device ms: CUDA-graph replay; wrapper ms: CUDA events"
                     if device.type == "cuda" else
                     "host ms of the plain versions"),
           "image": [rows, cols], "shapes": {}}
    for name, (kernel, args, ok) in data.items():
        terms = args[0] if kernel == "fused_linearize" else args[1]
        res["shapes"][name] = dict(terms=int(terms.numel()),
                                   **check(kernel, args, ok),
                                   **time_shape(kernel, args, device, reps))
    if sweep:
        texts = {f: (CSRC / f).read_text() for f in SOURCES}
        variants = [(variant_name(*v), patched_sources(texts, *v))
                    for v in SWEEP]
        from bpvo_tpu_torch.ops import _build
        timing = _timing()
        libs = [_build.bind_gn(ctypes.CDLL(str(p)))
                for p in build_copies(variants)]
        res["sweep"] = {}
        for (vname, _), lib in zip(variants, libs):
            row = res["sweep"][vname] = {}
            with _using(lib):
                for name, (kernel, args, ok) in data.items():
                    call, _ = _calls(kernel, args)
                    row[name] = {"ms": timing.graph_ms(call, reps),
                                 "agrees": check(kernel, args, ok)["agrees"]}
            print(f"{vname}: " + ", ".join(
                f"{v['ms'] * 1e3:.1f}" for v in row.values()) + " us",
                file=sys.stderr)
        res["fastest"] = {
            name: min(res["sweep"], key=lambda v: res["sweep"][v][name]["ms"])
            for name in data}
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 scripts/gn_kernel_bench.py")
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="checkout whose bpvo_tpu_torch is timed")
    ap.add_argument("--sweep", action="store_true",
                    help="also time copies at each launch shape of SWEEP")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if args.out is not None and not args.out.resolve().is_relative_to(
            BUILD.resolve()):
        ap.error(f"--out must lie under {BUILD}")
    if args.sweep and args.root.resolve() != ROOT:
        ap.error("--sweep sweeps this checkout's sources only")
    sys.path.insert(0, str(args.root.resolve()))
    text = json.dumps(run(device=args.device, reps=args.reps,
                          sweep=args.sweep))
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
