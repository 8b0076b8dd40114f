"""The measurements behind ``level_gn``'s cluster size, on one GPU: a sweep
over cluster sizes and where an iteration's time goes.

    python3 scripts/level_gn_sweep.py [--reps 20]
        [--out build/level_gn_sweep.json]

Both run at the 12 level shapes that the VO paths send to ``level_gn``
(templates of frame 0, channels of frame 1 of the synthetic 376x1241
sequence, from the identity pose): intensity with bench.py's settings (C=1)
and stereo Bit-Planes with conf/kitti_bitplanes.cfg (C=8, SGM disparity) at
K = 16384/4096/1024/512, and dense intensity and Bit-Planes (bench.py's
settings, non-maxima suppression off, pointCapacity 131072) at L2 and L3,
K = 8192/2048.

The shipped ``csrc/level_gn.cu`` has no knob for either measurement: this
script writes patched copies of it under ``build/level_gn_sweep/`` and
builds each alone with the package's nvcc flags, all builds started
together.

1. Cluster sizes: a copy whose ``ctas_for`` returns n, for each n of
   ``SWEEP`` (1, 2, 4, 8, 16 CTAs).  Per copy and shape: the solve's device
   ms (CUDA-graph replay, ``reps`` replays), us per iteration, and whether
   it agrees with the plain version (the same iterations and status, the
   one-iteration sigma bit for bit, the pose within 1e-4).  Each shape's
   ``rule`` is the shipped library's size; ``rules`` sums each candidate
   rule's device us over the shapes.
2. Phases: a copy of the shipped rule with clock marks after the
   linearization's n / max|r| reduction, the 4 median rounds, the system's
   reduction (with the weights and normal equations; on iterations that
   skip sigma also the linearization) and the solve and update, summed over
   iterations by CTA 0's thread 0.  Reported per iteration in cycles and in
   us (the cycles scaled by the copy's own device time).

Prints one JSON object.  Imports no JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from bpvo_tpu_torch.ops import _build  # noqa: E402
from bpvo_tpu_torch.ops import level_gn as lg  # noqa: E402
from bpvo_tpu_torch.probes import timing  # noqa: E402

SWEEP = (1, 2, 4, 8, 16)
SOURCE = ROOT / "bpvo_tpu_torch" / "csrc" / "level_gn.cu"
CONF = ROOT / "conf" / "kitti_bitplanes.cfg"
BUILD = ROOT / "build"
T_ATOL = 1e-4
BENCH = dict(minSaliency=2.0, numPyramidLevels=4, functionTolerance=1e-4,
             parameterTolerance=1e-6, maxIterations=50)
DENSE = dict(minNumPixelsForNonMaximaSuppression=20000000,
             pointCapacity=131072)
# candidate rules: CTAs for K points (each gives a size of SWEEP at every
# shape here)
RULES = {
    "one per 256": lambda K: min(16, -(-K // 256)),
    "one per 512": lambda K: min(16, -(-K // 512)),
    "one per 1024": lambda K: min(16, -(-K // 1024)),
    "1 up to 512, else one per 256": lambda K: (
        1 if K <= 512 else min(16, -(-K // 256))),
}

PHASES = ("linearize_and_n_max", "median_rounds", "normal_equations",
          "solve_and_update")
_MARK = ("if (rank == 0 && tid == 0) {{ const long long now = clock64(); "
         "g_phase_cycles[{0}] += now - t_mark; t_mark = now; }}\n")
# (anchor, text inserted after it) of the phase-timing copy; each anchor
# must occur exactly once in the source
_PHASE_PATCH = (
    ("namespace {\n",
     f"__device__ unsigned long long g_phase_cycles[{len(PHASES) + 1}];\n"),
    ("    const float sigma = st.sigma, dscale = st.dscale;\n",
     "    long long t_mark = clock64();\n"),
    ("      cluster_reduce(na, IntReduce{2u}, sh, parity, cl, n_ctas);\n",
     "      " + _MARK.format(0)),
    ("      sigma_new = est;\n", "      " + _MARK.format(1)),
    ("    cluster_reduce(acc, FloatSum{}, sh, parity, cl, n_ctas);\n",
     "    " + _MARK.format(2)),
    ("      solve_and_update(st, p, sc, acc, sigma_new, dscale_new);\n"
     "    }\n    __syncthreads();\n",
     "    " + _MARK.format(3)
     + f"    if (rank == 0 && tid == 0) g_phase_cycles[{len(PHASES)}] += 1;\n"),
)
_PHASE_READER = f"""
// Copies the phase cycles and the iterations to ``out`` and, with
// ``reset``, sets them to 0.
extern "C" int bpvo_level_gn_phases(unsigned long long* out, int reset) {{
  cudaError_t e =
      cudaMemcpyFromSymbol(out, g_phase_cycles, sizeof(g_phase_cycles));
  if (e == cudaSuccess && reset) {{
    const unsigned long long zero[{len(PHASES) + 1}] = {{}};
    e = cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));
  }}
  return static_cast<int>(e);
}}
"""


def _insert_after(text: str, anchor: str, insert: str) -> str:
    if text.count(anchor) != 1:
        raise ValueError(f"level_gn_sweep: {anchor!r} occurs "
                         f"{text.count(anchor)} times in {SOURCE.name}")
    return text.replace(anchor, anchor + insert)


def patched_source(text: str, n_ctas: int | None = None,
                   phases: bool = False) -> str:
    """``level_gn.cu``'s text with ``ctas_for`` returning ``n_ctas`` (when
    given) and with the phase clock marks (``phases``)."""
    if n_ctas is not None:
        text = _insert_after(text, "int ctas_for(int K) {\n",
                             f"  (void)K;\n  return {int(n_ctas)};\n")
    if phases:
        for anchor, insert in _PHASE_PATCH:
            text = _insert_after(text, anchor, insert)
        text += _PHASE_READER
    return text


def build_copies(variants) -> list:
    """Build one shared library per ``(name, source text)`` of ``variants``
    under build/level_gn_sweep/, one nvcc each, all started together.
    Returns the libraries' paths; a failed build raises with nvcc's
    stderr."""
    out_dir = BUILD / "level_gn_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name, text in variants:
        src, lib = out_dir / f"{name}.cu", out_dir / f"{name}.so"
        src.write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
               str(src)]
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


def _load(path) -> ctypes.CDLL:
    """A built copy, with the argument types ``_build.library`` sets for
    level_gn.cu's entry points."""
    lib = ctypes.CDLL(str(path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.bpvo_level_gn.argtypes = ([p] * 14 + [i] * 4 + [f] * 6 + [i] * 3
                                  + [f] * 5 + [p])
    lib.bpvo_level_gn.restype = i
    lib.bpvo_level_gn_ctas.argtypes = [i]
    lib.bpvo_level_gn_ctas.restype = i
    lib.bpvo_cuda_error_string.argtypes = [i]
    lib.bpvo_cuda_error_string.restype = ctypes.c_char_p
    return lib


@contextlib.contextmanager
def _using(lib):
    """``ops.level_gn.level_gn`` launches from ``lib`` inside the block."""
    saved = _build._lib
    _build._lib = lib
    try:
        yield
    finally:
        _build._lib = saved


def level_shapes(device) -> dict:
    """{"<path> L<l>": the arguments of ``level_gn``} at the 12 level
    shapes, on ``device``."""
    from bpvo_tpu_torch import (AlgorithmParameters, ConfigFile,
                                DescriptorType)
    from bpvo_tpu_torch.data import stereo, synthetic
    from bpvo_tpu_torch.vo import device_vo
    K, b, frames = synthetic.synthesize_stereo_sequence(2)
    cf = ConfigFile(str(CONF))
    intensity = DescriptorType.INTENSITY
    # (params, stereo_fn, index of the second init image, levels)
    paths = {
        "intensity": (AlgorithmParameters(**BENCH, descriptor=intensity),
                      None, 2, range(4)),
        "stereo_bitplanes": (AlgorithmParameters.from_config(cf),
                             stereo.create_stereo_algorithm(cf).as_fn(), 1,
                             range(4)),
        "dense_intensity": (AlgorithmParameters(**BENCH, **DENSE,
                                                descriptor=intensity),
                            None, 2, (2, 3)),
        "dense_bitplanes": (AlgorithmParameters(
            **BENCH, **DENSE, descriptor=DescriptorType.BITPLANES),
            None, 2, (2, 3))}
    out = {}
    for path, (params, stereo_fn, aux, levels) in paths.items():
        vo = device_vo.DeviceVO(K, b, (synthetic.ROWS, synthetic.COLS),
                                params, device=device, stereo_fn=stereo_fn)
        vo.init(*(torch.as_tensor(frames[0][i]).to(device) for i in (0, aux)))
        channels = device_vo._compute_channels_pyr(
            torch.as_tensor(frames[1][0]).to(device), vo._p,
            vo._p.numPyramidLevels)
        T0 = torch.eye(4, dtype=torch.float32, device=device)
        for level in levels:
            td = vo.state.templates[level]
            out[f"{path} L{level}"] = (
                vo._cams[level], td.points, td.valid, td.pixels, td.jacobians,
                channels[level], T0, 1.0, 1e10, td.norm_scale,
                td.norm_center, vo._opts[level])
    return out


def _one_iteration(args):
    return args[:-1] + (dataclasses.replace(args[-1], max_iterations=1),)


def _phases(lib, call, reps):
    """Per-iteration cycles of each phase over ``reps`` calls of the
    phase-timing copy, and us: the cycles scaled by the copy's device time
    per call (CUDA-graph replay)."""
    counts = (ctypes.c_ulonglong * (len(PHASES) + 1))()
    call()
    torch.cuda.synchronize()
    lib.bpvo_level_gn_phases(counts, 1)
    for _ in range(reps):
        call()
    torch.cuda.synchronize()
    if lib.bpvo_level_gn_phases(counts, 1) != 0:
        raise RuntimeError("level_gn_sweep: reading the phase cycles failed")
    ms = timing.graph_ms(call, reps)
    iters = counts[len(PHASES)]
    cycles = [c / iters for c in counts[:len(PHASES)]]
    us_per_cycle = ms * 1e3 * reps / iters / max(sum(cycles), 1.0)
    return {"ms": ms, "iterations_per_call": iters / reps,
            "cycles_per_iteration": dict(zip(PHASES, cycles)),
            "us_per_iteration": {k: c * us_per_cycle
                                 for k, c in zip(PHASES, cycles)}}


def run(device="cuda", reps: int = 20) -> dict:
    """The sweep and the phases on ``device`` (a CUDA device): {"device",
    "sweep", "results": {shape: {"C", "K", "rule", "plain_iterations",
    "<n>": {"ms", "us_per_iteration", "iterations", "agrees", ...},
    "phases"}}, "rules": {rule: us summed over the shapes}}."""
    from bpvo_tpu_torch.vo.device_vo import resolve_device
    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError("level_gn_sweep: the sweep times the kernel, which "
                         "runs only on a CUDA device")
    text = SOURCE.read_text()
    paths = build_copies(
        [(f"ctas{n}", patched_source(text, n_ctas=n)) for n in SWEEP]
        + [("phases", patched_source(text, phases=True))])
    libs = [_load(p) for p in paths]
    libs, phased = libs[:-1], libs[-1]
    phased.bpvo_level_gn_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    phased.bpvo_level_gn_phases.restype = ctypes.c_int
    results = {}
    for shape, args in level_shapes(device).items():
        C, K = args[3].shape
        one = _one_iteration(args)
        Tp, sp = (t.cpu() for t in lg.level_gn_reference(*args)[:2])
        sigma1 = lg.level_gn_reference(*one)[1][4].item()
        row = results[shape] = {"C": C, "K": K, "rule": lg.n_ctas(K),
                                "plain_iterations": int(sp[0])}
        for n, lib in zip(SWEEP, libs):
            with _using(lib):
                T, st = (t.cpu() for t in lg.level_gn(*args)[:2])
                s1 = lg.level_gn(*one)[1][4].item()
                ms = timing.graph_ms(lambda: lg.level_gn(*args), reps)
            d_T = float((T - Tp).abs().max())
            row[str(n)] = {
                "ms": ms, "us_per_iteration": ms * 1e3 / max(int(st[0]), 1),
                "iterations": int(st[0]), "status": int(st[3]),
                "max_dT": d_T, "sigma1_bitwise": s1 == sigma1,
                "agrees": (int(st[0]) == int(sp[0]) and st[3] == sp[3]
                           and s1 == sigma1 and d_T <= T_ATOL)}
        with _using(phased):
            row["phases"] = _phases(phased, lambda: lg.level_gn(*args), reps)
        print(f"{shape} C={C} K={K}: " + ", ".join(
            f"{n} CTAs {row[str(n)]['ms'] * 1e3:.1f} us" for n in SWEEP)
            + f"; rule {row['rule']}", file=sys.stderr)
    rules = {name: sum(r[str(rule(r["K"]))]["ms"] * 1e3
                       for r in results.values())
             for name, rule in RULES.items()}
    return {"device": torch.cuda.get_device_name(device), "sweep": SWEEP,
            "clock": "device ms, CUDA-graph replay", "results": results,
            "rules_us": rules}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 scripts/level_gn_sweep.py")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if args.out is not None and not args.out.resolve().is_relative_to(
            BUILD.resolve()):
        ap.error(f"--out must lie under {BUILD}")
    text = json.dumps(run(reps=args.reps))
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
