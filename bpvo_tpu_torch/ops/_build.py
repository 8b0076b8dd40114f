"""Build the hand-written CUDA kernels at first use and bind them by ctypes.

``nvcc`` compiles every ``bpvo_tpu_torch/csrc/*.cu`` of this checkout, one
process per source, all started together, and links the objects into one
shared library under ``build/bpvo_tpu_torch/`` (listed in .gitignore), named
by a hash of the sources so a changed source is rebuilt.  The library
exposes plain C entry points that return ``cudaGetLastError()``.  A failed
build raises with nvcc's stderr.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
BUILD_DIR = _PKG.parent / "build" / "bpvo_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_lib = None
_lib_lock = threading.Lock()
# held while a wrapper adds to its module's ``launch_count`` and while a CUDA
# graph is captured (``utils.graphs``): a launch another thread counts then
# is added after the capture, never taken for one of the graph's
count_lock = threading.RLock()
# completion-ticket counters of the one-launch GN kernels, per device index:
# (zeroed int32 slab of TICKET_SLOTS counters, {stream handle: slot})
TICKET_SLOTS = 1024
_tickets = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _sources():
    return sorted((_PKG / "csrc").glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sorted((_PKG / "csrc").glob("*.cu*")):    # sources and headers
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    return BUILD_DIR / f"libbpvo_kernels_{h.hexdigest()[:16]}.so"


def compile_library() -> str:
    """Run nvcc unless the library for these sources exists; return nvcc's
    output (``-Xptxas -v``: registers, shared memory, spills) or "" when the
    library was already built."""
    out = library_path()
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    jobs = []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    logs, failed = [], []
    for cmd, _, proc in jobs:          # wait for every compile
        stdout, stderr = proc.communicate()
        logs.append(stdout + stderr)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                          f"\n{stderr}")
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *LINK_FLAGS, "-o", str(tmp),
               *(str(obj) for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, out)   # atomic: a concurrent build never sees half
    finally:
        for _, obj, _ in jobs:
            obj.unlink(missing_ok=True)
    return "".join(logs) + proc.stdout + proc.stderr


def check_tensors(op: str, device, want) -> None:
    """Raise ValueError unless every ``name: (tensor, shape, dtype)`` of
    ``want`` lies on ``device`` with that shape and dtype, contiguous: what
    a kernel's raw pointer needs."""
    for name, (t, shape, dtype) in want.items():
        if t.device != device:
            raise ValueError(f"{op}: {name} is on {t.device}, not {device}")
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(f"{op}: {name} must be {dtype} {tuple(shape)}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous")


def launch(lib: ctypes.CDLL, op: str, rc: int) -> None:
    """Raise RuntimeError if a C entry point returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{op} kernel launch failed: "
                           + lib.bpvo_cuda_error_string(rc).decode())


def ticket_counter(stream) -> ctypes.c_void_p:
    """The completion-ticket counter of ``fused_linearize.cu`` and
    ``irls_reduce.cu`` (``csrc/gn_reduce.cuh``) for launches on the CUDA
    ``stream``: one zeroed int per stream, each launch leaves it at 0.

    A device's counters are allocated, zeroed, at its first call, which
    must come before any CUDA-graph capture on that device; a stream first
    seen later (a capture stream) takes a free one of them.  Launches on
    two streams thus never share a counter.  Both kernels share a stream's
    counter, since launches on one stream never overlap; a captured graph
    keeps the counter of the stream it was captured on.
    """
    import torch
    dev = stream.device
    if dev.index not in _tickets:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "fused_linearize / irls_reduce: call one of them on "
                f"{dev} before capturing a CUDA graph (their ticket counters "
                "are allocated at the first call)")
        slab = torch.zeros(TICKET_SLOTS, dtype=torch.int32, device=dev)
        torch.cuda.synchronize(dev)          # zero before any stream uses it
        _tickets[dev.index] = (slab, {})
    slab, slots = _tickets[dev.index]
    slot = slots.get(stream.cuda_stream)
    if slot is None:
        if len(slots) == TICKET_SLOTS:
            raise RuntimeError(f"fused_linearize / irls_reduce: more than "
                               f"{TICKET_SLOTS} streams on {dev}")
        slot = slots[stream.cuda_stream] = len(slots)
    return ctypes.c_void_p(slab.data_ptr() + 4 * slot)


def bind_sgm(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument types of sgm.cu's entry points on ``lib`` (the
    kernels' library, or a build of sgm.cu alone)."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.bpvo_sgm_carry_pass.argtypes = [p, p, i, i, i, f, f, i, p]
    lib.bpvo_sgm_carry_pass.restype = i
    lib.bpvo_sgm_tile_pass.argtypes = [p, p, p, i, i, i, f, f, i, p]
    lib.bpvo_sgm_tile_pass.restype = i
    lib.bpvo_sgm_scratch_floats.argtypes = [i, i, i]
    lib.bpvo_sgm_scratch_floats.restype = ctypes.c_longlong
    return lib


def bind_gn(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument types of fused_linearize.cu's and irls_reduce.cu's
    entry points on ``lib`` (the kernels' library, or a build of those two
    sources alone)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bpvo_fused_linearize.argtypes = [p] * 7 + [i] * 6 + [p] * 6
    lib.bpvo_fused_linearize.restype = i
    lib.bpvo_fused_linearize_blocks.argtypes = [i, i]
    lib.bpvo_fused_linearize_blocks.restype = i
    lib.bpvo_irls_reduce.argtypes = [p] * 4 + [i] * 2 + [p] * 5
    lib.bpvo_irls_reduce.restype = i
    lib.bpvo_irls_reduce_blocks.argtypes = [i]
    lib.bpvo_irls_reduce_blocks.restype = i
    return lib


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use in this process
    (once, whichever threads ask for it)."""
    global _lib
    with _lib_lock:
        return _lib if _lib is not None else _load_library()


def _load_library() -> ctypes.CDLL:
    global _lib
    compile_library()
    lib = ctypes.CDLL(str(library_path()))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.bpvo_level_gn.argtypes = ([p] * 14 + [i] * 4 + [f] * 6 + [i] * 3
                                  + [f] * 5 + [p])
    lib.bpvo_level_gn.restype = i
    lib.bpvo_level_gn_ctas.argtypes = [i]
    lib.bpvo_level_gn_ctas.restype = i
    lib.bpvo_cuda_error_string.argtypes = [i]
    lib.bpvo_cuda_error_string.restype = ctypes.c_char_p
    lib.bpvo_census_planes.argtypes = [p, p, i, i, p]
    lib.bpvo_census_planes.restype = i
    lib.bpvo_census_cost.argtypes = [p, p, p, i, i, i, p]
    lib.bpvo_census_cost.restype = i
    bind_sgm(lib)
    bind_gn(lib)
    # gn_step.cu: gauss_newton.run's step after the linearization
    lib.bpvo_gn_step.argtypes = [p] * 25 + [i] * 2 + [f] * 5 + [p]
    lib.bpvo_gn_step.restype = i
    # graph_cond.cu: the IF and WHILE nodes of utils/graphs.py
    pp, u64 = ctypes.POINTER(p), ctypes.c_ulonglong
    for name, args in (
            ("create", [pp]), ("destroy", [p]),
            ("num_nodes", [p, ctypes.POINTER(ctypes.c_longlong)]),
            ("node_types", [p, ctypes.POINTER(ctypes.c_longlong), i]),
            ("append_child", [p, pp, p]), ("append_if", [p, pp, p, pp]),
            ("append_while", [p, pp, p, pp, ctypes.POINTER(u64)]),
            ("append_set", [p, pp, u64, p]),
            ("instantiate", [pp, p]), ("launch", [p, p]),
            ("exec_destroy", [p])):
        fn = getattr(lib, "bpvo_graph_" + name)
        fn.argtypes, fn.restype = args, i
    # and the loops' clocks (utils/graphs.py Timer)
    lib.bpvo_clock_start.argtypes, lib.bpvo_clock_start.restype = [p, p], i
    lib.bpvo_clock_stop.argtypes, lib.bpvo_clock_stop.restype = [p, p, p], i
    # peer_reduce.cu: the distributed layer's all-reduce (parallel/peer.py)
    ll = ctypes.c_longlong
    for name, args, res in (
            ("buffer_bytes", [], ll), ("slot_bytes", [], ll),
            ("max_ranks", [], i), ("handle_bytes", [], i),
            ("alloc", [i, pp, p], i), ("open", [i, p, pp], i),
            ("close", [i, p], i), ("free", [i, p], i),
            ("reduce", [p, i, i, i, p, p, ll, i, i, u64, p], i)):
        fn = getattr(lib, "bpvo_peer_" + name)
        fn.argtypes, fn.restype = args, res
    # the microbenchmarks of bpvo_tpu_torch/probes
    for name, args in (
            ("while_cta", [p, p, i, i, p]),
            ("while_cluster", [p, p, i, i, i, p]),
            ("while_grid_ctas", []),
            ("while_grid", [p, p, i, i, p, p]),
            ("scalar_chain", [p, p, p]),
            ("matmul_chain", [p, p, p, i, f, p]),
            ("take_global", [p, p, p, i, i, i, p]),
            ("take_smem", [p, p, p, i, i, i, p]),
            ("take_dsmem", [p, p, p, i, i, i, p]),
            ("take_dsmem_clusters", [i, p]),
            ("band_bilinear", [p, p, p, p, i, i, i, i, i, p]),
            ("band_static_slice", [p, i, i, i, p, p]),
            ("band_dyn_slice", [p, i, p, i, i, i, p, p]),
            ("band_onehot", [p, i, p, p]),
            ("band_onehot_matmul", [p, p, i, p, p]),
            ("band_rowweight", [p, p, i, i, p, p])):
        fn = getattr(lib, "bpvo_probe_" + name)
        fn.argtypes, fn.restype = args, i
    _lib = lib
    return _lib
