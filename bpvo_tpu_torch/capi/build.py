"""Build the port's C API and its standalone C host at first use.

``build()`` compiles ``bpvo_torch_capi.cc`` into a shared library with
``g++`` and ``vo_c_example.c`` against it with ``cc``, taking the embedding
flags from the ``python3-config`` of the running interpreter (``--includes``
and ``--ldflags --embed``).  The outputs go to
``build/bpvo_tpu_torch_capi/<hash>/`` (listed in .gitignore), named by a
hash of the sources, the flags and that Python, so a changed source is
rebuilt; a failed build raises with the compiler's stderr.

``load()`` binds the library by ctypes with every entry point's argument
and result types; ``host_env()`` is the environment the standalone host
needs (its embedded interpreter finds this Python's packages and the
repository through ``PYTHONPATH``).

    python -m bpvo_tpu_torch.capi.build      # prints the two paths
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import sysconfig
from pathlib import Path

_HERE = Path(__file__).resolve().parent
_ROOT = _HERE.parents[1]
BUILD_DIR = _ROOT / "build" / "bpvo_tpu_torch_capi"
SOURCES = ("bpvo_torch_capi.h", "bpvo_torch_capi.cc", "vo_c_example.c")
LIB_NAME = "libbpvo_torch_capi.so"
HOST_NAME = "vo_c_example"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-shared")
CC_FLAGS = ("-O2", "-Wall")


def _python_config() -> str:
    """The python3-config of the running interpreter's installation."""
    ver = sysconfig.get_config_var("VERSION")          # e.g. "3.12"
    bindir = sysconfig.get_config_var("BINDIR") or ""
    for cand in (os.path.join(bindir, f"python{ver}-config"),
                 os.path.join(bindir, "python3-config"),
                 shutil.which(f"python{ver}-config"),
                 shutil.which("python3-config")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(f"python{ver}-config not found: the C API embeds "
                       f"CPython {ver} and needs its development files")


def _flags():
    """(include flags, embedding link flags) from python3-config."""
    cfg = _python_config()

    def run(*args):
        return subprocess.run([cfg, *args], capture_output=True, text=True,
                              check=True).stdout.split()
    includes = run("--includes")
    ldflags = run("--ldflags", "--embed")
    # the library resolves libpython where python3-config found it
    rpaths = [f"-Wl,-rpath,{f[2:]}" for f in ldflags if f.startswith("-L")]
    return includes, ldflags + rpaths


def _compilers():
    cxx = shutil.which("g++")
    cc = shutil.which("cc") or shutil.which("gcc")
    if not cxx or not cc:
        raise RuntimeError("g++ and cc are needed to build the C API")
    return cxx, cc


def _run(cmd) -> None:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"build failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stderr}")


def build():
    """Build unless built; return (library path, standalone host path)."""
    cxx, cc = _compilers()
    includes, ldflags = _flags()
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((_HERE / name).read_bytes())
    h.update(" ".join((cxx, cc, *CXX_FLAGS, *CC_FLAGS, *includes,
                       *ldflags)).encode())
    out = BUILD_DIR / h.hexdigest()[:16]
    if not out.exists():
        tmp = BUILD_DIR / f"{out.name}.{os.getpid()}.tmp"
        tmp.mkdir(parents=True, exist_ok=True)
        try:
            _run([cxx, *CXX_FLAGS, *includes, "-o", str(tmp / LIB_NAME),
                  str(_HERE / "bpvo_torch_capi.cc"), *ldflags])
            _run([cc, *CC_FLAGS, f"-I{_HERE}", "-o", str(tmp / HOST_NAME),
                  str(_HERE / "vo_c_example.c"), f"-L{tmp}",
                  "-lbpvo_torch_capi", "-lm", "-Wl,-rpath,$ORIGIN"])
            try:
                tmp.rename(out)   # atomic: a concurrent build never sees half
            except OSError:
                if not out.exists():
                    raise
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return out / LIB_NAME, out / HOST_NAME


def load(path=None) -> ctypes.CDLL:
    """The C API by ctypes (``build()``'s library unless ``path``), every
    entry point typed.  In a Python process the library rides the running
    interpreter; ctypes releases the GIL around each call and the entry
    points take it."""
    lib = ctypes.CDLL(str(path or build()[0]))
    f32p = ctypes.POINTER(ctypes.c_float)
    create = [f32p, ctypes.c_float, ctypes.c_int, ctypes.c_int,
              ctypes.c_char_p]
    lib.bpvo_vo_create.restype = ctypes.c_void_p
    lib.bpvo_vo_create.argtypes = create
    lib.bpvo_vo_create_on.restype = ctypes.c_void_p
    lib.bpvo_vo_create_on.argtypes = create + [ctypes.c_char_p]
    lib.bpvo_vo_add_frame.restype = ctypes.c_int
    lib.bpvo_vo_add_frame.argtypes = [ctypes.c_void_p, f32p, f32p, f32p,
                                      ctypes.POINTER(ctypes.c_int)]
    lib.bpvo_vo_trajectory_size.restype = ctypes.c_int
    lib.bpvo_vo_trajectory_size.argtypes = [ctypes.c_void_p]
    lib.bpvo_vo_destroy.restype = None
    lib.bpvo_vo_destroy.argtypes = [ctypes.c_void_p]
    lib.bpvo_vo_last_error.restype = ctypes.c_char_p
    lib.bpvo_vo_last_error.argtypes = []
    return lib


def host_env(env=None) -> dict:
    """``env`` (default: this process's) with ``PYTHONPATH`` set to the
    repository root and this interpreter's import path, which the
    standalone host's embedded interpreter needs to import torch and
    ``bpvo_tpu_torch``."""
    env = dict(os.environ if env is None else env)
    paths = [str(_ROOT)] + [p for p in sys.path if p and os.path.isdir(p)]
    env["PYTHONPATH"] = os.pathsep.join(dict.fromkeys(paths))
    return env


if __name__ == "__main__":
    for p in build():
        print(p)
