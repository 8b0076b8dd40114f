"""ctypes binding for the C++ native runtime (native/bpvo_native.cc):
multi-threaded frame decode pipeline + binary PLY writer (the port's copy
of ``bpvo_tpu/data/native_loader.py``; the library links OpenCV, so
``is_available()`` is False on a machine without it).

Alternative to ``DatasetLoaderThread`` for file-backed datasets — the decode pool runs entirely outside the GIL.  Build with
``make -C native`` (the library is loaded lazily; ``is_available()`` reports
whether it exists).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Optional, Tuple

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native",
    "libbpvo_native.so")
_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        try:
            subprocess.run(["make", "-C", os.path.dirname(_LIB_PATH)],
                           check=True, capture_output=True)
        except Exception as e:
            raise OSError(f"native library not built: {e}")
    lib = ctypes.CDLL(_LIB_PATH)
    lib.bpvo_loader_create.restype = ctypes.c_void_p
    lib.bpvo_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float]
    lib.bpvo_loader_pop.restype = ctypes.c_int
    lib.bpvo_loader_pop.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_int]
    lib.bpvo_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.bpvo_write_ply.restype = ctypes.c_int
    lib.bpvo_write_ply.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
    _lib = lib
    return lib


def is_available() -> bool:
    try:
        _load()
        return True
    except OSError:
        return False


class NativeFrameLoader:
    """In-order multi-worker decode pipeline over explicit file lists."""

    def __init__(self, image_paths: List[str], disparity_paths: List[str],
                 rows: int, cols: int, capacity: int = 16, workers: int = 2,
                 disparity_scale: float = 1.0 / 16.0):
        assert len(image_paths) == len(disparity_paths)
        lib = _load()
        self._lib = lib
        self._rows, self._cols = rows, cols
        n = len(image_paths)
        img_arr = (ctypes.c_char_p * n)(*[p.encode() for p in image_paths])
        dsp_arr = (ctypes.c_char_p * n)(*[p.encode() for p in disparity_paths])
        self._handle = lib.bpvo_loader_create(
            img_arr, dsp_arr, n, capacity, workers,
            ctypes.c_float(disparity_scale))
        if not self._handle:
            raise OSError("failed to create native loader")

    def pop(self, timeout_ms: int = 5000
            ) -> Optional[Tuple[int, np.ndarray, np.ndarray]]:
        """Next (index, image u8, disparity f32) in order; None at end."""
        img = np.empty((self._rows, self._cols), np.uint8)
        dsp = np.empty((self._rows, self._cols), np.float32)
        rc = self._lib.bpvo_loader_pop(
            self._handle,
            img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            dsp.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._rows, self._cols, timeout_ms)
        if rc == -1:
            return None
        if rc == -2:
            raise TimeoutError("native loader pop timed out")
        if rc == -3:
            raise ValueError("frame size mismatch")
        return rc, img, dsp

    def __iter__(self):
        while True:
            out = self.pop()
            if out is None:
                return
            yield out

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.bpvo_loader_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def write_ply_native(path: str, points: np.ndarray, colors: np.ndarray) -> None:
    """Binary PLY via the native writer (points (N,3) f32, colors (N,3) u8)."""
    lib = _load()
    pts = np.ascontiguousarray(points, np.float32)
    rgb = np.ascontiguousarray(colors[:, :3], np.uint8)
    rc = lib.bpvo_write_ply(
        path.encode(), pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(pts))
    if rc != 0:
        raise OSError(f"bpvo_write_ply failed: {rc}")
