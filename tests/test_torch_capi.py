"""The port's C API (``bpvo_tpu_torch/capi``), the counterpart of
tests/test_native.py's two C API cases: built here with g++, driven in this
process through ctypes on the CPU, its poses bit for bit those of
``bpvo_tpu_torch.VisualOdometry(device="cpu")`` on the same frames and
within 5e-4 of ``bpvo_tpu.VisualOdometry``; a caller that reuses one buffer
for every frame gets the poses of fresh buffers; a bad config path gives
NULL and an error; the standalone C host embeds its own interpreter."""
import ctypes
import os
import subprocess

import numpy as np
import pytest
import torch

import bpvo_tpu
import bpvo_tpu_torch
from bpvo_tpu_torch.capi import build

ROWS, COLS = 120, 160
FX = 0.8 * COLS
Z, TX = 8.0, 0.02                 # plane depth, lateral motion per frame
BASELINE = float(np.float32(0.12))    # what the C side passes on
K9 = np.array([FX, 0, COLS / 2, 0, FX, ROWS / 2, 0, 0, 1], np.float32)
ATOL_JAX = 5e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Whole VO runs of small ops: with torch's thread pool as wide as the
    machine, they and the test files beside them (the suite runs several
    workers) wait on each other's spinning threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def frame(f):
    """tests/test_native.py's frame f: a texture shifted by the camera's
    lateral motion over a fronto-parallel plane, and its disparity."""
    yy, xx = np.mgrid[0:ROWS, 0:COLS].astype(np.float64)
    shift = FX * (f * TX) / Z
    img = (128 + 60 * np.sin((xx + shift) / 7.0) * np.cos(yy / 9.0)
           + 40 * np.sin((xx + shift + 2 * yy) / 13.0)).astype(np.float32)
    return img, np.full((ROWS, COLS), FX * 0.12 / Z, np.float32)


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


@pytest.fixture(scope="module")
def lib():
    return build.load()


def run_capi(lib, frames, reuse=False, config=None):
    """Poses (float32, per frame) and keyframe flags through the C API on
    the CPU; with ``reuse`` every frame goes through the same two
    buffers, overwritten in place."""
    h = lib.bpvo_vo_create_on(_f32p(K9), BASELINE, ROWS, COLS,
                              config and str(config).encode(), b"cpu")
    assert h, lib.bpvo_vo_last_error()
    img_buf = np.empty((ROWS, COLS), np.float32)
    dsp_buf = np.empty((ROWS, COLS), np.float32)
    poses, kfs = [], []
    try:
        for img, dsp in frames:
            if reuse:
                img_buf[...], dsp_buf[...] = img, dsp
                img, dsp = img_buf, dsp_buf
            pose = np.zeros(16, np.float32)
            kf = ctypes.c_int(-1)
            rc = lib.bpvo_vo_add_frame(h, _f32p(img), _f32p(dsp),
                                       _f32p(pose), ctypes.byref(kf))
            assert rc == 0, lib.bpvo_vo_last_error()
            poses.append(pose.reshape(4, 4))
            kfs.append(kf.value)
        n = lib.bpvo_vo_trajectory_size(h)
    finally:
        lib.bpvo_vo_destroy(h)
    return np.stack(poses), kfs, n


def test_build_is_cached():
    a = build.build()
    assert all(p.exists() for p in a)
    assert build.build() == a


def test_c_api_drives_vo_in_process(lib):
    """3 frames through the C API on the CPU: the known translation, a
    trajectory of 3, the port's VisualOdometry bit for bit and JAX's
    within 5e-4."""
    frames = [frame(f) for f in range(3)]
    poses, kfs, n = run_capi(lib, frames)
    assert n == 3
    assert kfs[0] == 1
    for pose in poses[1:]:
        assert abs(pose[0, 3] + TX) < 5e-3, pose
    K = K9.reshape(3, 3)
    port = bpvo_tpu_torch.VisualOdometry(K, BASELINE, (ROWS, COLS),
                                         device="cpu")
    jax_vo = bpvo_tpu.VisualOdometry(K, BASELINE, (ROWS, COLS))
    for pose, kf, (img, dsp) in zip(poses, kfs, frames):
        want = port.add_frame(img, dsp)
        np.testing.assert_array_equal(pose, want.pose.astype(np.float32))
        assert kf == int(want.is_keyframe)
        np.testing.assert_allclose(
            pose, np.asarray(jax_vo.add_frame(img, dsp).pose), atol=ATOL_JAX)


def test_c_api_copies_reused_buffers(lib, tmp_path):
    """A host that reuses one image and one disparity buffer for every
    frame (native/vo_c_example.c does) gets the poses of fresh buffers:
    the frame kept as the keyframe candidate is a copy, not a view of the
    caller's memory.  A config file moves the keyframe to frame 3 (0.06 m
    from frame 0), where the candidate, frame 2, becomes the keyframe."""
    cfg = tmp_path / "kf.cfg"
    cfg.write_text("minTranslationMagToKeyFrame = 0.05\n")
    frames = [frame(f) for f in range(5)]
    fresh, kf_fresh, _ = run_capi(lib, frames, config=cfg)
    reused, kf_reused, _ = run_capi(lib, frames, reuse=True, config=cfg)
    np.testing.assert_array_equal(reused, fresh)
    assert kf_reused == kf_fresh == [1, 0, 0, 1, 0]


def test_c_api_errors(lib, tmp_path):
    """A config path that does not exist gives NULL and the Python error;
    ``bpvo_vo_create`` runs on CUDA, so without a card it refuses too."""
    h = lib.bpvo_vo_create_on(_f32p(K9), BASELINE, ROWS, COLS,
                              str(tmp_path / "missing.cfg").encode(), b"cpu")
    assert not h
    assert b"missing.cfg" in lib.bpvo_vo_last_error()
    assert lib.bpvo_vo_add_frame(None, None, None, None, None) == -1
    assert lib.bpvo_vo_last_error() == b"null handle"
    if not torch.cuda.is_available():
        assert not lib.bpvo_vo_create(_f32p(K9), BASELINE, ROWS, COLS, None)
        assert b"CUDA" in lib.bpvo_vo_last_error()


def test_c_example_standalone_embedding():
    """The pure-C host embedding its OWN interpreter tracks the synthetic
    motion end to end on the CPU."""
    _, host = build.build()
    out = subprocess.run([str(host), "cpu"], capture_output=True, text=True,
                         env=build.host_env(dict(os.environ,
                                                 OMP_NUM_THREADS="1")),
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "C-API example (cpu): OK" in out.stdout
