"""The port's last utilities against the JAX package's, on the CPU:
``utils.viz`` (``colorize_disparity`` and ``overlay_disparity`` bit for bit
JAX's cv2 calls, the headless ``Viewer``'s dumps, ``VoApp``'s viewer),
``utils.profiling`` (``trace``, ``annotate``, ``timed``), and that these
modules and ``capi.build`` load without jax, and the viewer runs, with cv2
unavailable."""
import json
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from bpvo_tpu.utils import viz as jviz
from bpvo_tpu_torch import AlgorithmParameters
from bpvo_tpu_torch.apps.vo_app import VoApp, VoAppOptions
from bpvo_tpu_torch.data import imageio
from bpvo_tpu_torch.data.synthetic import SyntheticPlaneDataset
from bpvo_tpu_torch.utils import profiling, viz

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Whole VO runs of small ops: with torch's thread pool as wide as the
    machine, they and the test files beside them (the suite runs several
    workers) wait on each other's spinning threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _disparity(seed, shape=(48, 64)):
    """Disparities in (-5, 60): about 8% invalid (<= 0)."""
    return np.random.default_rng(seed).uniform(-5, 60, shape).astype(
        np.float32)


def test_jet_table_is_cv2s():
    lut = cv2.applyColorMap(np.arange(256, dtype=np.uint8)[None],
                            cv2.COLORMAP_JET)[0]
    np.testing.assert_array_equal(viz.JET_BGR, lut)


@pytest.mark.parametrize("min_d,max_d", [(0.0, None), (0.0, 40.0),
                                         (5.0, None), (5.0, 80.0)])
def test_colorize_disparity_matches_jax(min_d, max_d):
    for seed in range(3):
        D = _disparity(seed)
        got = viz.colorize_disparity(D, min_d, max_d)
        np.testing.assert_array_equal(got, jviz.colorize_disparity(
            D, min_d, max_d))
        assert (got[D <= min_d] == 0).all()
    empty = np.zeros((8, 8), np.float32)        # no valid pixel
    np.testing.assert_array_equal(viz.colorize_disparity(empty),
                                  jviz.colorize_disparity(empty))


@pytest.mark.parametrize("kind", ["gray_u8", "float", "bgr"])
@pytest.mark.parametrize("alpha", [0.5, 0.3, 0.1])
def test_overlay_disparity_matches_jax(kind, alpha):
    """Bit for bit cv2's ``addWeighted`` on every input kind, also where
    ``1 - alpha`` and ``alpha`` are not exact in float32 (cv2 fuses the
    multiply-adds, which the port reproduces)."""
    r = np.random.default_rng(7)
    shape = (37, 81)        # odd widths: cv2's vector loop and its tail
    image = {"gray_u8": r.integers(0, 256, shape).astype(np.uint8),
             "float": r.uniform(0, 255, shape).astype(np.float32),
             "bgr": r.integers(0, 256, shape + (3,)).astype(np.uint8)}[kind]
    D = _disparity(1, shape)
    np.testing.assert_array_equal(viz.overlay_disparity(image, D, alpha),
                                  jviz.overlay_disparity(image, D, alpha))


def _hud_text(n, hz, kf):
    return f"#{n}  {hz:5.1f} Hz" + ("  KF" if kf else "")


def _cv2_hud_box(text):
    """Where JAX's ``putText`` at (8, 22), scale 0.6, thickness 1 may write,
    with a pixel for its anti-aliasing."""
    (w, h), base = cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX, 0.6, 1)
    return 22 - h - 2, 22 + base + 2, 6, 8 + w + 2


def test_headless_viewer_matches_jax(tmp_path, monkeypatch):
    """Both viewers headless over 5 frames, a dump every 2nd: the same
    files; each image JAX's outside the HUD's box, the port's HUD inside
    its own box only."""
    monkeypatch.delenv("DISPLAY", raising=False)
    r = np.random.default_rng(3)
    frames = [(r.uniform(0, 255, (48, 240)).astype(np.float32),
               _disparity(10 + i, (48, 240))) for i in range(5)]
    hz = [31.25, 8.0, 120.5, 9.96, 1000.0]
    kf = [True, False, False, True, False]
    jv = jviz.Viewer(dump_dir=str(tmp_path / "jax"), dump_every=2)
    tv = viz.Viewer(dump_dir=str(tmp_path / "port"), dump_every=2)
    for (image, D), h, k in zip(frames, hz, kf):
        assert jv.show(image, D, hz=h, is_keyframe=k)
        assert tv.show(torch.from_numpy(image), D, hz=h, is_keyframe=k)
    jv.close()
    tv.close()
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == ["frame_00000.png", "frame_00002.png", "frame_00004.png"]
    assert sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        n = int(name[6:11])
        text = _hud_text(n, hz[n], kf[n])
        want = cv2.imread(str(tmp_path / "jax" / name), cv2.IMREAD_UNCHANGED)
        got = imageio.imread(str(tmp_path / "port" / name))
        plain = viz.overlay_disparity(*frames[n])
        r0, r1, c0, c1 = viz.hud_box(text)
        j0, j1, k0, k1 = _cv2_hud_box(text)
        outside = np.ones(got.shape[:2], bool)
        outside[min(r0, j0):max(r1, j1), min(c0, k0):max(c1, k1)] = False
        np.testing.assert_array_equal(got[outside], want[outside])
        mine = np.ones(got.shape[:2], bool)
        mine[r0:r1, c0:c1] = False
        np.testing.assert_array_equal(got[mine], plain[mine])
        assert (got[r0:r1, c0:c1] == 255).all(-1).any()     # the HUD drawn


def test_vo_app_viewer_writes_frames(tmp_path):
    """``VoApp(viewer=True)`` on the CPU: every ``viewer_dump_every``-th
    frame under ``<trajectory prefix>_frames``, at the image's size."""
    ds = SyntheticPlaneDataset(rows=96, cols=128, n_frames=5)
    params = AlgorithmParameters(minSaliency=2.0, numPyramidLevels=3)
    prefix = str(tmp_path / "run")
    res = VoApp(ds, params, VoAppOptions(
        trajectory_prefix=prefix, viewer=True, viewer_dump_every=2),
        device="cpu").run()
    assert res.num_frames == 5
    names = sorted(os.listdir(prefix + "_frames"))
    assert names == ["frame_00000.png", "frame_00002.png", "frame_00004.png"]
    img = imageio.imread(os.path.join(prefix + "_frames", names[1]))
    assert img.shape == (96, 128, 3) and img.dtype == np.uint8


def test_trace_annotate_timed(tmp_path):
    """``trace`` writes one Chrome-trace JSON per session holding the
    ``annotate`` regions; ``timed`` returns a mean wall ms >= 0."""
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path), device="cpu") as d:
        assert d == str(tmp_path)
        for i in range(2):
            with profiling.annotate(f"bpvo_region_{i}"):
                (x @ x).sum()
    with profiling.trace(str(tmp_path), device="cpu"):
        x.sum()
    files = sorted(os.listdir(tmp_path))
    assert files == [f"trace_{os.getpid()}_0.json",
                     f"trace_{os.getpid()}_1.json"]
    with open(tmp_path / files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"bpvo_region_0", "bpvo_region_1"} <= names
    assert profiling.timed(torch.mm, x, x, n_rep=3) >= 0.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            with profiling.trace(str(tmp_path)):
                pass


def test_tools_load_without_jax_and_view_without_cv2(tmp_path):
    """In a fresh process with cv2 unavailable (and ``$DISPLAY`` set, so
    the viewer tries a window): ``utils.profiling``, ``utils.viz`` and
    ``capi.build`` import without jax or ``bpvo_tpu``, and
    ``python -m bpvo_tpu_torch.apps.vo --viewer`` dumps its frames."""
    cfg = tmp_path / "synthetic.cfg"
    cfg.write_text("Dataset = synthetic\nSyntheticRows = 96\n"
                   "SyntheticCols = 128\nSyntheticNumFrames = 3\n"
                   "numPyramidLevels = 3\nminSaliency = 2.0\n")
    prefix = str(tmp_path / "cli")
    code = (
        "import sys\n"
        "sys.modules['cv2'] = None\n"
        "import bpvo_tpu_torch.utils.profiling, bpvo_tpu_torch.utils.viz\n"
        "import bpvo_tpu_torch.capi.build\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'bpvo_tpu')]\n"
        "assert not bad, bad\n"
        "from bpvo_tpu_torch.apps import vo\n"
        f"r = vo.main(['--config', {str(cfg)!r}, '--output', {prefix!r}, "
        "'--viewer', '--device', 'cpu'])\n"
        "assert r.num_frames == 3\n")
    env = dict(os.environ, DISPLAY=":0", PYTHONPATH=ROOT,
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(tmp_path), timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert os.listdir(prefix + "_frames") == ["frame_00000.png"]
