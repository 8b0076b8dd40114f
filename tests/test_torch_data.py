"""The port's host data layer against the JAX package's and OpenCV on the
CPU: ``data.imageio`` against cv2 bit for bit, each dataset class and
``create_dataset`` branch against JAX's on the same written files,
``TpuBlockMatching`` against JAX's ``_block_matching``, the KITTI and
Tsukuba evaluations, the loader, and checkpoints the JAX package wrote
loaded by the port."""
import importlib.util
import os
import struct
import zlib

import numpy as np
import pytest
import torch

from bpvo_tpu.config import ConfigFile as JConfigFile
from bpvo_tpu.data import dataset as jdataset
from bpvo_tpu.data import stereo as jstereo
from bpvo_tpu.data import synthetic as jsynthetic
from bpvo_tpu.eval import kitti_eval as jkitti_eval
from bpvo_tpu.eval import tsukuba_eval as jtsukuba_eval
from bpvo_tpu_torch.config import ConfigFile
from bpvo_tpu_torch.data import dataset, imageio, loader, stereo, synthetic
from bpvo_tpu_torch.eval import kitti_eval, tsukuba_eval

cv2 = pytest.importorskip("cv2")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Whole-pipeline runs of small ops: with torch's thread pool as wide
    as the machine, they and the test files beside them (the suite runs
    several workers) wait on each other's spinning threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chip_smoke():
    """chip_smoke.py's sequence writers (the script is the one copy)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _images(rows=72, cols=96, seed=0):
    """8-bit and 16-bit grey, BGR and BGRA test images: smooth texture plus
    noise, so libpng's filters have something to predict."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:rows, 0:cols].astype(np.float32)
    smooth = (128 + 60 * np.sin(xx / 7) * np.cos(yy / 9)
              + 40 * np.sin((xx + 2 * yy) / 13))
    g8 = np.clip(smooth + rng.normal(0, 8, smooth.shape), 0, 255).astype(
        np.uint8)
    g16 = (g8.astype(np.uint16) * 251
           + rng.integers(0, 200, g8.shape)).astype(np.uint16)
    bgr = np.stack([g8, np.roll(g8, 5, 1), 255 - g8], -1)
    return {"gray8": g8, "gray16": g16, "bgr8": bgr,
            "bgra8": np.concatenate([bgr, g8[..., None]], -1),
            "bgr16": np.stack([g16, g16 // 3, 65535 - g16], -1)}


# ---------------------------------------------------------------------------
# imageio against cv2
# ---------------------------------------------------------------------------

_FILTERS = ("NONE", "SUB", "UP", "AVG", "PAETH", "ALL_FILTERS")


@pytest.mark.parametrize("kind", ["gray8", "gray16", "bgr8", "bgra8",
                                  "bgr16"])
@pytest.mark.parametrize("png_filter", _FILTERS)
def test_png_read_matches_cv2(tmp_path, kind, png_filter):
    """PNGs cv2 wrote with each of libpng's row filters (and its adaptive
    choice) read bit for bit as cv2.imread(IMREAD_UNCHANGED) reads them."""
    img = _images()[kind]
    path = str(tmp_path / f"{kind}.png")
    flag = getattr(cv2, "IMWRITE_PNG_" + png_filter if png_filter ==
                   "ALL_FILTERS" else "IMWRITE_PNG_FILTER_" + png_filter)
    assert cv2.imwrite(path, img, [cv2.IMWRITE_PNG_FILTER, flag])
    want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    got = imageio.imread(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind,ext", [("gray8", ".png"), ("gray16", ".png"),
                                      ("bgr8", ".png"), ("bgra8", ".png"),
                                      ("bgr16", ".png"), ("gray8", ".pgm"),
                                      ("gray16", ".pgm"), ("bgr8", ".ppm")])
def test_written_files_read_back_by_cv2(tmp_path, kind, ext):
    """imageio's writer: cv2 and imageio read the pixels back exactly, and
    imageio reads cv2's PGM/PPM files as cv2 does."""
    img = _images()[kind]
    ours = str(tmp_path / f"ours{ext}")
    imageio.imwrite(ours, img)
    np.testing.assert_array_equal(cv2.imread(ours, cv2.IMREAD_UNCHANGED),
                                  img)
    np.testing.assert_array_equal(imageio.imread(ours), img)
    theirs = str(tmp_path / f"cv2{ext}")
    cv2.imwrite(theirs, img)
    np.testing.assert_array_equal(imageio.imread(theirs),
                                  cv2.imread(theirs, cv2.IMREAD_UNCHANGED))


def test_pfm_and_missing_and_unsupported_files(tmp_path):
    d = np.random.default_rng(1).normal(size=(30, 41)).astype(np.float32)
    path = str(tmp_path / "d.pfm")
    imageio.write_pfm(path, d)
    np.testing.assert_array_equal(imageio.imread(path), d)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), d)
    jsynthetic.write_pfm(str(tmp_path / "j.pfm"), d)
    assert (tmp_path / "j.pfm").read_bytes() == (tmp_path / "d.pfm").read_bytes()
    assert imageio.imread(str(tmp_path / "none.png")) is None
    # a palette PNG (colour type 3) and an unknown file raise
    ihdr = struct.pack(">IIBBBBB", 2, 2, 8, 3, 0, 0, 0)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    (tmp_path / "p.png").write_bytes(
        imageio.PNG_SIGNATURE + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(bytes(6))) + chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="colour type 3"):
        imageio.imread(str(tmp_path / "p.png"))
    (tmp_path / "x.bin").write_bytes(b"GIF89a")
    with pytest.raises(ValueError):
        imageio.imread(str(tmp_path / "x.bin"))


@pytest.mark.parametrize("kind", ["bgr8", "bgra8", "bgr16"])
def test_to_gray_matches_cv2(kind):
    img = _images(120, 160, seed=3)[kind]
    code = cv2.COLOR_BGRA2GRAY if img.shape[2] == 4 else cv2.COLOR_BGR2GRAY
    np.testing.assert_array_equal(imageio.to_gray(img),
                                  cv2.cvtColor(img, code))


@pytest.mark.parametrize("factor", [2, 3, 4])
def test_downscale_matches_cv2_resize(factor):
    """``ScaleBy``'s downscale against cv2.resize(fx=fy=1/factor,
    INTER_LINEAR), even and odd sizes, uint8 and uint16."""
    rng = np.random.default_rng(factor)
    for rows, cols in ((64, 96), (63, 97), (62, 98), (65, 99)):
        for img in (rng.integers(0, 256, (rows, cols)).astype(np.uint8),
                    rng.integers(0, 65536, (rows, cols)).astype(np.uint16)):
            want = cv2.resize(img, None, fx=1.0 / factor, fy=1.0 / factor)
            got = imageio.downscale(img, factor)
            assert got.shape == want.shape
            np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# datasets against the JAX package's, on the same files
# ---------------------------------------------------------------------------

def _same_frames(jds, tds, n):
    assert tuple(tds.image_size) == tuple(jds.image_size)
    assert tds.name == jds.name
    np.testing.assert_array_equal(tds.calibration.K, jds.calibration.K)
    assert tds.calibration.baseline == pytest.approx(
        jds.calibration.baseline, abs=1e-12)
    for i in range(n):
        fj, ft = jds.get_frame(i), tds.get_frame(i)
        assert ft.image.dtype == fj.image.dtype
        np.testing.assert_array_equal(ft.image, fj.image)
        np.testing.assert_array_equal(ft.disparity, fj.disparity)
        np.testing.assert_array_equal(ft.original, fj.original)
        assert ft.filename == fj.filename
    assert jds.get_frame(n) is None and tds.get_frame(n) is None


def _both(cfg_text, tmp_path):
    cfg = tmp_path / "ds.cfg"
    cfg.write_text(cfg_text)
    return (jdataset.create_dataset(JConfigFile(str(cfg))),
            dataset.create_dataset(ConfigFile(str(cfg)), device="cpu"))


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    """A 2-frame KITTI tree of the bench scene at 48x160, written by
    chip_smoke.py's writer."""
    root = str(tmp_path_factory.mktemp("kitti"))
    K, b, frames = synthetic.synthesize_stereo_sequence(2, 48, 160)
    _chip_smoke().write_kitti_tree(root, frames, K, b, scale=1.0)
    return root


@pytest.mark.parametrize("algorithm", ["TpuSGM", "TpuBlockMatching",
                                       "BlockMatching"])
def test_kitti_dataset_matches_jax(kitti_root, tmp_path, algorithm):
    """KITTI layout (image_0/image_1 PNGs, calib.txt P0/P1): the same
    images, calibration and matcher disparity as JAX's, bit for bit."""
    jds, tds = _both(
        f"Dataset = kitti\nDataSetRootDirectory = {kitti_root}\n"
        f"StereoAlgorithm = {algorithm}\nnumberOfDisparities = 32\n",
        tmp_path)
    _same_frames(jds, tds, 2)
    assert tds.get_frame(0).disparity.max() > 0


def test_kitti_calibration_matches_jax(tmp_path):
    from bpvo_tpu.data.kitti import load_kitti_calibration as jload
    from bpvo_tpu_torch.data.kitti import load_kitti_calibration
    calib = tmp_path / "calib.txt"
    calib.write_text(
        "P0: 718.856 0 607.1928 0 0 718.856 185.2157 0 0 0 1 0\n"
        "P1: 718.856 0 607.1928 -386.1448 0 718.856 185.2157 0 0 0 1 0\n")
    for s in (1, 2):
        j, t = jload(str(calib), s), load_kitti_calibration(str(calib), s)
        np.testing.assert_array_equal(t.K, j.K)
        assert t.baseline == j.baseline


@pytest.fixture(scope="module")
def tsukuba_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tsukuba"))
    _chip_smoke().write_tsukuba_tree(root, 2, rows=48, cols=64)
    return root


@pytest.mark.parametrize("name,extra", [
    ("tsukuba", ""),
    ("tsukuba_synthetic", "DisparityScale = 0.5\n"),
    ("tsukuba_stereo", "StereoAlgorithm = BlockMatching\n"
                       "numberOfDisparities = 32\nminDisparity = 0\n"),
    ("tsukuba_stereo", "StereoAlgorithm = TpuBlockMatching\n"
                       "numberOfDisparities = 32\nScaleBy = 2\n")])
def test_tsukuba_datasets_match_jax(tsukuba_root, tmp_path, name, extra):
    jds, tds = _both(f"Dataset = {name}\nDataSetRootDirectory = "
                     f"{tsukuba_root}\n{extra}", tmp_path)
    _same_frames(jds, tds, 2)


@pytest.mark.parametrize("calib", [
    "CRL Camera Config\nfx,fy,cx,cy: 600.0, 601.0, 320.5, 240.5\n"
    "xyzrpq: -0.25, 0, 0, 0, 0, 0\n",
    "CameraIntrinsicsPlumbBob{40,32,500.0,501.0,20.5,16.5,0,0}\n"
    "Transform3D(1,0,0,-0.3,0,1,0,0)\n",
    "610.0 611.0 20.0 16.0 0.2\n"])
def test_tunnel_dataset_matches_jax(tmp_path, calib):
    """conf/tunnel.cfg's layout (8-bit PGM images, 16-bit PGM disparity x16)
    with each calibration flavour."""
    rng = np.random.default_rng(0)
    for i in range(900, 903):
        cv2.imwrite(str(tmp_path / f"image{i:06d}.pgm"),
                    rng.integers(0, 255, (32, 40), np.uint8))
        cv2.imwrite(str(tmp_path / f"image{i:06d}-disparity.pgm"),
                    (rng.uniform(1, 64, (32, 40)) * 16).astype(np.uint16))
    (tmp_path / "stereoCalibration.txt").write_text(calib)
    jds, tds = _both(
        f"Dataset = tunnel\nDataSetRootDirectory = {tmp_path}\n"
        f"CalibrationFile = {tmp_path}/stereoCalibration.txt\n"
        "LeftImageFormat = image%06d.pgm\n"
        "DisparityMapFormat = image%06d-disparity.pgm\n"
        "firstFrameNumber = 900\n", tmp_path)
    _same_frames(jds, tds, 3)


@pytest.mark.parametrize("calib_keys", [True, False])
def test_stereo_and_disparity_datasets_match_jax(tmp_path, calib_keys):
    """The generic ``stereo`` (glob patterns, BGR images, ScaleBy 2) and
    ``disparity`` (PNG + PFM written by write_sequence) branches."""
    rng = np.random.default_rng(2)
    (tmp_path / "left").mkdir()
    (tmp_path / "right").mkdir()
    for i in range(2):
        img = _images(64, 96, seed=i)["bgr8"]
        cv2.imwrite(str(tmp_path / "left" / f"l{i:03d}.png"), img)
        cv2.imwrite(str(tmp_path / "right" / f"r{i:03d}.png"),
                    np.roll(img, -int(rng.integers(2, 6)), axis=1))
    calib = ("fx = 300\nfy = 301\ncx = 48\ncy = 32\nbaseline = 0.2\n"
             if calib_keys else
             f"CalibrationFile = {tmp_path}/calib.txt\n")
    (tmp_path / "calib.txt").write_text("300 301 48 32 0.2\n")
    jds, tds = _both(
        f"Dataset = stereo\nDataSetRootDirectory = {tmp_path}\n"
        "LeftImageFormat = left/l*.png\nRightImageFormat = right/r*.png\n"
        "StereoAlgorithm = TpuBlockMatching\nnumberOfDisparities = 16\n"
        f"ScaleBy = 2\n{calib}", tmp_path)
    _same_frames(jds, tds, 2)
    seq = str(tmp_path / "seq")
    synthetic.write_sequence(synthetic.SyntheticPlaneDataset(
        rows=40, cols=56, n_frames=3, texture="noise"), seq)
    jds, tds = _both(
        f"Dataset = disparity\nDataSetRootDirectory = {seq}\n"
        f"CalibrationFile = {seq}/calib.txt\n", tmp_path)
    _same_frames(jds, tds, 3)


_SYNTHETIC = {"synthetic": "SyntheticPlaneDataset",
              "synthetic_corridor": "SyntheticCorridorDataset",
              "synthetic_occluder": "SyntheticOccluderDataset",
              "synthetic_stereo": "SyntheticStereoPlaneDataset"}


@pytest.mark.parametrize("name", sorted(_SYNTHETIC))
def test_synthetic_datasets_match_jax(tmp_path, name):
    """The synthetic scenes from their config branch: the same calibration
    and ground truth, the rendered images within atol 1e-3 and the exact
    disparities within rtol 1e-5 (the per-frame SE(3) step comes from each
    package's own se3.exp, ~1 ulp apart; frame 0 is bitwise).  The stereo
    scene's matcher disparity is held at 1e-3 where both are valid."""
    extra = ("StereoAlgorithm = TpuBlockMatching\nnumberOfDisparities = 48\n"
             if name == "synthetic_stereo" else "")
    jds, tds = _both(f"Dataset = {name}\nSyntheticRows = 40\n"
                     f"SyntheticCols = 56\nSyntheticNumFrames = 3\n{extra}",
                     tmp_path)
    assert type(tds).__name__ == _SYNTHETIC[name] == type(jds).__name__
    assert tds.name == jds.name and tds.image_size == jds.image_size
    np.testing.assert_array_equal(tds.calibration.K, jds.calibration.K)
    for i in range(3):
        fj, ft = jds.get_frame(i), tds.get_frame(i)
        np.testing.assert_allclose(ft.image, fj.image, atol=1e-3)
        if name == "synthetic_stereo":
            ok = (fj.disparity > 0) & (ft.disparity > 0)
            assert ok.mean() > 0.3
            np.testing.assert_allclose(ft.disparity[ok], fj.disparity[ok],
                                       atol=1e-3)
        else:
            np.testing.assert_allclose(ft.disparity, fj.disparity, rtol=1e-5)
        np.testing.assert_allclose(tds.gt_world_pose(i), jds.gt_world_pose(i),
                                   atol=1e-6)
    np.testing.assert_array_equal(tds.get_frame(0).image,
                                  jds.get_frame(0).image)
    assert tds.get_frame(3) is None


def test_illumination_dataset_and_write_sequence_match_jax(tmp_path):
    jds = jsynthetic.SyntheticIlluminationDataset(rows=40, cols=56,
                                                  n_frames=3)
    tds = synthetic.SyntheticIlluminationDataset(rows=40, cols=56,
                                                 n_frames=3)
    for i in range(3):
        np.testing.assert_allclose(tds.get_frame(i).image,
                                   jds.get_frame(i).image, atol=1e-3)
    # write_sequence: the same pixels, disparities, calibration and ground
    # truth on disk (the PNG encoders differ, the pixels do not)
    assert jsynthetic.write_sequence(jds, str(tmp_path / "j")) == 3
    assert synthetic.write_sequence(tds, str(tmp_path / "t")) == 3
    for i in range(3):
        for sub in ("left", "disp"):
            ext = "png" if sub == "left" else "pfm"
            a = cv2.imread(str(tmp_path / "j" / sub / f"{i:06d}.{ext}"),
                           cv2.IMREAD_UNCHANGED)
            b = imageio.imread(str(tmp_path / "t" / sub / f"{i:06d}.{ext}"))
            if sub == "left":
                np.testing.assert_array_equal(b, a)
            else:
                np.testing.assert_allclose(b, a, rtol=1e-5)
    assert (tmp_path / "t" / "calib.txt").read_text() == (
        tmp_path / "j" / "calib.txt").read_text()
    np.testing.assert_allclose(np.loadtxt(tmp_path / "t" / "gt_kitti.txt"),
                               np.loadtxt(tmp_path / "j" / "gt_kitti.txt"),
                               atol=1e-6)


def test_file_sequence_and_missing_first_frame(tmp_path):
    seq = dataset.FileSequence(str(tmp_path), "img_%04d.png", first_frame=3)
    jseq = jdataset.FileSequence(str(tmp_path), "img_%04d.png", first_frame=3)
    assert seq[0] == jseq[0] and seq[2] == jseq[2] and not seq.exists(0)
    with pytest.raises(FileNotFoundError):
        dataset.DisparityDataset(seq, seq, dataset.StereoCalibration(
            np.eye(3, dtype=np.float32), 0.1))
    with pytest.raises(ValueError, match="unknown dataset"):
        dataset.create_dataset(ConfigFile().set("Dataset", "nope"),
                               device="cpu")


# ---------------------------------------------------------------------------
# TpuBlockMatching against JAX's _block_matching
# ---------------------------------------------------------------------------

def _pair(rows, cols):
    K, b, frames = synthetic.synthesize_stereo_sequence(1, rows, cols)
    return tuple(np.clip(np.round(img), 0, 255).astype(np.uint8)
                 for img in frames[0][:2])


@pytest.mark.parametrize("kw", [
    dict(num_disparities=32), dict(num_disparities=64),
    dict(num_disparities=48, sad_window=5, uniqueness_ratio=5.0),
    dict(num_disparities=64, subpixel=False, lr_check=False)])
def test_block_matching_bitwise_at_96x128(kw):
    """At 96x128 every box-filter prefix sum stays below 2^24, so the
    float32 sums are exact in any order: bit for bit JAX's jitted
    ``_block_matching`` (its division by k^2 compiled to a product by the
    reciprocal, which the port keeps)."""
    L, R = _pair(96, 128)
    want = jstereo.TpuBlockMatching(**kw).run(L, R)
    got = stereo.TpuBlockMatching(**kw).run(L, R, device="cpu")
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert (got > 0).mean() > 0.1
    # the stereo_fn form on tensors is the same function
    np.testing.assert_array_equal(
        stereo.TpuBlockMatching(**kw).as_fn()(
            torch.as_tensor(L), torch.as_tensor(R)).numpy(), got)


def test_block_matching_equal_share_at_240x320():
    """At 240x320x64 the prefix sums pass 2^24 and the summation order
    could round differently; on the CPU torch's cumulative sums run in
    XLA's order.  Floor: 99.9% of the pixels equal (measured: 100%); the
    card's share is measured by tests/test_torch_data_gpu.py and
    chip_smoke.py (ROADMAP C, accepted delta g)."""
    L, R = _pair(240, 320)
    want = jstereo.TpuBlockMatching(num_disparities=64).run(L, R)
    got = stereo.TpuBlockMatching(num_disparities=64).run(L, R, device="cpu")
    share = float(np.mean(got.view(np.int32) == want.view(np.int32)))
    print(f"TpuBlockMatching 240x320x64, port vs JAX on the CPU: "
          f"{share:.6f} of the pixels bitwise equal")
    assert share >= 0.999


def test_matchers_need_their_device_or_cv2(monkeypatch):
    L, R = _pair(48, 64)
    if not torch.cuda.is_available():
        for alg in (stereo.TpuBlockMatching(num_disparities=16),
                    stereo.TpuSGM(num_disparities=16)):
            with pytest.raises(RuntimeError, match="CUDA"):
                alg.run(L, R)
    # without cv2 the OpenCV matchers raise a clear error
    import builtins
    real_import = builtins.__import__

    def no_cv2(name, *a, **k):
        if name == "cv2":
            raise ImportError("No module named 'cv2'")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    for name in ("BlockMatching", "SGBM"):
        with pytest.raises(RuntimeError, match="needs cv2"):
            stereo.create_stereo_algorithm(
                ConfigFile().set("StereoAlgorithm", name))


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

def _trajectory(n, rng, drift):
    poses, T = [], np.eye(4)
    for _ in range(n):
        poses.append(T.copy())
        step = np.eye(4)
        a = 0.01 * rng.normal() + drift
        step[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                        [-np.sin(a), 0, np.cos(a)]]
        step[:3, 3] = [0.1 * rng.normal(), 0.02 * rng.normal(), 1.6]
        T = T @ step
    return poses


def test_kitti_eval_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    gt = _trajectory(420, rng, 0.0)
    est = [g @ np.diag([1, 1, 1, 1.0]) for g in _trajectory(
        420, np.random.default_rng(1), 0.001)]
    for name, poses in (("gt", gt), ("est", est)):
        with open(tmp_path / f"{name}.txt", "w") as f:
            for T in poses:
                f.write(" ".join(f"{v:.12e}" for v in T[:3].ravel()) + "\n")
    g, e = (kitti_eval.load_poses(str(tmp_path / f"{n}.txt"))
            for n in ("gt", "est"))
    gj, ej = (jkitti_eval.load_poses(str(tmp_path / f"{n}.txt"))
              for n in ("gt", "est"))
    np.testing.assert_array_equal(np.stack(g), np.stack(gj))
    np.testing.assert_allclose(kitti_eval.trajectory_distances(g),
                               jkitti_eval.trajectory_distances(gj),
                               rtol=0, atol=1e-12)
    errs = kitti_eval.calc_sequence_errors(g, e)
    jerrs = jkitti_eval.calc_sequence_errors(gj, ej)
    assert len(errs) == len(jerrs) > 100
    for a, b in zip(errs, jerrs):
        assert (a.first_frame, a.length) == (b.first_frame, b.length)
        for f in ("r_err", "t_err", "speed"):
            assert abs(getattr(a, f) - getattr(b, f)) <= 1e-12
    s, sj = kitti_eval.summarize(errs), jkitti_eval.summarize(jerrs)
    assert s.num_segments == sj.num_segments
    assert abs(s.t_err_percent - sj.t_err_percent) <= 1e-12
    assert abs(s.r_err_deg_per_m - sj.r_err_deg_per_m) <= 1e-12
    assert abs(kitti_eval.ate_rmse(g, e) - jkitti_eval.ate_rmse(gj, ej)) \
        <= 1e-12
    kitti_eval.save_error_plot_data(errs, str(tmp_path / "t"))
    jkitti_eval.save_error_plot_data(jerrs, str(tmp_path / "j"))
    for suffix in ("tl", "rl", "ts", "rs"):
        assert (tmp_path / f"t_{suffix}.txt").read_text() == (
            tmp_path / f"j_{suffix}.txt").read_text()
    st = kitti_eval.evaluate_sequence(str(tmp_path / "gt.txt"),
                                      str(tmp_path / "est.txt"))
    assert abs(st.t_err_percent - sj.t_err_percent) <= 1e-12
    assert kitti_eval.summarize([]).num_segments == 0


def test_tsukuba_eval_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    rows = np.cumsum(rng.normal(size=(20, 6)) * [5, 5, 5, 1, 1, 1], axis=0)
    (tmp_path / "camera_track.txt").write_text(
        "\n".join(", ".join(f"{v:.6f}" for v in r) for r in rows) + "\n")
    path = str(tmp_path / "camera_track.txt")
    for left in (True, False):
        a = tsukuba_eval.load_camera_track(path, left)
        b = jtsukuba_eval.load_camera_track(path, left)
        np.testing.assert_allclose(np.stack(a), np.stack(b), rtol=0,
                                   atol=1e-12)
    est = [T @ np.diag([1, 1, 1, 1.0]) + 1e-3 * i
           for i, T in enumerate(jtsukuba_eval.load_camera_track(path))]
    a = tsukuba_eval.evaluate_trajectory(path, est)
    b = jtsukuba_eval.evaluate_trajectory(path, est)
    assert a.keys() == b.keys() and a["frames"] == b["frames"] == 20
    for k in ("ate_rmse_m", "final_drift_m"):
        assert abs(a[k] - b[k]) <= 1e-12


# ---------------------------------------------------------------------------
# the loader
# ---------------------------------------------------------------------------

def _plane(n):
    return synthetic.SyntheticPlaneDataset(rows=24, cols=32, n_frames=n)


def test_loader_order_max_frames_and_end():
    with loader.DatasetLoaderThread(_plane(6), buffer_size=2) as ld:
        names = [f.filename for f in ld]
        assert ld.pop(timeout=0.5) is None          # the end, again
    assert names == [f"synthetic/{i:06d}" for i in range(6)]
    with loader.DatasetLoaderThread(_plane(100), buffer_size=2,
                                    max_frames=4, start_frame=3) as ld:
        frames = list(ld)
    assert [f.filename for f in frames] == [f"synthetic/{i:06d}"
                                            for i in range(3, 7)]
    assert isinstance(frames[0].image, np.ndarray)


def test_loader_stop_and_cpu_tensors():
    ld = loader.DatasetLoaderThread(_plane(1000), buffer_size=2,
                                    device="cpu")
    first = ld.pop(timeout=10.0)
    assert isinstance(first.image, torch.Tensor)
    assert first.image.dtype == torch.float32
    np.testing.assert_array_equal(first.image.numpy(),
                                  _plane(1).get_frame(0).image)
    ld.stop()
    assert not ld.is_running()


def test_loader_raises_what_the_dataset_raised():
    class Failing(dataset.Dataset):
        def get_frame(self, i):
            if i == 2:
                raise OSError("disk gone")
            return _plane(3).get_frame(i)

    got = []
    with pytest.raises(OSError, match="disk gone"):
        with loader.DatasetLoaderThread(Failing(), buffer_size=4) as ld:
            for f in ld:
                got.append(f)
    assert len(got) == 2


# ---------------------------------------------------------------------------
# checkpoints the JAX package wrote
# ---------------------------------------------------------------------------

_CKPT_KW = dict(minSaliency=2.0, numPyramidLevels=3, functionTolerance=1e-4,
                parameterTolerance=1e-6, maxIterations=50,
                pointCapacity=2048, minTranslationMagToKeyFrame=0.015)


def _ckpt_setup():
    from test_gn import H_IMG, W_IMG, make_cam
    from test_odometry import make_sequence
    cam = make_cam()
    return (np.asarray(cam.K()), float(cam.baseline), (H_IMG, W_IMG),
            make_sequence([0, 0, 0, 0.004, 0, 0.008], 7))


def test_visual_odometry_loads_a_jax_checkpoint(tmp_path):
    """JAX's VisualOdometry.save after 4 frames (keyframe, candidate and
    trajectory) loads into the port, which then follows JAX's own
    continuation for 3 frames within accepted delta (b), with the same
    keyframes; the port's own save round-trips."""
    from bpvo_tpu import AlgorithmParameters as JParams
    from bpvo_tpu import VisualOdometry as JVisualOdometry
    from bpvo_tpu_torch import AlgorithmParameters, VisualOdometry
    K, b, size, frames = _ckpt_setup()
    jvo = JVisualOdometry(K, b, size, JParams(**_CKPT_KW))
    for I, D in frames[:4]:
        jvo.add_frame(I, D)
    path = str(tmp_path / "jax_vo")
    jvo.save(path)
    tvo = VisualOdometry(K, b, size, AlgorithmParameters(**_CKPT_KW),
                         device="cpu")
    tvo.load(path)
    assert len(tvo.trajectory) == 4
    np.testing.assert_array_equal(np.stack(tvo.trajectory.poses),
                                  np.stack(jvo.trajectory.poses))
    assert tvo.num_points_at_level(0) == jvo.num_points_at_level(0)
    for I, D in frames[4:]:
        rj, rt = jvo.add_frame(I, D), tvo.add_frame(I, D)
        assert rt.is_keyframe == rj.is_keyframe
        np.testing.assert_allclose(rt.pose, rj.pose, atol=1.8e-4)
    np.testing.assert_allclose(np.stack(tvo.trajectory.poses),
                               np.stack(jvo.trajectory.poses), atol=1.8e-4)
    tvo.save(str(tmp_path / "port_vo"))
    again = VisualOdometry(K, b, size, AlgorithmParameters(**_CKPT_KW),
                           device="cpu")
    again.load(str(tmp_path / "port_vo.npz"))
    np.testing.assert_array_equal(np.stack(again.trajectory.poses),
                                  np.stack(tvo.trajectory.poses))
    assert again.num_points_at_level(0) == tvo.num_points_at_level(0)


def test_device_vo_loads_a_jax_state_checkpoint(tmp_path):
    """A ``save_vo_state`` file of JAX's DeviceVO (``state::<path>`` keys)
    loads into the port's VOState; the port's DeviceVO continues 3 frames
    within (b) of JAX's continuation, and its own file round-trips with
    the same keys."""
    from bpvo_tpu import AlgorithmParameters as JParams
    from bpvo_tpu.utils import checkpoint as jcheckpoint
    from bpvo_tpu.vo.device_vo import DeviceVO as JDeviceVO
    from bpvo_tpu.vo.trajectory import Trajectory as JTrajectory
    from bpvo_tpu_torch import AlgorithmParameters
    from bpvo_tpu_torch.utils import checkpoint
    from bpvo_tpu_torch.vo.device_vo import DeviceVO
    K, b, size, frames = _ckpt_setup()
    jvo = JDeviceVO(K, b, size, JParams(**_CKPT_KW))
    for I, D in frames[:4]:
        jvo.add_frame(I, D)
    tr = JTrajectory()
    tr.push(np.eye(4))
    path = str(tmp_path / "state.npz")
    jcheckpoint.save_vo_state(path, jvo.state, tr, {"frame": 4})
    state, traj, meta = checkpoint.load_vo_state(path, device="cpu")
    assert meta == {"frame": 4} and traj.shape == (1, 4, 4)
    assert len(state.templates) == 3 and len(state.prev_channels) == 3
    np.testing.assert_array_equal(state.T_kf.numpy(),
                                  np.asarray(jvo.state.T_kf))
    assert state.has_prev == bool(jvo.state.has_prev)
    tvo = DeviceVO(K, b, size, AlgorithmParameters(**_CKPT_KW), device="cpu")
    tvo.state = state
    for I, D in frames[4:]:
        oj, ot = jvo.add_frame(I, D), tvo.add_frame(I, D)
        np.testing.assert_allclose(ot.pose.numpy(), np.asarray(oj.pose),
                                   atol=1.8e-4)
        np.testing.assert_allclose(ot.pose_world.numpy(),
                                   np.asarray(oj.pose_world), atol=1.8e-4)
        assert bool(ot.is_keyframe) == bool(oj.is_keyframe)
    mine = str(tmp_path / "port_state")
    checkpoint.save_vo_state(mine, tvo.state, metadata={"frame": 7})
    with np.load(mine + ".npz") as a, np.load(path) as b_:
        assert set(a.files) - {"trajectory"} == set(b_.files) - {"trajectory"}
    back, _, meta = checkpoint.load_vo_state(mine, device="cpu")
    assert meta == {"frame": 7}
    for x, y in zip(back.templates[0], tvo.state.templates[0]):
        assert torch.equal(x, y)


def test_device_entry_points_default_to_cuda(tmp_path):
    """Without a CUDA device every new entry point raises unless the caller
    asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from bpvo_tpu_torch.utils import checkpoint
    with pytest.raises(RuntimeError, match="CUDA"):
        dataset.create_dataset(ConfigFile().set("Dataset", "synthetic"))
    with pytest.raises(RuntimeError, match="CUDA"):
        synthetic.SyntheticStereoPlaneDataset(rows=24, cols=32, n_frames=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        loader.DatasetLoaderThread(_plane(2), device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        checkpoint.load_vo_state(str(tmp_path / "none.npz"))
