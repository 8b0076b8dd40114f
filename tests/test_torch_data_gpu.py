"""The data layer on the card (``gpu``-marked; they skip without CUDA):
the loader's pinned-memory prefetch against unprefetched frames, the
threaded and prefetched app against an unthreaded run with CUDA graphs
captured while the loader thread runs its matcher, and ``TpuBlockMatching``
on the card against its CPU run."""
import importlib.util
import os

import numpy as np
import pytest
import torch

from bpvo_tpu_torch.apps.vo_app import VoApp
from bpvo_tpu_torch.data import loader, stereo, synthetic
from bpvo_tpu_torch.utils import graphs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the prefetch, the matcher's "
                    "kernels and CUDA graphs run only on the GPU")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    """A 1+9 frame KITTI tree of the bench scene at 120x320 (chip_smoke.py's
    writer)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    K, b, frames = synthetic.synthesize_stereo_sequence(10, 120, 320)
    return cs.write_kitti_tree(str(tmp_path_factory.mktemp("kitti")), frames,
                               K, b, scale=1.0)


def _config(tmp_path, root, dense):
    cfg = tmp_path / ("dense.cfg" if dense else "sparse.cfg")
    text = (f"Dataset = kitti\nDataSetRootDirectory = {root}\n"
            "StereoAlgorithm = TpuSGM\nnumberOfDisparities = 64\n"
            "descriptor = Intensity\nnumPyramidLevels = 3\nminSaliency = 2.0\n"
            "functionTolerance = 1e-4\nparameterTolerance = 1e-6\n"
            "maxIterations = 50\nminTranslationMagToKeyFrame = 0.1\n")
    if dense:
        # NMS off and room for every pixel: L0 (38400 points) goes to
        # gauss_newton.run, whose iterations replay CUDA graphs
        text += ("minNumPixelsForNonMaximaSuppression = 20000000\n"
                 "pointCapacity = 65536\n")
    cfg.write_text(text)
    return str(cfg)


@pytest.mark.gpu
def test_prefetch_equals_unprefetched_frames(cuda, kitti_root, tmp_path):
    """Frames through pinned buffers and the loader's copy stream (its
    matcher on that stream too) equal the frames read directly, bit for
    bit; the consumer reads them on its own stream."""
    from bpvo_tpu_torch.data.dataset import create_dataset
    ds = create_dataset(_config(tmp_path, kitti_root, False), device=cuda)
    with loader.DatasetLoaderThread(ds, buffer_size=3, device=cuda) as ld:
        got = list(ld)
    assert len(got) == 10
    for i, f in enumerate(got):
        want = ds.get_frame(i)
        assert f.image.is_cuda and f.disparity.is_cuda
        np.testing.assert_array_equal(f.image.cpu().numpy(),
                                      want.image.astype(np.float32))
        np.testing.assert_array_equal(f.disparity.cpu().numpy(),
                                      want.disparity)


@pytest.mark.gpu
@pytest.mark.parametrize("dense", [False, True])
def test_threaded_app_equals_unthreaded_with_graphs(cuda, kitti_root,
                                                    tmp_path, dense):
    """The threaded, prefetched app (census and SGM launched from the loader
    thread on its stream) and an unthreaded run give the same trajectory
    and iterations bit for bit.  Dense: the pose estimator captures its
    iteration graphs during the threaded run, while the loader thread keeps
    launching (thread-local capture); the launch counts stay exact."""
    from bpvo_tpu_torch.ops import census, level_gn, sgm
    runs = {}
    for threaded in (True, False):
        for mod in (census, level_gn, sgm):
            mod.launch_count = 0
        replays = graphs.replay_count
        app = VoApp.from_config(_config(tmp_path, kitti_root, dense),
                                device=cuda, threaded=threaded)
        res = app.run()
        assert (graphs.replay_count > replays) == dense
        runs[threaded] = (np.stack(res.vo.trajectory.poses), res.iterations,
                          census.launch_count, sgm.launch_count,
                          level_gn.launch_count)
        # the dataset read frame 0 once when it was built
        assert census.launch_count == 2 * (res.num_frames + 1)
        assert sgm.launch_count == res.num_frames + 1
    (pa, ia, *ca), (pb, ib, *cb) = runs[True], runs[False]
    np.testing.assert_array_equal(pa, pb)
    assert ia == ib and ca == cb


@pytest.mark.gpu
def test_block_matching_card_equals_cpu(cuda):
    """Bitwise at 96x128 (exact prefix sums); at 240x320x128 the card's
    parallel cumulative sums may round where the sums pass 2^24: the share
    of equal pixels must stay at or above 99% (ROADMAP C, accepted delta
    g), and it is printed."""
    for rows, cols, D, floor in ((96, 128, 64, 1.0), (240, 320, 128, 0.99)):
        K, b, frames = synthetic.synthesize_stereo_sequence(1, rows, cols)
        L, R = (np.clip(np.round(x), 0, 255).astype(np.uint8)
                for x in frames[0][:2])
        bm = stereo.TpuBlockMatching(num_disparities=D)
        cpu = bm.run(L, R, device="cpu")
        gpu = bm.run(L, R, device=cuda)
        share = float(np.mean(cpu.view(np.int32) == gpu.view(np.int32)))
        print(f"TpuBlockMatching {rows}x{cols}x{D} card vs CPU: {share:.6f} "
              "of the pixels bitwise equal")
        assert share >= floor
