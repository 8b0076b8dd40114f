"""``profiling.device_read`` and ``profiling.upload`` on the card
(``gpu``-marked; they skip without CUDA): a read lands in page-locked host
memory of its own, bit for bit the tensor's, which no later read writes
into, and on the online path (``TpuSGM.run`` then
``VisualOdometry.add_frame``, the images on the card) every byte copied
between host and card moves from or into page-locked memory."""
import numpy as np
import pytest
import torch

from bpvo_tpu_torch import AlgorithmParameters, VisualOdometry
from bpvo_tpu_torch.data import synthetic
from bpvo_tpu_torch.data.stereo import TpuSGM
from bpvo_tpu_torch.utils import profiling


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: page-locked host memory and "
                    "copies from the card exist only with one")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _clean_recorder():
    profiling.reset()
    yield
    profiling.reset()


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint8)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.uint8, torch.int64])
def test_device_read_is_pinned_and_exact(cuda, dtype):
    t = (torch.randn(376, 1241, device=cuda) * 100).to(dtype)
    got = profiling.device_read("sgm.read", t)
    assert torch.from_numpy(got).is_pinned()
    want = t.cpu().numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(_bits(got), _bits(want))
    n = t.numel() * t.element_size()
    assert profiling.counts() == {"device_reads": 1, "d2h_bytes": n,
                                  "d2h_pinned_bytes": n}


@pytest.mark.gpu
def test_held_reads_share_no_memory(cuda):
    """130 reads of different tensors, all held (as a caller that keeps
    every disparity): none shares memory with a later one, and each still
    holds its own tensor's values once all are read."""
    base = torch.randn(376, 1241, device=cuda)
    held = []
    for k in range(130):
        got = profiling.device_read("sgm.read", base + k)
        assert not any(np.shares_memory(a, got) for a in held), k
        held.append(got)
    for k, a in enumerate(held):
        assert np.array_equal(a, (base + k).cpu().numpy()), k


@pytest.mark.gpu
def test_online_frames_copy_only_pinned_memory(cuda):
    """With the stereo pairs on the card, the disparity down and up, the
    estimates' starts and results and the keyframes' clouds all move from
    or into page-locked memory."""
    K, b, frames = synthetic.synthesize_stereo_sequence(8, 120, 320)
    vo = VisualOdometry(K, b, (120, 320), AlgorithmParameters(
        numPyramidLevels=3, minTranslationMagToKeyFrame=0.02), device=cuda)
    sgm = TpuSGM(num_disparities=64)
    keyframes = 0
    for left, right, _ in frames:
        left, right = (torch.from_numpy(x).to(cuda) for x in (left, right))
        disp = sgm.run(left, right, device=cuda)
        assert torch.from_numpy(disp).is_pinned()
        keyframes += vo.add_frame(left, disp).is_keyframe
    c = profiling.counts()
    assert keyframes > 1
    assert c["device_reads"] >= 2 * len(frames) - 1
    assert c["h2d_bytes"] > 0 and c["d2h_bytes"] > 0
    assert c["h2d_pinned_bytes"] == c["h2d_bytes"]
    assert c["d2h_pinned_bytes"] == c["d2h_bytes"]
