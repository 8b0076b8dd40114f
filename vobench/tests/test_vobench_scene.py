"""The device renderer against the port's numpy scene, at a small size."""
import numpy as np
import torch
from scipy.ndimage import gaussian_filter

from bpvo_tpu_torch.data import synthetic
from vobench import scene


def test_noise_smoothing_is_scipys_wrapped_gaussian():
    g = torch.randn(64, 64, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(3))
    want = gaussian_filter(g.numpy(), scene.GRID_SIGMA, mode="wrap")
    got = scene._gaussian_wrap(g, scene.GRID_SIGMA).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_noise_grid_follows_the_seed():
    a = scene.noise_grid(scene.sub_seed(2 ** 31 + 5, 0), "cpu")
    b = scene.noise_grid(scene.sub_seed(2 ** 31 + 5, 0), "cpu")
    c = scene.noise_grid(scene.sub_seed(2 ** 31 + 5, 1), "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert abs(float(a.double().std(unbiased=False)) - 1.0) < 1e-5


def test_renderer_matches_the_ports_scene():
    rows, cols, n = 24, 40, 4
    grid = torch.from_numpy(synthetic._noise_grid(7).copy())
    cam = scene.Camera(rows, cols, synthetic.FX, synthetic.BASELINE)
    sc = scene.Scene(cam, [0.12, 0.22, 1.0], 8.0, torch.device("cpu"))
    seq = scene.render_sequence(sc, grid, synthetic.STEP_TWIST, n,
                                stereo=True)
    _, _, frames = synthetic.synthesize_stereo_sequence(n, rows, cols)
    for i, (left, right, disp) in enumerate(frames):
        np.testing.assert_allclose(seq.images[i].numpy(), left, atol=2e-3)
        np.testing.assert_allclose(seq.rights[i].numpy(), right, atol=2e-3)
        np.testing.assert_allclose(seq.disparities[i].numpy(), disp,
                                   rtol=1e-5)
    np.testing.assert_allclose(scene.step_pose(synthetic.STEP_TWIST),
                               synthetic.step_pose(), atol=1e-7)
