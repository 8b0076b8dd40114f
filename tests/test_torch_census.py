"""The port's census transform, Gaussian smoothing and Bit-Planes descriptor
(their plain versions, which the wrappers take for CPU tensors) against
``bpvo_tpu`` on the same numpy inputs.

Tolerances: the census planes are compared bit for bit (a comparison of
equal floats has one answer).  ``imsmooth`` takes the JAX package's
slice-and-accumulate order and is held to it bit for bit.  End to end
through the pyramid the two packages' ``pyr_down`` round differently (two
matrix products in another summation order, ~3e-5 grey levels), so a census
comparison between two nearly equal neighbours may flip; there the share of
flipped bits is held to FLIP_BOUND, and the descriptor to the bit-flip's
effect on the 5x5 smoothing."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpvo_tpu.ops import census as jcensus
from bpvo_tpu.ops import descriptors as jdesc
from bpvo_tpu.ops import imgproc as jimg
from bpvo_tpu.ops.pallas.census_kernel import census_planes_pallas
from bpvo_tpu_torch.config import AlgorithmParameters
from bpvo_tpu_torch.ops import census, descriptors, imgproc
from bpvo_tpu_torch.types import DescriptorType
from conftest import synthetic_image

# share of census bits allowed to flip through a 4-level pyramid (measured
# on the CPU: 0 on both images)
FLIP_BOUND = 2e-3


def _t(a):
    return torch.as_tensor(np.array(a, np.float32))


def _images():
    img = synthetic_image(32, 256)
    # quantized to 8 grey levels: most neighbours tie with the centre
    ties = np.round(synthetic_image(32, 256, seed=1) / 32.0) * 32.0
    return {"noise": img, "ties": ties}


@pytest.mark.parametrize("name", ["noise", "ties"])
def test_census_planes_bitwise(name):
    img = _images()[name]
    got = census.census_planes(_t(img)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jcensus.census_planes(jnp.asarray(img))))
    np.testing.assert_array_equal(
        got, np.asarray(census_planes_pallas(jnp.asarray(img),
                                             interpret=True)))
    assert got.shape == (8, 32, 256) and set(np.unique(got)) <= {0.0, 1.0}
    # both border rows and columns are zero, and the image has both bits
    assert not got[:, [0, -1], :].any() and not got[:, :, [0, -1]].any()
    assert 0.2 < got[:, 1:-1, 1:-1].mean() < 0.9


def test_census_planes_batched_and_cpu_only():
    """Leading axes are carried through; CPU tensors never launch the
    kernel."""
    imgs = np.stack(list(_images().values()))
    before = census.launch_count
    got = census.census_planes(_t(imgs)).numpy()
    assert census.launch_count == before
    np.testing.assert_array_equal(
        got, np.asarray(jcensus.census_planes(jnp.asarray(imgs))))
    with pytest.raises(ValueError):
        census.census_planes(_t(imgs).to("meta"))


@pytest.mark.parametrize("name", ["noise", "ties"])
def test_census_packed_and_extract(name):
    img = _images()[name]
    packed = census.census(_t(img))
    ref = np.asarray(jcensus.census(jnp.asarray(img)))
    assert packed.dtype == torch.uint8
    np.testing.assert_array_equal(packed.numpy(), ref)
    np.testing.assert_array_equal(
        census.extract_bitplanes(packed).numpy(),
        np.asarray(jcensus.extract_bitplanes(jnp.asarray(ref))))
    # unpacking the packed code gives the planes back
    np.testing.assert_array_equal(census.extract_bitplanes(packed).numpy(),
                                  census.census_planes(_t(img)).numpy())


@pytest.mark.parametrize("ksize", [3, 5])
@pytest.mark.parametrize("sigma", [0.5, 1.2])
def test_imsmooth_matches_jax(ksize, sigma):
    img = synthetic_image()
    stack = np.stack([img, img[::-1].copy() * 0.5])
    for x in (img, stack):
        np.testing.assert_array_equal(
            imgproc.imsmooth(_t(x), sigma, ksize=ksize).numpy(),
            np.asarray(jimg.imsmooth(jnp.asarray(x), sigma, ksize=ksize)))
    np.testing.assert_array_equal(
        imgproc.gaussian_kernel_1d(ksize, sigma),
        jimg.gaussian_kernel_1d(ksize, sigma))
    x = _t(img)
    assert imgproc.imsmooth(x, 0.0) is x          # sigma <= 0: no smoothing


def test_bitplanes_bitwise_on_identical_input():
    """Fed JAX's pre-smoothed image, the port's census and 5x5 smoothing
    give JAX's descriptor bit for bit; so does the whole descriptor from
    the same raw image."""
    img = synthetic_image()
    pre = np.asarray(jimg.imsmooth(jnp.asarray(img), 0.5, ksize=3))
    planes = census.census_planes(_t(pre))
    np.testing.assert_array_equal(
        planes.numpy(), np.asarray(jcensus.census_planes(jnp.asarray(pre))))
    np.testing.assert_array_equal(
        imgproc.imsmooth(planes, 0.5, ksize=5).numpy(),
        np.asarray(jdesc.bitplanes(jnp.asarray(img), 0.5, 0.5)))
    np.testing.assert_array_equal(
        descriptors.bitplanes(_t(img), 0.5, 0.5).numpy(),
        np.asarray(jdesc.bitplanes(jnp.asarray(img), 0.5, 0.5)))
    # without the pre-smoothing
    np.testing.assert_array_equal(
        descriptors.bitplanes(_t(img), -1.0, 0.5).numpy(),
        np.asarray(jdesc.bitplanes(jnp.asarray(img), -1.0, 0.5)))


@pytest.mark.parametrize("name", ["noise", "ties"])
def test_bitplanes_pyramid_flip_bound(name):
    """Through 4 pyramid levels, each package's own pyr_down: the share of
    flipped census bits stays under FLIP_BOUND, and the descriptor differs
    only where a flipped bit's 5x5 smoothing reaches."""
    j = jnp.asarray(_images()[name])
    t = _t(_images()[name])
    flips = total = 0
    for _ in range(4):
        pj = np.asarray(jcensus.census_planes(jimg.imsmooth(j, 0.5, ksize=3)))
        pt = census.census_planes(imgproc.imsmooth(t, 0.5, ksize=3)).numpy()
        flips += int((pj != pt).sum())
        total += pj.size
        dj = np.asarray(jdesc.bitplanes(j, 0.5, 0.5))
        dt = descriptors.bitplanes(t, 0.5, 0.5).numpy()
        # one flipped bit moves a smoothed plane by at most the 5x5
        # kernel's centre weight; the others agree to f32 rounding
        g = imgproc.gaussian_kernel_1d(5, 0.5)
        np.testing.assert_allclose(dt, dj, atol=float(g.max() ** 2) + 1e-6)
        j, t = jimg.pyr_down(j), imgproc.pyr_down(t)
    assert flips / total <= FLIP_BOUND, (flips, total)


def test_descriptor_compute_and_num_channels():
    img = _t(synthetic_image())
    p = AlgorithmParameters(descriptor=DescriptorType.BITPLANES,
                            sigmaPriorToCensusTransform=0.5)
    ch = descriptors.compute(img, p)
    assert ch.shape == (8, 120, 160)
    np.testing.assert_array_equal(ch.numpy(), descriptors.bitplanes(img, 0.5,
                                                                    0.5))
    assert descriptors.num_channels(DescriptorType.BITPLANES, p) == 8
    assert descriptors.num_channels(DescriptorType.INTENSITY, p) == 1
    # LATCH, once refused: 8 channels per latchNumBytes
    assert descriptors.num_channels(DescriptorType.LATCH, p) == 8
    assert descriptors.num_channels(
        DescriptorType.LATCH, p.replace(latchNumBytes=4)) == 32
