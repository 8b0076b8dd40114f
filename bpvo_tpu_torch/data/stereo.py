"""Stereo disparity (counterpart of ``bpvo_tpu/data/stereo.py``; the
classes keep their names so a reader finds their counterparts).

- ``TpuSGM``: semi-global matching over a census Hamming cost.  The census
  planes of both images come from ``ops.census`` (kernel ``csrc/census.cu``
  on the card), the cost volume from ``ops.census_cost`` (kernel
  ``csrc/census_cost.cu``), and the 4-direction aggregation with the
  winner-take-all and parabolic sub-pixel refinement from
  ``ops.sgm.disparity_4dir`` (kernel ``csrc/sgm.cu``, whose tile pass takes
  the winner where it holds each position's sum, so the (H, W, D) sum is
  never written; the JAX package leaves the winner to XLA).
- ``TpuBlockMatching``: SAD block matching as one batched (D, H, W) cost
  volume of tensor ops on the device (JAX computes it in XLA, with no
  Pallas kernel).
- ``CvBlockMatching``, ``CvSGBM``: OpenCV's matchers, for the reference's
  ``BlockMatching`` / ``SGBM`` names.  They need ``cv2``, which the GPU
  machine does not have; constructing one there raises.

Every ``run(left, right, device="cuda")`` takes numpy arrays or tensors and
returns a numpy disparity, invalid pixels < 0.
"""
from __future__ import annotations

import numpy as np
import torch

from bpvo_tpu_torch.config import ConfigFile
from bpvo_tpu_torch.ops import census as census_ops
from bpvo_tpu_torch.ops import sgm as sgm_ops
from bpvo_tpu_torch.ops.census_cost import census_cost_volume
from bpvo_tpu_torch.utils import profiling
from bpvo_tpu_torch.vo.device_vo import resolve_device

# the plain winner-take-all, counterpart of the JAX package's
# stereo._wta_subpixel (the card's is inside ``ops.sgm.disparity_4dir``)
_wta_subpixel = sgm_ops.wta_reference


class StereoAlgorithm:
    """run(left, right, device) -> float32 disparity, invalid pixels < 0."""

    def run(self, left, right, device="cuda"):
        raise NotImplementedError


def _import_cv2(name: str):
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            f"StereoAlgorithm {name!r} is OpenCV's matcher and needs cv2, "
            "which is not installed; TpuBlockMatching and TpuSGM run on the "
            "card without it") from e
    return cv2


class CvBlockMatching(StereoAlgorithm):
    """OpenCV StereoBM with the reference's configuration keys
    (stereo.py:39-55).  Runs on the host whatever ``device`` says."""

    def __init__(self, cf: ConfigFile):
        cv2 = _import_cv2("BlockMatching")
        self._bm = cv2.StereoBM_create(
            numDisparities=cf.get("numberOfDisparities", 128, int),
            blockSize=cf.get("SADWindowSize", 15, int) | 1)
        self._bm.setPreFilterCap(cf.get("preFilterCap", 31, int))
        self._bm.setMinDisparity(cf.get("minDisparity", 0, int))
        self._bm.setTextureThreshold(cf.get("textureThreshold", 10, int))
        self._bm.setUniquenessRatio(cf.get("uniquenessRatio", 15, int))
        self._bm.setSpeckleWindowSize(cf.get("speckleWindowSize", 0, int))
        self._bm.setSpeckleRange(cf.get("speckleRange", 0, int))
        self._bm.setDisp12MaxDiff(cf.get("disp12MaxDiff", -1, int))

    def run(self, left, right, device="cuda"):
        d16 = self._bm.compute(left, right)
        return d16.astype(np.float32) / 16.0


class CvSGBM(StereoAlgorithm):
    """OpenCV StereoSGBM with the reference's configuration keys
    (stereo.py:58-75).  Runs on the host whatever ``device`` says."""

    def __init__(self, cf: ConfigFile):
        cv2 = _import_cv2("SGBM")
        self._sgbm = cv2.StereoSGBM_create(
            minDisparity=cf.get("minDisparity", 0, int),
            numDisparities=cf.get("numberOfDisparities", 128, int),
            blockSize=cf.get("SADWindowSize", 3, int) | 1,
            P1=cf.get("P1", 0, int),
            P2=cf.get("P2", 0, int),
            uniquenessRatio=cf.get("uniquenessRatio", 0, int),
            speckleWindowSize=cf.get("speckleWindowSize", 0, int),
            speckleRange=cf.get("speckleRange", 0, int),
            mode=(cv2.STEREO_SGBM_MODE_HH if cf.get("fullDP", 0, int)
                  else cv2.STEREO_SGBM_MODE_SGBM))

    def run(self, left, right, device="cuda"):
        d16 = self._sgbm.compute(left, right)
        return d16.astype(np.float32) / 16.0


def _box_filter(x, radius: int):
    """Mean over (2r+1)^2 windows on the trailing (H, W) axes, edges
    replicated (stereo.py:82-94): a float32 cumulative sum along H, then
    along W, and four corners of it, times 1/k^2 (XLA compiles the JAX
    package's division by the constant k^2 into that product, and the port
    keeps its rounding).  Exact while the sums stay below 2^24; beyond that
    the summation order of the device's scan decides the last bits, as
    XLA's does in the JAX package."""
    if radius <= 0:
        return x
    k = 2 * radius + 1
    H, W = x.shape[-2:]
    xp = torch.nn.functional.pad(x, (radius, radius, radius, radius),
                                 mode="replicate")
    c = torch.cumsum(torch.cumsum(xp, dim=-2), dim=-1)
    c = torch.nn.functional.pad(c, (1, 0, 1, 0))
    s = (c[..., k:, k:] - c[..., :-k, k:] - c[..., k:, :-k]
         + c[..., :-k, :-k])
    return s[..., :H, :W] * float(np.float32(1.0) / np.float32(k * k))


def _block_matching(L, R, num_disparities: int, radius: int,
                    uniqueness_ratio: float, subpixel: bool, lr_check: bool):
    """SAD block matching (stereo.py:97-150), the whole (D, H, W) volume at
    once: the right image at column x - d (255 where x < d), the mean
    absolute difference over the window, the first-index argmin, the
    uniqueness test excluding +-1, the parabola clipped to +-0.5, the
    left-right check through the same volume; -1 where invalid."""
    L = L.to(torch.float32)
    R = R.to(torch.float32)
    H, W = L.shape
    D = num_disparities
    dev = L.device
    didx = torch.arange(D, device=dev)
    src = torch.arange(W, device=dev)[None, :] - didx[:, None]      # (D, W)
    diff = torch.abs(L[None] - R[:, src.clamp(min=0)].permute(1, 0, 2))
    diff = diff.masked_fill((src < 0)[:, None, :], 255.0)
    cost = _box_filter(diff, radius)                                 # (D, H, W)
    del diff

    cmin = torch.amin(cost, dim=0)
    best = torch.argmin(cost, dim=0)              # the first minimum
    near = torch.abs(didx[:, None, None] - best[None]) <= 1
    second = torch.amin(cost.masked_fill(near, float("inf")), dim=0)
    ok = second * (1.0 - uniqueness_ratio / 100.0) >= cmin
    ok &= torch.isfinite(cmin)

    disp = best.to(torch.float32)
    if subpixel:
        def take(idx):
            return torch.gather(cost, 0, idx[None])[0]

        c0 = take(torch.clamp(best - 1, 0, D - 1))
        c1 = take(best)
        c2 = take(torch.clamp(best + 1, 0, D - 1))
        denom = c0 - 2.0 * c1 + c2
        delta = torch.where(torch.abs(denom) > 1e-6,
                            0.5 * (c0 - c2) / torch.clamp(denom, min=1e-6),
                            torch.zeros_like(denom))
        disp = disp + torch.clamp(delta, -0.5, 0.5)

    if lr_check:
        # right-view winner from the same volume: costR[d, y, x] =
        # cost[d, y, x + d]; a left pixel's disparity must match the right
        # pixel's at x - d within 1
        xs = torch.arange(W, device=dev)
        xr = torch.clamp(xs[None, :] + didx[:, None], 0, W - 1)     # (D, W)
        bestR = torch.argmin(torch.gather(
            cost, 2, xr[:, None, :].expand(D, H, W)), dim=0)
        xl = torch.clamp(xs[None, :] - best, 0, W - 1)
        ok &= torch.abs(torch.gather(bestR, 1, xl) - best) <= 1

    return torch.where(ok & (best > 0), disp, torch.full_like(disp, -1.0))


class TpuBlockMatching(StereoAlgorithm):
    """Batched SAD block matching on the device (stereo.py:153-180): config
    keys ``numberOfDisparities``, ``SADWindowSize``, ``uniquenessRatio``."""

    def __init__(self, cf: ConfigFile = None, num_disparities: int = 128,
                 sad_window: int = 9, uniqueness_ratio: float = 15.0,
                 subpixel: bool = True, lr_check: bool = True):
        if cf is not None:
            num_disparities = cf.get("numberOfDisparities", num_disparities,
                                     int)
            sad_window = cf.get("SADWindowSize", sad_window, int)
            uniqueness_ratio = cf.get("uniquenessRatio", uniqueness_ratio,
                                      float)
        self.num_disparities = num_disparities
        self.radius = max(sad_window // 2, 1)
        self.uniqueness_ratio = uniqueness_ratio
        self.subpixel = subpixel
        self.lr_check = lr_check

    def run(self, left, right, device="cuda"):
        """(H, W) images (numpy arrays, or tensors on any device) -> numpy
        disparity, computed on ``device``: the card unless the caller asks
        for the CPU (without a CUDA device it raises).  Read from the card
        (the wait span ``bm.read``), the array is page-locked host memory
        of its own (``profiling.device_read``), which the caller owns."""
        dev = resolve_device(device)
        L, R = (torch.as_tensor(x).to(dev, torch.float32)
                for x in (left, right))
        return profiling.device_read("bm.read", self.as_fn()(L, R))

    def as_fn(self):
        """``(left, right) -> disparity`` on the tensors' device (a
        ``DeviceVO`` ``stereo_fn``)."""
        D, r, u = self.num_disparities, self.radius, self.uniqueness_ratio
        sp, lr = self.subpixel, self.lr_check
        return lambda L, R: _block_matching(L, R, D, r, u, sp, lr)


def _sgm(L, R, num_disparities: int, p1: float, p2: float):
    """Semi-global matching over 4 scan-line directions (stereo.py:189-224):
    census of both images, Hamming cost volume, then aggregation and WTA in
    one call (``ops.sgm.disparity_4dir``; its plain version is the
    aggregation followed by ``_wta_subpixel``)."""
    with profiling.annotate("sgm.census"):
        codes = census_ops.census(
            torch.stack([L.to(torch.float32), R.to(torch.float32)]))
    with profiling.annotate("sgm.cost_volume"):
        cost = census_cost_volume(codes[0], codes[1], num_disparities)
    with profiling.annotate("sgm.aggregate"):
        return sgm_ops.disparity_4dir(cost, p1, p2)


class TpuSGM(StereoAlgorithm):
    """Census + SGM matcher.  Penalties are in Hamming-distance units
    (p1=2, p2=8 by default, the JAX package's calibrated values); config
    keys ``numberOfDisparities``, ``sgmP1``, ``sgmP2``."""

    def __init__(self, cf: ConfigFile = None, num_disparities: int = 128,
                 p1: float = 2.0, p2: float = 8.0):
        if cf is not None:
            num_disparities = cf.get("numberOfDisparities", num_disparities,
                                     int)
            p1 = cf.get("sgmP1", p1, float)
            p2 = cf.get("sgmP2", p2, float)
        self.num_disparities = num_disparities
        self.p1 = p1
        self.p2 = p2

    def run(self, left, right, device="cuda"):
        """(H, W) images (numpy arrays, or tensors on any device) -> numpy
        disparity, computed on ``device``: the card unless the caller asks
        for the CPU (without a CUDA device it raises).  Spans: the root
        ``sgm.run`` over ``sgm.census``, ``sgm.cost_volume``,
        ``sgm.aggregate`` (the aggregation and the winner-take-all, one
        kernel call) and ``sgm.read`` (the disparity's copy to the host, a
        wait).  Read from the card, the array is page-locked host memory
        of its own (``profiling.device_read``), which the caller owns:
        ``VisualOdometry.add_frame`` uploads it again by DMA, and no later
        call writes into it."""
        with profiling.annotate("sgm.run"):
            dev = resolve_device(device)
            L, R = (profiling.upload(torch.as_tensor(x), dev, torch.float32)
                    for x in (left, right))
            disparity = _sgm(L, R, self.num_disparities, self.p1, self.p2)
            return profiling.device_read("sgm.read", disparity)

    def as_fn(self):
        """``(left, right) -> disparity`` on the tensors' device: the
        matcher ``DeviceVO(stereo_fn=...)`` runs inside its keyframe
        branch."""
        D, p1, p2 = self.num_disparities, self.p1, self.p2
        return lambda L, R: _sgm(L, R, D, p1, p2)


def create_stereo_algorithm(cf: ConfigFile) -> StereoAlgorithm:
    """Factory on the ``StereoAlgorithm`` key, with the JAX package's names
    (stereo.py:325-338): the reference's ``BlockMatching`` / ``SGBM`` are
    OpenCV's matchers (they need cv2), the SGM names ``TpuSGM``, and
    ``TpuBlockMatching`` / ``TpuBM`` the device's block matcher."""
    name = cf.get("StereoAlgorithm", "BlockMatching", str).lower()
    if name in ("blockmatching", "bm"):
        return CvBlockMatching(cf)
    if name in ("sgbm", "semiglobalblockmatching"):
        return CvSGBM(cf)
    if name in ("sgm", "semiglobalmatching", "rsgm", "tpusgm"):
        return TpuSGM(cf)
    if name in ("tpublockmatching", "tpubm"):
        return TpuBlockMatching(cf)
    raise ValueError(f"unknown stereo algorithm {name!r}")
