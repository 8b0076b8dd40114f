"""Stereo disparity on the device: semi-global matching over a census
Hamming cost (counterpart of the ``TpuSGM`` matcher of
``bpvo_tpu/data/stereo.py``; the class keeps its name so a reader finds its
counterpart).

The census planes of both images come from ``ops.census`` (kernel
``csrc/census.cu`` on the card) and the 4-direction aggregation from
``ops.sgm`` (kernel ``csrc/sgm.cu``); the cost volume and the
winner-take-all with parabolic sub-pixel refinement are plain torch, as the
JAX package leaves them to XLA.  The OpenCV matchers and ``TpuBlockMatching``
are not ported: the card's machine has no ``cv2``.
"""
from __future__ import annotations

import numpy as np
import torch

from bpvo_tpu_torch.config import ConfigFile
from bpvo_tpu_torch.ops import census as census_ops
from bpvo_tpu_torch.ops import sgm as sgm_ops
from bpvo_tpu_torch.vo.device_vo import resolve_device

# popcount of every byte, for the Hamming distance of packed census codes
_POPCOUNT = np.array([bin(i).count("1") for i in range(256)], np.float32)


class StereoAlgorithm:
    """run(left, right) -> float32 disparity, invalid pixels < 0."""

    def run(self, left, right):
        raise NotImplementedError


def census_cost_volume(cL, cR, num_disparities: int):
    """(H, W, D) Hamming cost between the packed census codes (H, W) uint8
    of the left image and of the right image shifted by d, 8 where x < d
    (stereo.py:212-218).  Built with D innermost in a fixed number of tensor
    ops for any D: one gather of the right codes at column x - d, XOR with
    the left codes, code 255 (popcount 8) where x < d, and one lookup in the
    popcount table."""
    W = cL.shape[1]
    src = (torch.arange(W, device=cL.device)[:, None]
           - torch.arange(num_disparities, device=cL.device))      # (W, D)
    codes = cR[:, src.clamp(min=0)] ^ cL[:, :, None]
    codes.masked_fill_(src < 0, 255)
    return torch.as_tensor(_POPCOUNT, device=cL.device)[codes.int()]


def _wta_subpixel(a, D: int):
    """Winner-take-all over the disparity axis and parabolic sub-pixel
    refinement (stereo.py:261-283); best = 0 is invalid (-1).  Ties go to
    the first index, as ``jnp.argmin``."""
    best = torch.argmin(a, dim=-1)
    bm1 = torch.clamp(best - 1, 0, D - 1)
    bp1 = torch.clamp(best + 1, 0, D - 1)

    def take(idx):
        return torch.gather(a, -1, idx[..., None])[..., 0]

    c0, c1, c2 = take(bm1), take(best), take(bp1)
    denom = c0 - 2.0 * c1 + c2
    delta = torch.where(torch.abs(denom) > 1e-6,
                        0.5 * (c0 - c2) / torch.clamp(denom, min=1e-6),
                        torch.zeros_like(denom))
    disp = best.to(torch.float32) + torch.clamp(delta, -0.5, 0.5)
    return torch.where(best > 0, disp, torch.full_like(disp, -1.0))


def _sgm(L, R, num_disparities: int, p1: float, p2: float):
    """Semi-global matching over 4 scan-line directions (stereo.py:189-224):
    census of both images, Hamming cost volume, aggregation, WTA."""
    codes = census_ops.census(
        torch.stack([L.to(torch.float32), R.to(torch.float32)]))
    cost = census_cost_volume(codes[0], codes[1], num_disparities)
    return _wta_subpixel(sgm_ops.aggregate_4dir(cost, p1, p2),
                         num_disparities)


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
        for the CPU (without a CUDA device it raises)."""
        dev = resolve_device(device)
        L, R = (torch.as_tensor(x).to(dev, torch.float32)
                for x in (left, right))
        return _sgm(L, R, self.num_disparities, self.p1,
                    self.p2).cpu().numpy()

    def as_fn(self):
        """``(left, right) -> disparity`` on the tensors' device: the
        matcher ``DeviceVO(stereo_fn=...)`` runs inside its keyframe
        branch."""
        D, p1, p2 = self.num_disparities, self.p1, self.p2
        return lambda L, R: _sgm(L, R, D, p1, p2)


_SGM_NAMES = ("sgm", "semiglobalmatching", "rsgm", "tpusgm")
_CV2_NAMES = ("blockmatching", "bm", "sgbm", "semiglobalblockmatching",
              "tpublockmatching", "tpubm")


def create_stereo_algorithm(cf: ConfigFile) -> StereoAlgorithm:
    """Factory on the ``StereoAlgorithm`` key (stereo.py:325-338).  The SGM
    names map to ``TpuSGM``; the block matchers are not ported."""
    name = cf.get("StereoAlgorithm", "BlockMatching", str).lower()
    if name in _SGM_NAMES:
        return TpuSGM(cf)
    if name in _CV2_NAMES:
        raise NotImplementedError(
            f"stereo algorithm {name!r} is not ported: the OpenCV matchers "
            f"need cv2 and TpuBlockMatching comes with a later slice")
    raise ValueError(f"unknown stereo algorithm {name!r}")
