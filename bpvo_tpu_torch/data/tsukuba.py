"""NewTsukuba dataset (counterpart of ``bpvo_tpu/data/tsukuba.py``;
reference ``utils/tsukuba_dataset.{h,cc}``).

The synthetic variant uses the ground-truth disparity; the stereo variant
runs a matcher on the left/right pairs.  Calibration is the fixed
NewTsukuba rig (tsukuba_dataset.cc:11-22): fx=fy=615, cx=320, cy=240,
baseline 10 cm.
"""
from __future__ import annotations

import numpy as np

from bpvo_tpu_torch.config import ConfigFile
from bpvo_tpu_torch.data.dataset import (DisparityDataset, FileSequence,
                                         StereoCalibration, StereoDataset,
                                         _expand)
from bpvo_tpu_torch.data.stereo import create_stereo_algorithm


def tsukuba_calibration(scale: float = 1.0) -> StereoCalibration:
    K = np.array([[615.0, 0.0, 320.0],
                  [0.0, 615.0, 240.0],
                  [0.0, 0.0, 1.0]], np.float32)
    calib = StereoCalibration(K=K, baseline=0.1)
    if scale != 1.0:
        calib = calib.scaled(scale)
    return calib


def _sequences(cf: ConfigFile):
    root = _expand(cf.get("DataSetRootDirectory", "", str))
    illum = cf.get("Illumination", "fluorescent", str)
    first = cf.get("FirstFrameNumber", 1, int)
    left = FileSequence(
        root, f"illumination/{illum}/left/tsukuba_{illum}_L_%05d.png", first)
    right = FileSequence(
        root, f"illumination/{illum}/right/tsukuba_{illum}_R_%05d.png", first)
    disp = FileSequence(
        root, "groundtruth/disparity_maps/left/tsukuba_disparity_L_%05d.png",
        first)
    return left, right, disp


class TsukubaSyntheticDataset(DisparityDataset):
    """Ground-truth disparity variant (tsukuba_dataset.cc:27-60)."""

    def __init__(self, conf):
        cf = conf if isinstance(conf, ConfigFile) else ConfigFile(conf)
        left, _, disp = _sequences(cf)
        super().__init__(left, disp, tsukuba_calibration(),
                         disparity_scale=cf.get("DisparityScale", 1.0, float))

    @property
    def name(self):
        return "tsukuba-synthetic"


class TsukubaStereoDataset(StereoDataset):
    """Stereo-matcher variant (tsukuba_dataset.cc:70-100)."""

    def __init__(self, conf, device="cuda"):
        cf = conf if isinstance(conf, ConfigFile) else ConfigFile(conf)
        left, right, _ = _sequences(cf)
        super().__init__(left, right, tsukuba_calibration(),
                         create_stereo_algorithm(cf),
                         scale_by=cf.get("ScaleBy", 1, int), device=device)

    @property
    def name(self):
        return "tsukuba-stereo"
