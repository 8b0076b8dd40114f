"""KITTI odometry dataset (counterpart of ``bpvo_tpu/data/kitti.py``;
reference ``utils/kitti_dataset.{h,cc}``).

Layout: ``sequences/%02d/image_0/%06d.png`` (left), ``image_1`` (right),
``calib.txt`` with P0/P1 projection rows; baseline = -P1(0,3)/P1(0,0)
(kitti_dataset.cc:44-99).
"""
from __future__ import annotations

import os

import numpy as np

from bpvo_tpu_torch.config import ConfigFile
from bpvo_tpu_torch.data.dataset import (FileSequence, StereoCalibration,
                                         StereoDataset, _expand)
from bpvo_tpu_torch.data.stereo import create_stereo_algorithm


def load_kitti_calibration(calib_file: str, scale_by: int = 1
                           ) -> StereoCalibration:
    """Parse P0/P1 from a KITTI calib.txt (kitti_dataset.cc:73-99)."""
    with open(calib_file) as f:
        lines = f.readlines()

    def parse(line):
        vals = [float(v) for v in line.split()[1:]]
        return np.array(vals, np.float32).reshape(3, 4)

    P0 = parse(lines[0])
    P1 = parse(lines[1])
    K = P0[:3, :3].copy()
    baseline = -P1[0, 3] / P1[0, 0]
    calib = StereoCalibration(K=K, baseline=float(baseline))
    if scale_by > 1:
        calib = calib.scaled(1.0 / scale_by)
    return calib


class KittiDataset(StereoDataset):
    def __init__(self, conf, device="cuda"):
        cf = conf if isinstance(conf, ConfigFile) else ConfigFile(conf)
        root = _expand(cf.get("DataSetRootDirectory", "", str))
        seq = cf.get("SequenceNumber", 0, int)
        first = cf.get("FirstFrameNumber", 0, int)
        scale_by = cf.get("ScaleBy", 1, int)
        left = FileSequence(root, f"sequences/{seq:02d}/image_0/%06d.png",
                            first)
        right = FileSequence(root, f"sequences/{seq:02d}/image_1/%06d.png",
                             first)
        calib = load_kitti_calibration(
            os.path.join(root, f"sequences/{seq:02d}/calib.txt"))
        self._seq = seq
        super().__init__(left, right, calib, create_stereo_algorithm(cf),
                         scale_by, device=device)

    @property
    def name(self):
        return f"kitti-{self._seq:02d}"
