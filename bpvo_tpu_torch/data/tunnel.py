"""Tunnel dataset (counterpart of ``bpvo_tpu/data/tunnel.py``; reference
``utils/tunnel_dataset.{h,cc}``): precomputed
disparity PGM sequence with calibration loaded from a ``CalibrationFile``.

The reference's TunnelDataset is a DisparityDataset (tunnel_dataset.cc:21-29)
— it reads ``LeftImageFormat`` + ``DisparityMapFormat`` image pairs and parses
a CRL-style stereo calibration file (tunnel_dataset.cc:34-105).  We support
both CRL header flavors plus a plain ``fx fy cx cy baseline`` one-liner
(the format this repo's synthetic parity sequences write).
"""
from __future__ import annotations

import re

import numpy as np

from bpvo_tpu_torch.config import ConfigFile
from bpvo_tpu_torch.data.dataset import (DisparityDataset, FileSequence,
                                         StereoCalibration, _expand)


def load_calibration_file(path: str) -> StereoCalibration:
    """Parse a stereo calibration file.  Formats accepted:

    * ``CRL Camera Config`` header (reference tunnel_dataset.cc:42-60):
      ``fx,fy,cx,cy:<f>,<f>,<f>,<f>`` and ``xyzrpq:<baseline>...`` lines.
    * ``CameraIntrinsicsPlumbBob{cols,rows,fx,fy,cx,cy,...}`` followed by a
      ``Transform3D(...,...,...,baseline`` line (tunnel_dataset.cc:61-103).
    * A single line ``fx fy cx cy baseline`` (this repo's parity sequences).
    """
    with open(_expand(path)) as f:
        text = f.read()
    compact = re.sub(r"\s+", "", text)

    def _K(fx, fy, cx, cy):
        return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)

    m = re.search(r"fx,fy,cx,cy:([-\d.e+]+),([-\d.e+]+),([-\d.e+]+),([-\d.e+]+)",
                  compact)
    if m:
        fx, fy, cx, cy = map(float, m.groups())
        bm = re.search(r"xyzrpq:([-\d.e+]+)", compact)
        baseline = abs(float(bm.group(1))) if bm else 0.0
        return StereoCalibration(K=_K(fx, fy, cx, cy), baseline=baseline)

    m = re.search(r"CameraIntrinsicsPlumbBob\{(\d+),(\d+),([-\d.e+]+),"
                  r"([-\d.e+]+),([-\d.e+]+),([-\d.e+]+)", compact)
    if m:
        fx, fy, cx, cy = map(float, m.groups()[2:6])
        bm = re.search(r"Transform3D\(([-\d.e+]+),([-\d.e+]+),([-\d.e+]+),"
                       r"([-\d.e+]+)", compact)
        baseline = abs(float(bm.group(4))) if bm else 0.0
        return StereoCalibration(K=_K(fx, fy, cx, cy), baseline=baseline)

    vals = [float(v) for v in text.split()]
    if len(vals) >= 5:
        fx, fy, cx, cy, baseline = vals[:5]
        return StereoCalibration(K=_K(fx, fy, cx, cy), baseline=baseline)
    raise ValueError(f"unrecognized calibration file format: {path}")


class TunnelDataset(DisparityDataset):
    def __init__(self, conf):
        cf = conf if isinstance(conf, ConfigFile) else ConfigFile(conf)
        root = _expand(cf.get("DataSetRootDirectory", "", str))
        left_fmt = cf.get("LeftImageFormat", "image%06d.pgm", str)
        dmap_fmt = cf.get("DisparityMapFormat", "image%06d-disparity.pgm", str)
        first = cf.get("FirstFrameNumber", 0, int)
        calib = load_calibration_file(cf.get("CalibrationFile", "", str))
        super().__init__(FileSequence(root, left_fmt, first),
                         FileSequence(root, dmap_fmt, first),
                         calib,
                         disparity_scale=cf.get("DisparityScale", 1.0 / 16.0,
                                                float))

    @property
    def name(self):
        return "tunnel"
