"""Datasets: frames of (grey image, float disparity) with a calibration
(counterpart of ``bpvo_tpu/data/dataset.py``; reference
``utils/dataset.{h,cc}`` and the ``Dataset::Create`` factory of
``utils/dataset_create.cc``).

Images are read by ``data.imageio`` (no OpenCV), with cv2's
``IMREAD_UNCHANGED`` conventions, so a frame's pixels equal the JAX
package's bit for bit.  A ``StereoDataset`` runs its matcher on ``device``:
the card unless the caller asks for the CPU.
"""
from __future__ import annotations

import dataclasses
import glob
import os
from typing import Optional, Tuple

import numpy as np

from bpvo_tpu_torch.config import ConfigFile
from bpvo_tpu_torch.data import imageio
from bpvo_tpu_torch.vo.device_vo import resolve_device


@dataclasses.dataclass
class StereoCalibration:
    """(reference utils/stereo_calibration.h:17-35)"""
    K: np.ndarray       # (3, 3) intrinsics
    baseline: float     # stereo baseline in meters

    def scaled(self, s: float) -> "StereoCalibration":
        K = self.K.copy() * s
        K[2, 2] = 1.0
        return StereoCalibration(K=K, baseline=self.baseline / s)


@dataclasses.dataclass
class DatasetFrame:
    image: np.ndarray            # (H, W) uint8/float32 grey (a tensor once
                                 # a loader has prefetched it to a device)
    disparity: np.ndarray        # (H, W) float32
    original: Optional[np.ndarray] = None   # original (possibly colour) image
    filename: str = ""


def _expand(path: str) -> str:
    return os.path.expanduser(path)


class FileSequence:
    """printf-style or glob file-sequence enumeration (reference
    utils/file_loader.h:12-42, utils/glob.{h,cc}).

    A format containing ``%`` is printf-style (lazy, unbounded); one
    containing ``*``/``?``/``[`` is globbed eagerly and sorted."""

    def __init__(self, root_dir: str, fmt: str, first_frame: int = 0):
        self._root = _expand(root_dir)
        self._fmt = fmt
        self._first = first_frame
        self._globbed = None
        if "%" not in fmt and any(ch in fmt for ch in "*?["):
            self._globbed = sorted(
                glob.glob(os.path.join(self._root, fmt)))[first_frame:]

    def __getitem__(self, i: int) -> str:
        if self._globbed is not None:
            return self._globbed[i] if i < len(self._globbed) else ""
        return os.path.join(self._root, self._fmt % (self._first + i))

    def exists(self, i: int) -> bool:
        return bool(self[i]) and os.path.exists(self[i])


class Dataset:
    """Interface: get_frame(i) -> DatasetFrame | None, plus calibration and
    image size."""

    def get_frame(self, i: int) -> Optional[DatasetFrame]:
        raise NotImplementedError

    @property
    def calibration(self) -> StereoCalibration:
        raise NotImplementedError

    @property
    def image_size(self) -> Tuple[int, int]:
        raise NotImplementedError

    @property
    def name(self) -> str:
        return type(self).__name__

    def __iter__(self):
        i = 0
        while True:
            f = self.get_frame(i)
            if f is None:
                return
            yield f
            i += 1


class DisparityDataset(Dataset):
    """Frames with precomputed disparity maps (reference dataset.cc:39-92).
    Integer disparity images are scaled by ``disparity_scale`` (default
    1/16, the KITTI convention); PFM disparities are taken as they are."""

    def __init__(self, images: FileSequence, disparities: FileSequence,
                 calib: StereoCalibration, disparity_scale: float = 1.0 / 16.0):
        self._images = images
        self._disparities = disparities
        self._calib = calib
        self._scale = disparity_scale
        f0 = self.get_frame(0)
        if f0 is None:
            raise FileNotFoundError(
                f"cannot read first frame: {images[0]} / {disparities[0]}")
        self._size = f0.image.shape[:2]

    def get_frame(self, i: int) -> Optional[DatasetFrame]:
        img = imageio.imread(self._images[i])
        dsp = imageio.imread(self._disparities[i])
        if img is None or dsp is None:
            return None
        if dsp.dtype != np.float32:
            dsp = dsp.astype(np.float32) * self._scale
        return DatasetFrame(image=imageio.to_gray(img), disparity=dsp,
                            original=img, filename=self._images[i])

    @property
    def calibration(self) -> StereoCalibration:
        return self._calib

    @property
    def image_size(self):
        return self._size


class StereoDataset(Dataset):
    """Left/right image pairs run through a stereo matcher per frame
    (reference dataset.cc:103-135), on ``device``."""

    def __init__(self, left: FileSequence, right: FileSequence,
                 calib: StereoCalibration, stereo_algorithm,
                 scale_by: int = 1, device="cuda"):
        self._left = left
        self._right = right
        self._stereo = stereo_algorithm
        self._scale_by = scale_by
        self._device = resolve_device(device)
        self._calib = calib.scaled(1.0 / scale_by) if scale_by > 1 else calib
        f0 = self.get_frame(0)
        if f0 is None:
            raise FileNotFoundError(f"cannot read first frame: {left[0]}")
        self._size = f0.image.shape[:2]

    def get_frame(self, i: int) -> Optional[DatasetFrame]:
        L = imageio.imread(self._left[i])
        R = imageio.imread(self._right[i])
        if L is None or R is None:
            return None
        original = L
        L, R = imageio.to_gray(L), imageio.to_gray(R)
        if self._scale_by > 1:
            L = imageio.downscale(L, self._scale_by)
            R = imageio.downscale(R, self._scale_by)
        D = self._stereo.run(L, R, device=self._device)
        return DatasetFrame(image=L, disparity=D, original=original,
                            filename=self._left[i])

    @property
    def calibration(self) -> StereoCalibration:
        return self._calib

    @property
    def image_size(self):
        return self._size


def _calibration_from_config(cf: ConfigFile) -> StereoCalibration:
    """``CalibrationFile`` (see ``tunnel.load_calibration_file``) or the
    inline ``fx fy cx cy baseline`` keys."""
    from bpvo_tpu_torch.data.tunnel import load_calibration_file
    calib_fn = cf.get("CalibrationFile", "", str)
    if calib_fn:
        return load_calibration_file(calib_fn)
    fx = cf.get("fx", 0.0, float)
    K = np.array([[fx, 0, cf.get("cx", 0.0, float)],
                  [0, cf.get("fy", fx, float), cf.get("cy", 0.0, float)],
                  [0, 0, 1]], np.float32)
    return StereoCalibration(K=K, baseline=cf.get("baseline", 0.0, float))


def create_dataset(conf, device="cuda") -> Dataset:
    """Factory keyed on the ``Dataset`` config entry (reference
    utils/dataset_create.cc:11-28; bpvo_tpu/data/dataset.py:187-265).
    Accepts a ConfigFile or a path.  ``device`` is where stereo matchers
    run: the card unless the caller asks for the CPU (without a CUDA device
    it raises, whichever dataset the config names)."""
    device = resolve_device(device)
    cf = conf if isinstance(conf, ConfigFile) else ConfigFile(conf)
    name = cf.get("Dataset", "", str).lower()
    if name in ("tsukuba", "tsukuba_synthetic"):
        from bpvo_tpu_torch.data.tsukuba import TsukubaSyntheticDataset
        return TsukubaSyntheticDataset(cf)
    if name == "tsukuba_stereo":
        from bpvo_tpu_torch.data.tsukuba import TsukubaStereoDataset
        return TsukubaStereoDataset(cf, device=device)
    if name == "kitti":
        from bpvo_tpu_torch.data.kitti import KittiDataset
        return KittiDataset(cf, device=device)
    if name == "tunnel":
        from bpvo_tpu_torch.data.tunnel import TunnelDataset
        return TunnelDataset(cf)
    if name == "synthetic":
        from bpvo_tpu_torch.data.synthetic import SyntheticPlaneDataset
        return SyntheticPlaneDataset.from_config(cf)
    if name == "synthetic_corridor":
        from bpvo_tpu_torch.data.synthetic import SyntheticCorridorDataset
        return SyntheticCorridorDataset.from_config(cf)
    if name == "synthetic_occluder":
        from bpvo_tpu_torch.data.synthetic import SyntheticOccluderDataset
        return SyntheticOccluderDataset.from_config(cf)
    if name == "synthetic_stereo":
        from bpvo_tpu_torch.data.synthetic import SyntheticStereoPlaneDataset
        return SyntheticStereoPlaneDataset.from_config(cf, device=device)
    root = _expand(cf.get("DataSetRootDirectory", "", str))
    first = cf.get("FirstFrameNumber", 0, int)
    if name == "stereo":
        # generic file-based stereo sequence (reference StereoDataset,
        # dataset.cc:103-135): LeftImageFormat / RightImageFormat printf or
        # glob patterns and the StereoAlgorithm keys
        from bpvo_tpu_torch.data.stereo import create_stereo_algorithm
        return StereoDataset(
            FileSequence(root, cf.get("LeftImageFormat", "left/%06d.png",
                                      str), first),
            FileSequence(root, cf.get("RightImageFormat", "right/%06d.png",
                                      str), first),
            _calibration_from_config(cf), create_stereo_algorithm(cf),
            scale_by=cf.get("ScaleBy", 1, int), device=device)
    if name == "disparity":
        # generic precomputed-disparity sequence (reference DisparityDataset,
        # dataset.cc:39-92): LeftImageFormat / DisparityMapFormat patterns
        return DisparityDataset(
            FileSequence(root, cf.get("LeftImageFormat", "left/%06d.png", str),
                         first),
            FileSequence(root, cf.get("DisparityMapFormat", "disp/%06d.pfm",
                                      str), first),
            _calibration_from_config(cf),
            disparity_scale=cf.get("DisparityScale", 1.0 / 16.0, float))
    raise ValueError(f"unknown dataset {name!r}")
