"""Configuration: ``AlgorithmParameters`` + ``ConfigFile``.

Counterpart of ``bpvo_tpu/config.py`` with the same keys, defaults and
``Key = Value`` parsing (reference ``bpvo/types.h:171-413``,
``bpvo/config_file.{h,cc}``), so every ``conf/*.cfg`` parses to equal fields
in both packages.  Field names keep the reference's camelCase spelling.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from bpvo_tpu_torch.types import (
    DescriptorType,
    GradientEstimationType,
    InterpolationType,
    LossFunctionType,
    VerbosityType,
    descriptor_from_string,
    gradient_estimation_from_string,
    interpolation_from_string,
    loss_function_from_string,
    verbosity_from_string,
)


class ConfigFile:
    """``Key = Value`` text config with ``#``/``%`` comments and case-insensitive
    keys (reference config_file.h:65-170)."""

    def __init__(self, filename: Optional[str] = None):
        self._values: Dict[str, str] = {}
        self._original_keys: Dict[str, str] = {}
        if filename is not None:
            self.parse(filename)

    def parse(self, filename: str) -> "ConfigFile":
        with open(filename, "r") as f:
            for line in f:
                line = line.strip()
                # Comments only when the line STARTS with '#'/'%' (reference
                # config_file.cc:59 checks line.front()); '%' mid-value must
                # survive for printf formats like LeftImageFormat=image%06d.pgm.
                if not line or line[0] in "#%" or "=" not in line:
                    continue
                key, _, value = line.partition("=")
                self.set(key.strip(), value.strip())
        return self

    def set(self, key: str, value) -> "ConfigFile":
        self._values[key.lower()] = str(value)
        self._original_keys[key.lower()] = key
        return self

    def get(self, key: str, default=None, type=None):
        k = key.lower()
        if k not in self._values:
            if default is None:
                raise KeyError(key)
            return default
        raw = self._values[k]
        if type is None:
            type = default.__class__ if default is not None else str
        if type is bool:
            return raw.strip().lower() in ("1", "true", "yes", "on")
        if type is int:
            # tolerate "5.0" for int keys the way atoi-ish parsing would not;
            # round-trip through float for robustness.  Numeric getters read
            # only the first token (reference str2num = stream extraction),
            # so trailing "% comment" text after a value is ignored.
            return int(float(raw.split()[0]))
        if type is float:
            return float(raw.split()[0])
        return type(raw)

    def __contains__(self, key: str) -> bool:
        return key.lower() in self._values

    def save(self, filename: str) -> None:
        with open(filename, "w") as f:
            for k_lower, v in sorted(self._values.items()):
                f.write(f"{self._original_keys[k_lower]} = {v}\n")

    def items(self):
        return [(self._original_keys[k], v) for k, v in self._values.items()]


def _parse_warp_type(name: str) -> str:
    n = name.strip().lower().replace("-", "").replace("_", "")
    if n in ("rigidbody", "rigid"):
        return "RigidBody"
    if n in ("disparityspace", "disparity", "dspace"):
        return "DisparitySpace"
    raise ValueError(f"unknown warpType: {name!r} (RigidBody | DisparitySpace)")


def _parse_pose_estimator(name: str) -> str:
    n = name.strip().lower()
    if n in ("gn", "gaussnewton", "gauss-newton", "gauss_newton"):
        return "GaussNewton"
    if n in ("lm", "levenbergmarquardt", "levenberg-marquardt",
             "levenberg_marquardt"):
        return "LevenbergMarquardt"
    raise ValueError(f"unknown poseEstimator: {name!r} (GaussNewton | "
                     f"LevenbergMarquardt)")


@dataclasses.dataclass(frozen=True)
class AlgorithmParameters:
    """All VO algorithm parameters (reference types.h:171-413, defaults types.cc:31-66).

    Frozen (hashable) so per-level solver options can be derived once and
    shared.
    """

    # ---- pyramid ----
    numPyramidLevels: int = -1  # -1 => auto from image size (vo.cc:101-105)
    minImageDimensionForPyramid: int = 40

    # ---- descriptor parameters ----
    sigmaPriorToCensusTransform: float = -1.0
    sigmaBitPlanes: float = 0.5
    dfSigma1: float = 0.75
    dfSigma2: float = 1.75
    latchNumBytes: int = 1
    latchRotationInvariance: bool = False
    latchHalfSsdSize: int = 1
    centralDifferenceRadius: int = 3
    centralDifferenceSigmaBefore: float = 0.75
    centralDifferenceSigmaAfter: float = 1.75
    laplacianKernelSize: int = 1

    # ---- optimization ----
    maxIterations: int = 50
    parameterTolerance: float = 1e-7
    functionTolerance: float = 1e-6
    gradientTolerance: float = 1e-8
    relaxTolerancesForCoarseLevels: bool = True
    # Which per-level optimizer: "GaussNewton" (reference pose_estimator_gn.h)
    # or "LevenbergMarquardt" (reference pose_estimator_lm.h:72-119; the
    # reference ships it as a code-level variant, we expose it as a config key).
    poseEstimator: str = "GaussNewton"
    # Warp parameterization: "RigidBody" (reference rigid_body_warp.h) or
    # "DisparitySpace" (reference disparity_space_warp.h, compile-gated there
    # by WITH_DISPARITY_SPACE_WARP; exposed here as a config key).  The
    # disparity-space warp conditions better for distant/low-disparity points
    # and needs no Hartley normalization.
    warpType: str = "RigidBody"
    gradientEstimation: GradientEstimationType = GradientEstimationType.CD3
    interp: InterpolationType = InterpolationType.LINEAR
    lossFunction: LossFunctionType = LossFunctionType.TUKEY
    descriptor: DescriptorType = DescriptorType.INTENSITY
    verbosity: VerbosityType = VerbosityType.SILENT

    # ---- keyframing ----
    minTranslationMagToKeyFrame: float = 0.15
    minRotationMagToKeyFrame: float = 5.0
    maxFractionOfGoodPointsToKeyFrame: float = 0.6
    goodPointThreshold: float = 0.85

    # ---- pixel selection ----
    minNumPixelsForNonMaximaSuppression: int = 320 * 240
    nonMaxSuppRadius: int = 1
    minNumPixelsToWork: int = 256
    minSaliency: float = 0.1
    minValidDisparity: float = 0.001
    maxValidDisparity: float = 512.0
    maxTestLevel: int = 0
    withNormalization: bool = True

    # ---- additions with no reference analogue (the measurements behind
    # each default are recorded beside the same field in bpvo_tpu/config.py)
    # Fixed point capacity at pyramid level 0; level l uses capacity >> (2*l),
    # clamped to pointCapacityMin: selection is top-K into this bucket + a
    # valid mask instead of a variable-length vector.
    pointCapacity: int = 16384
    pointCapacityMin: int = 512
    # Relaxation applied to coarse levels (reference pose_estimator_params.cc:36-47).
    coarseMaxIterations: int = 42
    coarseToleranceScale: float = 10.0
    # Number of devices to shard template points over (1 = single device).
    numShards: int = 1
    # Constant-velocity motion model: warm-start each frame's GN at
    # T_delta_prev @ T_kf instead of T_kf (and the post-keyframe re-estimate
    # at T_delta_prev instead of identity), behind the coarse-cost acceptance
    # gate (pose_estimator._gated_warm_start).  Off by default: the reference's
    # zero-velocity warm start (vo.cc:144-146).
    withMotionModel: bool = False
    # Scope of the post-keyframe candidate re-estimation (vo.cc:178-188),
    # which always solves a single frame's motion.  >= 0: start it at this
    # pyramid level and warm-start it from the measured candidate->current
    # motion behind the acceptance gate (identity fallback).  -1: the
    # reference's full pyramid from identity.
    keyframeReestimateStartLevel: int = 1
    # Alias-recovery multi-start probe offset in full-resolution pixels
    # (0 = off).  Not ported yet; parsed for config parity.
    coarseInitOffsetPx: float = 0.0
    # Keyframe rotation test units.  True = Euler magnitude in DEGREES per the
    # reference's documented contract (types.h:313-320).  False reproduces the
    # reference implementation, which compares radians against the degree
    # threshold (vo.cc:208-213), kept as an ablation knob for parity runs.
    rotationKeyframeInDegrees: bool = True

    def replace(self, **kw) -> "AlgorithmParameters":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_config_file(cls, filename: str) -> "AlgorithmParameters":
        """Build from a reference-style config file (types.cc:69-109 key names)."""
        cf = ConfigFile(filename)
        return cls.from_config(cf)

    @classmethod
    def from_config(cls, cf: ConfigFile) -> "AlgorithmParameters":
        d = cls()  # defaults
        return cls(
            numPyramidLevels=cf.get("numPyramidLevels", d.numPyramidLevels, int),
            minImageDimensionForPyramid=cf.get(
                "minImageDimensionForPyramid", d.minImageDimensionForPyramid, int),
            sigmaPriorToCensusTransform=cf.get("sigmaPriorToCensusTransform", 0.5, float),
            sigmaBitPlanes=cf.get("sigmaBitPlanes", d.sigmaBitPlanes, float),
            dfSigma1=cf.get("dfSigma1", d.dfSigma1, float),
            dfSigma2=cf.get("dfSigma2", d.dfSigma2, float),
            latchNumBytes=cf.get("latchNumBytes", d.latchNumBytes, int),
            latchRotationInvariance=cf.get(
                "latchRotationInvariance", d.latchRotationInvariance, bool),
            latchHalfSsdSize=cf.get("latchHalfSsdSize", d.latchHalfSsdSize, int),
            centralDifferenceRadius=cf.get(
                "centralDifferenceRadius", d.centralDifferenceRadius, int),
            centralDifferenceSigmaBefore=cf.get(
                "centralDifferenceSigmaBefore", d.centralDifferenceSigmaBefore, float),
            centralDifferenceSigmaAfter=cf.get(
                "centralDifferenceSigmaAfter", d.centralDifferenceSigmaAfter, float),
            laplacianKernelSize=cf.get("laplacianKernelSize", d.laplacianKernelSize, int),
            maxIterations=cf.get("maxIterations", d.maxIterations, int),
            parameterTolerance=cf.get("parameterTolerance", d.parameterTolerance, float),
            functionTolerance=cf.get("functionTolerance", d.functionTolerance, float),
            gradientTolerance=cf.get("gradientTolerance", 1e-6, float),
            relaxTolerancesForCoarseLevels=cf.get(
                "relaxTolerancesForCoarseLevels", d.relaxTolerancesForCoarseLevels, bool),
            gradientEstimation=gradient_estimation_from_string(
                cf.get("GradientEstimation", "CD5", str)),
            interp=interpolation_from_string(cf.get("Interpolation", "Linear", str)),
            lossFunction=loss_function_from_string(cf.get("lossFunction", "Huber", str)),
            descriptor=descriptor_from_string(cf.get("descriptor", "Intensity", str)),
            verbosity=verbosity_from_string(cf.get("Verbosity", "Silent", str)),
            minTranslationMagToKeyFrame=cf.get("minTranslationMagToKeyFrame", 0.1, float),
            minRotationMagToKeyFrame=cf.get("minRotationMagToKeyFrame", 2.5, float),
            maxFractionOfGoodPointsToKeyFrame=cf.get(
                "maxFractionOfGoodPointsToKeyFrame", d.maxFractionOfGoodPointsToKeyFrame, float),
            goodPointThreshold=cf.get("goodPointThreshold", 0.75, float),
            minNumPixelsForNonMaximaSuppression=cf.get(
                "minNumPixelsForNonMaximaSuppression",
                d.minNumPixelsForNonMaximaSuppression, int),
            nonMaxSuppRadius=cf.get("nonMaxSuppRadius", d.nonMaxSuppRadius, int),
            minNumPixelsToWork=cf.get("minNumPixelsToWork", d.minNumPixelsToWork, int),
            minSaliency=cf.get("minSaliency", d.minSaliency, float),
            minValidDisparity=cf.get("minValidDisparity", 1.0, float),
            maxValidDisparity=cf.get("maxValidDisparity", d.maxValidDisparity, float),
            maxTestLevel=cf.get("maxTestLevel", d.maxTestLevel, int),
            withNormalization=cf.get("withNormalization", d.withNormalization, bool),
            pointCapacity=cf.get("pointCapacity", d.pointCapacity, int),
            pointCapacityMin=cf.get("pointCapacityMin", d.pointCapacityMin, int),
            coarseMaxIterations=cf.get("coarseMaxIterations", d.coarseMaxIterations, int),
            coarseToleranceScale=cf.get(
                "coarseToleranceScale", d.coarseToleranceScale, float),
            numShards=cf.get("numShards", d.numShards, int),
            withMotionModel=cf.get("withMotionModel", d.withMotionModel, bool),
            keyframeReestimateStartLevel=cf.get(
                "keyframeReestimateStartLevel",
                d.keyframeReestimateStartLevel, int),
            coarseInitOffsetPx=cf.get(
                "coarseInitOffsetPx", d.coarseInitOffsetPx, float),
            rotationKeyframeInDegrees=cf.get(
                "rotationKeyframeInDegrees", d.rotationKeyframeInDegrees, bool),
            poseEstimator=_parse_pose_estimator(
                cf.get("poseEstimator", d.poseEstimator, str)),
            warpType=_parse_warp_type(cf.get("warpType", d.warpType, str)),
        )

    def num_pyramid_levels_for(self, rows: int, cols: int) -> int:
        """Auto pyramid-level selection (reference vo.cc:101-105)."""
        import math
        if self.numPyramidLevels > 0:
            return self.numPyramidLevels
        return 1 + int(round(
            math.log2(min(rows, cols) / float(self.minImageDimensionForPyramid))))
