"""Core enums and the results of ``VisualOdometry.add_frame`` (counterpart
of ``bpvo_tpu/types.py``; enum values are the same strings, so enums
convert between the packages by ``.value``)."""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional

import numpy as np


class LossFunctionType(enum.Enum):
    HUBER = "Huber"
    TUKEY = "Tukey"
    L2 = "L2"


class DescriptorType(enum.Enum):
    INTENSITY = "Intensity"
    INTENSITY_AND_GRADIENT = "IntensityAndGradient"
    DESCRIPTOR_FIELDS_FIRST_ORDER = "DescriptorFields1"
    DESCRIPTOR_FIELDS_SECOND_ORDER = "DescriptorFields2"
    LATCH = "Latch"
    CENTRAL_DIFFERENCE = "CentralDifference"
    LAPLACIAN = "Laplacian"
    BITPLANES = "BitPlanes"


class VerbosityType(enum.Enum):
    ITERATION = "Iteration"
    FINAL = "Final"
    SILENT = "Silent"
    DEBUG = "Debug"


class InterpolationType(enum.Enum):
    LINEAR = "Linear"
    COSINE = "Cosine"
    CUBIC = "Cubic"
    CUBIC_HERMITE = "CubicHermite"


class GradientEstimationType(enum.Enum):
    CD3 = "CD3"  # central difference [-1, 0, 1] / 2
    CD5 = "CD5"  # central difference [1, -8, 0, 8, -1] / 18


class KeyFramingReason(enum.Enum):
    LARGE_TRANSLATION = "LargeTranslation"
    LARGE_ROTATION = "LargeRotation"
    SMALL_FRAC_OF_GOOD_POINTS = "SmallFracOfGoodPoints"
    FIRST_FRAME = "FirstFrame"
    NO_KEYFRAMING = "NoKeyFraming"
    UNKNOWN = "Unknown"


class PoseEstimationStatus(enum.Enum):
    PARAMETER_TOL_REACHED = "ParameterTolReached"
    FUNCTION_TOL_REACHED = "FunctionTolReached"
    GRADIENT_TOL_REACHED = "GradientTolReached"
    MAX_ITERATIONS = "MaxIterations"
    SOLVER_ERROR = "SolverError"


def _from_string(enum_cls, s: str):
    for member in enum_cls:
        if member.value.lower() == s.strip().lower():
            return member
    raise ValueError(f"unknown {enum_cls.__name__}: {s!r}")


def loss_function_from_string(s: str) -> LossFunctionType:
    return _from_string(LossFunctionType, s)


def descriptor_from_string(s: str) -> DescriptorType:
    return _from_string(DescriptorType, s)


def verbosity_from_string(s: str) -> VerbosityType:
    return _from_string(VerbosityType, s)


def interpolation_from_string(s: str) -> InterpolationType:
    return _from_string(InterpolationType, s)


def gradient_estimation_from_string(s: str) -> GradientEstimationType:
    return _from_string(GradientEstimationType, s)


@dataclasses.dataclass
class OptimizerStatistics:
    """Per-pyramid-level optimizer stats (reference types.h:444-482)."""

    num_iterations: int = 0
    final_error: float = 0.0
    first_order_optimality: float = 0.0
    status: PoseEstimationStatus = PoseEstimationStatus.MAX_ITERATIONS

    def __repr__(self):
        return (f"OptimizerStatistics(iters={self.num_iterations}, "
                f"|F|={self.final_error:.6g}, "
                f"|G|={self.first_order_optimality:.6g}, "
                f"status={self.status.value})")


@dataclasses.dataclass
class Result:
    """Output of ``VisualOdometry.add_frame`` (reference types.h:489-569).

    ``pose``: 4x4 relative motion wrt the frame at the previous time step.
    ``covariance``: 6x6 covariance of the estimate (inverse GN Hessian).
    ``point_cloud``: the keyframe's points, at keyframes.
    """

    pose: np.ndarray
    covariance: np.ndarray
    is_keyframe: bool = False
    keyframing_reason: KeyFramingReason = KeyFramingReason.UNKNOWN
    optimizer_statistics: List[OptimizerStatistics] = dataclasses.field(
        default_factory=list)
    point_cloud: Optional[object] = None
    success: bool = True
