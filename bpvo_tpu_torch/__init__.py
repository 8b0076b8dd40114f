"""bpvo_tpu_torch — the PyTorch + CUDA port of ``bpvo_tpu``.

Same capabilities and module names as the JAX package, written as plain
functions on torch tensors.  Each Pallas kernel of the JAX package becomes a
kernel written by hand for NVIDIA Hopper (``csrc/``), with a plain PyTorch
version beside it; the wrapper takes the plain version only for CPU tensors.

This package never imports ``jax`` or ``bpvo_tpu``.
"""

import torch

# Full f32 everywhere: reduced-precision products in pose compositions and the
# GN normal equations once drove Gauss-Newton to 141 iterations/frame instead
# of ~20 (the same finding that pins the JAX package's matmul precision).
# The cuDNN flag defaults to True, so both are set.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from bpvo_tpu_torch.config import AlgorithmParameters, ConfigFile  # noqa: E402
from bpvo_tpu_torch.types import (  # noqa: E402
    DescriptorType,
    GradientEstimationType,
    InterpolationType,
    KeyFramingReason,
    LossFunctionType,
    OptimizerStatistics,
    PoseEstimationStatus,
    Result,
    VerbosityType,
)
from bpvo_tpu_torch.vo.odometry import VisualOdometry  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "AlgorithmParameters",
    "ConfigFile",
    "DescriptorType",
    "GradientEstimationType",
    "InterpolationType",
    "KeyFramingReason",
    "LossFunctionType",
    "OptimizerStatistics",
    "PoseEstimationStatus",
    "Result",
    "VerbosityType",
    "VisualOdometry",
]
