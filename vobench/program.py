"""The system under test, built from a configuration file: the port's
``AlgorithmParameters``, camera and matcher.  Everything of the port is
imported here and in the drivers, never at module import time of the
harness's other parts, and never by ``vobench.reference``."""
from __future__ import annotations

from typing import Dict

import numpy as np


def algorithm_parameters(params: Dict):
    """The port's ``AlgorithmParameters`` with every field of the
    configuration (enums by member name)."""
    import dataclasses
    from bpvo_tpu_torch import types
    from bpvo_tpu_torch.config import AlgorithmParameters
    enums = {"gradientEstimation": types.GradientEstimationType,
             "interp": types.InterpolationType,
             "lossFunction": types.LossFunctionType,
             "descriptor": types.DescriptorType,
             "verbosity": types.VerbosityType}
    fields = {f.name for f in dataclasses.fields(AlgorithmParameters)}
    if set(params) != fields:
        raise ValueError(f"configuration params differ from "
                         f"AlgorithmParameters: missing "
                         f"{sorted(fields - set(params))}, unknown "
                         f"{sorted(set(params) - fields)}")
    return AlgorithmParameters(**{
        k: enums[k][v] if k in enums else v for k, v in params.items()})


def camera_matrix(cfg: Dict) -> np.ndarray:
    c = cfg["camera"]
    return np.array([[c["fx"], 0, c["cols"] / 2.0],
                     [0, c["fx"], c["rows"] / 2.0], [0, 0, 1]], np.float32)


def matcher(cfg: Dict):
    """The configuration's ``TpuSGM``."""
    from bpvo_tpu_torch.data.stereo import TpuSGM
    m = cfg["matcher"]
    if m["algorithm"] != "TpuSGM":
        raise NotImplementedError(m["algorithm"])
    return TpuSGM(num_disparities=m["num_disparities"], p1=m["p1"],
                  p2=m["p2"])


def settled_counts() -> Dict[str, int]:
    """The kernels' launch counts with every conditional body settled."""
    from bpvo_tpu_torch.utils import graphs
    graphs.settle()
    return {m.__name__.rsplit(".", 1)[1]: int(m.launch_count)
            for m in graphs.op_modules()}
