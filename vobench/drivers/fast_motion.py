"""The ``fast_motion`` mix: the ``online`` driver (``drivers/online.py``)
over a camera that moves ``step_scale`` times the configuration's step a
frame.  The pool renders the configuration's scene with the step twist
scaled and every ``step_scale``-th pose of its sequence, (F - 1) /
step_scale + 1 frames: the same path and disparity range, covered in
fewer, longer steps.  KITTI's car covers 0.5-1 m a 10 Hz frame, beyond
the configuration's 0.1 m keyframe threshold (the fallback of bpvo's
config-file constructor, types.cc:69-109, for a cfg that sets none), so
the deployment makes a keyframe on nearly every frame, and the frame before it is a keyframe too: no candidate, the
frame becomes the keyframe from its own disparity.  ``pool.gt_step()`` is
the scaled step, the frames' true motion."""
from __future__ import annotations

import copy
from typing import Dict

from vobench.drivers import online


def fast_config(cfg: Dict, scale: int) -> Dict:
    """``cfg`` with its scene's step twist times ``scale`` and its sequence
    cut to the frames that land on the original's every ``scale``-th."""
    last = int(cfg["sequence_frames"]) - 1
    if scale < 1 or last % scale:
        raise ValueError(f"fast_motion: step_scale {scale} does not divide "
                         f"the {last} steps of the sequence")
    scene = dict(cfg["scene"],
                 step_twist=[scale * x for x in cfg["scene"]["step_twist"]])
    return dict(cfg, scene=scene, sequence_frames=last // scale + 1)


class Driver(online.Driver):
    def __init__(self, cell, seed: int, device, ctx):
        fast = copy.copy(cell)
        fast.config = fast_config(cell.config, int(cell.mix["step_scale"]))
        super().__init__(fast, seed, device, ctx)
