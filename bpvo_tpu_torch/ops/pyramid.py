"""Image pyramid: level i+1 = pyrDown(level i) (counterpart of
``bpvo_tpu/ops/pyramid.py``; reference image_pyramid.cc:43-50)."""
from __future__ import annotations

from typing import List

import torch

from bpvo_tpu_torch.ops.imgproc import pyr_down


def build(I, n_levels: int) -> List[torch.Tensor]:
    """[level 0 (finest) ... level n-1 (coarsest)] of the (H, W) image."""
    levels = [torch.as_tensor(I).to(torch.float32)]
    for _ in range(1, n_levels):
        levels.append(pyr_down(levels[-1]))
    return levels


def level_shapes(rows: int, cols: int, n_levels: int):
    shapes = [(rows, cols)]
    for _ in range(1, n_levels):
        r, c = shapes[-1]
        shapes.append(((r + 1) // 2, (c + 1) // 2))
    return shapes
