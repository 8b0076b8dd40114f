"""The whole VO step with the template points split over the ranks of a
``torch.distributed`` group (counterpart of
``bpvo_tpu/parallel/sharded_vo.py``; no reference analogue).

Every rank runs ``vo.device_vo.make_vo_step`` with the three hooks:

- the dense image work (descriptor pyramid, saliency, selection, back-
  projection, Hartley normalization) runs on every rank, so the selection
  is the single-device one; each rank then builds the per-point template
  (gathers, gradients, Jacobians) of its contiguous slice of the points
  (``build_templates_fn``), ``num_valid`` staying the global count;
- each level's GN reduces (H, g, f_sq) and the sigma histogram over the
  ranks (``sharded.linearize_sharded``);
- the good-point count and the warm-start gate's cost are summed over the
  ranks (``count_reduce``), so the keyframe decision, read on the host
  once per frame, is the same on every rank.

The step is eager (a hooked step has no CUDA graph).  ``scan_fn`` is a
loop over frames, the counterpart of ``lax.scan``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from bpvo_tpu_torch.config import AlgorithmParameters
from bpvo_tpu_torch.ops import imgproc, pyramid, selection
from bpvo_tpu_torch.parallel import sharded
from bpvo_tpu_torch.solver import gauss_newton as gn
from bpvo_tpu_torch.vo import device_vo
from bpvo_tpu_torch.vo import template_data as td_mod
from bpvo_tpu_torch.vo import warp as warp_mod
from bpvo_tpu_torch.vo.device_vo import VOState, VOStepOutput


def _shard_slice(x, axis: int, rank: int, world: int):
    """This rank's contiguous slice of ``x`` along ``axis``."""
    k = x.shape[axis] // world
    return x.narrow(axis, rank * k, k)


def _build_templates_sharded(channels_pyr, disparity, cams,
                             p: AlgorithmParameters, capacities, rank: int,
                             world: int) -> Tuple[td_mod.TemplateData, ...]:
    """The selection on every rank, the per-point build on this rank's
    slice, per level (JAX sharded_vo.py:53-72)."""
    out = []
    for level, ch in enumerate(channels_pyr):
        d_level = imgproc.disparity_at_level(disparity, level)
        d_level = d_level[:ch.shape[1], :ch.shape[2]]
        sel, points, s, c = td_mod.select_and_backproject(
            ch, d_level, cams[level], p, capacities[level])
        part = [_shard_slice(x, 0, rank, world)
                for x in (sel.rows, sel.cols, sel.valid, points)]
        rows, cols, valid, pts = part
        out.append(td_mod.build_from_selection(
            ch, cams[level], p, rows, cols, valid, sel.num_valid, pts, s, c))
    return tuple(out)


def _round_capacities(capacities, world: int):
    """Each level's capacity rounded down to a multiple of the world size
    (up could pass rows * cols on tiny coarse levels).  Powers of two stay
    as they are, so the selection is the single-device one."""
    return tuple(max(cap // world, 1) * world for cap in capacities)


def make_sharded_vo(reducer, K, baseline: float, image_size,
                    p: AlgorithmParameters, device="cuda"):
    """The distributed VO (JAX ``make_sharded_vo``): (init_fn, step_fn,
    scan_fn) for this rank.

      init_fn(image, disparity) -> VOState      (this rank's template slices)
      step_fn(state, image, disparity) -> (VOState, VOStepOutput)
      scan_fn(state, images, disparities) -> (VOState, stacked VOStepOutput)

    Images and disparities are whole on every rank.  ``reducer`` a
    ``collectives.Reducer``, or None for one process with no collectives.
    GaussNewton only (the sharded linearization hooks ``gauss_newton.run``;
    LM is a single-device option).  ``device`` names this rank's device
    ("cuda" unless the caller asks for the CPU)."""
    dev = device_vo.resolve_device(device)
    rank, world = (0, 1) if reducer is None else (reducer.rank,
                                                  reducer.world)
    rows, cols = image_size
    if p.numPyramidLevels <= 0:
        p = p.replace(numPyramidLevels=p.num_pyramid_levels_for(rows, cols))
    if p.poseEstimator != "GaussNewton":
        raise ValueError("sharded VO supports poseEstimator=GaussNewton only")
    base_cam = warp_mod.CameraModel.from_K(K, baseline)
    cams = tuple(base_cam.at_level(l) for l in range(p.numPyramidLevels))
    shapes = pyramid.level_shapes(rows, cols, p.numPyramidLevels)
    capacities = _round_capacities(
        tuple(selection.capacity_for_level(p, r, c, l)
              for l, (r, c) in enumerate(shapes)), world)
    fine = gn.GNOptions.from_params(p, coarse=False)
    coarse = gn.GNOptions.from_params(p, coarse=True)
    opts = tuple(sharded.sharded_options(fine if l == p.maxTestLevel
                                         else coarse)
                 for l in range(p.numPyramidLevels))

    def linearize_factory(level, tdata, channels, cam, lv_opts):
        return sharded.linearize_sharded(tdata, channels, cam, lv_opts,
                                         reducer)

    def build_templates_fn(channels_pyr, disparity):
        return _build_templates_sharded(channels_pyr, disparity, cams, p,
                                        capacities, rank, world)

    def count_reduce(t):
        return t if reducer is None else reducer.sum(t)[0]

    step = device_vo.make_vo_step(p, cams, capacities, opts,
                                  hooks=device_vo.StepHooks(
                                      linearize_factory, count_reduce,
                                      build_templates_fn))

    def as_tensor(a):
        return torch.as_tensor(a, dtype=torch.float32).to(dev)

    def init_fn(image, disparity) -> VOState:
        channels = device_vo._compute_channels_pyr(as_tensor(image), p,
                                                   p.numPyramidLevels)
        disparity = as_tensor(disparity)
        templates = build_templates_fn(channels, disparity)
        eye = torch.eye(4, dtype=torch.float32, device=dev)
        return VOState(
            templates=templates, prev_channels=channels,
            prev_disparity=disparity, has_prev=False, T_kf=eye,
            pose_world=eye, T_delta=eye,
            last_weights=torch.ones_like(templates[p.maxTestLevel].pixels))

    def step_fn(state: VOState, image, disparity):
        return step(state, as_tensor(image), as_tensor(disparity))

    def scan_fn(state: VOState, images, disparities):
        outs = []
        for image, disparity in zip(images, disparities):
            state, out = step_fn(state, image, disparity)
            outs.append(out)
        return state, VOStepOutput(*(torch.stack(f) for f in zip(*outs)))

    return init_fn, step_fn, scan_fn
