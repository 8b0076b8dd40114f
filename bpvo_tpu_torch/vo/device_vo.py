"""Visual odometry with all state in device tensors: descriptors,
coarse-to-fine IRLS GN, keyframe decision, template rebuild and trajectory
accumulation per frame (counterpart of ``bpvo_tpu/vo/device_vo.py``).

Keyframe semantics follow the reference's vo.cc:
  - not a keyframe: the current frame becomes the *candidate* (prev)
  - keyframe with no candidate: the current frame becomes the keyframe
  - keyframe with candidate: the candidate becomes the keyframe and the pose
    is re-estimated against it.
The keyframe branch is a host ``if`` on the decision: one device-to-host
sync per frame.  A step is the part before that read (``_make_front``),
which ``DeviceVO`` replays from a CUDA graph on CUDA (JAX jits the whole
step), and the part after it (``_make_commit``).

With a ``stereo_fn`` (``(left, right) -> disparity``) the second input of a
step is the right image and disparity is computed at keyframe rate: the
candidate store holds the (2, H, W) image pair, and the matcher runs only in
the keyframe branch and at ``init``, on the frame that becomes the keyframe
(bpvo_tpu/vo/device_vo.py:257-266, :306-310, :412-432).
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from bpvo_tpu_torch.config import AlgorithmParameters
from bpvo_tpu_torch.core import se3
from bpvo_tpu_torch.ops import descriptors, imgproc, pyramid, selection
from bpvo_tpu_torch.solver import gauss_newton as gn
from bpvo_tpu_torch.types import KeyFramingReason
from bpvo_tpu_torch.utils import graphs
from bpvo_tpu_torch.vo import pose_estimator as pe
from bpvo_tpu_torch.vo import template_data as td_mod
from bpvo_tpu_torch.vo import warp as warp_mod
from bpvo_tpu_torch.vo.point_cloud import PointCloud

# keyframing reason codes (mirror types.KeyFramingReason)
KF_NONE = 0
KF_TRANSLATION = 1
KF_ROTATION = 2
KF_FRAC_POINTS = 3

KF_REASON_ENUMS = {
    KF_NONE: KeyFramingReason.NO_KEYFRAMING,
    KF_TRANSLATION: KeyFramingReason.LARGE_TRANSLATION,
    KF_ROTATION: KeyFramingReason.LARGE_ROTATION,
    KF_FRAC_POINTS: KeyFramingReason.SMALL_FRAC_OF_GOOD_POINTS,
}


class VOState(NamedTuple):
    templates: Tuple[td_mod.TemplateData, ...]
    prev_channels: Tuple[torch.Tensor, ...]  # candidate descriptor pyramid
    prev_disparity: torch.Tensor             # candidate full-res disparity,
                                             # or its (2, H, W) image pair
                                             # with a stereo_fn
    has_prev: bool                           # a candidate exists
    T_kf: torch.Tensor                       # (4,4) keyframe -> last frame
    pose_world: torch.Tensor                 # (4,4) camera-to-world
    T_delta: torch.Tensor                    # (4,4) last inter-frame motion
    last_weights: torch.Tensor               # (C, K) finest-level IRLS weights


class VOStepOutput(NamedTuple):
    pose: torch.Tensor          # (4,4) motion wrt the previous frame
    pose_world: torch.Tensor    # (4,4) accumulated camera-to-world pose
    is_keyframe: torch.Tensor   # () bool
    reason: torch.Tensor        # () int32
    iters: torch.Tensor         # (L,) int32 per-level GN iterations
    f_norm: torch.Tensor        # (L,)
    frac_good: torch.Tensor     # ()
    H: torch.Tensor             # (6,6) finest-level Hessian
    band_overflow: torch.Tensor  # () int32, always 0 here


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; raises when it names CUDA and there is no
    CUDA device, so an entry point never runs on the CPU unasked."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available; pass device=\"cpu\" to run the plain "
                           "versions on the CPU")
    return device


def _eye4(device):
    return torch.eye(4, dtype=torch.float32, device=device)


class StepHooks(NamedTuple):
    """The distributed layer's hooks into the step (JAX
    bpvo_tpu/vo/device_vo.py:113-172, :224-247), all optional:
    ``linearize_factory(level, tdata, channels, cam, opts)`` gives each
    level's ``gauss_newton.run`` linearization (the sharded one reduces
    over the ranks); ``count_reduce(t)`` sums ``t`` over the ranks (the
    good-point count and the warm-start gate's cost); ``build_templates_fn(
    channels_pyr, disparity)`` builds the keyframe's templates (the sharded
    one keeps this rank's slice of the points)."""
    linearize_factory: Optional[Callable] = None
    count_reduce: Optional[Callable] = None
    build_templates_fn: Optional[Callable] = None


_rigid_inverse = se3.inverse


def _compute_channels_pyr(image, p: AlgorithmParameters, n_levels: int):
    out = []
    img = image
    for level in range(n_levels):
        out.append(descriptors.compute(img, p))
        if level + 1 < n_levels:
            img = imgproc.pyr_down(img)
    return tuple(out)


def _build_templates(channels_pyr, disparity, cams, p, capacities):
    out = []
    for level, ch in enumerate(channels_pyr):
        d_level = imgproc.disparity_at_level(disparity, level)
        d_level = d_level[:ch.shape[1], :ch.shape[2]]
        out.append(td_mod.set_data(ch, d_level, cams[level], p,
                                   capacities[level], level))
    return tuple(out)


def _estimate(templates, channels_pyr, cams, T_init, opts_per_level,
              max_test_level, good_threshold, min_points: int,
              solver: str = "GaussNewton", start_level=-1, run_graphs=None,
              hooks: StepHooks = StepHooks()):
    """Coarse-to-fine GN or LM from ``start_level`` (default: coarsest) down
    to ``max_test_level`` (``pose_estimator._estimate_all``, with the
    ``StepHooks``' linearization and count reduction).  Returns (T,
    iters (L,), f_norm (L,), frac_good, H, finest weights,
    band_overflow)."""
    T, iters, fs, _, _, frac, H, w, bo = pe._estimate_all(
        templates, channels_pyr, cams, T_init, opts_per_level,
        max_test_level, good_threshold, min_points, solver=solver,
        start_level=start_level, run_graphs=run_graphs,
        linearize_factory=hooks.linearize_factory,
        count_reduce=hooks.count_reduce)
    return T, iters, fs, frac, H, w, bo


def _keyframe_reason(T_est, frac_good, p: AlgorithmParameters):
    """shouldKeyFrame (reference vo.cc:199-224) on device."""
    t_sq = torch.sum(T_est[:3, 3] ** 2)
    R = T_est[:3, :3]
    sy = torch.sqrt(R[0, 0] ** 2 + R[1, 0] ** 2)
    euler = torch.stack([
        torch.atan2(R[2, 1], R[2, 2]),
        torch.atan2(-R[2, 0], torch.clamp(sy, min=1e-12)),
        torch.atan2(R[1, 0], R[0, 0])])
    if p.rotationKeyframeInDegrees:
        euler = euler * (180.0 / math.pi)
    r_sq = torch.sum(euler ** 2)
    reason = torch.where(
        t_sq > p.minTranslationMagToKeyFrame ** 2, KF_TRANSLATION,
        torch.where(r_sq > p.minRotationMagToKeyFrame ** 2, KF_ROTATION,
                    torch.where(frac_good < p.maxFractionOfGoodPointsToKeyFrame,
                                KF_FRAC_POINTS, KF_NONE)))
    return reason.to(torch.int32)


class _Front(NamedTuple):
    """The part of a step before its one host read: what the step graph
    computes."""
    channels: Tuple[torch.Tensor, ...]  # the frame's descriptor pyramid
    store: torch.Tensor         # its candidate store (disparity or pair)
    T_est: torch.Tensor         # (4,4) keyframe -> frame
    iters: torch.Tensor         # (L,) int32
    f_norm: torch.Tensor        # (L,)
    frac_good: torch.Tensor     # ()
    H: torch.Tensor             # (6,6) finest-level Hessian
    w_fine: torch.Tensor        # (C, K) finest-level IRLS weights
    band_overflow: torch.Tensor  # () int32
    reason: torch.Tensor        # () int32 keyframing reason
    is_kf: torch.Tensor         # () bool
    pose_kf: torch.Tensor       # (4,4) motion wrt the previous frame
    pose_world: torch.Tensor    # (4,4) world pose if this is no keyframe


def _make_front(p: AlgorithmParameters, cams, opts_per_level, stereo: bool,
                run_graphs=None, hooks: StepHooks = StepHooks()):
    """front(templates, T_kf, T_delta, pose_world, image, aux) -> _Front:
    the pyramid, the gated warm start, the coarse-to-fine estimate, the
    keyframe reason and the no-keyframe state update."""
    n_levels = p.numPyramidLevels

    def front(templates, T_kf, T_delta, pose_world, image, aux):
        image = image.to(torch.float32)
        channels = _compute_channels_pyr(image, p, n_levels)
        # the candidate store: the disparity, or the stereo pair
        store = (torch.stack([image, aux.to(torch.float32)]) if stereo
                 else aux.to(torch.float32))
        T_init = (pe._gated_warm_start(templates, channels, cams,
                                       T_delta @ T_kf, T_kf,
                                       opts_per_level[n_levels - 1],
                                       count_reduce=hooks.count_reduce)
                  if p.withMotionModel else T_kf)
        T_est, iters, fs, frac, H, w_fine, boverflow = _estimate(
            templates, channels, cams, T_init, opts_per_level,
            p.maxTestLevel, p.goodPointThreshold, p.minNumPixelsToWork,
            p.poseEstimator, run_graphs=run_graphs, hooks=hooks)
        reason = _keyframe_reason(T_est, frac, p)
        pose_kf = T_est @ _rigid_inverse(T_kf)
        return _Front(channels=channels, store=store, T_est=T_est,
                      iters=iters, f_norm=fs, frac_good=frac, H=H,
                      w_fine=w_fine, band_overflow=boverflow, reason=reason,
                      is_kf=reason != KF_NONE, pose_kf=pose_kf,
                      pose_world=pose_world @ _rigid_inverse(pose_kf))

    return front


def _make_commit(p: AlgorithmParameters, cams, capacities, opts_per_level,
                 stereo_fn=None, run_graphs=None,
                 hooks: StepHooks = StepHooks()):
    """commit(state, front, is_kf) -> (state, out): the step after its one
    host read.  No keyframe: the frame becomes the candidate.  Keyframe:
    the matcher (with a ``stereo_fn``), the template build and the
    re-estimate against the new keyframe."""
    n_levels = p.numPyramidLevels
    build_templates = hooks.build_templates_fn or (
        lambda channels_pyr, disparity: _build_templates(
            channels_pyr, disparity, cams, p, capacities))

    def commit(state: VOState, fr: _Front, is_kf: bool):
        if not is_kf:
            new_state = state._replace(
                prev_channels=fr.channels, prev_disparity=fr.store,
                has_prev=True, T_kf=fr.T_est, T_delta=fr.pose_kf,
                last_weights=fr.w_fine, pose_world=fr.pose_world)
            pose, it_out, fs_out = fr.pose_kf, fr.iters, fr.f_norm
        else:
            channels = fr.channels
            # keyframe source: the candidate when one exists, else the
            # current frame
            if state.has_prev:
                src_channels = state.prev_channels
                src_store = state.prev_disparity
            else:
                src_channels, src_store = channels, fr.store
            # stereo in the loop: the matcher runs here, on the pair of the
            # frame becoming the keyframe
            src_disp = (src_store if stereo_fn is None
                        else stereo_fn(src_store[0], src_store[1]))
            templates = build_templates(src_channels, src_disp)
            # re-estimate against the new keyframe.  When the keyframe IS the
            # current frame this converges to ~identity and only its weights
            # are kept.  It solves single-frame motion, so with
            # keyframeReestimateStartLevel >= 0 it skips the coarse levels and
            # warm-starts from the measured candidate->current motion behind
            # the coarse-cost gate (identity fallback).
            eye = _eye4(fr.T_est.device)
            if p.keyframeReestimateStartLevel >= 0:
                start2 = min(max(p.keyframeReestimateStartLevel,
                                 p.maxTestLevel), n_levels - 1)
                T2_init = pe._gated_warm_start(
                    templates, channels, cams, fr.pose_kf, eye,
                    opts_per_level[start2], level=start2,
                    count_reduce=hooks.count_reduce)
            else:
                start2 = n_levels - 1
                T2_init = (pe._gated_warm_start(
                    templates, channels, cams, state.T_delta, eye,
                    opts_per_level[n_levels - 1],
                    count_reduce=hooks.count_reduce)
                           if p.withMotionModel else eye)
            T2, it2, fs2, _frac2, _H2, w2_fine, _bo2 = _estimate(
                templates, channels, cams, T2_init, opts_per_level,
                p.maxTestLevel, p.goodPointThreshold, p.minNumPixelsToWork,
                p.poseEstimator, start_level=start2, run_graphs=run_graphs,
                hooks=hooks)
            if state.has_prev:
                pose, T_kf_new, it_out, fs_out = T2, T2, it2, fs2
            else:
                pose, T_kf_new = fr.pose_kf, eye
                it_out, fs_out = fr.iters, fr.f_norm
            new_state = VOState(
                templates=templates, prev_channels=channels,
                prev_disparity=fr.store, has_prev=False, T_kf=T_kf_new,
                pose_world=state.pose_world, T_delta=pose,
                last_weights=w2_fine)
            pose_world = new_state.pose_world @ _rigid_inverse(pose)
            new_state = new_state._replace(pose_world=pose_world)
        out = VOStepOutput(pose=pose, pose_world=new_state.pose_world,
                           is_keyframe=fr.is_kf, reason=fr.reason,
                           iters=it_out, f_norm=fs_out, frac_good=fr.frac_good,
                           H=fr.H, band_overflow=fr.band_overflow)
        return new_state, out

    return commit


def make_vo_step(p: AlgorithmParameters, cams, capacities,
                 opts_per_level: Tuple[gn.GNOptions, ...], stereo_fn=None,
                 run_graphs=None, hooks: StepHooks = StepHooks()):
    """Build the eager step function (state, image, aux) -> (state, out):
    ``_make_front``, the one host read of the keyframe decision, then
    ``_make_commit``.  ``aux`` is the disparity, or the right image when
    ``stereo_fn`` is given.  ``run_graphs`` (one ``gauss_newton.RunGraphs``
    per level) replays the iterations of levels that take
    ``gauss_newton.run``.

    ``hooks`` are the distributed layer's (``StepHooks``;
    ``parallel/sharded_vo.py``).  A hooked step is eager: a level with a
    custom linearization runs ``gauss_newton.run`` op by op, and hooks
    together with ``run_graphs`` raise a ``ValueError``."""
    cams = tuple(cams)
    if run_graphs is not None and hooks != StepHooks():
        raise ValueError("make_vo_step: a hooked step has no graphed route; "
                         "pass run_graphs=None")
    front = _make_front(p, cams, opts_per_level, stereo_fn is not None,
                        run_graphs, hooks)
    commit = _make_commit(p, cams, tuple(capacities), opts_per_level,
                          stereo_fn, run_graphs, hooks)

    def step(state: VOState, image, aux):
        fr = front(state.templates, state.T_kf, state.T_delta,
                   state.pose_world, image, aux)
        return commit(state, fr, bool(fr.is_kf))

    return step


class _StepBuffers(NamedTuple):
    """The static buffers of the two step graphs: each graph's frame (its
    pyramid's level 0 and its candidate store may be views of it), the
    keyframe's templates, and for each graph the state it leaves for the
    other (T_kf, T_delta, pose_world)."""
    image: Tuple[torch.Tensor, torch.Tensor]
    aux: Tuple[torch.Tensor, torch.Tensor]
    templates: Tuple[td_mod.TemplateData, ...]
    carry: Tuple[Tuple[torch.Tensor, torch.Tensor, torch.Tensor], ...]


class DeviceVO:
    """Host wrapper around the per-frame step; ``init`` consumes the first
    frame (reference FirstFrameResult, vo.cc:123-139).  ``stereo_fn``
    (optional ``(left, right) -> disparity``): the second argument of
    ``add_frame`` is then the right image.

    Routes, chosen statically by device and configuration:

    - CPU: the eager step (``make_vo_step``), every op issued from Python.
    - CUDA, every solved level on ``level_gn``: the step up to its host read
      (``_make_front``: pyramid with the census kernel, warm start, every
      ``level_gn`` launch, keyframe reason, the no-keyframe update) is one
      CUDA graph, replayed each frame (the counterpart of JAX's jitted
      step).  The host reads the keyframe decision once per frame, as JAX's
      ``lax.cond`` does on the device, and the keyframe branch (matcher,
      template build, re-estimate) runs eagerly and refills the graph's
      template buffers.  Two graphs, each with its own frame buffers,
      alternate frame by frame, so the candidate's pyramid and store that
      one wrote survive the other's replay; each reads the pose state the
      other left.
    - CUDA with a level on ``gauss_newton.run`` (more than
      ``MAX_LEVEL_KERNEL_POINTS`` points, CUBIC or CUBIC_HERMITE sampling,
      the DisparitySpace warp): the eager step, with those levels'
      iterations replayed from ``gauss_newton.RunGraphs``.  A whole step
      with a data-dependent loop in it awaits CUDA conditional nodes.
    - CUDA with Levenberg-Marquardt: the eager step (LM never takes the
      level kernel; its host loop reads the device once per iteration).

    ``add_frames`` replays once per frame and reads the keyframe decision
    each time; JAX's ``lax.scan`` needs no read per frame.  On the graphed
    route ``state`` holds the graphs' buffers, which later steps overwrite,
    as JAX's jitted step donates its state.
    """

    def __init__(self, K, baseline: float, image_size,
                 params: AlgorithmParameters = None, device="cuda",
                 stereo_fn=None):
        p = params or AlgorithmParameters()
        rows, cols = image_size
        if p.numPyramidLevels <= 0:
            p = p.replace(numPyramidLevels=p.num_pyramid_levels_for(rows, cols))
        self._p = p
        self._image_size = (rows, cols)
        self.device = resolve_device(device)
        base_cam = warp_mod.CameraModel.from_K(K, baseline)
        self._cams = tuple(base_cam.at_level(l)
                           for l in range(p.numPyramidLevels))
        shapes = pyramid.level_shapes(rows, cols, p.numPyramidLevels)
        self._capacities = tuple(
            selection.capacity_for_level(p, r, c, l)
            for l, (r, c) in enumerate(shapes))
        fine = gn.GNOptions.from_params(p, coarse=False)
        coarse = gn.GNOptions.from_params(p, coarse=True)
        self._opts = tuple(fine if l == p.maxTestLevel else coarse
                           for l in range(p.numPyramidLevels))
        self._stereo_fn = stereo_fn
        C = descriptors.num_channels(p.descriptor, p)
        gauss_newton = p.poseEstimator == "GaussNewton"
        on_kernel = gauss_newton and all(
            gn.level_kernel_supported(self._opts[l], C, *shapes[l],
                                      self._capacities[l])
            for l in range(p.maxTestLevel, p.numPyramidLevels))
        cuda = self.device.type == "cuda"
        # the graphed routes (see the class docstring)
        self._graphs = graphs.GraphCache(self.device) if (
            cuda and on_kernel) else None
        self._run_graphs = tuple(gn.RunGraphs() for _ in shapes) if (
            cuda and gauss_newton and not on_kernel) else None
        self._step = make_vo_step(p, self._cams, self._capacities, self._opts,
                                  stereo_fn=stereo_fn,
                                  run_graphs=self._run_graphs)
        self._front = _make_front(p, self._cams, self._opts,
                                  stereo_fn is not None)
        self._commit = _make_commit(p, self._cams, self._capacities,
                                    self._opts, stereo_fn)
        self._bufs: _StepBuffers = None
        self._next = 0             # the step graph the next frame replays
        self._own_state = None     # the state the buffers hold
        self.state: VOState = None

    def _as_tensor(self, a):
        return torch.as_tensor(a, dtype=torch.float32).to(self.device)

    def init(self, image, aux):
        p = self._p
        image = self._as_tensor(image)
        channels = _compute_channels_pyr(image, p, p.numPyramidLevels)
        if self._stereo_fn is None:
            store = disparity = self._as_tensor(aux)
        else:
            store = torch.stack([image, self._as_tensor(aux)])
            disparity = self._stereo_fn(store[0], store[1])
        templates = _build_templates(channels, disparity, self._cams, p,
                                     self._capacities)
        eye = _eye4(self.device)
        self.state = VOState(
            templates=templates, prev_channels=channels,
            prev_disparity=store, has_prev=False, T_kf=eye,
            pose_world=eye, T_delta=eye,
            last_weights=torch.ones_like(templates[p.maxTestLevel].pixels))

    def add_frame(self, image, aux) -> VOStepOutput:
        """One step; the first call initialises and returns None.  ``aux``
        is the disparity, or the right image with a ``stereo_fn``."""
        if self.state is None:
            self.init(image, aux)
            return None
        if self._graphs is not None:
            return self._graphed_step(image, aux)
        self.state, out = self._step(self.state, self._as_tensor(image),
                                     self._as_tensor(aux))
        return out

    def _load_state(self, state: VOState, carry):
        """Copy a state the buffers do not hold (after ``init``, a keyframe
        branch, or one set by the caller) into the templates and the
        ``carry`` buffers the next graph reads."""
        b = self._bufs
        for td_buf, td in zip(b.templates, state.templates):
            for dst, src in zip(td_buf, td):
                if dst.shape != src.shape:
                    raise ValueError(f"DeviceVO: template field of shape "
                                     f"{tuple(src.shape)}, the step graph's "
                                     f"is {tuple(dst.shape)}")
                dst.copy_(src)
        for dst, src in zip(carry, (state.T_kf, state.T_delta,
                                    state.pose_world)):
            dst.copy_(src)

    def _graphed_step(self, image, aux) -> VOStepOutput:
        state = self.state
        if self._bufs is None:
            rows, cols = self._image_size
            f32, dev = torch.float32, self.device
            self._bufs = _StepBuffers(
                image=tuple(torch.empty(rows, cols, dtype=f32, device=dev)
                            for _ in range(2)),
                aux=tuple(torch.empty(rows, cols, dtype=f32, device=dev)
                          for _ in range(2)),
                templates=tuple(td_mod.TemplateData(*(t.clone() for t in td))
                                for td in state.templates),
                carry=tuple(tuple(torch.empty(4, 4, dtype=f32, device=dev)
                                  for _ in range(3)) for _ in range(2)))
        b, g = self._bufs, self._next
        if state is not self._own_state:
            self._load_state(state, b.carry[1 - g])
        for dst, src in ((b.image[g], image), (b.aux[g], aux)):
            src = torch.as_tensor(src)
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"DeviceVO: frame of shape "
                                 f"{tuple(src.shape)}, expected "
                                 f"{tuple(dst.shape)}")
            dst.copy_(src)

        def fn():
            fr = self._front(b.templates, *b.carry[1 - g], b.image[g],
                             b.aux[g])
            for dst, src in zip(b.carry[g], (fr.T_est, fr.pose_kf,
                                             fr.pose_world)):
                dst.copy_(src)
            return fr

        fr = self._graphs(g, fn)
        self._next = 1 - g
        is_kf = bool(fr.is_kf)
        new_state, out = self._commit(state._replace(templates=b.templates),
                                      fr, is_kf)
        if is_kf:      # refill the buffers the next graph reads
            self._load_state(new_state, b.carry[g])
        # the pose state the next graph reads (as the graph wrote it when
        # this is no keyframe)
        T_kf, T_delta, pose_world = b.carry[g]
        new_state = new_state._replace(templates=b.templates, T_kf=T_kf,
                                       T_delta=T_delta, pose_world=pose_world)
        self.state = self._own_state = new_state
        # the graphs' outputs are overwritten two frames on
        return VOStepOutput(*(t.clone() for t in out))

    def add_frames(self, images, disparities) -> VOStepOutput:
        """(N,H,W) frames -> VOStepOutput with every field stacked over the
        steps taken (a leading frame initialises when there is no state)."""
        if self.state is None:
            self.init(images[0], disparities[0])
            images, disparities = images[1:], disparities[1:]
        outs = [self.add_frame(i, d) for i, d in zip(images, disparities)]
        return VOStepOutput(*(torch.stack(f) for f in zip(*outs)))

    def point_cloud(self):
        """Point cloud of the current keyframe's template at maxTestLevel,
        in keyframe coordinates, grey-coloured by its channel-0 values and
        weighted by the last finest-level IRLS weights (JAX
        bpvo_tpu/vo/device_vo.py:452-471; reference vo.cc:260-281).  None
        before the first frame."""
        if self.state is None:
            return None
        td = self.state.templates[self._p.maxTestLevel]
        valid = td.valid.cpu().numpy()
        pts = td.points.cpu().numpy()[valid].astype(np.float32)
        inten = np.clip(td.pixels[0].cpu().numpy()[valid], 0,
                        255).astype(np.uint8)
        colors = np.stack([inten, inten, inten, np.full_like(inten, 255)],
                          axis=1)
        weights = self.state.last_weights[0].cpu().numpy()[valid]
        return PointCloud(points=pts, colors=colors,
                          weights=weights.astype(np.float32))
