"""Visual odometry with all state in device tensors: descriptors,
coarse-to-fine IRLS GN, keyframe decision, template rebuild and trajectory
accumulation per frame (counterpart of ``bpvo_tpu/vo/device_vo.py``).

Keyframe semantics follow the reference's vo.cc:
  - not a keyframe: the current frame becomes the *candidate* (prev)
  - keyframe with no candidate: the current frame becomes the keyframe
  - keyframe with candidate: the candidate becomes the keyframe and the pose
    is re-estimated against it.
A step is ``_make_front`` (pyramid, warm start, estimate, keyframe reason)
and ``_make_commit``: the keyframe branch (``_make_keyframe``, JAX's
``lax.cond`` branch, with ``has_prev`` selected by ``torch.where``) under
``utils.graphs.cond``, then the state update.  Eagerly ``cond`` reads the
keyframe decision on the host; in ``DeviceVO``'s step graph on CUDA it is
an IF node, and a step reads nothing back.

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
    has_prev: torch.Tensor                   # () bool: a candidate exists
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


def _setup_levels(K, baseline: float, image_size, p: AlgorithmParameters):
    """The per-level setup every VO entry point shares: (``p`` with
    ``numPyramidLevels`` resolved for ``image_size``, the camera of each
    level, each level's template capacity, each level's ``GNOptions``:
    the fine ones at ``maxTestLevel``, the coarse ones elsewhere)."""
    rows, cols = image_size
    if p.numPyramidLevels <= 0:
        p = p.replace(numPyramidLevels=p.num_pyramid_levels_for(rows, cols))
    n_levels = p.numPyramidLevels
    base_cam = warp_mod.CameraModel.from_K(K, baseline)
    cams = tuple(base_cam.at_level(l) for l in range(n_levels))
    capacities = tuple(
        selection.capacity_for_level(p, r, c, l)
        for l, (r, c) in enumerate(pyramid.level_shapes(rows, cols,
                                                        n_levels)))
    fine = gn.GNOptions.from_params(p, coarse=False)
    coarse = gn.GNOptions.from_params(p, coarse=True)
    opts = tuple(fine if l == p.maxTestLevel else coarse
                 for l in range(n_levels))
    return p, cams, capacities, opts


def _estimate(templates, channels_pyr, cams, T_init, opts_per_level,
              max_test_level, good_threshold, min_points: int,
              solver: str = "GaussNewton", start_level=-1,
              hooks: StepHooks = StepHooks()):
    """Coarse-to-fine GN or LM from ``start_level`` (default: coarsest) down
    to ``max_test_level`` (``pose_estimator._estimate_all``, with the
    ``StepHooks``' linearization and count reduction).  Returns (T,
    iters (L,), f_norm (L,), frac_good, H, finest weights,
    band_overflow)."""
    T, iters, fs, _, _, frac, H, w, bo = pe._estimate_all(
        templates, channels_pyr, cams, T_init, opts_per_level,
        max_test_level, good_threshold, min_points, solver=solver,
        start_level=start_level, linearize_factory=hooks.linearize_factory,
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
    """The part of a step before the keyframe branch."""
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


class _Branch(NamedTuple):
    """What ``lax.cond``'s branches give (JAX bpvo_tpu/vo/device_vo.py:
    284-357): the keyframe's templates, the new T_kf, the step's pose (the
    next T_delta), its iterations and f_norm, and the finest level's IRLS
    weights.  No keyframe: the templates kept and the front's values."""
    templates: Tuple[td_mod.TemplateData, ...]
    T_kf: torch.Tensor
    pose: torch.Tensor
    iters: torch.Tensor
    f_norm: torch.Tensor
    last_weights: torch.Tensor


def _make_front(p: AlgorithmParameters, cams, opts_per_level, stereo: bool,
                hooks: StepHooks = StepHooks()):
    """front(templates, T_kf, T_delta, image, aux) -> _Front: the pyramid,
    the gated warm start, the coarse-to-fine estimate and the keyframe
    reason."""
    n_levels = p.numPyramidLevels

    def front(templates, T_kf, T_delta, image, aux):
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
            p.poseEstimator, hooks=hooks)
        reason = _keyframe_reason(T_est, frac, p)
        return _Front(channels=channels, store=store, T_est=T_est,
                      iters=iters, f_norm=fs, frac_good=frac, H=H,
                      w_fine=w_fine, band_overflow=boverflow, reason=reason,
                      is_kf=reason != KF_NONE,
                      pose_kf=T_est @ _rigid_inverse(T_kf))

    return front


def _make_keyframe(p: AlgorithmParameters, cams, capacities, opts_per_level,
                   stereo_fn=None, hooks: StepHooks = StepHooks()):
    """keyframe(state, front) -> _Branch: JAX's keyframe branch (bpvo_tpu/
    vo/device_vo.py:295-354), a function of tensors.  The keyframe source
    is the candidate when ``state.has_prev``, else the current frame,
    chosen by ``torch.where`` so that there is one matcher call (with a
    ``stereo_fn``), one template build and one re-estimate."""
    n_levels = p.numPyramidLevels
    build_templates = hooks.build_templates_fn or (
        lambda channels_pyr, disparity: _build_templates(
            channels_pyr, disparity, cams, p, capacities))

    def keyframe(state: VOState, fr: _Front) -> _Branch:
        has_prev = state.has_prev
        channels = fr.channels
        src_channels = tuple(torch.where(has_prev, a, b) for a, b in
                             zip(state.prev_channels, channels))
        src_store = torch.where(has_prev, state.prev_disparity, fr.store)
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
            p.poseEstimator, start_level=start2, hooks=hooks)
        return _Branch(templates=templates,
                       T_kf=torch.where(has_prev, T2, eye),
                       pose=torch.where(has_prev, T2, fr.pose_kf),
                       iters=torch.where(has_prev, it2, fr.iters),
                       f_norm=torch.where(has_prev, fs2, fr.f_norm),
                       last_weights=w2_fine)

    return keyframe


def _make_commit(p: AlgorithmParameters, cams, capacities, opts_per_level,
                 stereo_fn=None, hooks: StepHooks = StepHooks()):
    """commit(state, front) -> (state, out): the keyframe branch under
    ``graphs.cond`` (a host read of the decision, or in a step graph an IF
    node), then the state update both branches share.  No keyframe: the
    frame becomes the candidate.  Keyframe: the matcher (with a
    ``stereo_fn``), the template build and the re-estimate."""
    keyframe = _make_keyframe(p, cams, capacities, opts_per_level,
                              stereo_fn, hooks)

    def commit(state: VOState, fr: _Front):
        br = graphs.cond(fr.is_kf, lambda: keyframe(state, fr), _Branch(
            templates=state.templates, T_kf=fr.T_est, pose=fr.pose_kf,
            iters=fr.iters, f_norm=fr.f_norm, last_weights=fr.w_fine))
        pose_world = state.pose_world @ _rigid_inverse(br.pose)
        new_state = VOState(
            templates=br.templates, prev_channels=fr.channels,
            prev_disparity=fr.store, has_prev=~fr.is_kf, T_kf=br.T_kf,
            pose_world=pose_world, T_delta=br.pose,
            last_weights=br.last_weights)
        out = VOStepOutput(pose=br.pose, pose_world=pose_world,
                           is_keyframe=fr.is_kf, reason=fr.reason,
                           iters=br.iters, f_norm=br.f_norm,
                           frac_good=fr.frac_good, H=fr.H,
                           band_overflow=fr.band_overflow)
        return new_state, out

    return commit


def make_vo_step(p: AlgorithmParameters, cams, capacities,
                 opts_per_level: Tuple[gn.GNOptions, ...], stereo_fn=None,
                 hooks: StepHooks = StepHooks()):
    """Build the eager step function (state, image, aux) -> (state, out):
    ``_make_front``, then ``_make_commit`` with one host read of the
    keyframe decision.  ``aux`` is the disparity, or the right image when
    ``stereo_fn`` is given.  ``DeviceVO`` captures the same functions as
    one CUDA graph (``StepGraph``).

    ``hooks`` are the distributed layer's (``StepHooks``;
    ``parallel/sharded_vo.py``): a level with a custom linearization runs
    ``gauss_newton.run`` (eagerly a host loop; in a ``StepGraph`` its
    first iteration and a WHILE node, the collectives inside)."""
    cams = tuple(cams)
    front = _make_front(p, cams, opts_per_level, stereo_fn is not None,
                        hooks)
    commit = _make_commit(p, cams, tuple(capacities), opts_per_level,
                          stereo_fn, hooks)

    def step(state: VOState, image, aux):
        return commit(state, front(state.templates, state.T_kf,
                                   state.T_delta, image, aux))

    return step


class _StepBuffers(NamedTuple):
    """The static buffers of the step graph: the frame, and the state it
    reads and writes in place."""
    image: torch.Tensor
    aux: torch.Tensor
    state: VOState


class StepGraph:
    """A VO step as one CUDA graph over static buffers (JAX's jitted
    step): ``front`` and ``commit`` (``_make_front`` and ``_make_commit``,
    with any ``StepHooks``) captured by ``cache`` with the keyframe branch
    an IF node and every ``gauss_newton.run`` or LM loop a WHILE node; the
    frame and the state are copied into the buffers, the new state
    written over them.  ``step`` is one replay and no device read;
    ``chunk`` copies a chunk of frames to the device once and replays
    back to back (JAX's ``lax.scan``), its outputs stacked on the device.
    The returned state is the buffers, which the next step overwrites
    (JAX's step donates its state); another state is copied in."""

    def __init__(self, front, commit, image_size, device, cache):
        self._front, self._commit = front, commit
        self._image_size = tuple(image_size)
        self.device = device
        self.cache = cache
        self._bufs: _StepBuffers = None

    def _load_state(self, state: VOState):
        """Copy a state the buffers do not hold (after ``init``, or one set
        by the caller) into them."""
        try:
            graphs.copy_into(self._bufs.state, state)
        except ValueError as e:
            raise ValueError(f"DeviceVO: the state does not fit the step "
                             f"graph's buffers: {e}") from None

    def step(self, state: VOState, image, aux):
        """One replay of the step graph on the frame (tensors on the
        device, or host arrays) from ``state``; returns (the buffers'
        state, the graph's outputs)."""
        if self._bufs is None:
            rows, cols = self._image_size
            self._bufs = _StepBuffers(
                image=torch.empty(rows, cols, dtype=torch.float32,
                                  device=self.device),
                aux=torch.empty(rows, cols, dtype=torch.float32,
                                device=self.device),
                state=graphs.clone(state))
        b = self._bufs
        if state is not b.state:
            self._load_state(state)
        for dst, src in ((b.image, image), (b.aux, aux)):
            src = torch.as_tensor(src)
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"DeviceVO: frame of shape "
                                 f"{tuple(src.shape)}, expected "
                                 f"{tuple(dst.shape)}")
            dst.copy_(src)

        def fn():
            st = b.state
            fr = self._front(st.templates, st.T_kf, st.T_delta, b.image,
                             b.aux)
            new_state, out = self._commit(st, fr)
            graphs.copy_into(st, new_state)
            return out

        # keyed by this object too: the graph writes this object's buffers
        return b.state, self.cache(("step", self), fn)

    def chunk(self, state: VOState, images, auxs):
        """The steps of a chunk of (N, H, W) frames: one copy to the
        device, N replays, outputs stacked (N, ...) on the device; returns
        (the buffers' state, the stacked outputs)."""
        images, auxs = self._as_chunk(images), self._as_chunk(auxs)
        outs = None
        for i in range(images.shape[0]):
            state, out = self.step(state, images[i], auxs[i])
            if outs is None:
                outs = VOStepOutput(*(
                    t.new_empty((images.shape[0],) + tuple(t.shape))
                    for t in out))
            for dst, src in zip(outs, out):
                dst[i].copy_(src)
        return state, outs

    def _as_chunk(self, frames):
        """(N, H, W) float32 on the device from an array, a tensor or a
        sequence of either: one copy to the device."""
        if isinstance(frames, (list, tuple)) and frames and isinstance(
                frames[0], torch.Tensor):
            return torch.stack([f.to(self.device, torch.float32)
                                for f in frames])
        return torch.as_tensor(np.asarray(frames) if isinstance(
            frames, (list, tuple)) else frames, dtype=torch.float32).to(
                self.device)


class DeviceVO:
    """Host wrapper around the per-frame step; ``init`` consumes the first
    frame (reference FirstFrameResult, vo.cc:123-139).  ``stereo_fn``
    (optional ``(left, right) -> disparity``): the second argument of
    ``add_frame`` is then the right image.

    Routes, chosen statically by device and configuration:

    - CPU: the eager step (``make_vo_step``), every op issued from Python,
      the keyframe decision and each level solve's exit test read on the
      host.
    - CUDA: the whole step is one CUDA graph, replayed each frame (the
      counterpart of JAX's jitted step): the front (pyramid with the census
      kernel, warm start, every level solve, keyframe reason), the keyframe
      branch in an IF node (matcher, template build, re-estimate; JAX's
      ``lax.cond``), and the state update, all into static buffers.  A
      level on ``level_gn`` is one launch; a level on ``gauss_newton.run``
      (more than ``MAX_LEVEL_KERNEL_POINTS`` points, CUBIC or CUBIC_HERMITE
      sampling, the DisparitySpace warp) and a Levenberg-Marquardt level
      are their first iteration and a WHILE node (JAX's
      ``lax.while_loop``), the sigma re-estimate an IF node inside it.
      After the branch the frame's pyramid and store are copied into the
      candidate buffers, as JAX's ``prev_channels=channels``.  A step
      reads nothing back: ``add_frame`` returns device tensors, and
      ``add_frames`` copies the chunk to the card once and replays back to
      back (JAX's ``lax.scan``), its outputs stacked on the card.
    - CUDA with verbose levels (``verbosity`` ITERATION or DEBUG): the
      eager step, whose level solves print a line per iteration.

    On the graphed route ``state`` holds the graph's buffers, which later
    steps overwrite, as JAX's jitted step donates its state; a state set by
    the caller is copied into them at the next step.
    """

    def __init__(self, K, baseline: float, image_size,
                 params: AlgorithmParameters = None, device="cuda",
                 stereo_fn=None):
        p, self._cams, self._capacities, self._opts = _setup_levels(
            K, baseline, image_size, params or AlgorithmParameters())
        self._p = p
        self._image_size = tuple(image_size)
        self.device = resolve_device(device)
        self._stereo_fn = stereo_fn
        # the graphed route (see the class docstring)
        self._graphs = graphs.route(None, self.device, None, {}, self._opts)
        self._step = make_vo_step(p, self._cams, self._capacities, self._opts,
                                  stereo_fn=stereo_fn)
        self._front = _make_front(p, self._cams, self._opts,
                                  stereo_fn is not None)
        self._commit = _make_commit(p, self._cams, self._capacities,
                                    self._opts, stereo_fn)
        self._sg: StepGraph = None
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
            prev_disparity=store,
            has_prev=torch.zeros((), dtype=torch.bool, device=self.device),
            T_kf=eye, pose_world=eye, T_delta=eye,
            last_weights=torch.ones_like(templates[p.maxTestLevel].pixels))

    def add_frame(self, image, aux) -> VOStepOutput:
        """One step; the first call initialises and returns None.  ``aux``
        is the disparity, or the right image with a ``stereo_fn``.  The
        outputs are device tensors, read by the caller when it needs
        them."""
        if self.state is None:
            self.init(image, aux)
            return None
        if self._graphs is not None:
            # the graph's outputs are overwritten by the next replay
            return VOStepOutput(*(t.clone() for t in
                                  self._graphed_step(image, aux)))
        self.state, out = self._step(self.state, self._as_tensor(image),
                                     self._as_tensor(aux))
        return out

    def _step_graph(self) -> StepGraph:
        """The step graph over ``self._graphs`` (made at the first graphed
        step, and again if the cache was replaced)."""
        if self._sg is None or self._sg.cache is not self._graphs:
            self._sg = StepGraph(self._front, self._commit,
                                 self._image_size, self.device, self._graphs)
        return self._sg

    def _graphed_step(self, image, aux) -> VOStepOutput:
        """One replay of the step graph on the frame (tensors on the card,
        or host arrays); returns the graph's outputs."""
        self.state, out = self._step_graph().step(self.state, image, aux)
        return out

    def add_frames(self, images, auxs) -> VOStepOutput:
        """(N,H,W) frames -> VOStepOutput with every field stacked over the
        steps taken (a leading frame initialises when there is no state).
        On the graphed route the chunk is copied to the card once and the
        steps are replayed back to back into (N, ...) outputs on the card,
        with no read of the device."""
        if self.state is None:
            self.init(images[0], auxs[0])
            images, auxs = images[1:], auxs[1:]
        if self._graphs is None:
            outs = [self.add_frame(i, d) for i, d in zip(images, auxs)]
            return VOStepOutput(*(torch.stack(f) for f in zip(*outs)))
        self.state, outs = self._step_graph().chunk(self.state, images, auxs)
        return outs

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
