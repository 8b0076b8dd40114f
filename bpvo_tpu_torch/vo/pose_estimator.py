"""Coarse-to-fine pose estimation over the pyramid (counterpart of
``bpvo_tpu/vo/pose_estimator.py``; reference vo_pose_estimator.cc:63-107).

Each Gauss-Newton level is solved by ``gauss_newton.solve_level``: the
one-launch level kernel on levels it takes, ``gauss_newton.run`` on the
others.  Levenberg-Marquardt levels run ``levenberg_marquardt.run`` (never
the level kernel, as in the JAX package).  With ``coarseInitOffsetPx`` > 0
a multi-start probe picks the start among five candidates.

``PoseEstimator.estimate`` given a ``utils.graphs.GraphCache`` runs the
whole chain (the warm-start gate, the multi-start, every level solve, the
good-point fraction) as one CUDA graph (JAX's jitted ``_estimate_all``),
a graph per static key: the options per level, the level range, the
thresholds, the solver, whether an alternative start is given and the
multi-start offset.  Its inputs are copied into the key's static buffers:
the templates only when another template object arrives (at keyframes),
the channels and the starts on every call.  Every ``gauss_newton.run`` or
LM level is a WHILE node of that graph.  Without a cache the chain runs
eagerly.  Either way ``estimate`` reads its results back in one copy,
then adds the level kernel's solves to the ``gn_*`` counters of
``utils.profiling`` (``PoseEstimator._count_solves``).
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from bpvo_tpu_torch.config import AlgorithmParameters
from bpvo_tpu_torch.solver import gauss_newton as gn
from bpvo_tpu_torch.solver import levenberg_marquardt as lm
from bpvo_tpu_torch.solver import mestimator
from bpvo_tpu_torch.types import OptimizerStatistics
from bpvo_tpu_torch.utils import profiling
from bpvo_tpu_torch.vo import template_data as td_mod

# fewer valid points than this cannot constrain the 6-DoF solve; such levels
# leave the pose untouched.  Not minNumPixelsToWork: the reference parses
# that key but runs every level (vo_pose_estimator.cc:76-90).
_MIN_POINTS_PER_LEVEL = 8


def _coarse_cost(templates, channels_pyr, cams, T, opts, level=None,
                 count_reduce=None):
    """Mean squared residual over valid points at a coarse level (default:
    the coarsest): the probe of the warm-start acceptance gate.  With
    ``count_reduce`` (the sharded step's sum over ranks) the sum and the
    count are global, so every rank takes the same start."""
    lvl = len(channels_pyr) - 1 if level is None else level
    r, valid = td_mod.compute_residuals(templates[lvl], channels_pyr[lvl],
                                        cams[lvl], T, opts.interp,
                                        warp=opts.warp)
    sq = torch.sum(torch.where(valid[None, :], r, 0.0) ** 2)
    n = torch.sum(valid)
    if count_reduce is not None:
        sq, n = count_reduce(torch.stack([sq, n.to(sq.dtype)]))
    return sq / torch.clamp(n, min=1).to(torch.float32)


def _gated_warm_start(templates, channels_pyr, cams, T_warm, T_cold, opts,
                      level=None, count_reduce=None):
    """Take the warm prediction only when its photometric cost at the probe
    level does not exceed the cold start's."""
    c_warm = _coarse_cost(templates, channels_pyr, cams, T_warm, opts, level,
                          count_reduce)
    c_cold = _coarse_cost(templates, channels_pyr, cams, T_cold, opts, level,
                          count_reduce)
    return torch.where(c_warm <= c_cold, T_warm, T_cold)


def _multistart(templates, channels, cams, T, opts_per_level,
                start_level: int, max_test_level: int, multistart_px: float):
    """The alias-recovery multi-start (config coarseInitOffsetPx,
    bpvo_tpu/vo/pose_estimator.py:85-130): the robust cost (mean |r| over
    valid points) of T and of T shifted by +-multistart_px full-resolution
    pixels in x and in y, metricized by the median template depth, at the
    level midway between the start and the finest solved level (the
    coarsest cannot resolve one texture period).  The centred candidate
    wins ties by a 0.999 margin.  Returns (the cheapest candidate, its
    index)."""
    pl = min(max((start_level + max_test_level) // 2, max_test_level),
             start_level)
    td, o = templates[pl], opts_per_level[pl]
    zmed = mestimator.masked_median_sort(td.points[:, 2], td.valid)
    step = multistart_px * zmed / cams[0].fx

    def robust_cost(Tp):
        r, valid = td_mod.compute_residuals(td, channels[pl], cams[pl], Tp,
                                            o.interp, warp=o.warp)
        n = torch.clamp(torch.sum(valid), min=1).to(torch.float32)
        return torch.sum(torch.abs(torch.where(valid[None, :], r, 0.0))) / n

    def shifted(row, d):
        Ts = T.clone()
        Ts[row, 3] += d
        return Ts

    cands = torch.stack([T, shifted(0, step), shifted(0, -step),
                         shifted(1, step), shifted(1, -step)])
    costs = torch.stack([robust_cost(Tc) for Tc in cands])
    costs = torch.cat([costs[:1] * 0.999, costs[1:]])
    best = torch.argmin(costs)
    # index_select, not cands[best]: a 0-d index is read on the host
    return torch.index_select(cands, 0, best.reshape(1))[0], best


def _estimate_all(templates, channels, cams, T_init, opts_per_level,
                  max_test_level: int, good_threshold: float,
                  min_points: int = 0, solver: str = "GaussNewton",
                  start_level: int = -1, alt_init=None,
                  multistart_px: float = 0.0, linearize_factory=None,
                  count_reduce=None):
    """Coarse-to-fine estimation from ``start_level`` (default: coarsest)
    down to ``max_test_level``.  ``alt_init`` is taken instead of ``T_init``
    when its photometric cost at the start level is not higher.
    ``solver`` is "GaussNewton" or "LevenbergMarquardt"; ``multistart_px``
    > 0 runs the multi-start probe (``_multistart``) first.  No host read:
    in a function a ``GraphCache`` captures, every ``gauss_newton.run`` or
    LM loop is a WHILE node.

    The distributed hooks (JAX bpvo_tpu/vo/device_vo.py:113-172):
    ``linearize_factory(level, tdata, channels, cam, opts)`` returns the
    ``linearize_fn`` of a level, which then always takes
    ``gauss_newton.run`` (never the level kernel);
    ``count_reduce`` sums a tensor over the ranks (the good-point count).

    Returns (T, iters (L,), f_norm (L,), g (L, 6), status (L,), frac_good,
    H (6,6), finest weights, band_overflow ()), all on the device; levels
    not solved keep zeros and STATUS_MAX_ITERATIONS."""
    if solver not in ("GaussNewton", "LevenbergMarquardt"):
        raise ValueError(f"unknown poseEstimator {solver!r}")
    if linearize_factory is not None and (solver != "GaussNewton"
                                          or multistart_px > 0):
        raise ValueError("a custom linearization runs Gauss-Newton on "
                         "gauss_newton.run only: no LM, no multi-start")
    n_levels = len(channels)
    if start_level < 0:
        start_level = n_levels - 1
    dev = T_init.device
    T = T_init.to(torch.float32)
    if alt_init is not None:
        T = _gated_warm_start(templates, channels, cams,
                              alt_init.to(torch.float32), T,
                              opts_per_level[start_level], level=start_level)
    if multistart_px > 0:
        T, _ = _multistart(templates, channels, cams, T, opts_per_level,
                           start_level, max_test_level, multistart_px)
    iters = [torch.zeros((), dtype=torch.int32, device=dev)] * n_levels
    fs = [torch.zeros((), dtype=torch.float32, device=dev)] * n_levels
    gs = [torch.zeros(6, dtype=torch.float32, device=dev)] * n_levels
    status = [torch.full((), gn.STATUS_MAX_ITERATIONS, dtype=torch.int32,
                         device=dev)] * n_levels
    finest = None
    for level in range(start_level, max_test_level - 1, -1):
        if linearize_factory is not None:
            st = gn.run(templates[level], channels[level], cams[level], T,
                        opts_per_level[level],
                        linearize_fn=linearize_factory(
                            level, templates[level], channels[level],
                            cams[level], opts_per_level[level]))
        elif solver == "LevenbergMarquardt":
            st = lm.run(templates[level], channels[level], cams[level], T,
                        opts_per_level[level])
        else:
            st = gn.solve_level(templates[level], channels[level],
                                cams[level], T, opts_per_level[level])
        enough = templates[level].num_valid >= min_points
        T = torch.where(enough, st.T, T)
        iters[level] = torch.where(enough, st.num_iters, 0).to(torch.int32)
        fs[level], gs[level], status[level] = st.f_norm, st.g, st.status
        finest = st
    td = templates[max_test_level]
    frac = gn.fraction_of_good_points(finest.weights, td.num_channels,
                                      td.num_valid, good_threshold,
                                      count_reduce)
    # LM has no band_overflow: no kernel samples in bands on its route
    bo = getattr(finest, "band_overflow",
                 torch.zeros((), dtype=torch.int32, device=dev))
    return (T, torch.stack(iters), torch.stack(fs), torch.stack(gs),
            torch.stack(status), frac, finest.H, finest.weights, bo)


def _estimate_packed(templates, channels, cams, starts, opts_per_level,
                     max_test_level: int, good_threshold: float,
                     min_points: int, solver: str, start_level: int,
                     with_alt: bool, multistart_px: float):
    """``_estimate_all`` from ``starts[0]`` (with ``with_alt``,
    ``starts[1]`` the gated alternative), its results packed for the
    host's one read: (packed (52 + 9 L,) f32: T, H, g per level, iters,
    f_norm and status per level, frac_good; the finest weights)."""
    T, iters, fs, g, status, frac, H, w, _ = _estimate_all(
        templates, channels, cams, starts[0], opts_per_level,
        max_test_level, good_threshold, min_points, solver, start_level,
        starts[1] if with_alt else None, multistart_px)
    return torch.cat([T.reshape(-1), H.reshape(-1), g.reshape(-1),
                      iters.to(torch.float32), fs, status.to(torch.float32),
                      frac.reshape(1)]), w


class PoseEstimator:
    """``opts_per_level``: each level's ``GNOptions``
    (``device_vo._setup_levels``)."""

    def __init__(self, p: AlgorithmParameters, opts_per_level):
        self._p = p
        self._opts = tuple(opts_per_level)
        self._last_weights = None
        self._last_H = None
        self._last_frac = 1.0
        # the starts' pinned staging on CUDA (``_starts``)
        self._pinned = None

    def _starts(self, T_init, alt_init, device):
        """(2, 4, 4) f32 on ``device``: ``T_init`` and ``alt_init`` (or
        ``T_init`` again), host arrays.  On CUDA one asynchronous copy
        from pinned memory, which the host rewrites only at the next
        estimate, after this one's read has waited for the copy."""
        host = np.stack([T_init, T_init if alt_init is None else alt_init]
                        ).astype(np.float32)
        if device.type != "cuda":
            return profiling.upload(torch.from_numpy(host), device)
        if self._pinned is None:
            self._pinned = torch.empty((2, 4, 4), dtype=torch.float32,
                                       pin_memory=True)
        self._pinned.numpy()[...] = host
        return profiling.upload(self._pinned, device, non_blocking=True)

    @staticmethod
    def _read(packed) -> np.ndarray:
        """The estimate's one device -> host copy (the wait span
        ``vo.read``)."""
        return profiling.device_read("vo.read", packed)

    def estimate(self, templates: Sequence, channels_pyr: Sequence, cams,
                 T_init, start_level: int = -1, alt_init=None,
                 multistart_px: float = 0.0, graphs=None):
        """Coarse-to-fine estimate from ``T_init`` ((4,4) host array);
        ``start_level`` >= 0 starts below the coarsest level, ``alt_init``
        is a cost-gated alternative start.  ``graphs``: a
        ``utils.graphs.GraphCache`` that runs the whole estimate as one
        graph of the static key (the templates copied into its buffers
        when another template object arrives), or None for the eager
        chain.  One device read either way.

        Returns (T_est (4,4) np.float32, per-level OptimizerStatistics from
        maxTestLevel up)."""
        p = self._p
        n_levels = len(channels_pyr)
        starts = self._starts(T_init, alt_init, channels_pyr[0].device)
        static = (self._opts, p.maxTestLevel,
                  p.goodPointThreshold, _MIN_POINTS_PER_LEVEL,
                  p.poseEstimator, start_level, alt_init is not None,
                  multistart_px)
        cams = tuple(cams)
        if graphs is None:
            packed, w = _estimate_packed(tuple(templates),
                                         tuple(channels_pyr), cams, starts,
                                         *static)
        else:
            packed, w = graphs.jit(
                ("estimate", cams, *static),
                (templates, tuple(channels_pyr), starts),
                lambda b: _estimate_packed(b[0], b[1], cams, b[2], *static),
                held=(0,))
        self._last_weights = w
        host = self._read(packed)
        T_np = host[:16].reshape(4, 4).copy()
        self._last_H = host[16:52].reshape(6, 6).astype(np.float64)
        end = 52 + 6 * n_levels
        gs_np = np.abs(host[52:end].reshape(n_levels, 6)).max(1)
        iters_np, fs_np, st_np = host[end:end + 3 * n_levels].reshape(
            3, n_levels)
        self._last_frac = float(host[-1])
        self._count_solves(templates, channels_pyr, iters_np, start_level)
        stats: List[OptimizerStatistics] = [
            OptimizerStatistics(num_iterations=int(iters_np[level]),
                                final_error=float(fs_np[level]),
                                first_order_optimality=float(gs_np[level]),
                                status=gn.STATUS_ENUMS[int(st_np[level])])
            for level in range(p.maxTestLevel, n_levels)]
        return T_np, stats

    def _count_solves(self, templates, channels_pyr, iters, start_level):
        """Add the level solves of the estimate just read that the level
        kernel ran (``gauss_newton.solve_level``'s route) to the counters
        (``utils.profiling``): ``gn_solves`` one a solve, ``gn_points`` its
        template capacity K, ``gn_channel_points`` C K, ``gn_iter_points``
        it K and ``gn_iter_channel_points`` it C K, with ``it`` the level's
        GN iterations from the read, at least 1 (a level with too few
        valid points reads 0 and still ran)."""
        p = self._p
        if p.poseEstimator != "GaussNewton":
            return
        first = len(channels_pyr) - 1 if start_level < 0 else start_level
        n = k = ck = itk = itck = 0
        for level in range(first, p.maxTestLevel - 1, -1):
            C, rows, cols = channels_pyr[level].shape
            K = templates[level].pixels.shape[1]
            if not gn.level_kernel_supported(self._opts[level], C, rows,
                                             cols, K):
                continue
            it = max(int(iters[level]), 1)
            n, k, ck = n + 1, k + K, ck + C * K
            itk, itck = itk + it * K, itck + it * C * K
        profiling.count("gn_solves", n)
        profiling.count("gn_points", k)
        profiling.count("gn_channel_points", ck)
        profiling.count("gn_iter_points", itk)
        profiling.count("gn_iter_channel_points", itck)

    def fraction_of_good_points(self, threshold: float) -> float:
        """(reference vo_pose_estimator.cc:101-107), computed during
        ``estimate`` with the threshold of the AlgorithmParameters."""
        return self._last_frac

    def last_weights(self):
        return self._last_weights

    def last_covariance(self) -> np.ndarray:
        """6x6 covariance = inverse of the last finest-level GN Hessian
        (reference Result.covariance, types.h:503)."""
        if self._last_H is None:
            return np.eye(6)
        try:
            return np.linalg.inv(self._last_H)
        except np.linalg.LinAlgError:
            return np.linalg.pinv(self._last_H)
