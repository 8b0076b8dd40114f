"""Coarse-to-fine pose estimation over the pyramid (counterpart of
``bpvo_tpu/vo/pose_estimator.py``; reference vo_pose_estimator.cc:63-107).

Each Gauss-Newton level is solved by ``gauss_newton.solve_level``: the
one-launch level kernel on levels it takes, ``gauss_newton.run`` on the
others, whose iterations ``PoseEstimator`` replays from CUDA graphs on CUDA
(one ``gauss_newton.RunGraphs`` per level).  Levenberg-Marquardt levels run
``levenberg_marquardt.run`` (never the level kernel, as in the JAX
package).  With ``coarseInitOffsetPx`` > 0 a multi-start probe picks the
start among five candidates.  The level chain stays on the device;
``PoseEstimator.estimate`` reads its results back in one copy.
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
    return cands[best], best


def _estimate_all(templates, channels, cams, T_init, opts_per_level,
                  max_test_level: int, good_threshold: float,
                  min_points: int = 0, solver: str = "GaussNewton",
                  start_level: int = -1, alt_init=None,
                  multistart_px: float = 0.0, run_graphs=None,
                  linearize_factory=None, count_reduce=None):
    """Coarse-to-fine estimation from ``start_level`` (default: coarsest)
    down to ``max_test_level``.  ``alt_init`` is taken instead of ``T_init``
    when its photometric cost at the start level is not higher.
    ``run_graphs`` (one ``gauss_newton.RunGraphs`` per level) replays the
    iterations of levels that take ``gauss_newton.run``.  ``solver`` is
    "GaussNewton" or "LevenbergMarquardt"; ``multistart_px`` > 0 runs the
    multi-start probe (``_multistart``) first.

    The distributed hooks (JAX bpvo_tpu/vo/device_vo.py:113-172):
    ``linearize_factory(level, tdata, channels, cam, opts)`` returns the
    ``linearize_fn`` of a level, which then always takes the eager
    ``gauss_newton.run`` (never the level kernel, never ``run_graphs``);
    ``count_reduce`` sums a tensor over the ranks (the good-point count).

    Returns (T, iters (L,), f_norm (L,), g (L, 6), status (L,), frac_good,
    H (6,6), finest weights, band_overflow ()), all on the device; levels
    not solved keep zeros and STATUS_MAX_ITERATIONS."""
    if solver not in ("GaussNewton", "LevenbergMarquardt"):
        raise ValueError(f"unknown poseEstimator {solver!r}")
    if linearize_factory is not None and (
            solver != "GaussNewton" or run_graphs is not None
            or multistart_px > 0):
        raise ValueError("a custom linearization runs Gauss-Newton on the "
                         "eager gauss_newton.run only: no LM, no run_graphs,"
                         " no multi-start")
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
                                cams[level], T, opts_per_level[level],
                                graphs=run_graphs and run_graphs[level])
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


class PoseEstimator:
    def __init__(self, p: AlgorithmParameters):
        self._p = p
        self._fine_opts = gn.GNOptions.from_params(p, coarse=False)
        self._coarse_opts = gn.GNOptions.from_params(p, coarse=True)
        self._last_weights = None
        self._last_H = None
        self._last_frac = 1.0
        self._run_graphs = None

    def _level_graphs(self, channels_pyr):
        """One ``gauss_newton.RunGraphs`` per level on CUDA (the graphed
        route of ``gauss_newton.run``), None on the CPU and for LM."""
        if (self._run_graphs is None and self._p.poseEstimator == "GaussNewton"
                and channels_pyr[0].device.type == "cuda"):
            self._run_graphs = tuple(gn.RunGraphs()
                                     for _ in range(len(channels_pyr)))
        return self._run_graphs

    def _opts_for(self, n_levels: int):
        return tuple(self._fine_opts if lvl == self._p.maxTestLevel
                     else self._coarse_opts for lvl in range(n_levels))

    def estimate(self, templates: Sequence, channels_pyr: Sequence, cams,
                 T_init, start_level: int = -1, alt_init=None,
                 multistart_px: float = 0.0):
        """Coarse-to-fine estimate from the (4,4) tensor ``T_init``;
        ``start_level`` >= 0 starts below the coarsest level, ``alt_init``
        is a cost-gated alternative start.

        Returns (T_est (4,4) np.float32, per-level OptimizerStatistics from
        maxTestLevel up)."""
        p = self._p
        n_levels = len(channels_pyr)
        T, iters, fs, g, status, frac, H, w, _ = _estimate_all(
            tuple(templates), tuple(channels_pyr), tuple(cams), T_init,
            self._opts_for(n_levels), p.maxTestLevel, p.goodPointThreshold,
            _MIN_POINTS_PER_LEVEL, p.poseEstimator, start_level, alt_init,
            multistart_px, self._level_graphs(channels_pyr))
        self._last_weights = w
        # one device -> host copy of everything the host reads
        host = torch.cat([T.reshape(-1), H.reshape(-1), g.reshape(-1),
                          iters.to(torch.float32), fs,
                          status.to(torch.float32),
                          frac.reshape(1)]).cpu().numpy()
        T_np = host[:16].reshape(4, 4).copy()
        self._last_H = host[16:52].reshape(6, 6).astype(np.float64)
        end = 52 + 6 * n_levels
        gs_np = np.abs(host[52:end].reshape(n_levels, 6)).max(1)
        iters_np, fs_np, st_np = host[end:end + 3 * n_levels].reshape(
            3, n_levels)
        self._last_frac = float(host[-1])
        stats: List[OptimizerStatistics] = [
            OptimizerStatistics(num_iterations=int(iters_np[level]),
                                final_error=float(fs_np[level]),
                                first_order_optimality=float(gs_np[level]),
                                status=gn.STATUS_ENUMS[int(st_np[level])])
            for level in range(p.maxTestLevel, n_levels)]
        return T_np, stats

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
