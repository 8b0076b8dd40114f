"""Windowed photometric bundle adjustment over the last M keyframes, with
the point axis splittable over the ranks of a ``torch.distributed`` group
(counterpart of ``bpvo_tpu/parallel/bundle_adjustment.py``; no reference
analogue, halismai/bpvo tracks frame to keyframe only).

Each keyframe i keeps its finest-level template (points X_i, values I_i,
inverse-compositional Jacobians J_i in its own normalized tangent).  For
each co-visibility edge (i, j) the residual r_ij = I_j(pi(T_j T_i^-1 X_i))
- I_i(X_i) has, to first order in right increments T_k <- T_k exp(d_k),
the Jacobian J_i A_i (d_j - d_i), A_i = Ad(Tn_i T_i): the precomputed
Jacobians serve BA with one 6x6 transform per edge.  The normal equations
form an (M, 6) x (M, 6) block system, gauge-fixed by a prior on keyframe 0.

Per iteration and edge: pass 1 computes the residuals (``compute_residuals``),
the robust sigma comes from all edges' residuals at once
(``sharded.global_sigma``), and pass 2 is one ``irls_reduce_w`` launch on
(J, r, valid, sigma), which gives S = J^T W J, b = J^T W r and sum w r^2
(JAX's ``compute_weights`` and the two dots, bundle_adjustment.py:118-126).
With a reducer the (H, g, f_sq) of every rank are summed in one all-reduce.
The (6M)^2 solve is a library call (``torch.linalg.solve_ex``), as JAX's
is outside any Pallas kernel.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from bpvo_tpu_torch.core import se3
from bpvo_tpu_torch.ops import irls as irls_mod
from bpvo_tpu_torch.parallel import sharded
from bpvo_tpu_torch.parallel.sharded import global_sigma as _global_sigma
from bpvo_tpu_torch.types import InterpolationType, LossFunctionType
from bpvo_tpu_torch.vo import template_data as td_mod
from bpvo_tpu_torch.vo import warp as warp_mod
from bpvo_tpu_torch.vo.device_vo import resolve_device
from bpvo_tpu_torch.vo.template_data import TemplateData


class BAOptions(NamedTuple):
    max_iterations: int = 10
    loss: str = "Tukey"
    interp: InterpolationType = InterpolationType.LINEAR
    gauge_prior: float = 1e6     # prior weight pinning keyframe 0
    damping: float = 1e-4        # Levenberg damping on the block diagonal
    edge_radius: int = 1         # connect keyframes within this distance
    refine_depth: bool = False   # joint pose + inverse depth, Schur elim.
    # depth regularization, relative to the mean photometric depth
    # information: damping on the step and a prior anchored to the stereo
    # inverse depth
    depth_damping: float = 0.1
    depth_prior: float = 0.3


def window_edges(n_keyframes: int, radius: int) -> Tuple[Tuple[int, int], ...]:
    """Co-visibility edges: ordered pairs (i, j), 0 < |i - j| <= radius."""
    return tuple((i, j) for i in range(n_keyframes)
                 for j in range(n_keyframes)
                 if i != j and abs(i - j) <= radius)


def adjoint_similarity(G, scale):
    """6x6 adjoint of the similarity G = [s R | t; 0 1] on twists (w, v):
    Ad = [[R, 0], [[t]x R, s R]], so that G exp(xi) G^-1 = exp(Ad xi)."""
    R = G[:3, :3] / scale
    tx = se3.hat(G[:3, 3])
    top = torch.cat([R, torch.zeros(3, 3, dtype=G.dtype, device=G.device)],
                    dim=1)
    bot = torch.cat([tx @ R, scale * R], dim=1)
    return torch.cat([top, bot], dim=0)


def _loss(opts: BAOptions) -> LossFunctionType:
    return (LossFunctionType.TUKEY if opts.loss == "Tukey"
            else LossFunctionType.HUBER)


def _keyframe(templates: TemplateData, i: int) -> TemplateData:
    return TemplateData(*(x[i] for x in templates))


def _edge_residuals(td_i, channels_j, cam, pose_i, pose_j, opts):
    """Pass 1 of an edge: r (C, K), valid (K,)."""
    return td_mod.compute_residuals(td_i, channels_j, cam,
                                    pose_j @ se3.inverse(pose_i), opts.interp)


def _adjoint(td_i, pose_i):
    G = warp_mod.normalization_matrix(td_i.norm_scale,
                                      td_i.norm_center) @ pose_i
    return adjoint_similarity(G, td_i.norm_scale)


def _reduce_edge(J, r, valid, sigma, loss):
    """Pass 2 of an edge, one ``irls_reduce_w`` launch: J (C, K, 6), r (C,
    K), valid (K,) -> (S (6, 6), b (6,), sum w r^2, w (C, K))."""
    C, K = r.shape
    S, b, f_sq, w = irls_mod.irls_reduce_w(
        J.reshape(-1, 6), r.reshape(-1), valid.expand(C, K).reshape(-1),
        sigma, loss)
    return S, b, f_sq, w.view(C, K)


def _add_edge_block(H, g, i, j, B, be):
    H[j, :, j, :] += B
    H[i, :, i, :] += B
    H[i, :, j, :] -= B
    H[j, :, i, :] -= B
    g[j] += be
    g[i] -= be


def _assemble_edges(edge_data, M: int, opts: BAOptions, reducer):
    """Blocks of ``edge_data`` [(i, j, td_i, pose_i, r, valid)]: the sigma
    of all their residuals, one ``irls_reduce_w`` per edge, the (M,6,M,6)
    system; summed over the ranks when ``reducer`` is given."""
    sigma = _global_sigma(
        torch.cat([torch.abs(e[4][0]) for e in edge_data]),
        torch.cat([e[5] for e in edge_data]), reducer)
    dev = sigma.device
    H = torch.zeros(M, 6, M, 6, dtype=torch.float32, device=dev)
    g = torch.zeros(M, 6, dtype=torch.float32, device=dev)
    f_sq = torch.zeros((), dtype=torch.float32, device=dev)
    loss = _loss(opts)
    for i, j, td_i, pose_i, r, valid in edge_data:
        S, b, f_e, _ = _reduce_edge(td_i.jacobians, r, valid, sigma, loss)
        A = _adjoint(td_i, pose_i)
        _add_edge_block(H, g, i, j, A.T @ S @ A, A.T @ b)
        f_sq = f_sq + f_e
    if reducer is not None:
        H, g, f_sq = reducer.sum(H, g, f_sq)
    return H, g, f_sq


def _assemble(templates: TemplateData, channels, cam, poses, edges,
              opts: BAOptions, reducer=None):
    """The block system over ``edges`` with one residual evaluation per
    edge.  ``templates`` stacked (M, ...), ``channels`` (M, C, H, W),
    ``poses`` (M, 4, 4).  Returns (H (M,6,M,6), g (M,6), f_sq)."""
    edge_data = []
    for i, j in edges:
        td_i = _keyframe(templates, i)
        r, valid = _edge_residuals(td_i, channels[j], cam, poses[i],
                                   poses[j], opts)
        edge_data.append((i, j, td_i, poses[i], r, valid))
    return _assemble_edges(edge_data, poses.shape[0], opts, reducer)


def _solve_pose_system(H, g, opts: BAOptions):
    """Gauge-fixed, damped solve of the (M,6) x (M,6) pose block system."""
    M = g.shape[0]
    dev = g.device
    H = H.clone()
    H[0, :, 0, :] += opts.gauge_prior * torch.eye(6, dtype=torch.float32,
                                                  device=dev)
    Hm = H.reshape(M * 6, M * 6)
    Hm = Hm + opts.damping * torch.diag(torch.diag(Hm)) + 1e-6 * torch.eye(
        M * 6, dtype=torch.float32, device=dev)
    delta = -torch.linalg.solve_ex(Hm, g.reshape(M * 6))[0].reshape(M, 6)
    delta = torch.where(torch.isfinite(delta), delta, 0.0)
    delta[0] = 0.0   # hard gauge fix on keyframe 0
    return delta


def _iterate(assemble, poses_init, opts: BAOptions):
    """``opts.max_iterations`` pose updates from ``assemble(poses) -> (H, g,
    f_sq)``, no host read.  Returns (poses, f_sq of the last iteration)."""
    poses = poses_init.to(torch.float32)
    cost = torch.full((), float("inf"), dtype=torch.float32,
                      device=poses.device)
    for _ in range(opts.max_iterations):
        H, g, cost = assemble(poses)
        poses = poses @ se3.exp(_solve_pose_system(H, g, opts))
    return poses, cost


def ba_solve(templates: TemplateData, channels, cam: warp_mod.CameraModel,
             poses_init, opts: BAOptions, reducer=None):
    """Windowed BA: (poses (M, 4, 4), final weighted cost).  ``templates``
    stacked along a window axis; with ``reducer`` each rank passes its
    slice of the points.  ``opts.refine_depth`` delegates to
    ``ba_solve_with_depth``."""
    if opts.refine_depth:
        poses, _, cost = ba_solve_with_depth(templates, channels, cam,
                                             poses_init, opts, reducer)
        return poses, cost
    edges = window_edges(poses_init.shape[0], opts.edge_radius)
    return _iterate(lambda poses: _assemble(templates, channels, cam, poses,
                                            edges, opts, reducer),
                    poses_init, opts)


def ba_solve_with_depth(templates: TemplateData, channels,
                        cam: warp_mod.CameraModel, poses_init,
                        opts: BAOptions, reducer=None):
    """Joint pose and inverse-depth windowed BA, the depth block eliminated
    by its Schur complement (JAX bundle_adjustment.py:205-360).  The depth
    block is diagonal (one inverse depth per point), so Hpp' = Hpp - Hpd
    Hdd^-1 Hpd^T is a sum over points of per-keyframe products, summed over
    the ranks in one all-reduce of all (6,6) and (6,) terms.  Pass 2 of an
    edge is one ``irls_reduce_w`` launch on J A (the Jacobian in global
    increments).  Returns (poses (M,4,4), refined templates, final cost)."""
    M = poses_init.shape[0]
    edges = window_edges(M, opts.edge_radius)
    loss = _loss(opts)
    K = templates.points.shape[-2]
    dev = templates.points.device
    f32 = torch.float32
    reduce_sum = reducer.sum if reducer is not None else (lambda *t: t)
    vmask = templates.valid.to(f32)                         # (M, K)
    rho0 = 1.0 / torch.clamp(templates.points[..., 2], min=1e-6)

    poses = poses_init.to(f32)
    points = templates.points
    cost = torch.full((), float("inf"), dtype=f32, device=dev)
    for _ in range(opts.max_iterations):
        tds = templates._replace(points=points)
        # pass 1: residuals per edge
        edge_data = []
        for i, j in edges:
            td_i = _keyframe(tds, i)
            r, valid = _edge_residuals(td_i, channels[j], cam, poses[i],
                                       poses[j], opts)
            edge_data.append((td_i, r, valid))
        sigma = _global_sigma(
            torch.cat([torch.abs(r[0]) for _, r, _ in edge_data]),
            torch.cat([v for _, _, v in edge_data]), reducer)
        Z = points[..., 2]                                  # (M, K)

        # pass 2: the pose blocks, depth blocks and couplings
        Hpp = torch.zeros(M, 6, M, 6, dtype=f32, device=dev)
        gp = torch.zeros(M, 6, dtype=f32, device=dev)
        Hdd = torch.zeros(M, K, dtype=f32, device=dev)
        gd = torch.zeros(M, K, dtype=f32, device=dev)
        m_rows = [{} for _ in range(M)]   # m_rows[i][a]: (K, 6) coupling
        f_sq = torch.zeros((), dtype=f32, device=dev)
        A_all = [_adjoint(_keyframe(tds, i), poses[i]) for i in range(M)]
        for (i, j), (td_i, r, valid) in zip(edges, edge_data):
            JA = td_i.jacobians @ A_all[i]                  # (C, K, 6)
            # the depth derivative through the edge's relative pose: a
            # point moved along its ray keeps its identity projection, so
            # depth is seen only through the translation (parallax):
            # dr/drho = [a (t_x X'z - X'x t_z) + b (t_y X'z - X'y t_z)]
            #           * Z / X'z^2, a = gx fx, b = gy fy recovered from
            # the Jacobian's translation block (J_v = (a/Z, b/Z, .)/s)
            T_rel = poses[j] @ se3.inverse(poses[i])
            Xp = td_i.points @ T_rel[:3, :3].T + T_rel[:3, 3]    # (K, 3)
            t = T_rel[:3, 3]
            Zi = td_i.points[:, 2]
            ga = td_i.jacobians[..., 3] * td_i.norm_scale * Zi[None, :]
            gb = td_i.jacobians[..., 4] * td_i.norm_scale * Zi[None, :]
            Xpz = torch.clamp(Xp[:, 2], min=1e-6)
            num = (ga * (t[0] * Xp[:, 2] - Xp[:, 0] * t[2])[None, :]
                   + gb * (t[1] * Xp[:, 2] - Xp[:, 1] * t[2])[None, :])
            d = num * (Zi / (Xpz * Xpz))[None, :]               # (C, K)
            S, b, f_e, w = _reduce_edge(JA, r, valid, sigma, loss)
            _add_edge_block(Hpp, gp, i, j, S, b)
            m = torch.einsum("ckp,ck->kp", JA, w * d)           # (K, 6)
            m_rows[i][j] = m_rows[i].get(j, 0.0) + m
            m_rows[i][i] = m_rows[i].get(i, 0.0) - m
            Hdd[i] += torch.sum(w * d * d, dim=0)
            gd[i] += torch.sum(w * r * d, dim=0)
            f_sq = f_sq + f_e
        # the depth terms stay on their rank; only (6,6)/(6,) products and
        # the depth-information mean are summed
        Hpp, gp, f_sq = reduce_sum(Hpp, gp, f_sq)
        n_val, h_sum = reduce_sum(torch.sum(vmask), torch.sum(Hdd * vmask))
        h_mean = h_sum / torch.clamp(n_val, min=1.0)
        wp = opts.depth_prior * h_mean
        rho = 1.0 / torch.clamp(Z, min=1e-6)
        gd = gd + wp * (rho - rho0)
        Hdd = Hdd + wp + opts.depth_damping * h_mean

        # the Schur complement over the depths
        inv_h = 1.0 / torch.clamp(Hdd, min=1e-12)               # (M, K)
        terms, keys = [], []
        for i in range(M):
            for a, Ra in m_rows[i].items():
                terms.append(torch.einsum("kp,k->p", Ra, inv_h[i] * gd[i]))
                keys.append((a, None))
                for bkey, Rb in m_rows[i].items():
                    terms.append(torch.einsum("kp,k,kq->pq", Ra, inv_h[i],
                                              Rb))
                    keys.append((a, bkey))
        for (a, bkey), corr in zip(keys, reduce_sum(*terms)):
            if bkey is None:
                gp[a] -= corr
            else:
                Hpp[a, :, bkey, :] -= corr
        delta = _solve_pose_system(Hpp, gp, opts)

        # depth back-substitution: X <- X / (1 + Z drho), clamped so no
        # depth changes sign
        new_points = []
        for i in range(M):
            coupling = sum(Ra @ delta[a] for a, Ra in m_rows[i].items())
            drho = -inv_h[i] * (gd[i] + coupling)
            scale = torch.clamp(1.0 + Z[i] * drho, 0.8, 1.25)
            new_points.append(points[i] / scale[:, None])
        points = torch.stack(new_points)
        poses = poses @ se3.exp(delta)
        cost = f_sq
    return poses, templates._replace(points=points), cost


def make_sharded_ba(reducer, opts: BAOptions, m_keyframes: int):
    """Distributed BA (JAX ``make_sharded_ba``): run(templates_shard,
    channels, cam, poses) -> (poses, cost), each rank holding its
    ``sharded.shard_template`` slice of the stacked window's points,
    channels and poses whole; the block system summed over the ranks each
    iteration."""
    def run(templates_shard, channels, cam, poses):
        if templates_shard.points.shape[0] != m_keyframes:
            raise ValueError(f"make_sharded_ba: a window of "
                             f"{templates_shard.points.shape[0]} keyframes, "
                             f"built for {m_keyframes}")
        return ba_solve(templates_shard, channels, cam, poses, opts, reducer)
    return run


def _assemble_kf_sharded(templates_loc: TemplateData, channels, cam, poses,
                         opts: BAOptions, m_global: int, kf_idx: int,
                         reducer):
    """The edges out of this rank's keyframes (kf coordinate ``kf_idx``,
    ``templates_loc`` its (M / kf, ...) keyframes, their points this rank's
    slice), one sum over every rank of H, g, f_sq and the sigma histogram
    (JAX bundle_adjustment.py:383-456, which psums over both mesh axes).
    The keyframe indices are host integers here, so an edge that leaves the
    window is skipped: JAX masks it to zero weight, which adds nothing."""
    m_loc = templates_loc.points.shape[0]
    edge_data = []
    for i_loc in range(m_loc):
        i = kf_idx * m_loc + i_loc
        td_i = _keyframe(templates_loc, i_loc)
        for off in range(-opts.edge_radius, opts.edge_radius + 1):
            j = i + off
            if off == 0 or not 0 <= j < m_global:
                continue
            r, valid = _edge_residuals(td_i, channels[j], cam, poses[i],
                                       poses[j], opts)
            edge_data.append((i, j, td_i, poses[i], r, valid))
    return _assemble_edges(edge_data, m_global, opts, reducer)


def shard_window_2d(templates: TemplateData, rank: int, layout):
    """Rank ``rank``'s part of a stacked window on a ``multihost.RankLayout``
    (kf x points): the keyframes of its kf coordinate, their points sliced
    by its points coordinate."""
    kf_idx, pt_idx = layout.coords(rank)
    M = templates.points.shape[0]
    if M % layout.kf:
        raise ValueError(f"shard_window_2d: {M} keyframes over a kf axis of "
                         f"{layout.kf}")
    m_loc = M // layout.kf
    local = TemplateData(*(x[kf_idx * m_loc:(kf_idx + 1) * m_loc]
                           for x in templates))
    return sharded.shard_template(local, pt_idx, layout.points)


def make_sharded_ba_2d(reducer, opts: BAOptions, m_keyframes: int, layout):
    """Distributed BA on a (kf, points) layout of the ranks (JAX
    ``make_sharded_ba_2d``): run(templates_loc, channels, cam, poses) ->
    (poses, cost), ``templates_loc`` this rank's ``shard_window_2d``,
    channels and poses whole; one all-reduce over every rank per
    iteration.  Matches the pose-only ``ba_solve``."""
    if m_keyframes % layout.kf:
        raise ValueError(f"make_sharded_ba_2d: {m_keyframes} keyframes over "
                         f"a kf axis of {layout.kf}")
    kf_idx, _ = layout.coords(0 if reducer is None else reducer.rank)

    def run(templates_loc, channels, cam, poses):
        return _iterate(lambda P: _assemble_kf_sharded(
            templates_loc, channels, cam, P, opts, m_keyframes, kf_idx,
            reducer), poses, opts)
    return run


def stack_templates(templates: Sequence[TemplateData]) -> TemplateData:
    """Stack per-keyframe templates (equal capacity) along a window axis."""
    return TemplateData(*(torch.stack(xs) for xs in zip(*templates)))


class KeyframeWindow:
    """Host-side sliding window of keyframes feeding the BA solver.
    Collects (template, channels, pose) at each keyframe and slides when
    full; ``optimize()`` runs windowed BA on ``device`` (split over the
    ranks of ``reducer`` when given) and returns the refined poses."""

    def __init__(self, max_keyframes: int, cam: warp_mod.CameraModel,
                 opts: BAOptions = BAOptions(), reducer=None, device="cuda"):
        self._max = max_keyframes
        self._cam = cam
        self._opts = opts
        self._reducer = reducer
        self._device = resolve_device(device)
        self._templates = []
        self._channels = []
        self._poses = []

    def __len__(self):
        return len(self._templates)

    def push(self, template: TemplateData, channels, pose_world: np.ndarray):
        """``pose_world``: camera-from-world warp pose T_i (X_i = T_i X_w)."""
        self._templates.append(TemplateData(*(t.to(self._device)
                                              for t in template)))
        self._channels.append(torch.as_tensor(channels).to(self._device))
        self._poses.append(np.asarray(pose_world, np.float32))
        if len(self._templates) > self._max:
            self._templates.pop(0)
            self._channels.pop(0)
            self._poses.pop(0)

    def optimize(self) -> np.ndarray:
        """Run BA over the current window; returns the refined (M, 4, 4)
        poses (one read of the device)."""
        M = len(self._templates)
        if M < 2:
            return np.asarray(self._poses)
        templates = stack_templates(self._templates)
        channels = torch.stack(self._channels)
        poses = torch.from_numpy(np.stack(self._poses)).to(self._device)
        if self._reducer is not None:
            templates = sharded.shard_template(
                templates, self._reducer.rank, self._reducer.world)
        new_poses, _ = ba_solve(templates, channels, self._cam, poses,
                                self._opts, self._reducer)
        new_np = new_poses.cpu().numpy()
        self._poses = [new_np[i] for i in range(M)]
        return new_np
