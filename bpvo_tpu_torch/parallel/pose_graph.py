"""Pose-graph optimization over keyframe poses (counterpart of
``bpvo_tpu/parallel/pose_graph.py``; no reference analogue, halismai/bpvo
only accumulates a trajectory, trajectory.cc:42-50).

Nodes are keyframe warp poses T_k (camera-from-world); edges carry measured
relative poses Z_ij ~ T_i T_j^-1 with 6x6 information matrices.  The edge
residual is r_ij = log(Z_ij^-1 T_i(d_i) T_j(d_j)^-1) with right increments
T_k(d) = T_k exp(d_k); its Jacobian comes from forward-mode autodiff
(``torch.func.jacfwd``, where JAX uses ``jax.jacfwd``) through the closed
form ``se3.log``, and the normal equations are one dense (6N, 6N) solve.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from bpvo_tpu_torch.core import se3
from bpvo_tpu_torch.vo.device_vo import resolve_device


class PoseGraphOptions(NamedTuple):
    max_iterations: int = 10
    damping: float = 1e-6
    gauge_prior: float = 1e9


def edge_residuals(poses, deltas, edge_idx, measurements_inv):
    """All edge residuals (E, 6) for perturbed poses T_k exp(d_k)."""
    T = poses @ se3.exp(deltas)
    Ti = T[edge_idx[:, 0]]
    Tj = T[edge_idx[:, 1]]
    return se3.log(measurements_inv @ (Ti @ se3.inverse(Tj)))


def optimize(poses_init, edge_idx, measurements, information,
             opts: PoseGraphOptions = PoseGraphOptions(), device="cuda"):
    """Optimize (N, 4, 4) poses given (E, 2) edge indices, (E, 4, 4)
    measured relative poses and (E, 6, 6) information matrices (arrays or
    tensors), ``opts.max_iterations`` GN steps with no host read.  Node 0
    is the gauge.  Returns (poses (N, 4, 4), chi2 of the last
    linearization), tensors on ``device``."""
    dev = resolve_device(device)
    f32 = torch.float32

    def t(a, dtype=f32):
        return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a)
                               else a).to(device=dev, dtype=dtype)

    poses = t(poses_init)
    edge_idx = t(edge_idx, torch.int64)
    meas_inv = se3.inverse(t(measurements))
    info = t(information)
    N, E = poses.shape[0], edge_idx.shape[0]
    eye_n = torch.eye(N * 6, dtype=f32, device=dev)
    prior = torch.zeros(N * 6, N * 6, dtype=f32, device=dev)
    prior[:6, :6] = opts.gauge_prior * torch.eye(6, dtype=f32, device=dev)
    zero = torch.zeros(N, 6, dtype=f32, device=dev)
    chi2 = torch.full((), float("inf"), dtype=f32, device=dev)
    for _ in range(opts.max_iterations):
        def res(d, poses=poses):
            return edge_residuals(poses, d, edge_idx, meas_inv)
        r = res(zero)                                       # (E, 6)
        J = torch.func.jacfwd(res)(zero)                    # (E, 6, N, 6)
        Jf = J.reshape(E * 6, N * 6)
        Lr = torch.einsum("epq,eq->ep", info, r).reshape(E * 6)
        LJ = torch.einsum("epq,eqnk->epnk", info, J).reshape(E * 6, N * 6)
        H = Jf.T @ LJ + prior
        g = Jf.T @ Lr
        chi2 = torch.dot(r.reshape(-1), Lr)
        H = H + opts.damping * eye_n
        delta = -torch.linalg.solve_ex(H, g)[0].reshape(N, 6)
        delta = torch.where(torch.isfinite(delta), delta, 0.0)
        delta[0] = 0.0
        poses = poses @ se3.exp(delta)
    return poses, chi2


def sequential_edges(n: int) -> np.ndarray:
    """Odometry chain edges (k, k+1)."""
    return np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)


class PoseGraph:
    """Host-side accumulator: add odometry and loop-closure constraints,
    optimize on ``device``."""

    def __init__(self, opts: PoseGraphOptions = PoseGraphOptions(),
                 device="cuda"):
        self._opts = opts
        self._device = resolve_device(device)
        self._poses = []
        self._edges = []
        self._measurements = []
        self._infos = []

    def add_node(self, T: np.ndarray) -> int:
        self._poses.append(np.asarray(T, np.float32))
        return len(self._poses) - 1

    def add_edge(self, i: int, j: int, Z_ij: np.ndarray,
                 information: np.ndarray = None):
        self._edges.append((i, j))
        self._measurements.append(np.asarray(Z_ij, np.float32))
        self._infos.append(np.eye(6, dtype=np.float32)
                           if information is None
                           else np.asarray(information, np.float32))

    def optimize(self) -> np.ndarray:
        if len(self._poses) < 2 or not self._edges:
            return np.stack(self._poses) if self._poses else np.zeros((0, 4, 4))
        poses, _ = optimize(
            np.stack(self._poses), np.asarray(self._edges, np.int64),
            np.stack(self._measurements), np.stack(self._infos), self._opts,
            device=self._device)
        out = poses.cpu().numpy()
        self._poses = [out[k] for k in range(len(out))]
        return out
