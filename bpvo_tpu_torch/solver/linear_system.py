"""Weighted Gauss-Newton normal equations and the jittered 6x6 solve
(counterpart of ``bpvo_tpu/solver/linear_system.py``)."""
from __future__ import annotations

import torch


def build(J, r, w):
    """J (..., N, 6), r (..., N), w (..., N) (zero where invalid); leading
    axes are reduced.  Returns (H (6,6), g (6,), f_sq = sum w r^2), with the
    products in the same order as the level kernel: (J_i w) J_j, (J_i w) r,
    (r w) r."""
    lhs = torch.cat([J * w[..., None], (r * w)[..., None]], dim=-1)
    rhs = torch.cat([J, r[..., None]], dim=-1)
    block = lhs.reshape(-1, 7).T @ rhs.reshape(-1, 7)
    return block[:6, :6], block[:6, 6], block[6, 6]


def cholesky_solve_6x6(H, g):
    """Unrolled LL^T solve of H x = g; diagonal pivots floored at 1e-20."""
    L = [[None] * 6 for _ in range(6)]
    for i in range(6):
        for j in range(i + 1):
            s = H[i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][i] = torch.sqrt(torch.clamp(s, min=1e-20))
            else:
                L[i][j] = s / L[j][j]
    y = [None] * 6
    for i in range(6):
        s = g[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * 6
    for i in reversed(range(6)):
        s = y[i]
        for k in range(i + 1, 6):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x)


def solve(H, g):
    """Solve H dp = g on H + (1e-6 max(diag H) + 1e-12) I.

    Returns (dp, ok): dp is zeroed when not finite, and ok also requires the
    residual check |H dp - g|_inf <= 1e-3 (1 + |g|_inf)."""
    eye = torch.eye(6, dtype=H.dtype, device=H.device)
    dp = cholesky_solve_6x6(H + (1e-6 * torch.max(torch.diag(H)) + 1e-12) * eye,
                            g)
    finite = torch.all(torch.isfinite(dp))
    dp = torch.where(finite, dp, 0.0)
    ok = finite & (torch.max(torch.abs(H @ dp - g))
                   <= 1e-3 * (1.0 + torch.max(torch.abs(g))))
    return dp, ok


def solve_dense(A, b):
    """``torch.linalg.solve_ex(A, b)[0]`` (a dense solve outside any kernel
    of this package: bundle adjustment's (6M)^2 and the pose graph's
    (6N)^2 systems).  On CUDA the LU runs in cuSOLVER, chosen here: the
    default may pick MAGMA, whose LU works partly on the host and
    synchronizes with it, which a CUDA-graph capture refuses; cuSOLVER's
    ``getrf``/``getrs`` stay on the device.  The preference is restored
    after the call."""
    if A.device.type != "cuda":
        return torch.linalg.solve_ex(A, b)[0]
    saved = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        return torch.linalg.solve_ex(A, b)[0]
    finally:
        torch.backends.cuda.preferred_linalg_library(saved)
