"""The reference's stereo matcher: 3x3 census, Hamming cost volume (8
where x < d), semi-global aggregation along the four scan-line directions
with penalties P1 and P2 (Hirschmueller 2008, eq. 13: L(p, d) = C(p, d) +
min(L(p-r, d), L(p-r, d+-1) + P1, min_k L(p-r, k) + P2) - min_k L(p-r,
k)), summed, then the winner-take-all (first index on ties) with parabolic
sub-pixel refinement clipped to +-0.5; disparity 0 is invalid (-1).  Plain
PyTorch, one tensor op at a time; ``dtype`` is the cost and aggregation
precision."""
from __future__ import annotations

import torch

OFFSETS = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0),
           (1, 1))


def census_codes(I):
    """(H, W) -> (H, W) int32: bit b set when neighbour b >= centre
    (row-major 8-neighbourhood), a one-pixel border of 0."""
    H, W = I.shape
    out = torch.zeros((H, W), dtype=torch.int32, device=I.device)
    c = I[1:-1, 1:-1]
    acc = torch.zeros_like(c, dtype=torch.int32)
    for b, (dy, dx) in enumerate(OFFSETS):
        acc |= (I[1 + dy:H - 1 + dy, 1 + dx:W - 1 + dx] >= c).to(
            torch.int32) << b
    out[1:-1, 1:-1] = acc
    return out


def cost_volume(cL, cR, D: int, dtype):
    """(H, W, D) Hamming distance of the left code and the right code at
    x - d; 8 where x < d."""
    H, W = cL.shape
    cost = torch.full((H, W, D), 8, dtype=dtype, device=cL.device)
    for d in range(D):
        x = cL[:, d:] ^ cR[:, :W - d]
        n = torch.zeros_like(x)
        for b in range(8):
            n += (x >> b) & 1
        cost[:, d:, d] = n.to(dtype)
    return cost


def _scan(lines, p1: float, p2: float):
    """The recurrence along the first axis of ``lines`` (T, B, D) for B
    scan lines at once; returns every position's L (T, B, D)."""
    out = torch.empty_like(lines)
    prev = out[0] = lines[0]
    for t in range(1, lines.shape[0]):
        m = prev.amin(-1, keepdim=True)
        up = torch.cat([prev[:, :1], prev[:, :-1]], -1) + p1
        dn = torch.cat([prev[:, 1:], prev[:, -1:]], -1) + p1
        best = torch.minimum(torch.minimum(prev, up),
                             torch.minimum(dn, m + p2))
        prev = out[t] = lines[t] + best - m
    return out


def aggregate(cost, p1: float, p2: float):
    """Left->right + right->left + top->bottom + bottom->top, each pair of
    opposite directions scanned together."""
    H, W, _ = cost.shape
    rows = cost.transpose(0, 1)                                 # (W, H, D)
    a = _scan(torch.cat([rows, rows.flip(0)], 1), p1, p2)
    acc = (a[:, :H] + a[:, H:].flip(0)).transpose(0, 1)         # (H, W, D)
    a = _scan(torch.cat([cost, cost.flip(0)], 1), p1, p2)
    return acc + a[:, :W] + a[:, W:].flip(0)


def wta(a):
    D = a.shape[-1]
    best = torch.argmin(a.to(torch.float32), dim=-1)

    def take(idx):
        return torch.gather(a, -1, idx[..., None])[..., 0].to(torch.float32)

    c0 = take(torch.clamp(best - 1, 0, D - 1))
    c1 = take(best)
    c2 = take(torch.clamp(best + 1, 0, D - 1))
    den = c0 - 2.0 * c1 + c2
    delta = torch.where(torch.abs(den) > 1e-6,
                        0.5 * (c0 - c2) / torch.clamp(den, min=1e-6), 0.0)
    disp = best.to(torch.float32) + torch.clamp(delta, -0.5, 0.5)
    return torch.where(best > 0, disp, -1.0)


def sgm(left, right, num_disparities: int, p1: float, p2: float,
        dtype=torch.float32):
    """(H, W) left and right images -> (H, W) float32 disparity, -1 where
    invalid."""
    L, R = left.to(dtype), right.to(dtype)
    cost = cost_volume(census_codes(L), census_codes(R), num_disparities,
                       dtype)
    return wta(aggregate(cost, p1, p2))
