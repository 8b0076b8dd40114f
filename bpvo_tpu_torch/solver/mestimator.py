"""Robust M-estimation: IRLS weights and robust scale estimation
(counterpart of ``bpvo_tpu/solver/mestimator.py`` and of the level kernel's
in-kernel estimator at ``bpvo_tpu/ops/pallas/level_gn_kernel.py:366-391,
429-430``).

sigma = 1.4826 (1 + 5/max(n-6, 1)) median(|r_valid|), clamped to 1 when
below 1e-6.  Three medians: the 1024-bin histogram median that
``gauss_newton.run`` uses (``estimate_scale``), the exact sorted median, and
the 16-step count bisection on [0, max|r|] of the level kernel
(``estimate_scale_bisect``; the kernel and its plain version run it as 4
rounds of 4 steps, ``ops.level_gn.median_rounds``, equal bit for bit).
Each route is held to the estimator of the JAX code it replaces.
"""
from __future__ import annotations

import math

import torch

from bpvo_tpu_torch.types import LossFunctionType

HUBER_K = 1.345
TUKEY_T = 4.685
BISECTION_STEPS = 16
HISTOGRAM_BINS = 1024


def huber_weight(u, k: float = HUBER_K):
    au = torch.abs(u)
    return torch.where(au < k, 1.0, k / torch.clamp(au, min=1e-20))


def tukey_weight(u, t: float = TUKEY_T):
    x = u / t
    w = 1.0 - x * x
    return torch.where(torch.abs(u) < t, w * w, 0.0)


def l2_weight(u):
    return torch.ones_like(u)


# the rest of the reference's robust_loss.h zoo (robust_loss.h:80-115); no
# LossFunctionType selects them, as in the JAX package
def cauchy_weight(u, c: float = 2.3849):
    x = u / c
    return 1.0 / (1.0 + x * x)


def fair_weight(u, c: float = 1.3998):
    return 1.0 / (1.0 + torch.abs(u) / c)


def andrews_weight(u, c: float = 1.339):
    # the normalized sinc of u / c, sin(pi u/c) / (pi u/c), as the JAX
    # package computes it
    return torch.where(torch.abs(u) < c * math.pi, torch.sinc(u / c), 0.0)


def geman_mcclure_weight(u):
    d = 1.0 + u * u
    return 1.0 / (d * d)


def welsch_weight(u, c: float = 2.9846):
    x = u / c
    return torch.exp(-x * x)


_WEIGHT_FNS = {
    LossFunctionType.HUBER: huber_weight,
    LossFunctionType.TUKEY: tukey_weight,
    LossFunctionType.L2: l2_weight,
}


def compute_weights(loss: LossFunctionType, residuals, valid, sigma):
    """IRLS weights of ``residuals / sigma``; invalid entries get 0."""
    return valid.to(residuals.dtype) * _WEIGHT_FNS[loss](residuals / sigma)


def scale_from_median(med, n):
    scale = 1.4826 * (1.0 + 5.0 / torch.clamp(n - 6.0, min=1.0)) * med
    return torch.where(scale < 1e-6, 1.0, scale)


def masked_median_sort(x, valid):
    """Exact median of x[valid]: element n//2 of the sorted data for odd n
    (and n < 3), the mean of the two middle ones for even n."""
    xs = torch.sort(torch.where(valid, x, float("inf"))).values
    n = torch.sum(valid)
    mid = n // 2
    lo = xs[torch.clamp(mid - 1, min=0)]
    hi = xs[torch.clamp(mid, min=0)]
    med = torch.where((n % 2 == 1) | (n < 3), hi, 0.5 * (lo + hi))
    return torch.where(n > 0, med, 0.0)


def histogram_counts(x, valid, hi, bins: int = HISTOGRAM_BINS):
    """csum (bins,) int64: csum[b] = count of valid x_i <= edge_b, edges at
    ((b+1) hi) / bins in float32 - the counts of JAX's (bins, N) compare
    matrix, without the matrix (134 MB at N = 131072).

    Each x goes to the first bin whose edge is >= x (``bucketize``); the
    edges are non-decreasing, so the cumulative count of that assignment is
    the compare count.  The counts are summed by ``scatter_add_``:
    ``torch.bincount`` sizes its output from ``max(x)`` and so waits for the
    device."""
    edges = (torch.arange(bins, dtype=x.dtype, device=x.device) + 1.0) \
        * hi / bins
    idx = torch.where(valid, torch.bucketize(x, edges), bins)
    counts = torch.zeros(bins + 1, dtype=torch.int64, device=x.device)
    counts.scatter_add_(0, idx, torch.ones_like(idx))
    return torch.cumsum(counts[:bins], 0)


def masked_median_histogram(x, valid, lo: float = 0.0, hi=None,
                            bins: int = HISTOGRAM_BINS):
    """Histogram approximate median (reference approximate_median.h:33-57)
    over [lo, lo + hi], hi = max valid (x - lo) by default: the lower edge of
    the first bin whose cumulative count reaches (n+1)//2, 0 when n = 0."""
    x = x - lo
    if hi is None:
        hi = torch.clamp(torch.max(torch.where(valid, x, 0.0)), min=1e-12)
    csum = histogram_counts(x, valid, hi, bins)
    n = torch.sum(valid)
    # first bin that reaches the target (argmax returns the first maximum;
    # 0 when none does, as jnp.argmax)
    bin_idx = torch.argmax((csum >= (n + 1) // 2).to(torch.uint8))
    edge = lo + bin_idx.to(x.dtype) * hi / bins
    return torch.where(n > 0, edge, 0.0)


def estimate_scale(residuals, valid, use_histogram: bool = True):
    """Robust sigma of ``residuals`` over ``valid`` with the histogram median
    (default) or the exact sorted median - ``gauss_newton.run``'s
    estimator."""
    r = torch.abs(residuals.reshape(-1))
    v = valid.reshape(-1)
    med = (masked_median_histogram(r, v) if use_histogram
           else masked_median_sort(r, v))
    return scale_from_median(med, torch.sum(v).to(residuals.dtype))


def bisect_interval(a, valid):
    """(lo, hi, n) after the 16 steps of count bisection of the median of
    ``a`` (non-negative) over ``valid``, n the valid count as float32.

    Invariant: count(a <= lo) < target <= count(a <= hi), so the median lies
    in (lo, hi] and hi converges onto it from above (width max(a)/2^16)."""
    n = torch.sum(valid.to(torch.float32))
    target = torch.floor((n + 1.0) * 0.5)
    hi = torch.max(torch.where(valid, a, 0.0))
    lo = torch.zeros_like(hi)
    for _ in range(BISECTION_STEPS):
        mid = (lo + hi) * 0.5
        cnt = torch.sum((valid & (a <= mid)).to(torch.float32))
        pred = cnt >= target
        lo, hi = torch.where(pred, lo, mid), torch.where(pred, mid, hi)
    return lo, hi, n


def median_bisect(a, valid):
    """Median of ``a`` (non-negative) over ``valid`` by count bisection:
    ``bisect_interval``'s hi, 0 when nothing is valid.  Returns (median,
    n)."""
    _, hi, n = bisect_interval(a, valid)
    return torch.where(n > 0, hi, 0.0), n


def estimate_scale_bisect(residuals, valid):
    """Robust sigma with the bisection median: the level kernel's estimator
    (``ops.level_gn``), not ``gauss_newton.run``'s."""
    med, n = median_bisect(torch.abs(residuals.reshape(-1)), valid.reshape(-1))
    return scale_from_median(med, n)
