"""Distributed IRLS Gauss-Newton: the template points split over the
ranks of a ``torch.distributed`` group (counterpart of
``bpvo_tpu/parallel/sharded.py``; no reference analogue, halismai/bpvo is
single-process).

Each rank holds a contiguous slice of the template's points and the whole
current image; per iteration it linearizes its slice and one fused
all-reduce of (H, g, f_sq) makes the normal equations global.  The 6x6
solve and the pose update run on every rank on replicated values, so every
host decision (sigma re-estimation, convergence) is the same on every rank.

The linearization is ``gauss_newton.run``'s own (the kernel route,
``fused_linearize`` and ``irls_reduce_w``, or the gather route for CUBIC
sampling and the DisparitySpace warp) with the reductions put in.
The robust scale is JAX's sharded estimator, not ``gauss_newton.run``'s:
the max of |r| over the ranks, the 1024-bin cumulative histogram summed
over the ranks, the median ``hi * argmax / bins`` (JAX sharded.py:88-99),
re-estimated while the last change of sigma exceeds
``scale_tolerance`` (JAX sharded.py:102; the single-device route also stops
on ``scale_tolerance_rel``).
"""
from __future__ import annotations

import dataclasses

import torch

from bpvo_tpu_torch.solver import gauss_newton as gn
from bpvo_tpu_torch.solver import mestimator
from bpvo_tpu_torch.vo.template_data import TemplateData

# the point axis of each TemplateData field, counted from the end (so a
# window of stacked templates shards the same way)
_POINT_AXIS = TemplateData(points=-2, pixels=-1, jacobians=-2, valid=-1,
                           num_valid=None, norm_scale=None, norm_center=None,
                           rows=-1, cols=-1)


def shard_template(tdata: TemplateData, rank: int, world: int
                   ) -> TemplateData:
    """Rank ``rank``'s contiguous slice of ``tdata``'s points (any leading
    window axes kept).  The capacity is first padded to a multiple of
    ``world`` with invalid points at (0, 0, 1) (JAX sharded.py:55-76);
    ``num_valid`` stays the global count."""
    K = tdata.points.shape[-2]
    pad = (-K) % world
    k = (K + pad) // world
    out = []
    for x, axis in zip(tdata, _POINT_AXIS):
        if axis is None:
            out.append(x)
            continue
        if pad:
            shape = list(x.shape)
            shape[axis] = pad
            fill = torch.zeros(shape, dtype=x.dtype, device=x.device)
            if x is tdata.points:
                fill[..., 2] = 1.0
            x = torch.cat([x, fill], dim=axis)
        out.append(x.narrow(axis, rank * k, k).contiguous())
    return TemplateData(*out)


def global_sigma(abs_r, valid, reducer=None):
    """Robust sigma of the |r| samples over every rank (JAX sharded.py:88-99
    and bundle_adjustment.py:131-147): hi = the max over the ranks, the
    cumulative histogram summed over them, median = hi * argmax / bins,
    sigma = 1.4826 (1 + 5 / max(n - 6, 1)) median, 1 below 1e-6.
    ``reducer`` None: this process's samples only."""
    local_max = torch.max(torch.where(valid, abs_r, 0.0))
    if reducer is not None:
        local_max = reducer.max(local_max)
    hi = torch.clamp(local_max, min=1e-12)
    # int32 counts (JAX's dtype): half the bytes of an all-reduce
    csum = mestimator.histogram_counts(abs_r, valid, hi).to(torch.int32)
    if reducer is not None:
        csum, = reducer.sum(csum)
    n = csum[-1]
    idx = torch.argmax((csum >= (n + 1) // 2).to(torch.uint8))
    med = hi * idx.to(abs_r.dtype) / mestimator.HISTOGRAM_BINS
    med = torch.where(n > 0, med, 0.0)
    return mestimator.scale_from_median(med, n.to(abs_r.dtype))


def sharded_options(opts: gn.GNOptions) -> gn.GNOptions:
    """``opts`` with JAX's sharded sigma rule: ``gauss_newton.run``'s host
    loop re-estimates sigma while its last change exceeds
    ``scale_tolerance``, with no relative test."""
    return dataclasses.replace(opts, scale_tolerance_rel=0.0)


def linearize_sharded(tdata: TemplateData, channels, cam, opts: gn.GNOptions,
                      reducer=None):
    """The ``linearize_fn`` of one rank's point slice (JAX
    ``_linearize_sharded``): ``gauss_newton``'s own linearization, the
    kernel route or the gather route by the level's options, with sigma
    from ``global_sigma`` and one ``reducer.sum`` of (H, g, f_sq).
    ``reducer`` None: no reduction (one process holding all points; equal
    to a world of one).  Returns linearize(T, scale, delta_scale, do_est)
    -> (H, g, f, sigma, delta_scale, w (C, K_local))."""
    def sigma_fn(r0, valid):
        return global_sigma(torch.abs(r0), valid, reducer)

    return gn._default_linearize_fn(
        tdata, channels, cam, opts, sigma_fn=sigma_fn,
        reduce=reducer.sum if reducer is not None else gn._no_reduce)


def make_sharded_gn(reducer, opts: gn.GNOptions):
    """The distributed GN runner (JAX ``make_sharded_gn``):
    run(tdata_shard, channels, cam, T_init) -> GNState, ``tdata_shard``
    this rank's ``shard_template``, ``channels`` the whole image.  Every
    field is replicated but the weights, which stay this rank's (C,
    K_local).  ``reducer`` a ``collectives.Reducer``, or None for one
    process with no collectives.  Eager: one host read per iteration, as
    ``gauss_newton.run``."""
    sopts = sharded_options(opts)

    def run(tdata_shard, channels, cam, T_init) -> gn.GNState:
        lin = linearize_sharded(tdata_shard, channels, cam, sopts, reducer)
        return gn.run(tdata_shard, channels, cam, T_init, sopts,
                      linearize_fn=lin)

    return run
