"""Carry state across from the JAX package (as numpy arrays and plain
values) to the port's tensors, so a test can feed both packages the very
same template or state.  Nothing here imports the JAX package: enums are
matched by their string values."""
from __future__ import annotations

import dataclasses
import enum
import typing
from typing import Any, Mapping

import numpy as np
import torch

from bpvo_tpu_torch.config import AlgorithmParameters
from bpvo_tpu_torch.solver.gauss_newton import GNOptions
from bpvo_tpu_torch.vo.device_vo import VOState
from bpvo_tpu_torch.vo.template_data import TemplateData
from bpvo_tpu_torch.vo.warp import CameraModel


def _dataclass_from(cls, get):
    """``cls(**{field: get(field)})`` with enum members converted by
    value."""
    types = typing.get_type_hints(cls)
    kw = {}
    for f in dataclasses.fields(cls):
        v = get(f.name)
        t = types[f.name]
        if isinstance(t, type) and issubclass(t, enum.Enum):
            v = t(getattr(v, "value", v))
        kw[f.name] = v
    return cls(**kw)


def params_from_jax(d: Mapping[str, Any]) -> AlgorithmParameters:
    """``AlgorithmParameters`` from ``dataclasses.asdict`` of the JAX
    package's parameters (enum members are converted by value)."""
    return _dataclass_from(AlgorithmParameters, d.__getitem__)


def gn_options_from_jax(opts) -> GNOptions:
    """The port's ``GNOptions`` from the JAX package's (its TPU backend
    choices, such as ``linearize`` and ``fused_bf16``, have no counterpart
    and are dropped)."""
    return _dataclass_from(GNOptions, lambda name: getattr(opts, name))


def camera_from_numpy(cam) -> CameraModel:
    """``CameraModel`` from a mapping or NamedTuple with fx, fy, cx, cy,
    baseline (numpy or JAX scalars)."""
    d = cam._asdict() if hasattr(cam, "_asdict") else cam
    return CameraModel(**{k: float(np.asarray(d[k], np.float32))
                          for k in CameraModel._fields})


def _tensor(a, device, dtype=None):
    t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=device, dtype=dtype) if dtype else t.to(device)


def template_from_numpy(d: Mapping[str, Any], device="cuda") -> TemplateData:
    """``TemplateData`` from a mapping of its fields (e.g. ``_asdict()`` of
    the JAX template, as numpy arrays); a window of templates stacked along
    leading axes (JAX ``stack_templates``) stays stacked."""
    f32, i64 = torch.float32, torch.int64
    return TemplateData(
        points=_tensor(d["points"], device, f32),
        pixels=_tensor(d["pixels"], device, f32),
        jacobians=_tensor(d["jacobians"], device, f32),
        valid=_tensor(d["valid"], device, torch.bool),
        num_valid=_tensor(d["num_valid"], device, i64),
        norm_scale=_tensor(d["norm_scale"], device, f32),
        norm_center=_tensor(d["norm_center"], device, f32),
        rows=_tensor(d["rows"], device, i64),
        cols=_tensor(d["cols"], device, i64))


def state_from_numpy(d: Mapping[str, Any], device="cuda") -> VOState:
    """``VOState`` from a mapping of its fields, with ``templates`` a
    sequence of template mappings and ``prev_channels`` a sequence of
    arrays.  ``prev_disparity`` is the candidate's disparity, or its
    (2, H, W) stereo pair for a ``DeviceVO`` with a ``stereo_fn``."""
    f32 = torch.float32
    return VOState(
        templates=tuple(template_from_numpy(t, device)
                        for t in d["templates"]),
        prev_channels=tuple(_tensor(c, device, f32)
                            for c in d["prev_channels"]),
        prev_disparity=_tensor(d["prev_disparity"], device, f32),
        has_prev=bool(np.asarray(d["has_prev"])),
        T_kf=_tensor(d["T_kf"], device, f32),
        pose_world=_tensor(d["pose_world"], device, f32),
        T_delta=_tensor(d["T_delta"], device, f32),
        last_weights=_tensor(d["last_weights"], device, f32))


def ba_options_from_jax(opts):
    """The port's ``BAOptions`` from the JAX package's (or a mapping of its
    fields); the sampling mode is converted by value."""
    from bpvo_tpu_torch.parallel.bundle_adjustment import BAOptions
    from bpvo_tpu_torch.types import InterpolationType
    d = opts._asdict() if hasattr(opts, "_asdict") else dict(opts)
    d["interp"] = InterpolationType(getattr(d["interp"], "value",
                                            d["interp"]))
    return BAOptions(**{k: d[k] for k in BAOptions._fields if k in d})


def pose_graph_options_from_jax(opts):
    """The port's ``PoseGraphOptions`` from the JAX package's (or a mapping
    of its fields)."""
    from bpvo_tpu_torch.parallel.pose_graph import PoseGraphOptions
    d = opts._asdict() if hasattr(opts, "_asdict") else dict(opts)
    return PoseGraphOptions(**{k: d[k] for k in PoseGraphOptions._fields
                               if k in d})


def state_shard_from_numpy(d: Mapping[str, Any], rank: int, world: int,
                           device="cuda") -> VOState:
    """Rank ``rank``'s part of a whole VOState (a mapping as for
    ``state_from_numpy``, e.g. a JAX sharded VO's state read back whole):
    every template sliced by ``sharded.shard_template``, the finest
    weights by the same contiguous slice; the rest whole."""
    from bpvo_tpu_torch.parallel import sharded
    st = state_from_numpy(d, device)
    w = st.last_weights
    k = w.shape[-1] // world
    return st._replace(
        templates=tuple(sharded.shard_template(t, rank, world)
                        for t in st.templates),
        last_weights=w[..., rank * k:(rank + 1) * k].contiguous())
