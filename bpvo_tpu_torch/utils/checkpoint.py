"""Checkpoint and resume of a ``DeviceVO`` state (counterpart of
``bpvo_tpu/utils/checkpoint.py``), in the JAX package's file format.

One ``.npz`` holds the state's arrays under ``state::<path>`` keys, the
path spelled as ``jax.tree_util`` spells a ``VOState`` leaf
(``.templates/[0]/.points``, ``.prev_channels/[1]``, ``.T_kf``, ...), the
trajectory's (N, 4, 4) poses under ``trajectory`` and a JSON metadata blob
under ``__meta__``.  A file either package wrote loads into the other: the
port maps the keys onto its ``VOState`` through ``utils.convert``.
"""
from __future__ import annotations

import json
import os
import re
from typing import Tuple

import numpy as np
import torch

from bpvo_tpu_torch.utils import convert
from bpvo_tpu_torch.vo.device_vo import VOState, resolve_device
from bpvo_tpu_torch.vo.template_data import TemplateData

_INDEXED = re.compile(r"^\.(templates|prev_channels)/\[(\d+)\](?:/\.(\w+))?$")


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _state_arrays(state: VOState) -> dict:
    """{JAX tree path: numpy array} of every leaf of ``state``."""
    out = {}
    for name, value in zip(VOState._fields, state):
        if name == "templates":
            for i, td in enumerate(value):
                for f, a in zip(TemplateData._fields, td):
                    out[f".templates/[{i}]/.{f}"] = _numpy(a)
        elif name == "prev_channels":
            for i, a in enumerate(value):
                out[f".prev_channels/[{i}]"] = _numpy(a)
        else:
            out[f".{name}"] = _numpy(value)
    return out


def save_vo_state(path: str, state: VOState, trajectory=None,
                  metadata: dict = None) -> None:
    """Write ``state`` (and a ``Trajectory``'s poses, and ``metadata``) to
    ``path`` (``.npz`` appended when missing)."""
    payload = {f"state::{k}": v for k, v in _state_arrays(state).items()}
    if trajectory is not None:
        payload["trajectory"] = np.asarray(
            np.stack(trajectory.poses) if len(trajectory) else
            np.zeros((0, 4, 4)))
    payload["__meta__"] = np.frombuffer(
        json.dumps(metadata or {}).encode(), dtype=np.uint8)
    np.savez_compressed(path, **payload)


def load_vo_state(path: str, device="cuda"
                  ) -> Tuple[VOState, np.ndarray, dict]:
    """(state on ``device``, trajectory poses (N, 4, 4), metadata) from a
    file ``save_vo_state`` of either package wrote.  ``device`` is the
    card unless the caller asks for the CPU."""
    device = resolve_device(device)
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as data:
        fields = {"templates": {}, "prev_channels": {}}
        for key in data.files:
            if not key.startswith("state::"):
                continue
            leaf = key[len("state::"):]
            m = _INDEXED.match(leaf)
            if m is None:
                fields[leaf.lstrip(".")] = data[key]
            elif m.group(1) == "templates":
                fields["templates"].setdefault(int(m.group(2)), {})[
                    m.group(3)] = data[key]
            else:
                fields["prev_channels"][int(m.group(2))] = data[key]
        traj = data["trajectory"] if "trajectory" in data.files \
            else np.zeros((0, 4, 4))
        meta = json.loads(bytes(data["__meta__"]).decode()) \
            if "__meta__" in data.files else {}
    for name in ("templates", "prev_channels"):
        fields[name] = [fields[name][i] for i in sorted(fields[name])]
    return convert.state_from_numpy(fields, device), traj, meta
