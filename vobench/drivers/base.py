"""What the drivers share: the traffic pool rendered on the device from the
seed, the spans and samples the run records, and the program's outputs
kept for the check."""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List

import numpy as np
import torch

from vobench import scene as scene_mod
from vobench.bench import Cell, log


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Context:
    """What a run records for the per-layer metrics' readers: host spans
    (name -> [(t0, t1, frames)]), samples (name -> [values]), the traced
    slice (``trace``, its frames, ``launches`` per kernel module, the
    ``level_gn`` launches' shapes and the SGM calls' shapes in launch
    order), the window's frames and its seconds."""

    def __init__(self, cell: Cell):
        self.cell = cell
        self.spans = defaultdict(list)
        self.samples = defaultdict(list)
        self.trace = None
        self.launches: Dict[str, int] = {}
        self.frames = 0            # the window's frames and seconds
        self.window_s = 0.0
        self.traced_frames = 0     # the frames of the traced slice
        self.level_gn_launches: List = []   # (C, K, iterations) a launch
        self.sgm_calls: List = []           # (H, W, D) a call

    def log(self, msg: str) -> None:
        log(msg)


class Pool:
    """The mix's sequences, rendered on the device: ``images``,
    ``disparities`` and, for stereo input, ``rights``, each (S, F, H, W)
    float32."""

    def __init__(self, cell: Cell, seed: int, device):
        cfg = cell.config
        sc = cfg["scene"]
        cam = scene_mod.camera_of(cfg)
        self.twist = sc["step_twist"]
        self.n_frames = int(cfg["sequence_frames"])
        self.n_seq = int(cell.mix["sequences"])
        self.stereo = cell.inputs == "stereo"
        t0 = time.perf_counter()
        sc_ = scene_mod.Scene(cam, sc["plane_normal"], sc["plane_depth_m"],
                              device)
        seqs = []
        for s in range(self.n_seq):
            grid = scene_mod.noise_grid(scene_mod.sub_seed(seed, s), device)
            seqs.append(scene_mod.render_sequence(
                sc_, grid, self.twist, self.n_frames, self.stereo))
            del grid
        self.images = torch.stack([q.images for q in seqs])
        self.disparities = torch.stack([q.disparities for q in seqs])
        self.rights = (torch.stack([q.rights for q in seqs])
                       if self.stereo else None)
        del seqs
        d = self.disparities
        self.disparity_range = (float(d.min()), float(d.max()))
        limit = cfg["matcher"]["num_disparities"]
        if self.stereo and not self.disparity_range[1] < limit:
            raise ValueError(f"vobench: the scene's disparity reaches "
                             f"{self.disparity_range[1]:.2f}, beyond the "
                             f"matcher's {limit}")
        sync(device)
        log(f"pool: {self.n_seq} x {self.n_frames} frames "
            f"{tuple(self.images.shape[-2:])}, stereo {self.stereo}, "
            f"disparity {self.disparity_range[0]:.3f}-"
            f"{self.disparity_range[1]:.3f}, rendered in "
            f"{time.perf_counter() - t0:.3f} s")

    def aux(self, s: int):
        """Sequence ``s``'s second input: the right images or the
        disparities."""
        return self.rights[s] if self.stereo else self.disparities[s]

    def gt_step(self) -> np.ndarray:
        """The true motion of a frame wrt the previous one, as the VO
        reports it."""
        return scene_mod.step_pose(self.twist)
