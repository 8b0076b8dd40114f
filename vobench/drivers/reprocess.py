"""The ``reprocess`` mixes: a job that re-processes recorded sequences.
The pool's sequences are replayed in turn, each from a fresh state
(``DeviceVO.init``, which keeps the captured step graph), its steps in
``add_frames`` chunks that read nothing from the device, then one read of
the chunk's outputs.  With stereo input the matcher runs inside the step
graph's keyframe branch (``DeviceVO(stereo_fn=TpuSGM(...).as_fn())``).

``frames_per_s``: every frame of the window's chunks, the sequences' init
frames included, over the time from the first chunk's start to the read
after the last chunk that started before the deadline."""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from vobench import program
from vobench.drivers.base import Context, Pool, sync

# the step outputs kept for the check, in the order of their columns
FIELDS = ("pose", "pose_world", "is_keyframe", "reason", "frac_good",
          "iters")


def _host(outs, n_levels: int) -> np.ndarray:
    """One read of a chunk's stacked outputs: (N, 16 + 16 + 3 + L)."""
    n = outs.pose.shape[0]
    return torch.cat([getattr(outs, f).reshape(n, -1).to(torch.float32)
                      for f in FIELDS], 1).cpu().numpy()


def columns(rows: np.ndarray, n_levels: int) -> Dict[str, np.ndarray]:
    """The named fields of ``_host``'s rows."""
    return {"pose": rows[:, :16].reshape(-1, 4, 4).astype(np.float64),
            "pose_world": rows[:, 16:32].reshape(-1, 4, 4).astype(
                np.float64),
            "is_keyframe": rows[:, 32] > 0.5,
            "reason": rows[:, 33].astype(int),
            "frac_good": rows[:, 34].astype(np.float64),
            "iters": rows[:, 35:35 + n_levels].astype(int)}


class Driver:
    def __init__(self, cell, seed: int, device, ctx: Context):
        self.cell, self.seed, self.device, self.ctx = cell, seed, device, ctx
        self.pool = Pool(cell, seed, device)
        self.chunk = int(cell.mix["chunk"])
        self.runs: List[Dict] = []   # {"seq", "rows"} of each sequence run
        self._next = 0               # the next sequence in turn

    # -- set-up ------------------------------------------------------------
    def setup(self):
        from bpvo_tpu_torch.vo.device_vo import DeviceVO
        cfg = self.cell.config
        self.params = program.algorithm_parameters(cfg["params"])
        self.n_levels = self.params.numPyramidLevels
        stereo_fn = (program.matcher(cfg).as_fn() if self.pool.stereo
                     else None)
        c = cfg["camera"]
        self.vo = DeviceVO(program.camera_matrix(cfg), c["baseline"],
                           (c["rows"], c["cols"]), self.params,
                           device=self.device, stereo_fn=stereo_fn)
        # the shapes the window runs: an init and a chunk, twice (the
        # first captures the step graph, the second re-enters it from a
        # fresh state)
        for _ in range(2):
            self._sequence_chunks(0, 1, record=False)
        sync(self.device)

    def _sequence_chunks(self, s: int, n_chunks: int, record=True,
                         deadline=None):
        """Run sequence ``s`` from its init through ``n_chunks`` chunks
        (fewer when ``deadline`` passes before a chunk starts); returns
        the frames run."""
        pool, n = self.pool, self.chunk
        images, auxs = pool.images[s], pool.aux(s)
        rows, frames = [], 0
        for k in range(n_chunks):
            if deadline is not None and time.perf_counter() >= deadline:
                break
            if k == 0:
                self.vo.init(images[0], auxs[0])
                frames += 1
            lo = 1 + k * n
            t0 = time.perf_counter()
            outs = self.vo.add_frames(images[lo:lo + n], auxs[lo:lo + n])
            t1 = time.perf_counter()
            rows.append(_host(outs, self.n_levels))
            frames += n
            if record:
                self.ctx.spans["add_frames"].append((t0, t1, n))
        if record and rows:
            self.runs.append({"seq": s, "rows": np.concatenate(rows)})
        return frames

    @property
    def chunks_per_sequence(self) -> int:
        return (self.pool.n_frames - 1) // self.chunk

    # -- the window --------------------------------------------------------
    def window(self, seconds: float) -> Dict:
        deadline = time.perf_counter() + seconds
        t0 = time.perf_counter()
        frames = 0
        while time.perf_counter() < deadline:
            s = self._next
            self._next = (s + 1) % self.pool.n_seq
            frames += self._sequence_chunks(s, self.chunks_per_sequence,
                                            deadline=deadline)
        elapsed = time.perf_counter() - t0   # the last read synced
        self.ctx.frames = frames
        self.ctx.window_s = elapsed
        failed = sum(int((~np.isfinite(r["rows"])).any(1).sum())
                     for r in self.runs)
        return {"frames_per_s": frames / elapsed, "attempted": frames,
                "failed": failed, "t_start": t0}

    # -- the traced slice --------------------------------------------------
    def traced(self, short: bool = False):
        """Run ``trace_sequences`` whole sequences (one when ``short``), to
        be called inside the profiler."""
        runs_before = len(self.runs)
        n = 1 if short else int(self.cell.mix.get("trace_sequences", 1))
        frames = 0
        for _ in range(n):
            s = self._next
            self._next = (s + 1) % self.pool.n_seq
            frames += self._sequence_chunks(s, self.chunks_per_sequence)
        if not short:
            self._traced_runs = self.runs[runs_before:]
            self.ctx.traced_frames = frames

    def traced_shapes(self):
        """The level_gn launches of the traced sequences, in launch order:
        each step's front estimate (coarsest level first) and a keyframe's
        re-estimate from keyframeReestimateStartLevel, with the GN
        iterations the step's outputs give (1 where they do not)."""
        from bpvo_tpu_torch.ops import descriptors
        p = self.params
        C = descriptors.num_channels(p.descriptor, p)
        caps = self.vo._capacities
        L = self.n_levels
        start2 = min(max(p.keyframeReestimateStartLevel, p.maxTestLevel),
                     L - 1)
        front = list(range(L - 1, p.maxTestLevel - 1, -1))
        re = list(range(start2, p.maxTestLevel - 1, -1))
        out = []
        for run in self._traced_runs:
            col = columns(run["rows"], L)
            has_prev = False
            for kf, it in zip(col["is_keyframe"], col["iters"]):
                front_known = not kf or not has_prev
                out += [(C, caps[l], max(int(it[l]), 1) if front_known else 1)
                        for l in front]
                if kf:
                    out += [(C, caps[l], max(int(it[l]), 1) if has_prev else 1)
                            for l in re]
                has_prev = not kf
        self.ctx.level_gn_launches = out

    # -- what the check reads ----------------------------------------------
    def check_inputs(self) -> Dict:
        """The program's outputs and final state, copied to the host."""
        st = self.vo.state
        tmpl = [{"rows": t.rows.cpu().numpy(), "cols": t.cols.cpu().numpy(),
                 "valid": t.valid.cpu().numpy(),
                 "Z": t.points[:, 2].float().cpu().numpy()}
                for t in st.templates]
        return {"runs": [dict(r, **columns(r["rows"], self.n_levels))
                         for r in self.runs],
                "templates": tmpl, "n_levels": self.n_levels}

    def free(self):
        del self.vo
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
