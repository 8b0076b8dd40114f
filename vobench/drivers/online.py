"""The ``online`` mixes: a vehicle's stack, closed loop with one frame in
flight.  Each stereo pair (already on the card) is matched by
``TpuSGM.run``, whose disparity comes back to the host, and handed with
its left image to ``VisualOdometry.add_frame``, whose pose is read on the
host.  ``VisualOdometry`` has no reset (a new one captures its graphs
again), so the stream runs one sequence forward, then back, again and
again through one object: the camera's path stays continuous and its
velocity turns at each end, as a vehicle's does when it stops and
reverses.

``frame_ms_p50`` / ``frame_ms_p95``: host clock from a frame handed in to
its pose on the host, over every frame of the window."""
from __future__ import annotations

import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from vobench import bench, program
from vobench.drivers.base import Context, Pool, sync


class Driver:
    def __init__(self, cell, seed: int, device, ctx: Context):
        self.cell, self.seed, self.device, self.ctx = cell, seed, device, ctx
        if cell.inputs != "stereo":
            raise NotImplementedError("online: stereo input only")
        self.pool = Pool(cell, seed, device)
        self.stream: List[Dict] = []    # {"pos", "frame", "pose", "is_kf"}
        self.disparities: Dict[int, np.ndarray] = {}  # latest, by frame
        self._pos = 0
        self._window = (0, 0)

    def frame_at(self, pos: int) -> int:
        """The frame a stream position shows: 0..F-1, then back."""
        last = self.pool.n_frames - 1
        q = pos % (2 * last)
        return q if q <= last else 2 * last - q

    def setup(self):
        from bpvo_tpu_torch.vo.odometry import VisualOdometry
        cfg = self.cell.config
        self.params = program.algorithm_parameters(cfg["params"])
        self.sgm = program.matcher(cfg)
        c = cfg["camera"]
        self.vo = VisualOdometry(program.camera_matrix(cfg), c["baseline"],
                                 (c["rows"], c["cols"]), self.params,
                                 device=self.device)
        bench.mark("VisualOdometry built")
        # every graph key the stream meets: the first frame, other steps,
        # keyframes with a candidate; warm frames are part of the stream
        for _ in range(int(self.cell.mix.get("warm_frames", 12))):
            self._frame(None)
        sync(self.device)

    def _frame(self, rec):
        pos = self._pos
        self._pos += 1
        f = self.frame_at(pos)
        left, right = self.pool.images[0, f], self.pool.rights[0, f]
        timed = rec is not None and rec["events"] is not None
        t0 = time.perf_counter()
        if timed:
            rec["events"][0].record()
        disp = self.sgm.run(left, right, device=self.device)
        if timed:
            rec["events"][1].record()
        t1 = time.perf_counter()
        res = self.vo.add_frame(left, disp)
        pose = np.asarray(res.pose, np.float64)
        t2 = time.perf_counter()
        if rec is not None:
            rec["frame_ms"].append((t2 - t0) * 1e3)
            rec["add_frame_ms"].append((t2 - t1) * 1e3)
            # the matcher's span on the stream (the host's on the CPU)
            rec["matcher"].append(rec["events"] or (t1 - t0) * 1e3)
            rec["events"] = self._events()
        self.stream.append({"pos": pos, "frame": f, "pose": pose,
                            "is_kf": bool(res.is_keyframe)})
        self.disparities[f] = disp

    def _events(self):
        if self.device.type != "cuda":
            return None
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def _run(self, deadline=None, n=None) -> Dict:
        rec = {"frame_ms": [], "add_frame_ms": [], "matcher": [],
               "events": self._events()}
        k = 0
        while (time.perf_counter() < deadline if deadline is not None
               else k < n):
            self._frame(rec)
            k += 1
        return rec

    def window(self, seconds: float) -> Dict:
        first = self._pos
        t0 = time.perf_counter()
        rec = self._run(deadline=t0 + seconds)
        self.ctx.window_s = time.perf_counter() - t0  # the last pose read
        self._window = (first, self._pos)
        ms = rec["frame_ms"]
        self.ctx.frames = len(ms)
        self.ctx.samples["add_frame_ms"] = rec["add_frame_ms"]
        self.ctx.samples["matcher_ms"] = [
            m if isinstance(m, float) else m[0].elapsed_time(m[1])
            for m in rec["matcher"]]
        window = self.stream[first:]
        kf = sum(s["is_kf"] for s in window)
        failed = sum(not np.isfinite(s["pose"]).all() for s in window)
        p95 = float(np.percentile(ms, 95))
        q = max(len(ms) // 4, 1)
        self.ctx.log("online: frame ms p50 by quarter of the window "
                     + " ".join(f"{statistics.median(ms[i:i + q]):.4f}"
                                for i in range(0, q * 4, q) if ms[i:i + q]))
        self.ctx.log(f"online: {len(ms)} frames, {kf} keyframes (share "
                     f"{kf / max(len(ms), 1):.4f}), {sum(x > p95 for x in ms)}"
                     f" frames beyond the 95th percentile")
        return {"frame_ms_p50": statistics.median(ms), "frame_ms_p95": p95,
                "attempted": len(ms), "failed": failed, "t_start": t0}

    def traced(self, short: bool = False):
        """Run ``trace_frames`` frames (a quarter when ``short``), to be
        called inside the profiler."""
        n = int(self.cell.mix.get("trace_frames", 120))
        n = max(n // 4, 1) if short else n
        self._run(n=n)
        if not short:
            self.ctx.traced_frames = n

    def traced_shapes(self):
        cfg = self.cell.config
        c = cfg["camera"]
        n = int(self.cell.mix.get("trace_frames", 120))
        self.ctx.sgm_calls = [(c["rows"], c["cols"],
                               cfg["matcher"]["num_disparities"])] * n

    def check_inputs(self) -> Dict:
        return {"stream": self.stream, "window": self._window,
                "disparities": self.disparities}

    def free(self):
        del self.vo
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
