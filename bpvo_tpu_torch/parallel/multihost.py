"""Process groups, the layout of ranks and rank launching (counterpart of
``bpvo_tpu/parallel/multihost.py``; no reference analogue).

``initialize`` is ``torch.distributed.init_process_group`` with the
backend, the world, the rank and a timeout given explicitly (nothing picks
a backend for the caller), and returns the world's ``Reducer``.
``global_mesh`` is the (kf, points) layout of the ranks that JAX's 2-D
mesh gives: rank = kf * points + point, so a kf coordinate holds
consecutive ranks (JAX's host-major device order).  ``launch`` starts one
process per rank of a module and waits for them with a timeout, so a rank
that diverges fails instead of hanging.
"""
from __future__ import annotations

import datetime
import os
import socket
import subprocess
import sys
import time
from typing import List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from bpvo_tpu_torch.parallel import peer
from bpvo_tpu_torch.parallel.collectives import BACKENDS, Reducer
from bpvo_tpu_torch.utils import graphs

DEFAULT_TIMEOUT_S = 60.0
PORT_ATTEMPTS = 3             # ``launch``'s tries when a port was taken
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def initialize(backend: str, world_size: int, rank: int, address: str,
               timeout_s: float = DEFAULT_TIMEOUT_S,
               device: Optional[torch.device] = None) -> Reducer:
    """Join the default process group at ``address`` (a ``tcp://host:port``
    init method, e.g. on a ``free_port()``) and return its ``Reducer``.
    ``timeout_s`` bounds every eager collective (the group's warm-ups and
    the collectives of a capture), so a rank whose peers call another
    collective, or none, fails in that time instead of hanging.  A
    replayed CUDA graph's collectives are not watched: the graphed routes
    compute every branch and loop predicate from reduced values, so every
    rank replays the same collectives.
    ``device`` is this rank's device: with ``nccl`` each rank needs a
    device of its own, so two ranks that would share one raise (NCCL
    cannot place them), and the default is ``cuda:<rank>``."""
    if backend not in BACKENDS:
        raise ValueError(f"initialize: backend {backend!r} not in {BACKENDS}")
    kw = {}
    if backend == "nccl":
        n_dev = torch.cuda.device_count()
        if world_size > n_dev:
            raise ValueError(f"initialize: nccl with {world_size} ranks on "
                             f"{n_dev} CUDA device(s); NCCL cannot place two "
                             f"ranks on one device (use gloo)")
        device = torch.device(device or f"cuda:{rank}")
        torch.cuda.set_device(device)
        kw["device_id"] = device
    dist.init_process_group(backend, init_method=address,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            **kw)
    return Reducer()


def shutdown() -> None:
    """Destroy the default group, after every CUDA graph of the process
    (``graphs.release``: a graph holding a captured NCCL collective keeps
    its communicator from being destroyed) and then the peer buffers
    (``peer.close_all``: no graph that launches the peer kernel outlives
    the buffers it maps)."""
    if dist.is_initialized():
        graphs.release()
        peer.close_all()
        dist.destroy_process_group()


class RankLayout(NamedTuple):
    """A (kf, points) grid of ranks: rank = kf_index * points + point_index."""
    kf: int
    points: int

    def coords(self, rank: int):
        """(kf index, point index) of ``rank``."""
        return divmod(rank, self.points)


def global_mesh(points_axis_size: Optional[int] = None, kf_axis_size: int = 1,
                world_size: Optional[int] = None) -> RankLayout:
    """The (kf, points) layout of the world's ranks (``world_size`` default:
    the default group's); ``points_axis_size`` defaults to what
    ``kf_axis_size`` leaves."""
    n = world_size if world_size is not None else dist.get_world_size()
    if points_axis_size is None:
        if n % kf_axis_size:
            raise ValueError(f"global_mesh: {n} ranks, kf axis "
                             f"{kf_axis_size}")
        points_axis_size = n // kf_axis_size
    if kf_axis_size * points_axis_size != n:
        raise ValueError(f"global_mesh: {kf_axis_size} x {points_axis_size} "
                         f"!= {n} ranks")
    return RankLayout(kf_axis_size, points_axis_size)


def process_info():
    return {"process_index": dist.get_rank() if dist.is_initialized() else 0,
            "process_count": (dist.get_world_size() if dist.is_initialized()
                              else 1),
            "local_devices": torch.cuda.device_count(),
            "backend": dist.get_backend() if dist.is_initialized() else None}


def launch(module: str, args: Sequence[str], world: int,
           timeout_s: float = 600.0) -> List[subprocess.CompletedProcess]:
    """Run ``python -m module *args --rank r --world world --port P`` for
    every rank r (one free port), wait for all of them at most ``timeout_s``
    and kill what is still running then.  Returns the completed processes
    (stdout and stderr merged into stdout); a rank killed at the timeout
    has returncode None.  ``free_port`` closes the port it found before
    rank 0 listens on it, some seconds later; when another process took it
    meanwhile (a rank failed with EADDRINUSE), the ranks run again on a new
    port, at most PORT_ATTEMPTS times in all."""
    for _ in range(PORT_ATTEMPTS):
        out = _launch_once(module, args, world, free_port(), timeout_s)
        if not any(d.returncode != 0 and "EADDRINUSE" in (d.stdout or "")
                   for d in out):
            break
    return out


def _launch_once(module, args, world, port, timeout_s):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    procs = [subprocess.Popen(
        [sys.executable, "-m", module, *args, "--rank", str(r), "--world",
         str(world), "--port", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=ROOT) for r in range(world)]
    out = []
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            try:
                stdout, _ = p.communicate(
                    timeout=max(deadline - time.monotonic(), 0.1))
                out.append(subprocess.CompletedProcess(p.args, p.returncode,
                                                       stdout))
            except subprocess.TimeoutExpired:
                p.kill()
                stdout, _ = p.communicate()
                out.append(subprocess.CompletedProcess(p.args, None, stdout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out
