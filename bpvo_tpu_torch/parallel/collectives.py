"""The collectives of the distributed layer: one small object that the
sharded solvers call where JAX's ``shard_map`` bodies call
``jax.lax.psum`` and ``pmax``.

``Reducer(group)`` wraps a ``torch.distributed`` process group.
``sum(*tensors)`` flattens its arguments into one buffer, runs one
``all_reduce`` and splits the result, as JAX's tuple psum ``(H, g, f_sq)``
is one fused all-reduce; ``max(x)`` is ``pmax``.  It counts the calls and
bytes it moves (``stats``), the counterpart of the HLO collective count of
``__graft_entry__._collective_stats``.

gloo reduces host tensors only.  With gloo and CUDA tensors every buffer
is staged explicitly: copied into pinned host memory, reduced there and
copied back (``staged`` is then true).  Times taken on that route measure
the copies and the host, not a collective on the card.

An nccl group of several cards on one host that ``peer.eligible`` admits
(every rank on ``cuda:<rank>``, peer access all to all) reduces through
``peer.PeerReduce`` (``csrc/peer_reduce.cu``, one kernel a call over
NVLink peer memory, the ranks folded in rank order), eagerly and inside a
capture alike, so its eager and graphed routes equal each other bit for
bit; ``peer`` is then set (else None) and ``route`` is "peer".  Other nccl
groups (one rank, or ranks over several hosts) call ``dist.all_reduce``
("nccl"); gloo groups "gloo".  The choice is static, made when the
``Reducer`` is built (``peer.attach``: one eager gather of every rank's
host and cards), and nothing falls back.

In a CUDA graph: a peer all-reduce is a kernel node, and a one-rank nccl
all-reduce adds none (both do no host work); the counts are
``utils.graphs.Count``s, so every replay advances
``calls`` and ``bytes`` by what the capture counted, and
``graphs.settle()`` adds those of an all-reduce in a conditional body
times the body's runs: once settled, ``stats()`` equals an eager run's.  A
gloo all-reduce of a CUDA tensor cannot be captured (the staging copies
synchronize with the host) and raises inside a capture: the gloo route is
eager by choice of backend (``graphs.route``).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

from bpvo_tpu_torch.parallel import peer
from bpvo_tpu_torch.utils import graphs

BACKENDS = ("gloo", "nccl")
_DIST_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


class Reducer:
    """Sum and max over the ranks of ``group`` (None: the default group)
    with the group's backend, one of ``BACKENDS``."""

    def __init__(self, group=None):
        backend = dist.get_backend(group)
        if backend not in BACKENDS:
            raise ValueError(f"Reducer: backend {backend!r} not in "
                             f"{BACKENDS}")
        self.group = group
        self.backend = backend
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        self._calls, self._bytes = graphs.Count(), graphs.Count()
        self.peer_rule = ""
        self.peer = peer.attach(self)

    @property
    def route(self) -> str:
        """How this group reduces: "peer" (``peer.PeerReduce``), "nccl"
        (``dist.all_reduce``) or "gloo" (host-staged for CUDA tensors);
        ``peer_rule`` says why."""
        return "peer" if self.peer is not None else self.backend

    @property
    def calls(self) -> int:
        return self._calls.launch_count

    @property
    def bytes(self) -> int:
        return self._bytes.launch_count

    def reset(self) -> None:
        self._calls.launch_count = 0
        self._bytes.launch_count = 0

    def stats(self) -> Dict[str, int]:
        return {"calls": self.calls, "bytes": self.bytes}

    def _all_reduce(self, buf, op):
        """All-reduce ``buf`` in place with ``op`` ("sum" or "max"; through
        the peer kernel on the "peer" route, staged through pinned host
        memory for gloo and a CUDA tensor); returns it."""
        staged = self.backend == "gloo" and buf.device.type == "cuda"
        if staged and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "Reducer: a gloo all-reduce of a CUDA tensor stages through "
                "host memory and cannot be captured in a CUDA graph (the "
                "gloo route is eager)")
        self._calls.launch_count += 1
        self._bytes.launch_count += buf.numel() * buf.element_size()
        if self.peer is not None:
            return self.peer.all_reduce(buf, op)
        if staged:
            host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
            host.copy_(buf)      # synchronous: the device's work is done
            dist.all_reduce(host, op=_DIST_OPS[op], group=self.group)
            buf.copy_(host)
        else:
            dist.all_reduce(buf, op=_DIST_OPS[op], group=self.group)
        return buf

    def sum(self, *tensors):
        """The element-wise sum over the ranks of each tensor (one dtype),
        in one all-reduce; a tuple of tensors of the input shapes."""
        dtypes = {t.dtype for t in tensors}
        if len(dtypes) != 1:
            raise ValueError(f"Reducer.sum: one dtype per call, got {dtypes}")
        buf = self._all_reduce(torch.cat([t.reshape(-1) for t in tensors]),
                               "sum")
        out, at = [], 0
        for t in tensors:
            out.append(buf[at:at + t.numel()].view(t.shape))
            at += t.numel()
        return tuple(out)

    def max(self, x):
        """The element-wise max of ``x`` over the ranks (``pmax``)."""
        return self._all_reduce(x.clone().reshape(-1), "max").view(x.shape)
