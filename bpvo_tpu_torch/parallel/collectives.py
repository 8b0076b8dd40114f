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
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")


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
        self.calls = 0
        self.bytes = 0

    def reset(self) -> None:
        self.calls = 0
        self.bytes = 0

    def stats(self) -> Dict[str, int]:
        return {"calls": self.calls, "bytes": self.bytes}

    def _all_reduce(self, buf, op):
        """All-reduce ``buf`` in place (staged through pinned host memory
        for gloo and a CUDA tensor); returns it."""
        self.calls += 1
        self.bytes += buf.numel() * buf.element_size()
        if self.backend == "gloo" and buf.device.type == "cuda":
            host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
            host.copy_(buf)      # synchronous: the device's work is done
            dist.all_reduce(host, op=op, group=self.group)
            buf.copy_(host)
        else:
            dist.all_reduce(buf, op=op, group=self.group)
        return buf

    def sum(self, *tensors):
        """The element-wise sum over the ranks of each tensor (one dtype),
        in one all-reduce; a tuple of tensors of the input shapes."""
        dtypes = {t.dtype for t in tensors}
        if len(dtypes) != 1:
            raise ValueError(f"Reducer.sum: one dtype per call, got {dtypes}")
        buf = self._all_reduce(torch.cat([t.reshape(-1) for t in tensors]),
                               dist.ReduceOp.SUM)
        out, at = [], 0
        for t in tensors:
            out.append(buf[at:at + t.numel()].view(t.shape))
            at += t.numel()
        return tuple(out)

    def max(self, x):
        """The element-wise max of ``x`` over the ranks (``pmax``)."""
        return self._all_reduce(x.clone().reshape(-1),
                                dist.ReduceOp.MAX).view(x.shape)
