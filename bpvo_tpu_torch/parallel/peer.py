"""All-reduce across the cards of one host over NVLink peer memory: the
port's counterpart of the ``psum`` and ``pmax`` that XLA compiles into JAX's
``jit(shard_map(...))`` programs (``csrc/peer_reduce.cu``).

A captured NCCL all-reduce across cards brings event wait and record nodes
(NCCL's graph mixing), which the IF and WHILE bodies of the graphed routes
refuse.  ``peer_reduce`` is one plain kernel launch a call, so an nccl
group of several cards that qualifies (``eligible``) reduces through it,
eagerly and inside a capture alike (``collectives.Reducer``), and its
graphed routes replay with the reductions in their bodies.  The kernel
folds the ranks' values in rank order 0..W-1, the same operations on every
rank: every rank gets the same bits, and the eager and graphed routes
equal each other bit for bit.

- ``eligible(infos)``: the static rule, from every rank's ``rank_info``
  (gathered at setup): every rank on one host, on ``cuda:<rank>`` (as
  ``worker.join`` places them, every card visible), each card with peer
  access to every other, at most ``MAX_RANKS`` ranks.
- ``attach(reducer)``: the rule applied to a ``Reducer``'s group (one
  eager ``all_gather_object``); a ``PeerReduce`` for an nccl group of
  several ranks that qualifies, else None (the group keeps its route).
- ``PeerReduce``: this rank's buffer (``cudaMalloc``, exported with
  ``cudaIpcGetMemHandle``), the peers' buffers opened from their handles
  (gathered eagerly at setup), ``all_reduce(buf, op)`` one launch in place;
  ``close()`` unmaps and frees them (``multihost.shutdown`` calls
  ``close_all`` after ``graphs.release``: no graph outlives the buffers).
- ``loopback_reduce(x, op, arena)``: the same device code as W CTAs of one
  launch, CTA r playing rank r over the W buffers of a ``Loopback`` arena,
  so one card holds the kernel against its plain version.
- ``plain_fold``: the plain version, the rank-order fold; and
  ``plain_all_reduce`` / ``PlainPeer``, an all-gather of the W buffers
  then that fold, bit for bit what the kernel computes (the tests' stand-in
  on gloo ranks on the CPU).

Nothing falls back: a failed IPC open, a buffer over ``SLOT_BYTES`` or a
build failure raises; a peer that never arrives makes the kernel trap after
``TIMEOUT_S`` (a loud error, never a hang), and so does a peer whose call
of the same epoch reduces another (elements, op, dtype), or that is more
than one call ahead.  Calls of one (elements, op, dtype) made in another
order on two ranks are not told apart: the ranks' lockstep is the callers'.
"""
from __future__ import annotations

import ctypes
import socket
import weakref
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

OPS = {"sum": 0, "max": 1}
DTYPES = {torch.float32: 0, torch.int32: 1, torch.int64: 2}
SLOT_BYTES = 1 << 20          # csrc/peer_reduce.cu kSlotBytes
MAX_RANKS = 8                 # csrc/peer_reduce.cu kMaxRanks
# a spin's bound (multihost's group timeout); it catches a peer that never
# arrives, the call tag a peer whose all-reduce differs, neither a peer that
# made the same calls in another order
TIMEOUT_S = 60.0

# kernel launches made by ``PeerReduce.all_reduce`` and ``loopback_reduce``
# in this process (the plain version is not counted)
launch_count = 0

# the PeerReduce objects whose buffers are mapped (``close_all``)
_live = weakref.WeakSet()


class RankInfo(NamedTuple):
    """What the static rule needs of one rank: its host, its card's index,
    and whether that card reaches each card 0..W-1 (itself counts)."""
    host: str
    device: int
    access: Tuple[bool, ...]


def rank_info(device, world: int) -> RankInfo:
    device = torch.device(device)
    n = torch.cuda.device_count()
    return RankInfo(socket.gethostname(), device.index, tuple(
        q == device.index or (q < n and torch.cuda.can_device_access_peer(
            device.index, q)) for q in range(world)))


def eligible(infos: Sequence[RankInfo]) -> Tuple[bool, str]:
    """(whether ranks with these ``infos``, by rank, reduce over peer
    memory, why)."""
    world = len(infos)
    if world < 2:
        return False, "one rank"
    if world > MAX_RANKS:
        return False, f"{world} ranks > {MAX_RANKS}"
    if len({i.host for i in infos}) != 1:
        return False, "ranks on several hosts"
    placed = [i.device for i in infos]
    if placed != list(range(world)):
        return False, f"ranks on cards {placed}, not cuda:<rank>"
    if not all(all(i.access) for i in infos):
        return False, "a card without peer access to another"
    return True, "one host, cuda:<rank>, peer access all to all"


def attach(reducer) -> Optional["PeerReduce"]:
    """A ``PeerReduce`` for ``reducer``'s group if it is nccl with several
    ranks and ``eligible`` (one eager gather of every rank's ``rank_info``),
    else None; sets ``reducer.peer_rule`` to the rule's reason."""
    if reducer.backend != "nccl" or reducer.world == 1:
        reducer.peer_rule = (f"{reducer.backend}, {reducer.world} rank(s): "
                             f"not a multi-card nccl group")
        return None
    device = torch.device("cuda", torch.cuda.current_device())
    infos = [None] * reducer.world
    dist.all_gather_object(infos, rank_info(device, reducer.world),
                           group=reducer.group)
    ok, reducer.peer_rule = eligible([RankInfo(*i) for i in infos])
    if not ok:
        return None
    return PeerReduce(reducer.group, reducer.rank, reducer.world, device)


def _lib():
    from bpvo_tpu_torch.ops import _build
    return _build.library()


def _codes(buf, op: str, who: str):
    """(op code, dtype code) of a reduction of ``buf``; raises on what the
    kernel does not take."""
    if op not in OPS or buf.dtype not in DTYPES or (
            op == "max" and buf.dtype != torch.float32):
        raise ValueError(f"{who}: {op} of {buf.dtype} is not a reduction "
                         f"the layer makes (f32 sum and max, int32 and int64 "
                         f"sum)")
    if buf.numel() * buf.element_size() > SLOT_BYTES:
        raise ValueError(f"{who}: {buf.numel() * buf.element_size()} bytes "
                         f"over the slot capacity of {SLOT_BYTES}")
    return OPS[op], DTYPES[buf.dtype]


def _launch(lib, bufs, world, rank, loopback, src, dst, n, codes, device):
    global launch_count
    from bpvo_tpu_torch.ops import _build
    stream = torch.cuda.current_stream(device).cuda_stream
    p = ctypes.c_void_p
    rc = lib.bpvo_peer_reduce(bufs, world, rank, loopback,
                              p(src.data_ptr()), p(dst.data_ptr()), n,
                              *codes, int(TIMEOUT_S * 1e9), p(stream))
    _build.launch(lib, "peer_reduce", rc)
    with _build.count_lock:
        launch_count += 1


def _check(lib, what, rc):
    if rc != 0:
        raise RuntimeError(f"peer_reduce: {what} failed: "
                           + lib.bpvo_cuda_error_string(rc).decode())


class PeerReduce:
    """This rank's side of the peer all-reduce over ``group`` (W ranks on
    cards 0..W-1 of one host): its buffer, the peers' mapped buffers and
    the launch."""

    def __init__(self, group, rank: int, world: int, device):
        self.group, self.rank, self.world = group, rank, world
        self.device = torch.device(device)
        self._lib = lib = _lib()
        if (lib.bpvo_peer_slot_bytes() != SLOT_BYTES
                or lib.bpvo_peer_max_ranks() != MAX_RANKS):
            raise RuntimeError("peer_reduce: the library's slot size or rank "
                               "limit differs from parallel/peer.py's")
        handle = (ctypes.c_ubyte * lib.bpvo_peer_handle_bytes())()
        own = ctypes.c_void_p()
        _check(lib, "cudaMalloc / cudaIpcGetMemHandle",
               lib.bpvo_peer_alloc(self.device.index, ctypes.byref(own),
                                   handle))
        self._own, self._opened = own.value, []
        _live.add(self)
        handles = [None] * world
        dist.all_gather_object(handles, bytes(handle), group=group)
        ptrs = []
        for q, h in enumerate(handles):
            if q == rank:
                ptrs.append(self._own)
                continue
            ptr = ctypes.c_void_p()
            _check(lib, f"cudaIpcOpenMemHandle of rank {q}'s buffer",
                   lib.bpvo_peer_open(self.device.index,
                                      (ctypes.c_ubyte * len(h))(*h),
                                      ctypes.byref(ptr)))
            self._opened.append(ptr.value)
            ptrs.append(ptr.value)
        self._bufs = (ctypes.c_void_p * world)(*ptrs)

    def all_reduce(self, buf, op: str):
        """``buf`` (contiguous, on this rank's card) reduced over the ranks
        in place with ``op`` ("sum" or "max"), in rank order; one launch on
        the current stream.  Returns ``buf``."""
        if self._bufs is None:
            raise RuntimeError("peer_reduce: the buffers are closed")
        if buf.device != self.device or not buf.is_contiguous():
            raise ValueError(f"peer_reduce: a contiguous tensor on "
                             f"{self.device}, got {buf.device}")
        codes = _codes(buf, op, "peer_reduce")
        _launch(self._lib, self._bufs, self.world, self.rank, 0, buf, buf,
                buf.numel(), codes, self.device)
        return buf

    def close(self):
        """Unmap the peers' buffers and free this rank's, once every rank's
        kernels have ended (two barriers over the group: nobody reads a
        buffer that is being freed)."""
        if self._bufs is None:
            return
        self._bufs = None
        _live.discard(self)
        torch.cuda.synchronize(self.device)
        dist.barrier(group=self.group)
        for ptr in self._opened:
            _check(self._lib, "cudaIpcCloseMemHandle",
                   self._lib.bpvo_peer_close(self.device.index,
                                             ctypes.c_void_p(ptr)))
        dist.barrier(group=self.group)
        _check(self._lib, "cudaFree",
               self._lib.bpvo_peer_free(self.device.index,
                                        ctypes.c_void_p(self._own)))
        self._opened = []


def close_all():
    """Close every ``PeerReduce`` of the process (before its group is
    destroyed, after every graph that launches its kernel)."""
    for p in list(_live):
        p.close()


class Loopback:
    """The buffers of a loopback launch: W of them in one zeroed allocation
    on ``device`` (their epochs advance on the device; make the arena
    before capturing a graph that uses it)."""

    def __init__(self, world: int, device):
        if not 1 <= world <= MAX_RANKS:
            raise ValueError(f"Loopback: {world} ranks, 1..{MAX_RANKS}")
        lib = _lib()
        self.world, self.device = world, torch.device(device)
        size = lib.bpvo_peer_buffer_bytes()
        self.arena = torch.zeros(world * size, dtype=torch.uint8,
                                 device=self.device)
        base = self.arena.data_ptr()
        self._bufs = (ctypes.c_void_p * world)(
            *(base + r * size for r in range(world)))


def loopback_reduce(x, op: str, arena: Optional[Loopback] = None):
    """(W, n): row r is what rank r of W gets from the all-reduce of the
    rows of ``x`` (W, n) in rank order.  A CPU tensor takes the plain
    version; a CUDA tensor one launch of W CTAs over ``arena``'s
    buffers."""
    if x.dim() != 2:
        raise ValueError(f"loopback_reduce: (W, n), got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return plain_fold(x.unbind(0), op)[None].expand_as(x).clone()
    if x.device.type != "cuda":
        raise ValueError(f"loopback_reduce: unsupported device {x.device}")
    if arena is None or arena.world != x.shape[0] or arena.device != x.device:
        raise ValueError(f"loopback_reduce: a Loopback of {x.shape[0]} "
                         f"ranks on {x.device}")
    codes = _codes(x[0], op, "loopback_reduce")
    x = x.contiguous()
    out = torch.empty_like(x)
    _launch(_lib(), arena._bufs, arena.world, 0, 1, x, out, x.shape[1],
            codes, x.device)
    return out


def plain_fold(bufs: Sequence[torch.Tensor], op: str):
    """The plain version: the ranks' tensors folded in rank order 0..W-1
    (sum, or max keeping a NaN), as ``peer_reduce`` folds them."""
    if op not in OPS:
        raise ValueError(f"plain_fold: op {op!r} not in {tuple(OPS)}")
    acc = bufs[0].clone()
    for b in bufs[1:]:
        acc = acc + b if op == "sum" else torch.where(
            torch.isnan(acc) | (acc > b), acc, b)
    return acc


def plain_all_reduce(buf, op: str, group, world: int):
    """``buf`` reduced over ``group`` in place through the plain version:
    an all-gather of the W buffers, then ``plain_fold``."""
    parts = [torch.empty_like(buf) for _ in range(world)]
    dist.all_gather(parts, buf, group=group)
    return buf.copy_(plain_fold(parts, op))


class PlainPeer:
    """``PeerReduce``'s stand-in for the tests: ``all_reduce`` through
    ``plain_all_reduce`` on any backend (gloo ranks on the CPU); ``folds``
    counts its calls."""

    def __init__(self, group, world: int):
        self.group, self.world, self.folds = group, world, 0

    def all_reduce(self, buf, op: str):
        self.folds += 1
        return plain_all_reduce(buf, op, self.group, self.world)
